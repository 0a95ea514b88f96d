"""CTC prefix beam search with optional 12-mer LM fusion, in plain PyTorch.

Counterpart of ``radian_tpu/ops/beam_search.py::beam_search_batch``; it
is the reference the CUDA kernels (``ops/beam_cuda.py``) are tested
against and the kernel wrappers' path for tensors on the CPU.
Semantics, step by step as in ``_step``:

- Each beam spawns one COPY candidate (labeling unchanged) and four
  EXTEND candidates (one per base; a repeated base extends only the
  blank-ending paths).
- An EXTEND(b1, c) and a COPY(b2) with equal labelings merge by
  logaddexp; equality is length + two independent 32-bit rolling hashes.
  The merged mass goes to the earlier slot of the insertion order
  ``5·beam + {0 copy, 1+c extend}``.
- The ``beam_width`` best candidates survive, by score floored at
  ``SCORE_FLOOR`` (so exact-zero probabilities, ``log 0 = -inf``, tie in
  slot order); picked slots are knocked to ``KNOCKED`` below every
  floored score.
- Each step emits packed backpointers ``parent·8 + (append+1)``; steps
  past a read's length leave the state alone and emit identity pointers.
  ``backtrace_batch`` walks them back from beam 0.
- With an LM (``LMFusion``), each beam's base distributions are fused
  with its context's LM row where the gate opens (LM entropy below
  ``r_threshold``, signal entropy above ``s_threshold``): COPY uses the
  row of the labeling's previous context (gated on ``length >=
  ctx_len+1``), EXTEND the row of its full last-``ctx_len`` context
  (gated on ``length >= ctx_len``).  Beams carry their contexts and both
  rows; only an extension looks a row up, and inactive steps leave them
  alone.

State is batch-minor, ``[W, N]``.  Hashes are carried in int64 and kept
to 32 bits by hand (torch has no complete uint32 arithmetic), and
``logaddexp`` is written out as JAX's formula, NaN branch included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_BASES = 4
BLANK = 4
NEG = -1.0e30  # finite "impossible" log-prob
NEG_HALF = -1.0e29  # validity threshold: junk ≈ NEG + log p < this
SCORE_FLOOR = -1.0e38  # selection clamp: log(0) = -inf scores tie here
KNOCKED = -3.0e38  # strictly below every floored score
H1_MULT = 2654435761
H2_MULT = 2246822519
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, mult: int) -> torch.Tensor:
    """``(h * mult) mod 2**32`` for int64 ``h`` in [0, 2**32) without
    overflowing int64: split ``h`` into 16-bit halves."""
    lo = (h & 0xFFFF) * mult
    hi = ((h >> 16) * mult) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX's ``logaddexp``: ``a+b`` where ``a-b`` is NaN (two equal
    infinities), else ``max + log1p(exp(-|a-b|))``."""
    d = a - b
    return torch.where(torch.isnan(d), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-d.abs())))


def _sum4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the four entries along ``dim`` (kept), left to right: the
    CUDA kernel adds in the same order, so both round alike."""
    a, b, c, d = x.unbind(dim)
    return (((a + b) + c) + d).unsqueeze(dim)


# bits set in each byte value: torch has no popcount
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)])


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 ``x`` in [0, 2**32), four byte lookups."""
    lut = _POPCOUNT8.to(x.device)
    return (lut[x & 255] + lut[(x >> 8) & 255] + lut[(x >> 16) & 255]
            + lut[(x >> 24) & 255])


class LMFusion(NamedTuple):
    """The LM side of a fused decode: tables, context length, gate.

    ``t1, t2`` are the dense tables ``(probs [R, 4], entropy [R])`` or,
    with ``packed``, ``KmerLM.compressed()``'s ``(l1 [ceil(R/32), 2]
    int32, vals [U+1, 5])``.  Probabilities and entropies are float32 or
    bfloat16, widened to float32 as a row is loaded.
    """

    t1: torch.Tensor
    t2: torch.Tensor
    packed: bool
    ctx_len: int
    s_threshold: float
    r_threshold: float

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """``[5, W, N]`` f32 rows (4 next-base probabilities, entropy) of
        the int64 contexts ``idx [W, N]``."""
        if self.packed:
            # presence bit and rank from l1, then vals[1 + rank + bits
            # below] for a real context, vals[0] for an absent one
            word_rank = self.t1[idx >> 5].long() & _MASK32  # [W, N, 2]
            word, rank = word_rank[..., 0], word_rank[..., 1]
            bit = idx & 31
            below = word & ((torch.ones_like(bit) << bit) - 1)
            present = (word >> bit) & 1
            cidx = torch.where(present == 1, rank + 1 + _popcount32(below),
                               torch.zeros_like(rank))
            rows = self.t2[cidx]  # [W, N, 5]
        else:
            rows = torch.cat([self.t1[idx], self.t2[idx][..., None]], -1)
        return rows.float().permute(2, 0, 1)


def signal_entropies(mat: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of the L1-normalised non-blank distribution per timestep,
    the class axis ``dim`` kept with size 1.

    Reference decode.py:134-138: zero-sum rows stay unnormalised and zero
    probabilities contribute nothing.  Both sums run left to right.
    """
    base = mat.narrow(dim, 0, N_BASES)
    s = _sum4(base, dim)
    p = torch.where(s > 0, base / s, base)
    terms = torch.where(p > 0, p * torch.log(p),
                        torch.zeros((), device=p.device))
    return -_sum4(terms, dim)


def _fused_dist(m4, s_base, s_sum, r_dist, r_ent, s_ent, len_ok, lm):
    """LM fusion (reference decode.py:52-64,79-96): the gated average of
    the LM row and the renormalised signal base distribution, rescaled by
    the non-blank mass.  ``m4/s_base [4, N]``, ``s_sum/s_ent [1, N]``,
    ``r_dist [4, W, N]``, ``r_ent/len_ok [W, N]`` → ``[4, W, N]``."""
    fused = (r_dist + s_base[:, None, :]) * 0.5 * s_sum[:, None, :]
    gate = len_ok & (r_ent < lm.r_threshold) & (s_ent > lm.s_threshold)
    return torch.where(gate[None], fused, m4[:, None, :])


def _step(state, lp, active, beam_width: int, lm: LMFusion | None = None,
          m5=None, s_ent=None):
    """One decode step. ``lp`` [5, N] log-probs, ``active`` [1, N] bool;
    with ``lm``, also the step's probabilities ``m5`` [5, N] and signal
    entropy ``s_ent`` [1, N]."""
    pr_b, pr_nb, pr_t, last, length, h1, h2 = state[:7]
    w = beam_width
    dev = lp.device
    neg = torch.tensor(NEG, device=dev)
    valid = pr_t > NEG_HALF  # [W, N]
    log_m4 = lp[:N_BASES]  # [4, N]
    blank_lp = lp[BLANK:BLANK + 1]  # [1, N]
    cvec = torch.arange(N_BASES, device=dev)[:, None, None]  # [4, 1, 1]
    w_col = torch.arange(w, device=dev)[:, None]  # [W, 1]

    if lm is None:
        log_dist_c = log_dist_e = log_m4[:, None, :]  # [4, 1, N]
    else:
        ctx_full, ctx_prev, lm_full, lm_prev = state[7:]
        m4 = m5[:N_BASES]
        s_sum = _sum4(m4, 0)  # [1, N]
        s_base = torch.where(s_sum > 0, m4 / s_sum,
                             torch.zeros((), device=dev))
        # cached rows: the LM was last consulted when each beam's context
        # last changed (its latest extension)
        log_dist_c = torch.log(_fused_dist(
            m4, s_base, s_sum, lm_prev[:N_BASES], lm_prev[N_BASES], s_ent,
            length >= lm.ctx_len + 1, lm))  # [4, W, N]
        log_dist_e = torch.log(_fused_dist(
            m4, s_base, s_sum, lm_full[:N_BASES], lm_full[N_BASES], s_ent,
            length >= lm.ctx_len, lm))

    # COPY candidates (one per beam)
    sel_last = torch.where(last[None] == cvec, log_dist_c,
                           torch.zeros((), device=dev)).sum(0)
    pr_nb_c = torch.where(length > 0, pr_nb + sel_last, neg)
    pr_b_c = pr_t + blank_lp
    pr_t_c = logaddexp(pr_b_c, pr_nb_c)  # [W, N]

    # EXTEND candidates (four per beam)
    repeat = last[None] == cvec  # [4, W, N]
    pr_nb_e = torch.where(repeat, pr_b[None], pr_t[None]) + log_dist_e

    # merge detection EXTEND(b1, c) vs COPY(b2), axes [c, b1, b2, N]
    h1_ext = (_mul32(h1, H1_MULT)[None] + cvec + 1) & _MASK32  # [4, W, N]
    h2_ext = (_mul32(h2, H2_MULT)[None] + cvec + 1) & _MASK32
    match = (
        valid[None, :, None, :] & valid[None, None, :, :]
        & (length[None, None] == length[None, :, None] + 1)
        & (h1[None, None] == h1_ext[:, :, None])
        & (h2[None, None] == h2_ext[:, :, None])
    )  # [4, W, W, N]
    ext_has_match = match.any(2)  # [4, W, N]
    slot_ext = 5 * w_col[None] + 1 + cvec  # [4, W, 1]
    slot_copy_b2 = 5 * torch.arange(w, device=dev)[None, None, :, None]
    ext_wins = (match & (slot_ext[:, :, None] < slot_copy_b2)).any(2)

    contrib = torch.where(match & ~ext_wins[:, :, None], pr_nb_e[:, :, None],
                          neg)
    copy_extra = contrib.amax(dim=(0, 1))  # [W, N]
    copy_killed = (match & ext_wins[:, :, None]).any(1).any(0)  # [W, N]
    m_pr_nb_c = torch.where(copy_killed, neg, logaddexp(pr_nb_c, copy_extra))
    m_pr_b_c = torch.where(copy_killed, neg, pr_b_c)
    m_pr_t_c = torch.where(copy_killed, neg, logaddexp(pr_t_c, copy_extra))

    ext_killed = ext_has_match & ~ext_wins
    copy_nb_in = torch.where(match, pr_nb_c[None, None], neg).amax(2)
    copy_b_in = torch.where(match, pr_b_c[None, None], neg).amax(2)
    copy_t_in = torch.where(match, pr_t_c[None, None], neg).amax(2)
    absorb = ext_has_match & ext_wins
    m_pr_nb_e = torch.where(
        ext_killed, neg,
        torch.where(absorb, logaddexp(pr_nb_e, copy_nb_in), pr_nb_e))
    m_pr_b_e = torch.where(absorb, copy_b_in, neg)
    m_pr_t_e = torch.where(
        ext_killed, neg,
        torch.where(absorb, logaddexp(copy_t_in, pr_nb_e), pr_nb_e))

    # candidates [W, 5, N] flattened to [5W, N]: row = slot 5·beam + col
    def cands(copy, ext):
        return torch.cat([copy[:, None], ext.transpose(0, 1)], 1).reshape(
            5 * w, -1)

    cand_pr_b = cands(m_pr_b_c, m_pr_b_e)
    cand_pr_nb = cands(m_pr_nb_c, m_pr_nb_e)
    cand_pr_t = cands(m_pr_t_c, m_pr_t_e)

    slot = torch.arange(5 * w, device=dev)[:, None]  # [5W, 1]
    big = torch.tensor(2 ** 30, device=dev)
    scores = torch.clamp(cand_pr_t, min=SCORE_FLOOR)
    rows = {k: [] for k in ("pb", "pnb", "pt", "last", "len", "h1", "h2",
                            "bp", "ctxf", "ctxp", "lmf", "lmp", "ext")}
    for _ in range(w):
        m_all = scores.amax(0, keepdim=True)  # [1, N]
        # smallest slot achieving the max (top_k's earliest-index rule);
        # the clamp only guards the index against non-finite input
        s_star = torch.where(scores >= m_all, slot, big).amin(0)
        s_star = torch.clamp(s_star, max=5 * w - 1)[None]  # [1, N]
        parent = s_star // 5
        append = s_star - 5 * parent - 1  # -1 = copy
        is_ext = append >= 0
        p_h1 = h1.gather(0, parent)
        p_h2 = h2.gather(0, parent)
        rows["pb"].append(cand_pr_b.gather(0, s_star))
        rows["pnb"].append(cand_pr_nb.gather(0, s_star))
        rows["pt"].append(cand_pr_t.gather(0, s_star))
        rows["last"].append(torch.where(is_ext, append,
                                        last.gather(0, parent)))
        rows["len"].append(length.gather(0, parent) + is_ext.long())
        rows["h1"].append(torch.where(
            is_ext, (_mul32(p_h1, H1_MULT) + append + 1) & _MASK32, p_h1))
        rows["h2"].append(torch.where(
            is_ext, (_mul32(p_h2, H2_MULT) + append + 1) & _MASK32, p_h2))
        rows["bp"].append(parent * 8 + append + 1)
        if lm is not None:
            p_ctx_full = ctx_full.gather(0, parent)
            shifted = (p_ctx_full * N_BASES + append) % N_BASES ** lm.ctx_len
            rows["ctxf"].append(torch.where(is_ext, shifted, p_ctx_full))
            rows["ctxp"].append(torch.where(is_ext, p_ctx_full,
                                            ctx_prev.gather(0, parent)))
            par5 = parent[None].expand(N_BASES + 1, 1, -1)  # [5, 1, N]
            rows["lmf"].append(lm_full.gather(1, par5))
            rows["lmp"].append(lm_prev.gather(1, par5))
            rows["ext"].append(is_ext)
        scores = scores.scatter(0, s_star, KNOCKED)

    new = tuple(torch.cat(rows[k], 0) for k in
                ("pb", "pnb", "pt", "last", "len", "h1", "h2"))
    if lm is not None:
        # one row lookup per extended beam; copies inherit their parent's
        new_ctx_full = torch.cat(rows["ctxf"], 0)
        is_ext_all = torch.cat(rows["ext"], 0)  # [W, N]
        fresh = lm.rows(torch.where(is_ext_all, new_ctx_full,
                                    torch.zeros_like(new_ctx_full)))
        parent_full = torch.cat(rows["lmf"], 1)  # [5, W, N]
        new += (new_ctx_full, torch.cat(rows["ctxp"], 0),
                torch.where(is_ext_all[None], fresh, parent_full),
                torch.where(is_ext_all[None], parent_full,
                            torch.cat(rows["lmp"], 1)))
    out_state = tuple(torch.where(active, n_, o_) for n_, o_ in zip(new, state))
    bp = torch.where(active, torch.cat(rows["bp"], 0), w_col * 8)
    return out_state, bp.to(torch.int8)


def init_state(beam_width: int, n: int, device, lm: bool = False):
    slot0 = torch.arange(beam_width, device=device)[:, None] == 0
    neg = torch.full((beam_width, n), NEG, device=device)
    zero = torch.zeros((beam_width, n), dtype=torch.int64, device=device)
    ones = torch.ones((beam_width, n), dtype=torch.int64, device=device)
    pr0 = torch.where(slot0, torch.zeros((), device=device), neg)
    state = (pr0, neg, pr0.clone(), zero - 1, zero, ones, ones.clone())
    if lm:
        # contexts (full, previous) and their cached LM rows [5, W, N]
        rows = torch.zeros((N_BASES + 1, beam_width, n), device=device)
        state += (zero.clone(), zero.clone(), rows, rows.clone())
    return state


def beam_search_bp(logm_tn: torch.Tensor, lengths: torch.Tensor,
                   beam_width: int, lm: LMFusion | None = None,
                   probs_tn: torch.Tensor | None = None):
    """The forward pass on ``[T, 5, N]`` log-probs (and, with ``lm``, the
    ``[T, 5, N]`` probabilities they are the log of).

    Returns ``(bp [T, W, N] int8, n_labels [N] int32, best_logp [N] f32)``
    — the plain counterpart of the CUDA decode kernels.
    """
    t_len, _, n = logm_tn.shape
    dev = logm_tn.device
    state = init_state(beam_width, n, dev, lm is not None)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    s_ents = None if lm is None else signal_entropies(probs_tn, 1)
    bps = []
    for t in range(t_len):
        active = (t < lengths)[None, :]
        m5, s_ent = (None, None) if lm is None else (probs_tn[t], s_ents[t])
        state, bp = _step(state, logm_tn[t], active, beam_width, lm, m5, s_ent)
        bps.append(bp)
    bp = torch.stack(bps) if bps else torch.empty(
        (0, beam_width, n), dtype=torch.int8, device=dev)
    return bp, state[4][0].to(torch.int32), state[2][0]


def backtrace_batch(bp: torch.Tensor) -> torch.Tensor:
    """Walk the best beam backward through ``[T, W, N]`` backpointers.

    Returns ``[N, T]`` int32 labels in reversed (5'→3') emission order:
    column 0 = last emitted base; ``-1`` marks copy steps.
    """
    t_len, _, n = bp.shape
    beam = torch.zeros((1, n), dtype=torch.int64, device=bp.device)
    labels = torch.empty((t_len, n), dtype=torch.int32, device=bp.device)
    for t in range(t_len - 1, -1, -1):
        sel = bp[t].long().gather(0, beam)  # [1, N]
        labels[t_len - 1 - t] = (sel % 8 - 1)[0].to(torch.int32)
        beam = sel // 8
    return labels.T.contiguous()


def beam_search_batch(mats: torch.Tensor, lengths: torch.Tensor,
                      beam_width: int = 6, *, lm_probs=None, lm_ent=None,
                      lm_l1=None, lm_vals=None, s_threshold: float = 0.5,
                      r_threshold: float = 0.5, ctx_len: int = 11,
                      lm_enabled: bool = False):
    """Batched beam search over ``[N, T, 5]`` probability matrices, with
    the JAX ``beam_search_batch``'s arguments.

    With ``lm_enabled``, ``lm_probs/lm_ent`` are the dense LM tables, or
    ``lm_l1/lm_vals`` the packed ones (``KmerLM.compressed()``), which
    take precedence.  Returns ``(rev_labels [N, T] int32, n_labels [N]
    int32, best_logp [N] f32)``.
    """
    mats_tn = mats.float().permute(1, 2, 0)  # [T, 5, N]
    logm = torch.log(mats_tn)
    lm = None
    if lm_enabled:
        packed = lm_l1 is not None
        lm = LMFusion(lm_l1 if packed else lm_probs,
                      lm_vals if packed else lm_ent, packed, ctx_len,
                      0.0 if s_threshold is None else s_threshold,
                      0.0 if r_threshold is None else r_threshold)
    bp, n_lab, score = beam_search_bp(logm, lengths, beam_width, lm,
                                      mats_tn if lm_enabled else None)
    return backtrace_batch(bp), n_lab, score


def pack_labels(rev: torch.Tensor) -> torch.Tensor:
    """Nibble-pack labels in {-1, 0..3} along the (even) last axis."""
    if rev.shape[-1] % 2 != 0:
        raise ValueError(
            f"pack_labels needs an even last axis, got {tuple(rev.shape)}")
    v = (rev + 1).to(torch.uint8)
    return v[..., 0::2] | (v[..., 1::2] << 4)


def unpack_labels(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack_labels` → int8 labels."""
    packed = np.asarray(packed)
    out = np.empty((*packed.shape[:-1], packed.shape[-1] * 2), np.int8)
    out[..., 0::2] = (packed & 15).astype(np.int8) - 1
    out[..., 1::2] = (packed >> 4).astype(np.int8) - 1
    return out


def pack_labels2(comp: torch.Tensor) -> torch.Tensor:
    """2-bit-pack front-compacted labels along the last axis.

    ``comp`` holds labels in {0..3} up to each row's emission count and
    -1 after it; the count travels separately, so four labels share a
    byte.  The last axis must be a multiple of 4.
    """
    if comp.shape[-1] % 4 != 0:
        raise ValueError(f"pack_labels2 needs a multiple-of-4 last axis, "
                         f"got {tuple(comp.shape)}")
    v = torch.clamp(comp, min=0).to(torch.uint8)
    return (v[..., 0::4] | (v[..., 1::4] << 2) | (v[..., 2::4] << 4)
            | (v[..., 3::4] << 6))


def unpack_labels2(packed: np.ndarray, n_lab: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`pack_labels2` → int8 labels, -1 from each
    row's count ``n_lab`` (broadcast against ``packed.shape[:-1]``) on."""
    packed = np.asarray(packed)
    m = packed.shape[-1]
    out = np.empty((*packed.shape[:-1], m * 4), np.int8)
    for k in range(4):
        out[..., k::4] = ((packed >> (2 * k)) & 3).astype(np.int8)
    out[np.arange(m * 4) >= np.asarray(n_lab)[..., None]] = -1
    return out


def rows_to_seqs(rev_rows: np.ndarray, reverse: bool = True,
                 bases: str = "ACGT") -> list[str]:
    """Vectorised :func:`labels_to_seq` over a ``[n, T]`` label block."""
    arr = np.asarray(rev_rows)
    if reverse:
        arr = arr[:, ::-1]
    mask = arr >= 0
    counts = mask.sum(1)
    lut = np.frombuffer(bases.encode(), np.uint8)
    blob = lut[arr[mask]].tobytes()  # row-major: rows stay contiguous
    offs = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    return [blob[offs[k]:offs[k + 1]].decode() for k in range(len(counts))]


def labels_to_seq(rev_labels: np.ndarray, reverse: bool = False,
                  bases: str = "ACGT") -> str:
    """Render a backtraced label row into a base string.

    ``reverse=False`` keeps the emitted (5'→3') orientation the fasta
    output wants; ``reverse=True`` gives decoder order.
    """
    arr = np.asarray(rev_labels)
    labs = arr[arr >= 0]
    if reverse:
        labs = labs[::-1]
    lut = np.frombuffer(bases.encode(), np.uint8)
    return lut[labs].tobytes().decode()
