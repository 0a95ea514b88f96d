"""CTC prefix beam search without LM fusion, in plain PyTorch.

Counterpart of ``radian_tpu/ops/beam_search.py::beam_search_batch`` with
``lm_enabled=False``; it is the reference the CUDA kernel
(``ops/beam_cuda.py``) is tested against and the kernel wrapper's path
for tensors on the CPU.  Semantics, step by step as in ``_step``:

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

State is batch-minor, ``[W, N]``.  Hashes are carried in int64 and kept
to 32 bits by hand (torch has no complete uint32 arithmetic), and
``logaddexp`` is written out as JAX's formula, NaN branch included.
"""

from __future__ import annotations

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


def _step(state, lp, active, beam_width: int):
    """One decode step. ``lp`` [5, N] log-probs, ``active`` [1, N] bool."""
    pr_b, pr_nb, pr_t, last, length, h1, h2 = state
    w = beam_width
    dev = lp.device
    neg = torch.tensor(NEG, device=dev)
    valid = pr_t > NEG_HALF  # [W, N]
    log_m4 = lp[:N_BASES]  # [4, N]
    blank_lp = lp[BLANK:BLANK + 1]  # [1, N]
    cvec = torch.arange(N_BASES, device=dev)[:, None, None]  # [4, 1, 1]
    w_col = torch.arange(w, device=dev)[:, None]  # [W, 1]

    # COPY candidates (one per beam)
    sel_last = torch.where(last[None] == cvec, log_m4[:, None, :],
                           torch.zeros((), device=dev)).sum(0)
    pr_nb_c = torch.where(length > 0, pr_nb + sel_last, neg)
    pr_b_c = pr_t + blank_lp
    pr_t_c = logaddexp(pr_b_c, pr_nb_c)  # [W, N]

    # EXTEND candidates (four per beam)
    repeat = last[None] == cvec  # [4, W, N]
    pr_nb_e = torch.where(repeat, pr_b[None], pr_t[None]) + log_m4[:, None, :]

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
                            "bp")}
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
        scores = scores.scatter(0, s_star, KNOCKED)

    new = tuple(torch.cat(rows[k], 0) for k in
                ("pb", "pnb", "pt", "last", "len", "h1", "h2"))
    out_state = tuple(torch.where(active, n_, o_) for n_, o_ in zip(new, state))
    bp = torch.where(active, torch.cat(rows["bp"], 0), w_col * 8)
    return out_state, bp.to(torch.int8)


def init_state(beam_width: int, n: int, device):
    slot0 = torch.arange(beam_width, device=device)[:, None] == 0
    neg = torch.full((beam_width, n), NEG, device=device)
    zero = torch.zeros((beam_width, n), dtype=torch.int64, device=device)
    ones = torch.ones((beam_width, n), dtype=torch.int64, device=device)
    pr0 = torch.where(slot0, torch.zeros((), device=device), neg)
    return (pr0, neg, pr0.clone(), zero - 1, zero, ones, ones.clone())


def beam_search_bp(logm_tn: torch.Tensor, lengths: torch.Tensor,
                   beam_width: int):
    """The forward pass on ``[T, 5, N]`` log-probs.

    Returns ``(bp [T, W, N] int8, n_labels [N] int32, best_logp [N] f32)``
    — the plain counterpart of the CUDA decode kernel.
    """
    t_len, _, n = logm_tn.shape
    dev = logm_tn.device
    state = init_state(beam_width, n, dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    bps = []
    for t in range(t_len):
        active = (t < lengths)[None, :]
        state, bp = _step(state, logm_tn[t], active, beam_width)
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
                      beam_width: int = 6):
    """Batched no-LM beam search over ``[N, T, 5]`` probability matrices.

    Returns ``(rev_labels [N, T] int32, n_labels [N] int32,
    best_logp [N] f32)`` like the JAX ``beam_search_batch``.
    """
    logm = torch.log(mats.float().permute(1, 2, 0))  # [T, 5, N]
    bp, n_lab, score = beam_search_bp(logm, lengths, beam_width)
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
