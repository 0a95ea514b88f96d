"""The plain reference the benchmark holds the program to.

Plain PyTorch and numpy, written from radian's published description
(``radian/models/sig2seq.yaml``, ``basecall.py``, ``decode.py``,
``matrix_assembly.py``, ``sequence_assembly.py``) and frozen here: the
sig2seq TCN forward, overlapped windows and the "first" assembly, the
CTC prefix beam search with the gated k-mer LM (a copy of the port's
plain decoder, which is bit-exact with its kernels, restated so that a
block of steps can be captured in a CUDA graph), the chunk consensus
(difflib's longest block and a vote matrix), and the CTC loss with
optax's Adam.  It imports nothing of the program.

``rounding`` names a precision to compute the products in ('tf32',
'fp8', 'bf16'; None: float32 with TF32 off): each convolution's and
dense layer's operands are rounded to it and the product summed in
float32, as the tensor cores do.  That is the control's precision.
"""

from __future__ import annotations

import difflib

import numpy as np
import torch
import torch.nn.functional as F

BASES = "ACGT"
N_BASES = 4
BLANK = 4
NEG = -1.0e30
NEG_HALF = -1.0e29
SCORE_FLOOR = -1.0e38
KNOCKED = -3.0e38
H1_MULT = 2654435761
H2_MULT = 2246822519
MASK32 = 0xFFFFFFFF


# -- precisions ---------------------------------------------------------

def round_to(x: torch.Tensor, rounding: str | None) -> torch.Tensor:
    """``x`` (float32) rounded to ``rounding``'s precision, kept float32."""
    if rounding is None:
        return x
    if rounding == "bf16":
        return x.to(torch.bfloat16).float()
    if rounding == "tf32":
        # 10 mantissa bits, round to nearest (ties away), as tf32 inputs
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if rounding == "fp8":
        # e4m3 with one scale a tensor, the usual fp8 recipe
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown rounding {rounding!r}")


class _RoundedConv(torch.autograd.Function):
    """conv1d whose three products (forward, data and filter gradients)
    take rounded operands, as TF32 or fp8 tensor cores would."""

    @staticmethod
    def forward(ctx, x, w, dilation, rounding):
        xr, wr = round_to(x, rounding), round_to(w, rounding)
        ctx.save_for_backward(xr, wr)
        ctx.dilation, ctx.rounding = dilation, rounding
        return F.conv1d(xr, wr, dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_to(g.contiguous(), ctx.rounding)
        gx = torch.nn.grad.conv1d_input(xr.shape, wr, gr,
                                        dilation=ctx.dilation)
        gw = torch.nn.grad.conv1d_weight(xr, wr.shape, gr,
                                         dilation=ctx.dilation)
        return gx, gw, None, None


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, rounding):
        xr, wr = round_to(x, rounding), round_to(w, rounding)
        ctx.save_for_backward(xr, wr)
        ctx.rounding = rounding
        return xr @ wr.T

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_to(g.contiguous(), ctx.rounding)
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gr @ wr, gw, None


def conv(x, w, b, dilation, rounding=None):
    """Causal dilated conv1d ``[N, C_in, T] → [N, C_out, T]`` in float32."""
    x = F.pad(x, ((w.shape[-1] - 1) * dilation, 0))
    if rounding is None:
        y = F.conv1d(x, w, dilation=dilation)
    else:
        y = _RoundedConv.apply(x, w, dilation, rounding)
    return y + b[:, None]


def linear(x, w, b, rounding=None):
    y = x @ w.T if rounding is None else _RoundedLinear.apply(x, w, rounding)
    return y + b


# -- the model ------------------------------------------------------------

def torch_params(flax: dict[str, np.ndarray], model: dict, device,
                 requires_grad: bool = False) -> dict[str, torch.Tensor]:
    """Flax-layout arrays → ``{name: tensor}`` in conv layout: kernels
    ``[k, C_in, C_out]`` → ``[C_out, C_in, k]``, dense ``[in, out]`` →
    ``[out, in]``; names kept."""
    out = {}
    for name, arr in flax.items():
        a = np.asarray(arr, np.float32)
        if name.endswith("kernel"):
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
        t = torch.tensor(np.ascontiguousarray(a), device=device)
        out[name] = t.requires_grad_(requires_grad)
    return out


def forward(p: dict[str, torch.Tensor], model: dict, x: torch.Tensor,
            rounding: str | None = None, log: bool = False) -> torch.Tensor:
    """``[N, T]`` normalised signal → ``[N, T, 5]`` float32
    probabilities (or log-probabilities): the TCN's residual blocks of
    two causal dilated convolutions with ReLU, a 1×1 shortcut where the
    channels change, then Dense(relu_units) + ReLU and Dense(5)."""
    tcn = model["tcn"]
    h = x[:, None, :].float()
    c = 1
    for b, d in enumerate(list(tcn["dilations"]) * tcn["nb_stacks"]):
        pre = f"tcn/block{b}"
        y = F.relu(conv(h, p[f"{pre}/conv0/Conv_0/kernel"],
                        p[f"{pre}/conv0/Conv_0/bias"], d, rounding))
        y = F.relu(conv(y, p[f"{pre}/conv1/Conv_0/kernel"],
                        p[f"{pre}/conv1/Conv_0/bias"], d, rounding))
        res = (conv(h, p[f"{pre}/shortcut/kernel"], p[f"{pre}/shortcut/bias"],
                    1, rounding) if c != tcn["nb_filters"] else h)
        h = F.relu(res + y)
        c = tcn["nb_filters"]
    h = h.transpose(1, 2)
    h = F.relu(linear(h, p["dense_relu/kernel"], p["dense_relu/bias"],
                      rounding))
    logits = linear(h, p["dense_out/kernel"], p["dense_out/bias"], rounding)
    return (torch.log_softmax if log else torch.softmax)(logits, dim=-1)


def receptive_field(model: dict) -> int:
    tcn = model["tcn"]
    return 1 + 2 * (tcn["kernel_size"] - 1) * tcn["nb_stacks"] * sum(
        tcn["dilations"])


def mad_normalise(sig: np.ndarray, clip: float) -> np.ndarray:
    """Modified z-score of one raw read, float64 (radian preprocess.py)."""
    x = np.asarray(sig, np.float64)
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    return np.clip((x - med) / (1.4826 * mad), -clip, clip)


def windows(norm: np.ndarray, window: int, step: int):
    """Overlapped windows of one read (radian preprocess.py): full
    windows every ``step``, then one zero-padded tail window at the next
    step offset.  Returns ``(windows [n, window] f32, pad_end)``."""
    length = len(norm)
    n_full = max((length - window) // step + 1, 0)
    tail = norm[n_full * step:]
    out = np.zeros((n_full + 1, window), np.float32)
    for i in range(n_full):
        out[i] = norm[i * step:i * step + window]
    out[n_full, :len(tail)] = tail
    return out, window - len(tail)


def window_probs(p, model, norm: np.ndarray, opts: dict, device,
                 rounding=None, rows_at_once: int = 4096) -> np.ndarray:
    """Every window of one read through the model on its own:
    ``[n_windows, window, 5]`` float32 on the host."""
    wins, _ = windows(norm, opts["chunk_len"], opts["step_size"])
    out = []
    with torch.no_grad():
        for i in range(0, len(wins), rows_at_once):
            x = torch.from_numpy(wins[i:i + rows_at_once]).to(device)
            out.append(forward(p, model, x, rounding).cpu().numpy())
    return np.concatenate(out)


def first_assembly(probs: np.ndarray, length: int, window: int,
                   step: int) -> np.ndarray:
    """radian's "first" assembly of one read's window outputs: each
    step ``t`` from the first window covering it, the rows covered by
    more than one window L1-renormalised, cut to the read's length →
    ``[length, 5]``."""
    n = len(probs)
    t = np.arange(length)
    first = np.minimum(np.maximum((t - window) // step + 1, 0), n - 1)
    last = np.minimum(t // step, n - 1)
    mats = probs[first, t - first * step].astype(np.float32)
    s = mats.sum(-1, keepdims=True)
    renorm = ((last - first + 1) > 1)[:, None] & (s > 0)
    return np.where(renorm, mats / np.where(s > 0, s, 1), mats)


# -- CTC prefix beam search (LM-gated) -------------------------------------

class Lm:
    """The LM side of the decode: ``rows [4, 5]`` (4 next-base
    probabilities and the entropy after each last base: a first-order
    chain's whole k-mer LM), context length and the two gates."""

    def __init__(self, rows: torch.Tensor, ctx_len: int, s_threshold: float,
                 r_threshold: float):
        self.rows4 = rows
        self.ctx_len = ctx_len
        self.s_threshold = s_threshold
        self.r_threshold = r_threshold

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """``[5, W, N]`` rows of the contexts ``idx [W, N]``."""
        return self.rows4[idx % N_BASES].permute(2, 0, 1)


def _mul32(h, mult: int):
    lo = (h & 0xFFFF) * mult
    hi = ((h >> 16) * mult) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _logaddexp(a, b):
    d = a - b
    return torch.where(torch.isnan(d), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-d.abs())))


def _sum4(x, dim: int):
    a, b, c, d = x.unbind(dim)
    return (((a + b) + c) + d).unsqueeze(dim)


def signal_entropies(mat: torch.Tensor, dim: int) -> torch.Tensor:
    """Entropy of the renormalised non-blank distribution of each step
    (radian decode.py), the class axis kept with size 1."""
    base = mat.narrow(dim, 0, N_BASES)
    s = _sum4(base, dim)
    p = torch.where(s > 0, base / s, base)
    terms = torch.where(p > 0, p * torch.log(p), torch.zeros_like(p))
    return -_sum4(terms, dim)


class _Consts:
    def __init__(self, w: int, dev):
        self.neg = torch.tensor(NEG, device=dev)
        self.zero = torch.zeros((), device=dev)
        self.cvec = torch.arange(N_BASES, device=dev)[:, None, None]
        self.w_col = torch.arange(w, device=dev)[:, None]
        self.slot_ext = 5 * self.w_col[None] + 1 + self.cvec
        self.slot_copy = 5 * torch.arange(w, device=dev)[None, None, :, None]


def _fused(m4, s_base, s_sum, r_dist, r_ent, s_ent, len_ok, lm):
    fused = (r_dist + s_base[:, None, :]) * 0.5 * s_sum[:, None, :]
    gate = len_ok & (r_ent < lm.r_threshold) & (s_ent > lm.s_threshold)
    return torch.where(gate[None], fused, m4[:, None, :])


def _step(state, lp, active, w: int, k: _Consts, lm=None, m5=None,
          s_ent=None):
    """One decode step (radian decode.py's prefix beam search, the
    port's plain ``_step``): ``lp [5, N]`` log-probs, ``active [1, N]``."""
    pr_b, pr_nb, pr_t, last, length, h1, h2 = state[:7]
    valid = pr_t > NEG_HALF
    log_m4 = lp[:N_BASES]
    blank_lp = lp[BLANK:BLANK + 1]
    if lm is None:
        log_dist_c = log_dist_e = log_m4[:, None, :]
    else:
        ctx_full, ctx_prev, lm_full, lm_prev = state[7:]
        m4 = m5[:N_BASES]
        s_sum = _sum4(m4, 0)
        s_base = torch.where(s_sum > 0, m4 / s_sum, k.zero)
        log_dist_c = torch.log(_fused(m4, s_base, s_sum, lm_prev[:N_BASES],
                                      lm_prev[N_BASES], s_ent,
                                      length >= lm.ctx_len + 1, lm))
        log_dist_e = torch.log(_fused(m4, s_base, s_sum, lm_full[:N_BASES],
                                      lm_full[N_BASES], s_ent,
                                      length >= lm.ctx_len, lm))
    cvec = k.cvec
    sel_last = torch.where(last[None] == cvec, log_dist_c, k.zero).sum(0)
    pr_nb_c = torch.where(length > 0, pr_nb + sel_last, k.neg)
    pr_b_c = pr_t + blank_lp
    pr_t_c = _logaddexp(pr_b_c, pr_nb_c)
    repeat = last[None] == cvec
    pr_nb_e = torch.where(repeat, pr_b[None], pr_t[None]) + log_dist_e
    h1_ext = (_mul32(h1, H1_MULT)[None] + cvec + 1) & MASK32
    h2_ext = (_mul32(h2, H2_MULT)[None] + cvec + 1) & MASK32
    match = (valid[None, :, None, :] & valid[None, None, :, :]
             & (length[None, None] == length[None, :, None] + 1)
             & (h1[None, None] == h1_ext[:, :, None])
             & (h2[None, None] == h2_ext[:, :, None]))
    ext_has_match = match.any(2)
    ext_wins = (match & (k.slot_ext[:, :, None] < k.slot_copy)).any(2)
    contrib = torch.where(match & ~ext_wins[:, :, None], pr_nb_e[:, :, None],
                          k.neg)
    copy_extra = contrib.amax(dim=(0, 1))
    copy_killed = (match & ext_wins[:, :, None]).any(1).any(0)
    m_pr_nb_c = torch.where(copy_killed, k.neg,
                            _logaddexp(pr_nb_c, copy_extra))
    m_pr_b_c = torch.where(copy_killed, k.neg, pr_b_c)
    m_pr_t_c = torch.where(copy_killed, k.neg, _logaddexp(pr_t_c, copy_extra))
    ext_killed = ext_has_match & ~ext_wins
    copy_nb_in = torch.where(match, pr_nb_c[None, None], k.neg).amax(2)
    copy_b_in = torch.where(match, pr_b_c[None, None], k.neg).amax(2)
    copy_t_in = torch.where(match, pr_t_c[None, None], k.neg).amax(2)
    absorb = ext_has_match & ext_wins
    m_pr_nb_e = torch.where(ext_killed, k.neg, torch.where(
        absorb, _logaddexp(pr_nb_e, copy_nb_in), pr_nb_e))
    m_pr_b_e = torch.where(absorb, copy_b_in, k.neg)
    m_pr_t_e = torch.where(ext_killed, k.neg, torch.where(
        absorb, _logaddexp(copy_t_in, pr_nb_e), pr_nb_e))

    def cands(copy, ext):
        return torch.cat([copy[:, None], ext.transpose(0, 1)], 1).reshape(
            5 * w, -1)

    cand_pr_b = cands(m_pr_b_c, m_pr_b_e)
    cand_pr_nb = cands(m_pr_nb_c, m_pr_nb_e)
    cand_pr_t = cands(m_pr_t_c, m_pr_t_e)
    scores = torch.clamp(cand_pr_t, min=SCORE_FLOOR)
    # the W best candidates at once: highest score first, the smallest
    # slot first among equal scores (a stable sort; scores are floored,
    # never NaN), as the iterative pick-and-knock-out selection gives
    s_star = torch.sort(scores, dim=0, descending=True,
                        stable=True).indices[:w]  # [W, N]
    parent = s_star // 5
    append = s_star - 5 * parent - 1
    is_ext = append >= 0
    p_h1 = h1.gather(0, parent)
    p_h2 = h2.gather(0, parent)
    new = (cand_pr_b.gather(0, s_star), cand_pr_nb.gather(0, s_star),
           cand_pr_t.gather(0, s_star),
           torch.where(is_ext, append, last.gather(0, parent)),
           length.gather(0, parent) + is_ext.long(),
           torch.where(is_ext, (_mul32(p_h1, H1_MULT) + append + 1) & MASK32,
                       p_h1),
           torch.where(is_ext, (_mul32(p_h2, H2_MULT) + append + 1) & MASK32,
                       p_h2))
    if lm is not None:
        p_ctx_full = ctx_full.gather(0, parent)
        shifted = (p_ctx_full * N_BASES + append) % N_BASES ** lm.ctx_len
        new_ctx_full = torch.where(is_ext, shifted, p_ctx_full)
        par5 = parent[None].expand(N_BASES + 1, -1, -1)
        parent_full = lm_full.gather(1, par5)
        fresh = lm.rows(torch.where(is_ext, new_ctx_full,
                                    torch.zeros_like(new_ctx_full)))
        new += (new_ctx_full,
                torch.where(is_ext, p_ctx_full, ctx_prev.gather(0, parent)),
                torch.where(is_ext[None], fresh, parent_full),
                torch.where(is_ext[None], parent_full,
                            lm_prev.gather(1, par5)))
    out = tuple(torch.where(active, n_, o_) for n_, o_ in zip(new, state))
    bp = torch.where(active, parent * 8 + append + 1, k.w_col * 8)
    return out, bp.to(torch.int8)


def _init_state(w: int, n: int, dev, lm: bool):
    slot0 = torch.arange(w, device=dev)[:, None] == 0
    neg = torch.full((w, n), NEG, device=dev)
    zero = torch.zeros((w, n), dtype=torch.int64, device=dev)
    ones = torch.ones((w, n), dtype=torch.int64, device=dev)
    pr0 = torch.where(slot0, torch.zeros((), device=dev), neg)
    state = (pr0, neg, pr0.clone(), zero - 1, zero, ones, ones.clone())
    if lm:
        rows = torch.zeros((N_BASES + 1, w, n), device=dev)
        state += (zero.clone(), zero.clone(), rows, rows.clone())
    return state


def _run_block(state, lp, act, m5, s_ent, w, k, lm):
    """``len(lp)`` steps from ``state`` → ``(state, bp [K, W, N])``."""
    bps = []
    for i in range(lp.shape[0]):
        state, bp = _step(state, lp[i], act[i], w, k, lm,
                          None if lm is None else m5[i],
                          None if lm is None else s_ent[i])
        bps.append(bp)
    return state, torch.stack(bps)


def beam_search(mats: list[np.ndarray], beam: int, device,
                lm: Lm | None = None, graph_block: int = 64) -> list[str]:
    """Each read's ``[T_i, 5]`` probabilities decoded by CTC prefix beam
    search → its string, last emitted base first (radian's 5'→3').
    On a CUDA device the steps run ``graph_block`` at a time as one
    replayed CUDA graph (the same kernels as step by step)."""
    n = len(mats)
    t_max = max(len(m) for m in mats)
    pad = np.zeros((n, t_max, 5), np.float32)
    for j, m in enumerate(mats):
        pad[j, :len(m)] = m
    dev = torch.device(device)
    probs_tn = torch.from_numpy(pad).to(dev).permute(1, 2, 0).contiguous()
    logm = torch.log(probs_tn)
    lengths = torch.tensor([len(m) for m in mats], device=dev)
    active = (torch.arange(t_max, device=dev)[:, None] < lengths[None, :]
              )[:, None, :]
    s_ents = None if lm is None else signal_entropies(probs_tn, 1)
    k = _Consts(beam, dev)
    state = _init_state(beam, n, dev, lm is not None)
    if dev.type != "cuda" or graph_block < 2:
        _, bps = _run_block(state, logm, active, probs_tn, s_ents, beam, k,
                            lm)
    else:
        blk = graph_block
        # static buffers for one block; the tail block is zero-padded and
        # inactive, so it leaves the state alone
        pad_t = -t_max % blk
        logm = F.pad(logm, (0, 0, 0, 0, 0, pad_t))
        probs_tn = F.pad(probs_tn, (0, 0, 0, 0, 0, pad_t))
        active = torch.cat([active,
                            active.new_zeros((pad_t, *active.shape[1:]))])
        if s_ents is not None:
            s_ents = F.pad(s_ents, (0, 0, 0, 0, 0, pad_t))
        bps = torch.empty((t_max + pad_t, beam, n), dtype=torch.int8,
                          device=dev)
        st = state  # the static state buffers
        s_lp, s_act = logm[:blk].clone(), active[:blk].clone()
        s_m5 = None if lm is None else probs_tn[:blk].clone()
        s_se = None if lm is None else s_ents[:blk].clone()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up before capture
            _run_block(st, s_lp, s_act, s_m5, s_se, beam, k, lm)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out_state, out_bp = _run_block(st, s_lp, s_act, s_m5, s_se, beam,
                                           k, lm)
            for a, b in zip(st, out_state):
                a.copy_(b)
        for t0 in range(0, t_max + pad_t, blk):
            s_lp.copy_(logm[t0:t0 + blk])
            s_act.copy_(active[t0:t0 + blk])
            if lm is not None:
                s_m5.copy_(probs_tn[t0:t0 + blk])
                s_se.copy_(s_ents[t0:t0 + blk])
            graph.replay()
            bps[t0:t0 + blk] = out_bp
        bps = bps[:t_max]
        del graph
    return [_render(r) for r in backtrace(bps.cpu().numpy())]


def backtrace(bp: np.ndarray) -> np.ndarray:
    """Walk beam 0 back through ``[T, W, N]`` backpointers → ``[N, T]``
    labels, last emission first, -1 on copy steps."""
    t_len, _, n = bp.shape
    beam = np.zeros(n, np.int64)
    out = np.empty((n, t_len), np.int8)
    cols = np.arange(n)
    for t in range(t_len - 1, -1, -1):
        sel = bp[t, beam, cols].astype(np.int64)
        out[:, t_len - 1 - t] = sel % 8 - 1
        beam = sel // 8
    return out


def _render(rev: np.ndarray) -> str:
    lut = np.frombuffer(BASES.encode(), np.uint8)
    return lut[rev[rev >= 0]].tobytes().decode()


# -- chunk mode -----------------------------------------------------------

def consensus(fragments: list[str]) -> str:
    """radian's chunk consensus (sequence_assembly.py): each fragment
    aligned to its predecessor by difflib's longest matching block, its
    bases voted into a 4×L matrix at the running displacement, each
    column's argmax (ties A<C<G<T).  The first fragment votes but never
    counts toward the length (radian's quirk)."""
    if not fragments:
        return ""
    counts = np.zeros((4, 1000))
    pos = length = 0
    idx = {b: i for i, b in enumerate(BASES)}

    def vote(start, frag):
        nonlocal counts
        if start < 0:
            frag, start = frag[-start:], 0
        while start + len(frag) > counts.shape[1]:
            counts = np.pad(counts, ((0, 0), (0, 1000)))
        for i, base in enumerate(frag):
            counts[idx[base], start + i] += 1

    for i, frag in enumerate(fragments):
        if i == 0:
            vote(0, frag)
            continue
        sm = difflib.SequenceMatcher(None, fragments[i - 1], frag)
        blk = max(sm.get_matching_blocks(), key=lambda m: m.size)
        pos += blk.a - blk.b
        vote(pos, frag)
        length = max(length, pos + len(frag))
    return "".join(BASES[i] for i in np.argmax(counts[:, :length], axis=0))


def chunk_strings(win_probs: list[np.ndarray], pad_ends: list[int],
                  beam: int, device) -> list[str]:
    """radian's chunk mode from each read's window outputs: every window
    decoded alone over its length (the tail window without its padding),
    the fragments (emission order) stitched, the consensus reversed."""
    mats, owner = [], []
    for j, (wp, pad_end) in enumerate(zip(win_probs, pad_ends)):
        for i in range(len(wp)):
            mats.append(wp[i, :len(wp[i]) - (pad_end if i == len(wp) - 1
                                              else 0)])
            owner.append(j)
    frags: list[list[str]] = [[] for _ in win_probs]
    for s, j in zip(beam_search(mats, beam, device), owner):
        frags[j].append(s[::-1])
    return [consensus(f)[::-1] for f in frags]


# -- training: CTC loss and optax's Adam ----------------------------------

def ctc_mean_loss(p, model, batch: dict, rounding=None) -> torch.Tensor:
    """The mean CTC loss (blank 4) over the batch's rows."""
    lp = forward(p, model, batch["signal"], rounding, log=True)
    losses = F.ctc_loss(lp.transpose(0, 1), batch["labels"].long(),
                        batch["input_length"].long(),
                        batch["label_length"].long(), blank=BLANK,
                        reduction="none", zero_infinity=True)
    return losses.mean()


def adam_steps(p: dict[str, torch.Tensor], model: dict, batches: list[dict],
               lr: float, b1: float, b2: float, eps: float, rounding=None):
    """``len(batches)`` Adam steps (optax: ``m̂ / (sqrt(v̂) + eps)``) from
    ``p`` in place.  Returns ``(losses, first gradients {name: tensor})``."""
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, start=1):
        loss = ctc_mean_loss(p, model, batch, rounding)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                m_hat = mu[k] / (1 - b1 ** t)
                v_hat = nu[k] / (1 - b2 ** t)
                v -= lr * m_hat / (v_hat.sqrt() + eps)
    return losses, first
