"""Bonito's CTC-CRF sequence loss (``bonito/crf/model.py``'s
``CTC_CRF.ctc_loss`` with ``normalise_scores=True``), the training loss
of the port's CRF models, with its gradient (``csrc/crf_loss.cu``).

Scores ``[N, T, 4^L·5]`` (``L = state_len``) in the layout of
``ops/crf_viterbi.py``: for state ``s`` at step ``t`` column 0 is the
stay, column ``1+r`` the move from ``prev_r(s) = r·4^(L−1) + s // 4``,
which emits base ``s % 4``.  Cast to float32 first, as Bonito does.

- Full lattice: ``α_0[s] = 0``, ``α_{t+1}[s] = logsumexp(α_t[s] +
  sc[t,s,0], α_t[prev_r(s)] + sc[t,s,1+r] for r in 0..3)``, ``logZ =
  logsumexp_s α_T[s]``.
- Target lattice of bases ``b_0..b_{n−1}``: position ``j`` (``0..n−L``)
  is the k-mer ``k_j = Σ_i b_{j+i}·4^(L−1−i)``; ``β_0[0] = 0`` and −∞
  elsewhere, ``β_{t+1}[j] = logaddexp(β_t[j] + sc[t,k_j,0], β_t[j−1] +
  sc[t,k_j,1+b_{j−1}])``, ``logZ_target = β_T[n−L]``.
- ``loss_n = (logZ_n − logZ_target_n) / n``: Bonito's ``normalise``
  takes ``logZ/T`` off every step's scores, and every path has T steps.
- Gradient: ``(P_full − P_target) / n`` a row, P each lattice's edge
  posteriors from its forward and backward variables.

Both lattices keep their variables normalised: step ``t+1``'s values
have the largest of step ``t``'s taken off, a lag of one step, so that
the kernel finds that largest value among the warps' partial maxima of
the step before without a further barrier; the offsets add up in
float64 and return in ``logZ``, and each edge posterior is
``exp(α̂_t + sc + β̂_{t+1} − (logZ − C_t − D_{t+1}))``, ``C`` and ``D``
the forward's and the backward's offsets.  The normalised α of every
step, both lattices, are kept for the backward pass in float32.

On the card one launch a pass, forward and backward, over both
lattices: one block a row walking T inside the kernel (``launches.
crf_loss``).  On the CPU (and for any other device) :func:`loss_plain`
and :func:`grad_plain` do the same arithmetic in torch operations, the
backward written out, not autograd through the loop; neither path falls
back to the other.

The targets' lengths are read on the host, for the refusals and the
counters (``target_bases``, ``crf_loss_state_steps``): pass them as a
CPU tensor, or the read waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from radian_tpu_torch import _build
from radian_tpu_torch.utils import profiling

MIN_STATE_LEN, MAX_STATE_LEN = 2, 5  # the kernel's: 16 to 1,024 states
MAX_POSITIONS = 2048  # the kernel's target positions a row (n − L + 1)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = float("-inf")


def _geometry(scores: torch.Tensor, targets: torch.Tensor, lengths,
              state_len: int) -> np.ndarray:
    """The host lengths, int64, after the refusals."""
    s_n = 4 ** state_len
    if scores.dim() != 3 or scores.shape[2] != 5 * s_n:
        raise ValueError(f"scores must be [N, T, {5 * s_n}] for state_len "
                         f"{state_len}, got {tuple(scores.shape)}")
    n, t_len, _ = scores.shape
    lengths = torch.as_tensor(lengths).detach().cpu().numpy().astype(np.int64)
    if targets.dim() != 2 or targets.shape[0] != n or lengths.shape != (n,):
        raise ValueError(f"targets must be [{n}, n_max] and their lengths "
                         f"[{n}], got {tuple(targets.shape)} and "
                         f"{lengths.shape}")
    if n and lengths.min() < state_len:
        raise ValueError(f"a target of {int(lengths.min())} bases: a CRF of "
                         f"state_len {state_len} needs at least {state_len}")
    if n and lengths.max() > targets.shape[1]:
        raise ValueError(f"a target length of {int(lengths.max())} over "
                         f"the targets' {targets.shape[1]} columns")
    if n and (lengths - state_len).max() > t_len:
        raise ValueError(f"a target of {int(lengths.max())} bases needs "
                         f"more than the scores' {t_len} steps")
    return lengths


def _positions(targets: torch.Tensor, lengths: np.ndarray, state_len: int):
    """``(k [N, P] int64, col [N, P] int64, valid [N, P] bool)``: each
    target position's k-mer, the column of the move into it (0 at
    position 0, which has none) and whether it lies inside its row's
    target, ``P = n_max − L + 1``."""
    b = targets.long().clamp(0, 3)
    p = b.shape[1] - state_len + 1
    k = sum(b[:, i:i + p] * 4 ** (state_len - 1 - i)
            for i in range(state_len))
    col = torch.zeros_like(k)
    col[:, 1:] = 1 + b[:, :p - 1]
    real = torch.as_tensor(lengths - state_len + 1, device=b.device)
    valid = torch.arange(p, device=b.device)[None] < real[:, None]
    return k, col, valid


def _lse(*xs: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(torch.stack(xs, -1), -1)


def loss_plain(scores: torch.Tensor, targets: torch.Tensor, lengths,
               state_len: int):
    """The forward pass in torch operations: ``(loss [N] float32,
    saved)``, ``saved`` what :func:`grad_plain` takes."""
    lengths = _geometry(scores, targets, lengths, state_len)
    n, t_len, _ = scores.shape
    s_n = 4 ** state_len
    dev = scores.device
    sc = scores.float().reshape(n, t_len, s_n, 5)
    states = torch.arange(s_n, device=dev)
    prev = [r * (s_n // 4) + states // 4 for r in range(4)]
    k, col, valid = _positions(targets, lengths, state_len)
    rows = torch.arange(n, device=dev)[:, None]
    neg = torch.full(k.shape, _NEG, device=dev)

    a = torch.zeros(n, s_n, device=dev)
    at = torch.where(torch.arange(k.shape[1], device=dev)[None] == 0,
                     0.0, neg)
    c = torch.zeros(n, dtype=torch.float64, device=dev)
    ct = torch.zeros_like(c)
    alphas, alphas_t, cs, cts = [], [], [], []
    for t in range(t_len):
        alphas.append(a)
        alphas_t.append(at)
        cs.append(c)
        cts.append(ct)
        m = a.amax(1, keepdim=True)
        mt = at.amax(1, keepdim=True)
        x = sc[:, t]
        a = _lse(a + x[..., 0], *(a[:, prev[r]] + x[..., 1 + r]
                                  for r in range(4))) - m
        stay = at + x[rows, k, 0]
        move = torch.cat([neg[:, :1], at[:, :-1]], 1) + x[rows, k, col]
        at = torch.where(valid, _lse(stay, move) - mt, neg)
        c = c + m[:, 0].double()
        ct = ct + mt[:, 0].double()
    lens = torch.as_tensor(lengths, device=dev)
    logz = c + torch.logsumexp(a, 1).double()
    logz_t = ct + at.gather(1, (lens - state_len)[:, None])[:, 0].double()
    loss = ((logz - logz_t) / lens).float()
    saved = (torch.stack(alphas), torch.stack(alphas_t), torch.stack(cs),
             torch.stack(cts), logz, logz_t, k, col, valid, lens)
    return loss, saved


def grad_plain(scores: torch.Tensor, saved, grad_out: torch.Tensor,
               state_len: int) -> torch.Tensor:
    """The backward pass in torch operations: ``∂loss/∂scores`` for the
    rows' upstream gradients ``grad_out [N]``, in the scores' dtype."""
    alphas, alphas_t, cs, cts, logz, logz_t, k, col, valid, lens = saved
    n, t_len, _ = scores.shape
    s_n = 4 ** state_len
    q = s_n // 4
    dev = scores.device
    sc = scores.float().reshape(n, t_len, s_n, 5)
    states = torch.arange(s_n, device=dev)
    prev = [r * q + states // 4 for r in range(4)]
    # the moves out of state x: into (x % q)·4 + e, scored in column
    # 1 + x // q of that state
    out_cols = [((states % q) * 4 + e) * 5 + 1 + states // q
                for e in range(4)]
    out_states = [(states % q) * 4 + e for e in range(4)]
    rows = torch.arange(n, device=dev)[:, None]
    p_len = k.shape[1]
    neg = torch.full(k.shape, _NEG, device=dev)
    scale = (grad_out.float() / lens)[:, None]

    b = torch.zeros(n, s_n, device=dev)
    bt = torch.where(torch.arange(p_len, device=dev)[None]
                     == (lens - state_len)[:, None], 0.0, neg)
    d = torch.zeros(n, dtype=torch.float64, device=dev)
    dt = torch.zeros_like(d)
    grad = torch.empty(n, t_len, s_n * 5, dtype=scores.dtype, device=dev)
    for t in reversed(range(t_len)):
        x = sc[:, t]
        flat = x.reshape(n, -1)
        kk = (logz - cs[t] - d).float()[:, None, None]
        kt = (logz_t - cts[t] - dt).float()[:, None]
        a, at = alphas[t], alphas_t[t]
        src = torch.stack([a, *(a[:, prev[r]] for r in range(4))], -1)
        p_full = torch.exp(src + x + b[..., None] - kk).reshape(n, -1)
        stay = torch.exp(at + x[rows, k, 0] + bt - kt)
        move_src = torch.cat([neg[:, :1], at[:, :-1]], 1)
        move = torch.exp(move_src + x[rows, k, col] + bt - kt)
        p_target = torch.zeros_like(p_full)
        p_target.scatter_add_(1, k * 5, stay)
        p_target.scatter_add_(1, k * 5 + col, move)
        grad[:, t] = ((p_full - p_target) * scale).to(scores.dtype)
        m = b.amax(1, keepdim=True)
        mt = bt.amax(1, keepdim=True)
        b_new = _lse(b + x[..., 0], *(b[:, out_states[e]] + flat[:, out_cols[e]]
                                      for e in range(4))) - m
        nxt = torch.cat([bt[:, 1:], neg[:, :1]], 1)
        nxt_sc = torch.cat([x[rows, k, col][:, 1:], neg[:, :1]], 1)
        bt = torch.where(valid, _lse(bt + x[rows, k, 0], nxt + nxt_sc) - mt,
                         neg)
        b = b_new
        d = d + m[:, 0].double()
        dt = dt + mt[:, 0].double()
    return grad


def _launch_forward(scores, targets, lengths, state_len):
    n, t_len, _ = scores.shape
    s_n = 4 ** state_len
    dev = scores.device
    p_max = int(targets.shape[1]) - state_len + 1
    tg = targets.to(device=dev, dtype=torch.int32).contiguous()
    lens = torch.from_numpy(lengths.astype(np.int32)).pin_memory().to(
        dev, non_blocking=True)
    alpha = torch.empty(n, t_len, s_n, device=dev)
    alpha_t = torch.empty(n, t_len, p_max, device=dev)
    offsets = torch.empty(n, 2, t_len, dtype=torch.float64, device=dev)
    logz = torch.empty(n, 2, dtype=torch.float64, device=dev)
    loss = torch.empty(n, device=dev)
    lib = _build.load("crf_loss")
    err = lib.radian_crf_loss_forward(
        scores.data_ptr(), _DTYPES[scores.dtype], tg.data_ptr(),
        tg.shape[1], lens.data_ptr(), n, t_len, state_len, p_max,
        alpha.data_ptr(), alpha_t.data_ptr(), offsets.data_ptr(),
        logz.data_ptr(), loss.data_ptr(), *_build.target(scores))
    _build.check(lib, err, "crf_loss_forward_kernel launch")
    profiling.launch(crf_loss)
    return loss, (alpha, alpha_t, offsets, logz, tg, lens, p_max)


def _launch_backward(scores, saved, grad_out, state_len):
    alpha, alpha_t, offsets, logz, tg, lens, p_max = saved
    n, t_len, _ = scores.shape
    g = grad_out.to(device=scores.device, dtype=torch.float32).contiguous()
    grad = torch.empty_like(scores)
    lib = _build.load("crf_loss")
    err = lib.radian_crf_loss_backward(
        scores.data_ptr(), _DTYPES[scores.dtype], tg.data_ptr(),
        tg.shape[1], lens.data_ptr(), n, t_len, state_len, p_max,
        alpha.data_ptr(), alpha_t.data_ptr(), offsets.data_ptr(),
        logz.data_ptr(), g.data_ptr(), grad.data_ptr(),
        *_build.target(scores))
    _build.check(lib, err, "crf_loss_backward_kernel launch")
    profiling.launch(crf_loss)
    return grad


class _CrfLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, targets, lengths, state_len):
        ctx.state_len = state_len
        if scores.is_cuda:
            loss, saved = _launch_forward(scores, targets, lengths,
                                          state_len)
        else:
            loss, saved = loss_plain(scores, targets, lengths, state_len)
        ctx.saved = saved
        # the spans of the backward nest in whatever span the calling
        # thread has open then, though the engine may run it elsewhere
        ctx.caller = profiling.frames()
        ctx.save_for_backward(scores)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        (scores,) = ctx.saved_tensors
        caller = ctx.caller[-1] if ctx.caller else None
        with profiling.within(caller), profiling.span(
                "radian.train.crf_loss.backward", scores.device):
            if scores.is_cuda:
                grad = _launch_backward(scores, ctx.saved, grad_out,
                                        ctx.state_len)
            else:
                grad = grad_plain(scores, ctx.saved, grad_out,
                                  ctx.state_len)
        ctx.saved = None
        return grad, None, None, None


def crf_loss(scores: torch.Tensor, targets: torch.Tensor, target_lengths,
             state_len: int) -> torch.Tensor:
    """Bonito's CTC-CRF loss a row (module docstring): ``scores [N, T,
    4^state_len·5]`` (float32 or bf16), ``targets [N, n_max]`` bases 0–3
    padded past each row's length, ``target_lengths [N]`` (read on the
    host) → ``[N]`` float32, differentiable in ``scores``.  Refuses (a
    ``ValueError``) a target shorter than ``state_len`` or one the
    scores' steps cannot reach.  One kernel launch a pass on the card;
    torch operations elsewhere."""
    lengths = _geometry(scores, targets, target_lengths, state_len)
    if scores.is_cuda:
        if not MIN_STATE_LEN <= state_len <= MAX_STATE_LEN:
            raise ValueError(f"state_len {state_len} outside "
                             f"[{MIN_STATE_LEN}, {MAX_STATE_LEN}] (the "
                             "kernel's)")
        if targets.shape[1] - state_len + 1 > MAX_POSITIONS:
            raise ValueError(f"{targets.shape[1]} target columns: the "
                             f"kernel takes {MAX_POSITIONS + state_len - 1}"
                             " at most")
        if scores.dtype not in _DTYPES:
            raise ValueError(f"scores must be float32 or bfloat16, got "
                             f"{scores.dtype}")
        scores = scores.contiguous()
    s_n = 4 ** state_len
    n, t_len, _ = scores.shape
    profiling.count("target_bases", int(lengths.sum()))
    profiling.count("crf_loss_state_steps",
                    int(n * t_len * s_n
                        + t_len * (lengths - state_len + 1).sum()))
    with torch.autocast(scores.device.type, enabled=False):
        return _CrfLoss.apply(scores, targets, lengths, state_len)


crf_loss.launches = 0
