"""The CRF Viterbi decode of Bonito's CRF models, the transformer-CRF
and the LSTM-CRF (``csrc/crf_viterbi.cu``).

Scores ``[N, T, 4^state_len·5]`` (a state's stay score, then its 4
move scores) → the Viterbi path ``[N, T]`` int8: at each step the base
``"ACGT"[s % 4]`` a move into state ``s`` emits, -1 for a stay.  A state
is the last ``state_len`` bases, the newest in the low 2 bits; the move
scored in column ``1+r`` comes from the state ``r·4^(state_len−1) +
s // 4``.  α starts at 0 for every state and sums in float32; ties go to
the lowest column, then to the lowest final state.  These are Bonito's
``CTC_CRF`` semantics (``benchmark/core/reference_tx_crf.py``).

Two kernels, each behind its wrapper with a launch count:
``crf_viterbi`` (the forward scan of a batch, one byte of backpointer a
state-step, and each chunk's final state) and ``crf_backtrace`` (the
walk back from it).  Given CUDA tensors a wrapper launches its kernel
(bf16 or float32 scores, ``state_len`` 2–5) or raises; given CPU tensors
it runs the plain version here.
"""

from __future__ import annotations

import torch

from radian_tpu_torch import _build
from radian_tpu_torch.utils import profiling

MIN_STATE_LEN, MAX_STATE_LEN = 2, 5  # the kernel's: 16 to 1,024 states
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _states(scores: torch.Tensor, state_len: int) -> int:
    s_n = 4 ** state_len
    if scores.dim() != 3 or scores.shape[2] != 5 * s_n:
        raise ValueError(f"scores must be [N, T, {5 * s_n}] for state_len "
                         f"{state_len}, got {tuple(scores.shape)}")
    return s_n


def viterbi_forward_plain(scores: torch.Tensor, state_len: int):
    """``crf_viterbi``'s function in plain PyTorch: ``(bp [N, T, S]
    uint8, final [N] int32)``."""
    n, t_len, _ = scores.shape
    s_n = _states(scores, state_len)
    sc = scores.float().view(n, t_len, s_n, 5)
    dev = scores.device
    states = torch.arange(s_n, device=dev)
    prev = torch.stack([r * (s_n // 4) + states // 4 for r in range(4)])
    alpha = torch.zeros(n, s_n, device=dev)
    bp = torch.empty(n, t_len, s_n, dtype=torch.uint8, device=dev)
    for t in range(t_len):
        best = alpha + sc[:, t, :, 0]
        col = torch.zeros(n, s_n, dtype=torch.uint8, device=dev)
        for r in range(4):
            v = alpha[:, prev[r]] + sc[:, t, :, 1 + r]
            better = v > best
            best = torch.where(better, v, best)
            col.masked_fill_(better, r + 1)
        alpha = best
        bp[:, t] = col
    top = alpha.max(1, keepdim=True).values
    final = torch.where(alpha == top, states, s_n).min(1).values
    return bp, final.to(torch.int32)


def backtrace_plain(bp: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """``crf_backtrace``'s function in plain PyTorch: ``[N, T]`` int8."""
    n, t_len, s_n = bp.shape
    rows = torch.arange(n, device=bp.device)
    state = final.long()
    path = torch.empty(n, t_len, dtype=torch.int8, device=bp.device)
    for t in reversed(range(t_len)):
        c = bp[rows, t, state].long()
        path[:, t] = torch.where(c > 0, state % 4, -1).to(torch.int8)
        state = torch.where(c > 0, (c - 1) * (s_n // 4) + state // 4, state)
    return path


def crf_viterbi(scores: torch.Tensor, state_len: int):
    """The forward scan: ``[N, T, 4^state_len·5]`` scores → ``(bp [N, T,
    S] uint8, final [N] int32)``; one launch."""
    if scores.device.type == "cpu":
        return viterbi_forward_plain(scores, state_len)
    if not scores.is_cuda:
        raise ValueError(f"scores must be a CPU or CUDA tensor, got "
                         f"{scores.device}")
    s_n = _states(scores, state_len)
    if not MIN_STATE_LEN <= state_len <= MAX_STATE_LEN:
        raise ValueError(f"state_len {state_len} outside [{MIN_STATE_LEN}, "
                         f"{MAX_STATE_LEN}] (the kernel's)")
    if scores.dtype not in _DTYPES or not scores.is_contiguous():
        raise ValueError(f"scores must be contiguous float32 or bfloat16, "
                         f"got {scores.dtype}")
    if scores.data_ptr() % 16:
        raise ValueError("scores must start 16-byte aligned")
    n, t_len, _ = scores.shape
    bp = torch.empty((n, t_len, s_n), dtype=torch.uint8,
                     device=scores.device)
    final = torch.empty(n, dtype=torch.int32, device=scores.device)
    lib = _build.load("crf_viterbi")
    err = lib.radian_crf_viterbi(scores.data_ptr(), _DTYPES[scores.dtype],
                                 bp.data_ptr(), final.data_ptr(), t_len, n,
                                 state_len, *_build.target(scores))
    _build.check(lib, err, "crf_viterbi_fwd_kernel launch")
    profiling.launch(crf_viterbi)
    return bp, final


crf_viterbi.launches = 0


def crf_backtrace(bp: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """The walk back: ``(bp [N, T, S] uint8, final [N] int32)`` → the path
    ``[N, T]`` int8; one launch."""
    if bp.device.type == "cpu":
        return backtrace_plain(bp, final)
    if not bp.is_cuda:
        raise ValueError(f"bp must be a CPU or CUDA tensor, got {bp.device}")
    n, t_len, s_n = bp.shape
    if (bp.dtype != torch.uint8 or not bp.is_contiguous()
            or s_n not in [4 ** k for k in range(MIN_STATE_LEN,
                                                 MAX_STATE_LEN + 1)]):
        raise ValueError(f"bp must be contiguous [N, T, 4^k] uint8, got "
                         f"{tuple(bp.shape)} {bp.dtype}")
    if (final.device != bp.device or final.dtype != torch.int32
            or tuple(final.shape) != (n,) or not final.is_contiguous()):
        raise ValueError(f"final must be [{n}] int32 on {bp.device}")
    path = torch.empty((n, t_len), dtype=torch.int8, device=bp.device)
    lib = _build.load("crf_viterbi")
    err = lib.radian_crf_backtrace(bp.data_ptr(), final.data_ptr(),
                                   path.data_ptr(), t_len, n, s_n,
                                   *_build.target(bp))
    _build.check(lib, err, "crf_viterbi_backtrace_kernel launch")
    profiling.launch(crf_backtrace)
    return path


crf_backtrace.launches = 0


def viterbi_path(scores: torch.Tensor, state_len: int) -> torch.Tensor:
    """The Viterbi path ``[N, T]`` int8 of ``[N, T, 4^state_len·5]``
    scores: the two kernels on the card, the plain version on the CPU."""
    return crf_backtrace(*crf_viterbi(scores, state_len))
