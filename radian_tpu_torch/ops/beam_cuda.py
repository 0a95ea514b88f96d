"""CUDA beam-search kernel wrappers (counterpart of ops/beam_pallas.py).

``beam_search_cuda`` has ``beam_search_pallas``'s contract: ``[N, T, 5]``
probabilities and ``[N]`` lengths in, ``(rev_labels [N, T] int32,
n_labels [N] int32, best_logp [N] f32)`` out, ``beam_width <= 8``.  Its
semantics are ``beam_search_batch``'s (see ``csrc/beam_search.cu``).

Two kernels, each behind its own wrapper with a launch count:
``beam_decode_cuda`` (the time loop, emitting packed backpointers) and
``beam_backtrace_cuda`` (the walk back from beam 0).  A wrapper given CPU
tensors runs the plain PyTorch version in ``ops/beam_search.py``; given
CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from radian_tpu_torch import _build
from radian_tpu_torch.ops import beam_search as plain

MAX_BEAM = 8  # widest beam the kernel's state arrays hold (beam_pallas WSUB)


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got "
                         f"device {t.device}")


def beam_decode_cuda(logm: torch.Tensor, lengths: torch.Tensor,
                     beam_width: int):
    """Decode kernel on ``[T, 5, N]`` f32 log-probs and ``[N]`` int32
    lengths → ``(bp [T, W, N] int8, n_labels [N] int32, best_logp [N])``."""
    if not 1 <= beam_width <= MAX_BEAM:
        raise ValueError(f"beam_width {beam_width} outside [1, {MAX_BEAM}]")
    if logm.device.type == "cpu":
        return plain.beam_search_bp(logm, lengths, beam_width)
    _require_cuda("logm", logm)
    if logm.dtype != torch.float32 or logm.dim() != 3 or logm.shape[1] != 5:
        raise ValueError(f"logm must be [T, 5, N] float32, got "
                         f"{tuple(logm.shape)} {logm.dtype}")
    t_len, _, n = logm.shape
    if (lengths.device != logm.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (n,)):
        raise ValueError(f"lengths must be [{n}] int32 on {logm.device}")
    if not (logm.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("logm and lengths must be contiguous")
    bp = torch.empty((t_len, beam_width, n), dtype=torch.int8,
                     device=logm.device)
    score = torch.empty(n, dtype=torch.float32, device=logm.device)
    nlab = torch.empty(n, dtype=torch.int32, device=logm.device)
    lib = _build.load("beam_search")
    err = lib.radian_beam_decode(
        logm.data_ptr(), lengths.data_ptr(), bp.data_ptr(), score.data_ptr(),
        nlab.data_ptr(), t_len, n, beam_width, _stream_ptr(logm))
    _build.check(lib, err, "beam_decode_kernel launch")
    beam_decode_cuda.launches += 1
    return bp, nlab, score


beam_decode_cuda.launches = 0


def beam_backtrace_cuda(bp: torch.Tensor) -> torch.Tensor:
    """Backtrace kernel: ``[T, W, N]`` int8 backpointers → ``[N, T]``
    int32 labels, 5'→3' (column 0 = last emitted base, -1 = copy)."""
    if bp.device.type == "cpu":
        return plain.backtrace_batch(bp)
    _require_cuda("bp", bp)
    if bp.dtype != torch.int8 or bp.dim() != 3 or not bp.is_contiguous():
        raise ValueError(f"bp must be contiguous [T, W, N] int8, got "
                         f"{tuple(bp.shape)} {bp.dtype}")
    t_len, w, n = bp.shape
    if not 1 <= w <= MAX_BEAM:
        raise ValueError(f"beam dimension {w} outside [1, {MAX_BEAM}]")
    rev = torch.empty((n, t_len), dtype=torch.int32, device=bp.device)
    lib = _build.load("beam_search")
    err = lib.radian_beam_backtrace(bp.data_ptr(), rev.data_ptr(), t_len, w,
                                    n, _stream_ptr(bp))
    _build.check(lib, err, "beam_backtrace_kernel launch")
    beam_backtrace_cuda.launches += 1
    return rev


beam_backtrace_cuda.launches = 0


def log_probs_tn(mats: torch.Tensor) -> torch.Tensor:
    """``[N, T, 5]`` probabilities → contiguous ``[T, 5, N]`` f32 log-probs
    (the decode kernel's coalesced layout, as ``beam_pallas.py:362``)."""
    return torch.log(mats.float().permute(1, 2, 0)).contiguous()


def beam_search_cuda(mats: torch.Tensor, lengths: torch.Tensor,
                     beam_width: int = 6):
    """Beam search over ``[N, T, 5]`` probabilities via the two kernels.

    Returns ``(rev_labels [N, T] int32, n_labels [N] int32,
    best_logp [N] f32)`` with ``beam_search_batch``'s semantics.
    """
    if mats.dim() != 3 or mats.shape[-1] != 5:
        raise ValueError(f"mats must be [N, T, 5], got {tuple(mats.shape)}")
    lengths = lengths.to(device=mats.device, dtype=torch.int32).contiguous()
    bp, nlab, score = beam_decode_cuda(log_probs_tn(mats), lengths,
                                       beam_width)
    return beam_backtrace_cuda(bp), nlab, score
