"""CUDA beam-search kernel wrappers (counterpart of ops/beam_pallas.py and
of the LM-fused ``beam_search_batch``).

``beam_search_cuda`` has ``beam_search_pallas``'s contract: ``[N, T, 5]``
probabilities and ``[N]`` lengths in, ``(rev_labels [N, T] int32,
n_labels [N] int32, best_logp [N] f32)`` out, here for ``beam_width <=
16``.  ``beam_search_lm_cuda`` is the same with LM fusion.  Their
semantics are ``beam_search_batch``'s (see ``csrc/beam_search.cu`` and
``csrc/beam_search_lm.cu``).

Three kernels, each behind its own wrapper with a launch count:
``beam_decode_cuda`` (the time loop, emitting packed backpointers),
``beam_decode_lm_cuda`` (the same loop with the LM fused in) and
``beam_backtrace_cuda`` (the walk back from beam 0, shared by both).
They take the kernels' read-major layouts: ``[N, T, 5]`` log-probs (or,
with the LM, probabilities) and ``[N, T, W]`` backpointers.  A wrapper
given CPU tensors runs the plain PyTorch version in
``ops/beam_search.py`` (whose own interface keeps JAX's ``[T, ., N]``
layouts) and returns the same layouts as the kernel; given CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from radian_tpu_torch import _build
from radian_tpu_torch.ops import beam_search as plain
from radian_tpu_torch.utils import profiling

# widest beam the kernels take: the packed byte parent*8 + append+1 must
# fit int8, as in the reference's backpointers (ROADMAP Queue 3)
MAX_BEAM = 16


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got "
                         f"device {t.device}")


def _check_beam(beam_width: int) -> None:
    if not 1 <= beam_width <= MAX_BEAM:
        raise ValueError(f"beam_width {beam_width} outside [1, {MAX_BEAM}]")


def beam_decode_cuda(logm: torch.Tensor, lengths: torch.Tensor,
                     beam_width: int):
    """Decode kernel on ``[N, T, 5]`` f32 log-probs and ``[N]`` int32
    lengths → ``(bp [N, T, W] int8, n_labels [N] int32, best_logp [N])``."""
    _check_beam(beam_width)
    if logm.device.type == "cpu":
        bp, nlab, score = plain.beam_search_bp(logm.permute(1, 2, 0),
                                               lengths, beam_width)
        return bp.permute(2, 0, 1).contiguous(), nlab, score
    _require_cuda("logm", logm)
    if logm.dtype != torch.float32 or logm.dim() != 3 or logm.shape[2] != 5:
        raise ValueError(f"logm must be [N, T, 5] float32, got "
                         f"{tuple(logm.shape)} {logm.dtype}")
    n, t_len, _ = logm.shape
    if (lengths.device != logm.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (n,)):
        raise ValueError(f"lengths must be [{n}] int32 on {logm.device}")
    if not (logm.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("logm and lengths must be contiguous")
    bp = torch.empty((n, t_len, beam_width), dtype=torch.int8,
                     device=logm.device)
    score = torch.empty(n, dtype=torch.float32, device=logm.device)
    nlab = torch.empty(n, dtype=torch.int32, device=logm.device)
    lib = _build.load("beam_search")
    err = lib.radian_beam_decode(
        logm.data_ptr(), lengths.data_ptr(), bp.data_ptr(), score.data_ptr(),
        nlab.data_ptr(), t_len, n, beam_width, *_build.target(logm))
    _build.check(lib, err, "beam_decode_kernel launch")
    profiling.launch(beam_decode_cuda)
    return bp, nlab, score


beam_decode_cuda.launches = 0


def beam_backtrace_cuda(bp: torch.Tensor) -> torch.Tensor:
    """Backtrace kernel: ``[N, T, W]`` int8 backpointers → ``[N, T]``
    int32 labels, 5'→3' (column 0 = last emitted base, -1 = copy)."""
    if bp.device.type == "cpu":
        return plain.backtrace_batch(bp.permute(1, 2, 0))
    _require_cuda("bp", bp)
    if bp.dtype != torch.int8 or bp.dim() != 3 or not bp.is_contiguous():
        raise ValueError(f"bp must be contiguous [N, T, W] int8, got "
                         f"{tuple(bp.shape)} {bp.dtype}")
    n, t_len, w = bp.shape
    _check_beam(w)
    rev = torch.empty((n, t_len), dtype=torch.int32, device=bp.device)
    lib = _build.load("beam_search")
    err = lib.radian_beam_backtrace(bp.data_ptr(), rev.data_ptr(), t_len, w,
                                    n, *_build.target(bp))
    _build.check(lib, err, "beam_backtrace_kernel launch")
    profiling.launch(beam_backtrace_cuda)
    return rev


beam_backtrace_cuda.launches = 0


# the LM kernel's table layouts: (packed, dtype) -> table_kind
_TABLE_KINDS = {(False, torch.float32): 0, (False, torch.bfloat16): 1,
                (True, torch.float32): 2, (True, torch.bfloat16): 3}
MAX_CTX_LEN = 15  # the kernel's contexts are 32-bit: 2 bits a base


def _table_kind(lm: plain.LMFusion, device: torch.device) -> int:
    """Check the LM tables against what the kernel reads; its table_kind."""
    if not 0 <= lm.ctx_len <= MAX_CTX_LEN:
        raise ValueError(f"ctx_len {lm.ctx_len} outside [0, {MAX_CTX_LEN}]")
    t1, t2 = lm.t1, lm.t2
    if t1.device != device or t2.device != device:
        raise ValueError(f"LM tables must be on {device}")
    if not (t1.is_contiguous() and t2.is_contiguous()):
        raise ValueError("LM tables must be contiguous")
    kind = _TABLE_KINDS.get((lm.packed, t2.dtype))
    n_ctx = 4 ** lm.ctx_len
    if lm.packed:
        ok = (t1.dtype == torch.int32 and t1.dim() == 2 and t1.shape[1] == 2
              and t1.shape[0] * 32 >= n_ctx and t2.dim() == 2
              and t2.shape[1] == 5 and t2.shape[0] >= 1)
        want = "l1 [ceil(R/32), 2] int32 and vals [U+1, 5]"
    else:
        ok = (t1.dtype == t2.dtype and t1.dim() == 2 and t1.shape[1] == 4
              and t1.shape[0] >= n_ctx and tuple(t2.shape) == (t1.shape[0],))
        want = "probs [R, 4] and entropy [R] of one dtype"
    if kind is None or not ok:
        raise ValueError(
            f"LM tables must be {want}, float32 or bfloat16, R >= 4^ctx_len "
            f"= {n_ctx}; got {tuple(t1.shape)} {t1.dtype}, "
            f"{tuple(t2.shape)} {t2.dtype}")
    # the kernel copies a dense row's 4 probabilities with one cp.async and
    # reads a packed l1 entry as one int2: each needs its start aligned to
    # its size, which a view's storage offset may break
    align = 8 if lm.packed else 4 * t1.element_size()
    if t1.data_ptr() % align:
        raise ValueError(f"LM table {'l1' if lm.packed else 'probs'} must "
                         f"start {align}-byte aligned (a view's offset)")
    return kind


def beam_decode_lm_cuda(probs: torch.Tensor, lengths: torch.Tensor,
                        beam_width: int, lm: plain.LMFusion):
    """LM-fused decode kernel on ``[N, T, 5]`` f32 probabilities and
    ``[N]`` int32 lengths → ``(bp [N, T, W] int8, n_labels [N] int32,
    best_logp [N])``, the layouts of ``beam_decode_cuda``."""
    _check_beam(beam_width)
    if probs.device.type == "cpu":
        probs_tn = probs.float().permute(1, 2, 0)
        bp, nlab, score = plain.beam_search_bp(
            torch.log(probs_tn), lengths, beam_width, lm, probs_tn)
        return bp.permute(2, 0, 1).contiguous(), nlab, score
    _require_cuda("probs", probs)
    if probs.dtype != torch.float32 or probs.dim() != 3 or probs.shape[2] != 5:
        raise ValueError(f"probs must be [N, T, 5] float32, got "
                         f"{tuple(probs.shape)} {probs.dtype}")
    n, t_len, _ = probs.shape
    if (lengths.device != probs.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (n,)):
        raise ValueError(f"lengths must be [{n}] int32 on {probs.device}")
    if not (probs.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("probs and lengths must be contiguous")
    kind = _table_kind(lm, probs.device)
    bp = torch.empty((n, t_len, beam_width), dtype=torch.int8,
                     device=probs.device)
    score = torch.empty(n, dtype=torch.float32, device=probs.device)
    nlab = torch.empty(n, dtype=torch.int32, device=probs.device)
    lib = _build.load("beam_search_lm")
    err = lib.radian_beam_decode_lm(
        probs.data_ptr(), lengths.data_ptr(), lm.t1.data_ptr(),
        lm.t2.data_ptr(), kind, lm.ctx_len, lm.s_threshold, lm.r_threshold,
        bp.data_ptr(), score.data_ptr(), nlab.data_ptr(), t_len, n,
        beam_width, *_build.target(probs))
    _build.check(lib, err, "beam_decode_lm_kernel launch")
    profiling.launch(beam_decode_lm_cuda)
    return bp, nlab, score


beam_decode_lm_cuda.launches = 0


def log_probs(mats: torch.Tensor) -> torch.Tensor:
    """``[N, T, 5]`` probabilities → contiguous ``[N, T, 5]`` f32 log-probs
    (the decode kernel's layout: a read's steps contiguous)."""
    return torch.log(mats.float()).contiguous()


def beam_search_cuda(mats: torch.Tensor, lengths: torch.Tensor,
                     beam_width: int = 6):
    """Beam search over ``[N, T, 5]`` probabilities via the two kernels.

    Returns ``(rev_labels [N, T] int32, n_labels [N] int32,
    best_logp [N] f32)`` with ``beam_search_batch``'s semantics.
    """
    if mats.dim() != 3 or mats.shape[-1] != 5:
        raise ValueError(f"mats must be [N, T, 5], got {tuple(mats.shape)}")
    lengths = lengths.to(device=mats.device, dtype=torch.int32).contiguous()
    bp, nlab, score = beam_decode_cuda(log_probs(mats), lengths, beam_width)
    return beam_backtrace_cuda(bp), nlab, score


def beam_search_lm_cuda(mats: torch.Tensor, lengths: torch.Tensor,
                        beam_width: int, lm: plain.LMFusion):
    """LM-fused beam search over ``[N, T, 5]`` probabilities via the LM
    decode kernel and the backtrace kernel; ``beam_search_batch(...,
    lm_enabled=True)``'s semantics and results."""
    if mats.dim() != 3 or mats.shape[-1] != 5:
        raise ValueError(f"mats must be [N, T, 5], got {tuple(mats.shape)}")
    lengths = lengths.to(device=mats.device, dtype=torch.int32).contiguous()
    bp, nlab, score = beam_decode_lm_cuda(mats.float().contiguous(), lengths,
                                          beam_width, lm)
    return beam_backtrace_cuda(bp), nlab, score
