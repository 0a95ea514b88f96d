"""The transformer-CRF encoder's DeepNorm residual and RMSNorm,
``RMSNorm(y + α·x)``, one kernel a norm (``csrc/tx_norm.cu``).

``add_rmsnorm(y, x, weight, alpha, eps)`` takes the sublayer's output
``y`` and the residual ``x``, both ``[..., d]``, and returns the norm in
``x``'s dtype.  It computes what ``add_rmsnorm_plain`` computes, rounding
for rounding:

- ``h = y + α·x`` in float32, ``α`` rounded to float32, the product and
  the sum each rounded on its own;
- ``r = rsqrt(mean(h²) + eps)``, the squares rounded to float32 and
  summed in float32 (the kernel sums in another order than torch's
  reduction: the only difference);
- ``(h·r)·weight`` in float32, rounded once to ``x``'s dtype.

Given CUDA tensors it launches the kernel (bf16, ``d`` a multiple of 256
up to ``MAX_D``) or raises; given CPU tensors it runs
``add_rmsnorm_plain``.

``engages(model, x)`` is the rule ``TxCrfModel.forward`` takes this path
by: a CUDA input, a bf16 model, autograd off and a ``d_model``
``d_fits`` takes.  Everything else (float32, the CPU, training) runs
``add_rmsnorm_plain``.
"""

from __future__ import annotations

import torch

from radian_tpu_torch import _build
from radian_tpu_torch.utils import profiling

PIECE = 256  # the kernel's d is a multiple of this: 8 elements a lane
MAX_D = 1024  # the kernel's largest d (4 pieces a lane)


def d_fits(d: int) -> bool:
    """Whether the kernel takes rows of ``d`` elements."""
    return 0 < d <= MAX_D and d % PIECE == 0


def add_rmsnorm_plain(y: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor, alpha: float, eps: float):
    """``RMSNorm(y + α·x)·weight``: the sum and the norm in float32,
    rounded once to ``x``'s dtype."""
    h = y.float() + alpha * x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    return (h * weight.float()).to(x.dtype)


def add_rmsnorm(y: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                alpha: float, eps: float) -> torch.Tensor:
    """``add_rmsnorm_plain``'s function (module docstring): on CPU tensors
    that plain version, on CUDA tensors the kernel."""
    if y.device.type == "cpu":
        return add_rmsnorm_plain(y, x, weight, alpha, eps)
    return tx_norm(y, x, weight, alpha, eps)


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"bfloat16 {list(shape)} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def tx_norm(y: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
            alpha: float, eps: float) -> torch.Tensor:
    """The kernel's launch: ``y``, ``x`` ``[..., d]`` and ``weight``
    ``[d]``, bf16 on one CUDA device → ``[..., d]`` bf16."""
    if not y.is_cuda:
        raise ValueError(f"y must be a CUDA tensor, got {y.device}")
    d = y.shape[-1]
    if not d_fits(d):
        raise ValueError(f"d {d}: a multiple of {PIECE} up to {MAX_D}")
    _check("y", y, tuple(y.shape))
    _check("x", x, tuple(y.shape))
    _check("weight", weight, (d,))
    if x.device != y.device or weight.device != y.device:
        raise ValueError(f"every tensor must be on {y.device}")
    out = torch.empty_like(y)
    lib = _build.load("tx_norm")
    err = lib.radian_tx_norm(y.data_ptr(), x.data_ptr(), weight.data_ptr(),
                             out.data_ptr(), y.numel() // d, d, alpha, eps,
                             *_build.target(y))
    _build.check(lib, err, "tx_norm launch")
    profiling.launch(tx_norm)
    return out


tx_norm.launches = 0


def engages(model, x: torch.Tensor) -> bool:
    """Whether ``model`` (a ``TxCrfModel``) takes the kernel for tokens
    ``x`` ``[N, T′, d_model]``: a CUDA input, a bf16 model, autograd off
    and a ``d_model`` ``d_fits`` takes."""
    return (x.is_cuda and model.compute_dtype == torch.bfloat16
            and not torch.is_grad_enabled() and d_fits(x.shape[-1]))
