"""The transformer-CRF encoder's windowed multi-head attention with its
rotary embedding, one kernel a layer (``csrc/tx_attention.cu``).

``tx_attention(qkv, cos, sin, left, right)`` takes ``Wqkv``'s output
``[N, T′, 3, H, D]`` as it is and returns ``[N, T′, H·D]``, ready for
``out_proj``.  It computes what ``models/tx_crf.py``'s ``rotary`` and
``band_attention`` compute:

- the rotary embedding of ``q`` and ``k`` in float32, ``x1·cos − x2·sin``
  and ``x2·cos + x1·sin`` (each product and sum rounded on its own, as
  torch's separate kernels round), rounded once to the input's dtype;
  ``cos`` and ``sin`` are ``rotary_table``'s ``[T′, D/2]`` float32
  table, made by ``rotary``'s own torch ops, so the rotated ``q`` and
  ``k`` are ``rotary``'s bit for bit;
- query ``i`` attends to keys ``i − left … i + right`` of its own chunk,
  scale ``1/sqrt(D)``: queries in tiles of ``TILE``, tile ``b`` against
  the keys of tiles ``b``, ``b − 1``, ``b + 1`` in that order, 64 keys a
  step, with an online softmax in float32 (``exp2`` of the scores times
  ``log2(e)/sqrt(D)``, less the running maximum; the row sums in
  float32; the kernel's ``exp2`` flushes results under 2^-126 to 0); the
  probabilities are rounded to the input's dtype for the product with
  ``v``, which sums in float32; the output is that sum times the
  reciprocal of the row's sum.

Given CUDA tensors it launches the kernel (bf16, ``D`` 64, ``left`` and
``right`` at most ``TILE``) or raises; given CPU tensors it runs
``tx_attention_plain``, the same arithmetic in plain PyTorch.

``engages(model, x)`` is the rule ``TxCrfModel.forward`` takes this path
by: a CUDA input, a bf16 model, autograd off, heads of 64 and a window
``window_fits`` takes.  Everything else (float32, the CPU, training)
keeps ``rotary`` + ``band_attention``.
"""

from __future__ import annotations

import math

import torch

from radian_tpu_torch import _build
from radian_tpu_torch.utils import profiling

TILE = 128  # queries a tile; a tile's window lies in key tiles b-1..b+1
STEP = 64  # keys a step of the online softmax
HEAD_DIM = 64  # the kernel's D
MAX_WINDOW = 256  # left + right + 1


def rotary_table(t: int, d: int, base: float, device):
    """``(cos, sin)``, each ``[t, d/2]`` float32: the angles of positions
    ``0…t−1``, by ``models/tx_crf.py::rotary``'s own ops (a copy, so the
    tests hold the two to each other bit for bit)."""
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=device,
                                      dtype=torch.float32) / d)
    ang = torch.arange(t, device=device, dtype=torch.float32)[:, None] * inv
    return ang.cos(), ang.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """``x`` ``[N, T, H, D]`` rotated by the table, in float32, rounded
    once to ``x``'s dtype."""
    d = x.shape[-1]
    c, s = cos[:, None, :], sin[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., :d // 2], xf[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def window_fits(left: int, right: int) -> bool:
    """Whether the kernel takes the window: each side at most a tile (so
    tile ``b``'s window lies in key tiles ``b − 1 … b + 1``) and at most
    ``MAX_WINDOW`` keys in all."""
    return (0 <= left <= TILE and 0 <= right <= TILE
            and left + right + 1 <= MAX_WINDOW)


def scale_log2(d: int) -> float:
    """``log2(e)/sqrt(d)`` rounded to float32: the scores' factor."""
    return float(torch.tensor(math.log2(math.e) / math.sqrt(d),
                              dtype=torch.float32))


def tx_attention_plain(qkv: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, left: int, right: int):
    """``tx_attention``'s function in plain PyTorch, in ``qkv``'s dtype,
    step for step as the kernel takes it (module docstring)."""
    n, t, _, h, d = qkv.shape
    dt = qkv.dtype
    q = rotate(qkv[:, :, 0], cos, sin).transpose(1, 2).float()
    k = rotate(qkv[:, :, 1], cos, sin).transpose(1, 2).float()
    v = qkv[:, :, 2].transpose(1, 2).float()  # [N, H, T, D]
    c = scale_log2(d)
    out = torch.empty(n, t, h, d, dtype=dt, device=qkv.device)
    n_tiles = -(-t // TILE)
    pos = torch.arange(t, device=qkv.device)
    for b in range(n_tiles):
        rows = pos[b * TILE:(b + 1) * TILE]
        qb = q[:, :, rows]
        m = torch.full((n, h, len(rows), 1), float("-inf"),
                       device=qkv.device)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for tile in (b, b - 1, b + 1):
            if not 0 <= tile < n_tiles:
                continue
            for k0 in range(tile * TILE, min(t, (tile + 1) * TILE), STEP):
                keys = pos[k0:k0 + STEP]
                off = keys[None, :] - rows[:, None]
                ok = (off >= -left) & (off <= right)
                if not bool(ok.any()):
                    continue
                s = qb @ k[:, :, keys].transpose(-1, -2)
                s = s.masked_fill(~ok, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
                m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
                p = torch.exp2(s * c - m_use)
                alpha = torch.exp2(m - m_use)
                l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(dt).float() @ v[:, :, keys]
                m = m_new
        out[:, rows] = (acc * l_sum.reciprocal()).to(dt).transpose(1, 2)
    return out.view(n, t, h * d)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{dtype} {list(shape)} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def tx_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 left: int, right: int,
                 rotated: torch.Tensor | None = None) -> torch.Tensor:
    """The windowed attention (module docstring) of ``qkv`` ``[N, T′, 3,
    H, D]`` with the ``[T′, D/2]`` table → ``[N, T′, H·D]``.  On CUDA,
    ``rotated`` ``[N, T′, 2, H, D]`` (optional) receives the kernel's
    rotated ``q`` and ``k``."""
    if qkv.device.type == "cpu":
        return tx_attention_plain(qkv, cos, sin, left, right)
    if not qkv.is_cuda:
        raise ValueError(f"qkv must be a CPU or CUDA tensor, got "
                         f"{qkv.device}")
    if qkv.dim() != 5 or qkv.shape[2] != 3 or qkv.shape[4] != HEAD_DIM:
        raise ValueError(f"qkv must be [N, T, 3, H, {HEAD_DIM}], got "
                         f"{tuple(qkv.shape)}")
    if not window_fits(left, right):
        raise ValueError(f"window ({left}, {right}): each side at most "
                         f"{TILE}, {MAX_WINDOW} keys in all")
    n, t, _, h, d = qkv.shape
    _check("qkv", qkv, (n, t, 3, h, d), torch.bfloat16)
    _check("cos", cos, (t, d // 2), torch.float32)
    _check("sin", sin, (t, d // 2), torch.float32)
    tensors = [qkv, cos, sin]
    if rotated is not None:
        _check("rotated", rotated, (n, t, 2, h, d), torch.bfloat16)
        tensors.append(rotated)
    if any(x.device != qkv.device for x in tensors):
        raise ValueError(f"every tensor must be on {qkv.device}")
    out = torch.empty((n, t, h * d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("tx_attention")
    err = lib.radian_tx_attention(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        None if rotated is None else rotated.data_ptr(), n, t, h, left,
        right, scale_log2(d), *_build.target(qkv))
    _build.check(lib, err, "tx_attention launch")
    profiling.launch(tx_attention)
    return out


tx_attention.launches = 0


def engages(model, x: torch.Tensor) -> bool:
    """Whether ``model`` (a ``TxCrfModel``) takes the kernel for tokens
    ``x`` ``[N, T′, d_model]``: a CUDA input, a bf16 model, autograd off
    and ``fusable``."""
    return x.is_cuda and fusable(model)


def fusable(model) -> bool:
    """The rest of the rule: a bf16 model, autograd off, heads of
    ``HEAD_DIM`` and a window the kernel takes."""
    if model.compute_dtype != torch.bfloat16 or torch.is_grad_enabled():
        return False
    layer = model.encoder[0]
    a = layer.self_attn
    return (a.Wqkv.weight.shape[1] == a.nhead * HEAD_DIM
            and window_fits(layer.left, layer.right))
