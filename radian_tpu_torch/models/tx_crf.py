"""Bonito's transformer-CRF basecaller, the port's second model family
(``model.type: bonito_tx_crf`` in the config).

``[N, C]`` normalised chunks → ``[N, T, 4^state_len·5]`` CRF scores,
``T = C / stride`` (the benchmark's plain reference,
``benchmark/core/reference_tx_crf.py``, states the equations and the
departures from the published model):

- ``stem``: 1-d convolutions with bias and swish, ``[N, 1, C] → [N,
  d_model, T′]``, then channels-last ``[N, T′, d_model]``;
- ``encoder``: DeepNorm post-norm layers, each windowed multi-head
  attention with rotary embeddings and a SwiGLU feed-forward;
- ``upsample``: a linear layer to ``scale_factor`` tokens a token;
- ``crf``: the CRF head (``models/crf_head.py``, shared with the
  LSTM-CRF model): a linear layer to the move scores, ``tanh``·``scale``,
  the blank score put in front of each state's 4 move scores.

The windowed attention takes one of two paths, by
``ops/tx_attention.py``'s ``engages`` (no knob):

- bf16 inference on the card (a CUDA input, a bf16 model, autograd off,
  heads of 64, a window of at most 256 keys and 128 a side): one
  hand-written kernel a layer, ``csrc/tx_attention.cu``, reads
  ``Wqkv``'s output in place, applies the rotary embedding from a
  cos/sin table cached by length and device, attends over the window
  and writes ``[N, T′, d_model]`` for ``out_proj``;
- everything else (float32, the CPU, training): ``rotary`` then
  ``band_attention``, ``F.scaled_dot_product_attention`` on key bands:
  queries in blocks of ``ATTN_BLOCK``, each block against the band of
  keys its window can reach (``ATTN_BLOCK + left + right`` keys, rounded
  up to 8) under a band mask that is the same for every chunk of a
  length; no ``T′×T′`` mask is made.  This path is the kernel's
  yardstick.

The DeepNorm residual and RMSNorm, ``RMSNorm(y + α·x)``, take one of
two paths, by ``ops/tx_norm.py``'s ``engages`` (no knob):

- bf16 inference on the card (a CUDA input, a bf16 model, autograd off,
  ``d_model`` a multiple of 256 up to 1,024): one hand-written kernel a
  norm, ``csrc/tx_norm.cu``, two a layer, reads ``y`` and ``x`` in bf16
  and writes the norm in bf16;
- everything else (float32, the CPU, training): ``add_rmsnorm_plain``,
  separate PyTorch kernels.  This path is the kernel's yardstick.

Both compute the sum and the norm in float32 and round once; the rotary
embedding too runs in float32 and rounds once, on both paths.  Each
layer's attention (``Wqkv``, rotary, the windowed attention,
``out_proj``) is the span ``radian.tx.attention``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from radian_tpu_torch.config import DotDict
from radian_tpu_torch.models.crf_head import CrfHead
from radian_tpu_torch.ops import tx_attention as txa
from radian_tpu_torch.ops import tx_norm as txn
from radian_tpu_torch.utils import profiling

MODEL_TYPE = "bonito_tx_crf"
ATTN_BLOCK = 128  # queries a band


def band_mask(t: int, left: int, right: int, device) -> torch.Tensor:
    """``[n_blocks, ATTN_BLOCK, W]`` bool: query ``r`` of block ``b``
    (position ``b·ATTN_BLOCK + r``) may see key ``c`` of its band
    (position ``b·ATTN_BLOCK − left + c``): inside the window and the
    chunk.  A padding query sees its own band column ``r + left`` alone,
    so that no row is empty."""
    n_blocks = -(-t // ATTN_BLOCK)
    width = -(-(ATTN_BLOCK + left + right) // 8) * 8
    r = torch.arange(ATTN_BLOCK, device=device)[:, None]
    c = torch.arange(width, device=device)[None, :]
    b = torch.arange(n_blocks, device=device)[:, None, None]
    key = b * ATTN_BLOCK - left + c
    ok = (c >= r) & (c <= r + left + right) & (key >= 0) & (key < t)
    pad_query = (b * ATTN_BLOCK + r) >= t
    return ok | (pad_query & (c == r + left))


def band_attention(q, k, v, left: int, right: int, mask: torch.Tensor):
    """Softmax attention of ``[N, T′, H, D]`` queries over the keys
    ``j`` with ``i − left ≤ j ≤ i + right``, scale ``1/sqrt(D)``."""
    n, t, h, d = q.shape
    n_blocks, block, width = mask.shape
    tq = n_blocks * block
    qb = F.pad(q.transpose(1, 2), (0, 0, 0, tq - t))
    qb = qb.reshape(n, h * n_blocks, block, d)

    def bands(x):
        x = F.pad(x.transpose(1, 2), (0, 0, left, tq - t + width - block
                                      - left))
        x = x.unfold(2, width, block)  # [N, H, n_blocks, D, width]
        return x.transpose(-1, -2).reshape(n, h * n_blocks, width, d)

    m = mask.expand(h, n_blocks, block, width).reshape(h * n_blocks, block,
                                                       width)
    o = F.scaled_dot_product_attention(qb, bands(k), bands(v), attn_mask=m)
    return o.reshape(n, h, tq, d)[:, :, :t].transpose(1, 2)


def rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotary embedding of ``[N, T, H, D]`` at positions ``0…T−1``
    (non-interleaved halves), computed in float32, in ``x``'s dtype."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=x.device,
                                      dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., :d // 2], xf[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


class AddRMSNorm(nn.Module):
    """DeepNorm's ``RMSNorm(y + α·x)``, the sum and the norm in float32,
    rounded once to ``x``'s dtype: the kernel where ``kernel``, else
    ``add_rmsnorm_plain``."""

    def __init__(self, d: int, alpha: float, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.alpha, self.eps = alpha, eps

    def forward(self, y, x, kernel: bool = False):
        norm = txn.add_rmsnorm if kernel else txn.add_rmsnorm_plain
        return norm(y, x, self.weight, self.alpha, self.eps)


class Attention(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.Wqkv = nn.Linear(d_model, 3 * d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, 2 * dim_feedforward, bias=False)
        self.fc2 = nn.Linear(dim_feedforward, d_model, bias=False)


class EncoderLayer(nn.Module):
    def __init__(self, enc: DotDict):
        super().__init__()
        d = enc.d_model
        self.self_attn = Attention(d, enc.nhead)
        self.ff = FeedForward(d, enc.dim_feedforward)
        self.norm1 = AddRMSNorm(d, enc.deepnorm_alpha, enc.norm_eps)
        self.norm2 = AddRMSNorm(d, enc.deepnorm_alpha, enc.norm_eps)
        self.left, self.right = enc.attn_window
        self.rotary_base = enc.rotary_base

    def attention(self, x, mask, table):
        """``table``: the kernel's ``(cos, sin)``, else ``mask`` for
        ``band_attention``."""
        a = self.self_attn
        n, t, d = x.shape
        qkv = F.linear(x, a.Wqkv.weight).view(n, t, 3, a.nhead, -1)
        if table is not None:
            o = txa.tx_attention(qkv, *table, self.left, self.right)
        else:
            q = rotary(qkv[:, :, 0], self.rotary_base)
            k = rotary(qkv[:, :, 1], self.rotary_base)
            o = band_attention(q, k, qkv[:, :, 2], self.left, self.right,
                               mask).reshape(n, t, d)
        return F.linear(o, a.out_proj.weight, a.out_proj.bias)

    def forward(self, x, mask, table=None, norm_kernel: bool = False):
        with profiling.span("radian.tx.attention", x.device):
            a = self.attention(x, mask, table)
        x = self.norm1(a, x, norm_kernel)
        y, gate = F.linear(x, self.ff.fc1.weight).chunk(2, -1)
        return self.norm2(F.linear(y * F.silu(gate), self.ff.fc2.weight), x,
                          norm_kernel)


class TxCrfModel(nn.Module):
    """The transformer-CRF model of a ``bonito_tx_crf`` config's ``model``
    section, its parameters in ``compute_dtype``."""

    def __init__(self, model: DotDict,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                             "bfloat16")
        self.compute_dtype = compute_dtype
        self.stem = nn.ModuleList(
            nn.Conv1d(s.insize, s.size, s.winlen, stride=s.stride,
                      padding=s.padding) for s in model.stem)
        enc = model.encoder
        self.encoder = nn.ModuleList(EncoderLayer(enc)
                                     for _ in range(enc.num_layers))
        self.scale_factor = model.upsample.scale_factor
        self.upsample = nn.Linear(enc.d_model,
                                  self.scale_factor * enc.d_model)
        self.crf = CrfHead(enc.d_model, model.crf)
        self.state_len = self.crf.state_len
        self.sample_stride = math.prod(s.stride for s in model.stem)
        if self.sample_stride % self.scale_factor:
            raise ValueError("the stem's stride must divide by the "
                             "upsampling factor")
        self.stride = self.sample_stride // self.scale_factor
        self._masks: dict = {}
        self._tables: dict = {}
        self.to(compute_dtype)

    def _mask(self, t: int, device) -> torch.Tensor:
        key = (t, str(device))
        m = self._masks.get(key)
        if m is None:
            layer = self.encoder[0]
            m = self._masks[key] = band_mask(t, layer.left, layer.right,
                                             device)
        return m

    def _table(self, t: int, device) -> tuple:
        """The kernel's rotary ``(cos, sin)`` for ``t`` tokens, made once
        a length and device."""
        key = (t, str(device))
        tab = self._tables.get(key)
        if tab is None:
            layer = self.encoder[0]
            tab = self._tables[key] = txa.rotary_table(
                t, layer.self_attn.Wqkv.weight.shape[1]
                // layer.self_attn.nhead, layer.rotary_base, device)
        return tab

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, C]`` normalised chunks → ``[N, T, 4^state_len·5]`` scores
        in ``compute_dtype``."""
        if x.is_cuda:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        h = x.to(self.compute_dtype)[:, None, :]
        for conv in self.stem:
            h = F.silu(conv(h))
        h = h.transpose(1, 2).contiguous()
        if txa.engages(self, h):
            mask, table = None, self._table(h.shape[1], h.device)
        else:
            mask, table = self._mask(h.shape[1], h.device), None
        norm_kernel = txn.engages(self, h)
        for layer in self.encoder:
            h = layer(h, mask, table, norm_kernel)
        n, t, d = h.shape
        h = self.upsample(h).view(n, t * self.scale_factor, d)
        return self.crf(h)
