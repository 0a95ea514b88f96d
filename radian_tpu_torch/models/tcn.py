"""Temporal convolutional network backbone (counterpart of radian_tpu/models/tcn.py).

Same architecture as the JAX module: ``nb_stacks × len(dilations)``
residual blocks of two dilated causal convolutions with ReLU, a 1×1
shortcut only where the channel count changes (block 0: 1 → 256), and the
residual add + ReLU in float32.  With the default config the receptive
field is ``1 + 2*(k-1)*sum(dilations) = 253`` samples.

Compute dtype: the stack runs in the dtype of its input (float32, or
bfloat16 for ``compute_dtype=bfloat16``); parameters stay float32 and are
cast to it per convolution, as the flax module's ``dtype``/``param_dtype``
do; in bfloat16 the bias is added after the convolution is rounded, as
flax adds it (fused into the convolution, the trained model's
probabilities on the CPU sat up to 3.8e-2 from flax's instead of
1.1e-2).

Two paths compute the stack, with the same rounding points:

- ``TCN.forward`` (this module): activations ``[N, C, T]``, the layout
  ``F.conv1d`` takes (cuDNN on the card), each convolution ``F.pad``-ed,
  its bias, ReLUs and residual sum separate PyTorch operations;
  ``SigToSeq.forward`` transposes once on the way in and once on the way
  out, so its public boundary is ``[N, T, C]`` like the JAX module.  It
  serves float32, training and anything autograd records, the CPU,
  tensor-parallel models (``models/tensor_parallel.py``) and skip
  connections.
- ``ops/tcn_conv.py::tcn_forward``: bf16 inference on a CUDA device
  (``ops/tcn_conv.py::engages``, no knob): activations ``[N, T, C]`` from
  the signal to the dense head, one launch of ``csrc/tcn_conv.cu`` a
  convolution with its bias, ReLU and residual sum fused in; the causal
  padding is the kernel's zero-filled loads.  It rounds the product to
  bf16, adds the bf16 bias in float32 and rounds, and sums the residual
  in float32, as this module does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class CausalConv1D(nn.Module):
    """Dilated 1-D convolution with causal (left-only) padding, ``[N, C, T]``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, padding: str = "causal"):
        super().__init__()
        if padding != "causal":
            raise NotImplementedError(
                f"padding={padding!r}: only 'causal' is ported")
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return causal_conv1d(x, self.weight, self.bias, self.dilation)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, dilation: int) -> torch.Tensor:
    """``[N, C_in, T]`` → ``[N, C_out, T]``: ``weight`` ``[C_out, C_in,
    k]`` over ``x`` padded ``(k-1)·dilation`` on the left, in ``x``'s
    dtype, plus ``bias`` (``None``: none)."""
    x = F.pad(x, ((weight.shape[-1] - 1) * dilation, 0))
    w = weight.to(x.dtype)
    if bias is None:
        return F.conv1d(x, w, None, dilation=dilation)
    if x.dtype == torch.float32:
        return F.conv1d(x, w, bias, dilation=dilation)
    # flax rounds a bfloat16 convolution before adding its bias
    return F.conv1d(x, w, None, dilation=dilation) + bias.to(x.dtype)[:, None]


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 dilation: int, padding: str = "causal",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv0 = CausalConv1D(in_channels, filters, kernel_size,
                                  dilation, padding)
        self.conv1 = CausalConv1D(filters, filters, kernel_size, dilation,
                                  padding)
        # 1×1 shortcut only where the channel count changes (block 0)
        self.shortcut = (CausalConv1D(in_channels, filters, 1)
                         if in_channels != filters else None)

    def forward(self, x, train: bool = False):
        if train and self.dropout_rate > 0.0:
            # the flax block's nn.Dropout needs a 'dropout' rng when
            # train=True, which the JAX Trainer never passes: no reference
            # trains with dropout, so the port does not either
            raise NotImplementedError(
                f"dropout_rate={self.dropout_rate} with train=True: the JAX "
                "package cannot train with dropout (its train step passes "
                "no 'dropout' rng), so the port does not add it")
        # with train=False each nn.Dropout is deterministic: a no-op
        branch = F.relu(self.conv1(F.relu(self.conv0(x))))
        inputs = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(inputs.float() + branch.float()).to(x.dtype)
        return out, branch


class TCN(nn.Module):
    def __init__(self, nb_filters: int = 256, kernel_size: int = 3,
                 nb_stacks: int = 1,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 padding: str = "causal", use_skip_connections: bool = False,
                 dropout_rate: float = 0.0, return_sequences: bool = True,
                 use_batch_norm: bool = False, in_channels: int = 1):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "use_batch_norm=True: the JAX package cannot apply it "
                "either (init_params keeps only 'params', so every apply "
                "lacks the 'batch_stats' collection)")
        self.kernel_size = kernel_size
        self.nb_stacks = nb_stacks
        self.dilations = tuple(dilations)
        self.use_skip_connections = use_skip_connections
        self.return_sequences = return_sequences
        blocks = []
        c = in_channels
        for _ in range(nb_stacks):
            for d in self.dilations:
                blocks.append(ResidualBlock(c, nb_filters, kernel_size, d,
                                            padding, dropout_rate))
                c = nb_filters
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, train: bool = False):
        """``[N, C_in, T]`` → ``[N, nb_filters, T]`` (or ``[N, nb_filters]``)."""
        skips = []
        for block in self.blocks:
            x, branch = block(x, train)
            skips.append(branch)
        if self.use_skip_connections:
            x = sum(s.float() for s in skips).to(x.dtype)
        if not self.return_sequences:
            x = x[:, :, -1]
        return x

    @property
    def receptive_field(self) -> int:
        return 1 + 2 * (self.kernel_size - 1) * self.nb_stacks * sum(
            self.dilations)
