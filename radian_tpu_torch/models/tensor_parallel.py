"""Tensor parallelism over a mesh's ``model`` axis, inside one process.

The JAX package shards conv and dense kernels over ``'model'`` with
GSPMD (``param_shardings``; XLA inserts the collectives), so it has no
module like this one.  Here a process owns one row of ``M`` devices of
a ``[data, model]`` mesh (``parallel/mesh.py``: ``Mesh.model_row``), and
:func:`shard_model` turns a ``SigToSeq`` into its column-parallel form
on that row:

- each ``CausalConv1D`` and ``nn.Linear`` whose weight the rule splits
  keeps shard ``j`` of its weight (and of its bias, where the rule
  splits that too) on device ``j``, as parameter ``weight.j``
  (``bias.j``);
- the layer sends its input to each device, computes each shard's
  output channels there, and concatenates them along the channel axis
  on the row's first device, where a bias the rule keeps whole is then
  added;
- everything replicated (the residual sums, the ReLUs, the softmax,
  every whole leaf) runs once, on that first device.

The shards' names are the leaf's plus ``.j``, so
``models/checkpoint.py``'s ``gather_params`` gives back the full leaves
(and its ``params_to_flax`` the unsharded model's npz) and
``split_params`` splits full leaves to a sharded model's keys.

``.to(device)`` and ``torch.cat`` are differentiable, so autograd
carries the gradients back over the copies, and the gradient of a
layer's replicated input is the sum of its shard branches', which
autograd forms itself.  Each shard rounds as the whole layer does
(``tcn.causal_conv1d``, ``sig2seq.dense``: in bfloat16 the product is
rounded before its bias is added).  A split convolution need not be bit
for bit the whole one: cuDNN and oneDNN choose algorithms by shape.

On one card every device of the row is ``cuda:0`` and each ``.to`` is a
no-op: the split convolutions and the concatenations still run.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from radian_tpu_torch.models.checkpoint import flax_name
from radian_tpu_torch.models.sig2seq import SigToSeq, dense
from radian_tpu_torch.models.tcn import CausalConv1D, causal_conv1d


class ColumnParallel(nn.Module):
    """A ``CausalConv1D`` or ``nn.Linear`` split over its output channels,
    one equal shard a device of ``devices``; its bias split too
    (``split_bias``) or kept whole on ``devices[0]``.  The input and the
    output live on ``devices[0]``."""

    def __init__(self, layer: nn.Module, devices: Sequence[torch.device],
                 split_bias: bool):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.conv = isinstance(layer, CausalConv1D)
        self.dilation = layer.dilation if self.conv else 1
        m = len(self.devices)
        if layer.weight.shape[0] % m:
            raise ValueError(f"{layer.weight.shape[0]} output channels do "
                             f"not split over {m} devices")

        def shards(t: torch.Tensor) -> nn.ParameterList:
            return nn.ParameterList(
                nn.Parameter(part.detach().to(d, copy=True))
                for part, d in zip(t.chunk(m), self.devices))

        self.weight = shards(layer.weight)
        self.bias = (shards(layer.bias) if split_bias else nn.Parameter(
            layer.bias.detach().to(self.devices[0], copy=True)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, C_in, T]`` (a conv) or ``[..., C_in]`` (a dense layer) →
        the layer's output, on ``devices[0]``, in ``x``'s dtype."""
        split_bias = isinstance(self.bias, nn.ParameterList)
        biases = self.bias if split_bias else [None] * len(self.devices)
        home = self.devices[0]
        parts = []
        for d, w, b in zip(self.devices, self.weight, biases):
            xd = x.to(d)
            parts.append(causal_conv1d(xd, w, b, self.dilation) if self.conv
                         else dense(xd, w, b))
        y = torch.cat([p.to(home) for p in parts], dim=1 if self.conv else -1)
        if split_bias:
            return y
        b = self.bias.to(y.dtype)
        return y + (b[:, None] if self.conv else b)


def shard_model(model: SigToSeq, mesh_row: Sequence[torch.device],
                shardings: dict[str, int | None]) -> SigToSeq:
    """``model``, in place, split over ``mesh_row`` by ``shardings``
    (``parallel.param_shardings``: ``{flax path: split dim or None}``):
    every layer whose weight is split becomes a :class:`ColumnParallel`
    over the row, everything else moves to ``mesh_row[0]``.  With no leaf
    split (a model axis of 1) this is ``model.to(mesh_row[0])``."""
    row = [torch.device(d) for d in mesh_row]
    model.to(row[0])
    for name, layer in list(model.named_modules()):
        if not isinstance(layer, (CausalConv1D, nn.Linear)):
            continue
        if shardings[flax_name(f"{name}.weight")] is None:
            continue
        split_bias = shardings[flax_name(f"{name}.bias")] is not None
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr,
                ColumnParallel(layer, row, split_bias))
    return model
