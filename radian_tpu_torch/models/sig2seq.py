"""The sig2seq signal model (counterpart of radian_tpu/models/sig2seq.py).

``[N, T, 1] → TCN → Linear(relu_units) → ReLU → Linear(softmax_units)
→ f32 log-softmax`` (or softmax), one distribution over {A, C, G, U,
blank} per input sample.  Both were plain XLA on the TPU, not Pallas
kernels.  The conv stack takes one of two paths (``tcn.py``): bf16
inference on a CUDA device runs ``ops/tcn_conv.py``'s fused kernels,
channels-last ``[N, T, C]`` throughout, one launch a convolution;
everything else runs ``TCN.forward``'s ``F.conv1d`` (cuDNN on the card)
in ``[N, C, T]``, transposed in and out.  Their rounding points are the
same.  The head is two matrix products (``F.linear``) on ``[N, T, C]``
either way.

``compute_dtype=torch.bfloat16`` runs the convolutions and the head in
bfloat16 like the flax model's ``compute_dtype``: parameters stay
float32 and are cast per layer, the residual sums run in float32 (see
``tcn.py``), and the logits are cast to float32 before the softmax.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from radian_tpu_torch.config import DotDict, default_config
from radian_tpu_torch.models import lstm_crf, tx_crf
from radian_tpu_torch.models.checkpoint import params_from_flax
from radian_tpu_torch.models.init import (
    init_lstm_crf,
    init_params,
    init_tx_crf,
)
from radian_tpu_torch.models.tcn import TCN
from radian_tpu_torch.ops import tcn_conv


class SigToSeq(nn.Module):
    """TCN + dense head.  ``forward`` returns log-probabilities by default."""

    def __init__(self, relu_units: int = 128, softmax_units: int = 5,
                 nb_filters: int = 256, kernel_size: int = 3,
                 nb_stacks: int = 1, dilations=(1, 2, 4, 8, 16, 32),
                 padding: str = "causal", use_skip_connections: bool = False,
                 dropout_rate: float = 0.0, return_sequences: bool = True,
                 use_batch_norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                             "bfloat16")
        self.compute_dtype = compute_dtype
        # the shape-giving fields of the model config, for the seeded init
        self.config = DotDict({"model": {
            "relu_units": relu_units, "softmax_units": softmax_units,
            "tcn": {"nb_filters": nb_filters, "kernel_size": kernel_size,
                    "nb_stacks": nb_stacks, "dilations": list(dilations)}}})
        self.tcn = TCN(nb_filters, kernel_size, nb_stacks, dilations,
                       padding, use_skip_connections, dropout_rate,
                       return_sequences, use_batch_norm)
        self.dense_relu = nn.Linear(nb_filters, relu_units)
        self.dense_out = nn.Linear(relu_units, softmax_units)

    @property
    def receptive_field(self) -> int:
        return self.tcn.receptive_field

    def reset_parameters(self, seed: int = 0):
        """Seeded init: the JAX package's ``init_params(model,
        jax.random.PRNGKey(seed))``, the same numbers (``init.py``)."""
        self.load_state_dict(params_from_flax(init_params(self.config, seed)))

    def forward(self, x, *, train: bool = False, probs: bool = False):
        """``[N, T, 1]`` signal → ``[N, T, softmax_units]`` f32.

        ``train`` is the flax module's flag: it changes nothing but
        dropout, which is a no-op with ``train=False`` and refused with
        ``train=True`` (``tcn.py``)."""
        if x.is_cuda:
            # cuDNN runs f32 convolutions in TF32 by default, which keeps
            # ~3 decimal digits: the probabilities, and so the decoded
            # strings, would drift from the f32 reference.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        dt = self.compute_dtype
        if tcn_conv.engages(self, x, train):
            h = tcn_conv.tcn_forward(self.tcn, x[..., 0].to(dt))
        else:
            h = self.tcn(x.to(dt).transpose(1, 2), train)
            h = h.transpose(-1, -2) if h.dim() == 3 else h  # [N, T, C]
        h = F.relu(_dense(h, self.dense_relu, dt))
        logits = _dense(h, self.dense_out, dt).float()
        if probs:
            return torch.softmax(logits, dim=-1)
        return torch.log_softmax(logits, dim=-1)


def _dense(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype):
    """``layer`` in ``dtype``: an ``nn.Linear``, or its column-parallel
    form (``models/tensor_parallel.py``), which computes in ``x``'s dtype
    (``forward`` passes ``x`` in ``dtype``)."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    return dense(x.to(dtype), layer.weight, layer.bias)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor | None) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``x``'s dtype (``bias`` ``None``: none);
    in bfloat16 the product is rounded before its bias is added, as
    flax's ``nn.Dense`` does."""
    w = weight.to(x.dtype)
    if bias is None:
        return F.linear(x, w)
    if x.dtype == torch.float32:
        return F.linear(x, w, bias)
    return F.linear(x, w) + bias.to(x.dtype)


class CrfFamily(NamedTuple):
    """A Bonito CRF model family: its module, built from a config's
    ``model`` section and a compute dtype, and its seeded init, from
    the section and a seed."""

    model: Callable[..., nn.Module]
    init: Callable[..., dict]


# model.type → its family; a config without a type is radian's SigToSeq
CRF_FAMILIES = {
    tx_crf.MODEL_TYPE: CrfFamily(tx_crf.TxCrfModel, init_tx_crf),
    lstm_crf.MODEL_TYPE: CrfFamily(lstm_crf.LstmCrfModel, init_lstm_crf),
}


def build_model(config: DotDict | None = None,
                compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Construct the config's model: its ``CRF_FAMILIES`` module where it
    has a ``model.type``, else a SigToSeq (defaults to reference
    parity)."""
    cfg = config if config is not None else default_config()
    m = cfg.model
    kind = m.get("type")
    if kind is not None:
        if kind not in CRF_FAMILIES:
            raise ValueError(f"model.type {kind!r}: one of "
                             f"{', '.join(map(repr, CRF_FAMILIES))}, or "
                             "none for radian's SigToSeq")
        return CRF_FAMILIES[kind].model(m, compute_dtype)
    return SigToSeq(
        relu_units=m.relu_units,
        softmax_units=m.softmax_units,
        nb_filters=m.tcn.nb_filters,
        kernel_size=m.tcn.kernel_size,
        nb_stacks=m.tcn.nb_stacks,
        dilations=tuple(m.tcn.dilations),
        padding=m.tcn.padding,
        use_skip_connections=m.tcn.use_skip_connections,
        dropout_rate=m.tcn.dropout_rate,
        return_sequences=m.tcn.return_sequences,
        use_batch_norm=m.tcn.use_batch_norm,
        compute_dtype=compute_dtype,
    )


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
