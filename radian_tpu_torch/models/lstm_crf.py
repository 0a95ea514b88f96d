"""Bonito's LSTM-CRF basecaller (its v4 models), the port's third model
family (``model.type: bonito_lstm_crf`` in the config).

``[N, C]`` normalised chunks → ``[N, T, 4^state_len·5]`` CRF scores,
``T = C / stride`` (the benchmark's plain reference,
``benchmark/core/reference_lstm_crf.py``, states the equations and the
departures from the published model):

- ``stem``: 1-d convolutions with bias and swish, ``[N, 1, C] → [N,
  size, T]``, then Bonito's ``Permute`` to ``[T, N, size]``;
- ``lstm``: ``num_layers`` unidirectional LSTM layers of ``size``, each
  ``torch.nn.LSTM`` (cuDNN's RNN or ATen's fused LSTM cell, whichever
  torch takes for the dtype), in alternating directions: a reversed
  layer runs on the time-flipped input and flips its output back, layer
  ``i`` reversed when ``(num_layers − i) % 2`` is 1, as Bonito's
  ``rnn_encoder`` has it;
- ``crf``: the CRF head (``models/crf_head.py``, shared with the
  transformer-CRF model), with a bias.

The state dict keeps the numbering of Bonito's ``Serial`` encoder:
``encoder.0``–``.2`` the convolutions (``.conv``), ``encoder.3`` the
permute, then a layer each LSTM (``.rnn``), the head last
(``.linear``), so that a Bonito v4 state dict loads as it is.  Each
LSTM layer (its flips and its recurrence) is the span ``radian.lstm``,
and counts its rows × steps in ``lstm_row_steps``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from radian_tpu_torch.config import DotDict
from radian_tpu_torch.models.crf_head import CrfHead
from radian_tpu_torch.utils import profiling

MODEL_TYPE = "bonito_lstm_crf"


class LstmCrfModel(nn.Module):
    """The LSTM-CRF model of a ``bonito_lstm_crf`` config's ``model``
    section, its parameters in ``compute_dtype``."""

    def __init__(self, model: DotDict,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                             "bfloat16")
        self.compute_dtype = compute_dtype
        rnn = model.lstm
        layers = [nn.ModuleDict({"conv": nn.Conv1d(
            s.insize, s.size, s.winlen, stride=s.stride, padding=s.padding)})
            for s in model.stem]
        layers.append(nn.Identity())  # Bonito's Permute: no parameters
        insize = model.stem[-1].size
        for _ in range(rnn.num_layers):
            layers.append(nn.ModuleDict({"rnn": nn.LSTM(insize, rnn.size)}))
            insize = rnn.size
        layers.append(nn.ModuleDict({"linear": CrfHead(rnn.size,
                                                       model.crf)}))
        self.encoder = nn.ModuleList(layers)
        self.n_stem = len(model.stem)
        self.reversed = [(rnn.num_layers - i) % 2 == 1
                         for i in range(rnn.num_layers)]
        self.state_len = model.crf.state_len
        self.sample_stride = self.stride = math.prod(s.stride
                                                     for s in model.stem)
        self.to(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, C]`` normalised chunks → ``[N, T, 4^state_len·5]`` scores
        in ``compute_dtype``."""
        if x.is_cuda:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        h = x.to(self.compute_dtype)[:, None, :]
        for layer in self.encoder[:self.n_stem]:
            h = F.silu(layer.conv(h))
        h = h.permute(2, 0, 1).contiguous()  # [T, N, C]
        for layer, rev in zip(self.encoder[self.n_stem + 1:-1],
                              self.reversed):
            with profiling.span("radian.lstm", h.device):
                profiling.count("lstm_row_steps", h.shape[0] * h.shape[1])
                h = layer.rnn(h.flip(0) if rev else h)[0]
                if rev:
                    h = h.flip(0)
        # [N, T, size] before the head, so that its scores are [N, T, ·]
        h = h.transpose(0, 1).contiguous()
        return self.encoder[-1].linear(h)
