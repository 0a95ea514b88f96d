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

Training keeps the parameters in float32 (``compute_dtype`` float32)
under ``torch.autocast``: the convolutions and the head take autocast's
dtype, and each LSTM layer runs in it by explicit casts of its input
and weights (cuDNN's bf16 RNN on the card, forward and backward), not
by autocast's own rule for the RNN.  On the card such a layer, casts
included, runs as two CUDA graphs, its forward and its backward
(``torch.cuda.make_graphed_callables``), captured at its first input
shape, which every later step must keep: cuDNN launches a GEMM, a
reduction and a cell kernel a step each way, some 10,000 launches a
layer a training step of 1,666 steps, each too short at 64 rows to hide
the next one's launch.

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
            lstm = nn.LSTM(insize, rnn.size)
            # Bonito's disable_state_bias: bias_hh stays zero, untrained
            lstm.bias_hh_l0.requires_grad_(False)
            layers.append(nn.ModuleDict({"rnn": lstm}))
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
        # a layer's training graphs on the card: (the input's shape and
        # dtype they were captured at, the graphed layer), by layer
        self._graphs: dict[int, tuple[tuple, nn.Module]] = {}
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
        layers = self.encoder[self.n_stem + 1:-1]
        for i, (layer, rev) in enumerate(zip(layers, self.reversed)):
            with profiling.span("radian.lstm", h.device):
                profiling.count("lstm_row_steps", h.shape[0] * h.shape[1])
                h = self._recur(i, layer.rnn, h.flip(0) if rev else h)
                if rev:
                    h = h.flip(0)
        # [N, T, size] before the head, so that its scores are [N, T, ·]
        h = h.transpose(0, 1).contiguous()
        return self.encoder[-1].linear(h)

    def _recur(self, i: int, rnn: nn.LSTM, h: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s output over ``h``; under autocast, in autocast's
        dtype (:class:`_CastLstm`), graphed when it trains on the card."""
        dev = h.device.type
        if not torch.is_autocast_enabled(dev):
            return rnn(h)[0]
        if not (h.is_cuda and torch.is_grad_enabled()):
            return _CastLstm(rnn, torch.get_autocast_dtype(dev))(h)
        seen = (tuple(h.shape), h.dtype)
        if i not in self._graphs:
            layer = _CastLstm(rnn, torch.get_autocast_dtype(dev))
            with torch.autocast(dev, enabled=False):
                sample = torch.zeros_like(h).requires_grad_(h.requires_grad)
                self._graphs[i] = seen, torch.cuda.make_graphed_callables(
                    layer, (sample,))
        captured, graphed = self._graphs[i]
        if seen != captured:
            raise ValueError(
                f"LSTM layer {i}'s training graphs were captured for inputs "
                f"{captured}, not {seen}: a model trains at one batch shape")
        return graphed(h)


class _CastLstm(nn.Module):
    """An LSTM layer run in ``dtype``: its input and weights cast
    (differentiably) to it, autocast off inside."""

    def __init__(self, rnn: nn.LSTM, dtype: torch.dtype):
        super().__init__()
        self.rnn, self.dtype = rnn, dtype

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        with torch.autocast(h.device.type, enabled=False):
            weights = {k: p.to(self.dtype)
                       for k, p in self.rnn.named_parameters()}
            return torch.func.functional_call(self.rnn, weights,
                                              (h.to(self.dtype),))[0]
