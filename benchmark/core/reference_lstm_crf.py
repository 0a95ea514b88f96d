"""Plain float32 reference of Bonito's v4 LSTM-CRF basecaller.

Written from Bonito's published sources (https://github.com/nanoporetech/
bonito: ``bonito/crf/model.py``'s ``rnn_encoder``, ``LinearCRFEncoder``
and ``CTC_CRF``; ``bonito/nn.py``'s ``Convolution``, ``Permute``,
``LSTM`` / ``RNNWrapper`` and ``Serial``) at the widths of
``dna_r10.4.1_e8.2_400bps_sup@v4.2.0``.  It imports only ``torch``,
``numpy`` and the transformer-CRF reference
(``core/reference_tx_crf.py``), whose MAD normalisation, chunks,
Viterbi decode and stitch are the same for this model: nothing of the
port, no kernel, no cache.  The benchmark holds the port to it, and so
do the port's CPU tests.  It also draws the seeded weights both sides
take (``bonito_lstm_init``), under Bonito's state-dict names, so that
the port's reading of them is checked.

The model, in float32 with TF32 off (``rounding`` computes every
product in a lower precision instead), on ``[N, C]`` chunks at once
(the rows are independent):

- stem: 1-d convolutions with bias, each followed by swish ``x·σ(x)``,
  then ``Permute`` to ``[T, N, C]``;
- ``num_layers`` unidirectional LSTM layers, a step at a time:
  ``g = W_ih·x_t + b_ih + W_hh·h_{t−1} + b_hh`` with gate rows in the
  order i, f, g, o; ``c_t = σ(f)⊙c_{t−1} + σ(i)⊙tanh(g)``, ``h_t =
  σ(o)⊙tanh(c_t)``, ``h_0 = c_0 = 0`` in every chunk (the input
  products of all steps are one product, as they do not depend on the
  recurrence).  Layer ``i`` runs on the time-flipped input and flips its
  output back when Bonito's ``(num_layers − i) % 2`` is 1 (with an odd
  ``num_layers``, the first layer and then every other one);
- ``LinearCRFEncoder``: a linear layer with bias to ``4^state_len·4``
  scores, ``tanh`` times ``scale``, with ``blank_score`` put in front of
  each state's 4 move scores: ``[N, T, 4^state_len·5]``.

Departures from the published model (each also in the benchmark's
configuration file):

- MAD normalisation (``(x − median) / (1.4826·MAD)``, clipped) replaces
  the pA standardisation: the reads carry no pA calibration;
- the decode is Viterbi, not koi's beam search;
- the weights are drawn from a seed with Bonito's init, some of them
  scaled by the configuration's ``init_gains``: no published weights
  are loaded;
- the program's scores are bf16 (Dorado's are fp16).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core import reference_tx_crf as tx

# -- the weights ------------------------------------------------------------


def param_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, named as in Bonito's ``Serial`` encoder (the
    convolutions, the permute, a layer each LSTM, the head), and its
    shape, in the order ``bonito_lstm_init`` draws them."""
    shapes: dict[str, tuple[int, ...]] = {}
    for i, s in enumerate(model["stem"]):
        shapes[f"encoder.{i}.conv.weight"] = (s["size"], s["insize"],
                                              s["winlen"])
        shapes[f"encoder.{i}.conv.bias"] = (s["size"],)
    h, insize = model["lstm"]["size"], model["stem"][-1]["size"]
    for i in lstm_layers(model):
        shapes[f"encoder.{i}.rnn.weight_ih_l0"] = (4 * h, insize)
        shapes[f"encoder.{i}.rnn.weight_hh_l0"] = (4 * h, h)
        shapes[f"encoder.{i}.rnn.bias_ih_l0"] = (4 * h,)
        shapes[f"encoder.{i}.rnn.bias_hh_l0"] = (4 * h,)
        insize = h
    out = 4 ** model["crf"]["state_len"] * 4
    shapes[f"{head(model)}.weight"] = (out, h)
    shapes[f"{head(model)}.bias"] = (out,)
    return shapes


def lstm_layers(model: dict) -> list[int]:
    """The LSTM layers' places in the ``Serial`` encoder."""
    first = len(model["stem"]) + 1  # after the permute
    return list(range(first, first + model["lstm"]["num_layers"]))


def head(model: dict) -> str:
    """The CRF head's name, last in the ``Serial`` encoder."""
    return f"encoder.{lstm_layers(model)[-1] + 1}.linear"


def bonito_lstm_init(model: dict, seed: int,
                     gains: dict | None = None) -> dict[str, np.ndarray]:
    """Float32 weights from ``seed`` with Bonito's init
    (``RNNWrapper``): each ``size``-row gate block of ``weight_ih`` and
    ``weight_hh`` orthogonal (``torch.nn.init.orthogonal_``: the Q of a
    normal matrix's QR, its columns signed by R's diagonal); ``bias_ih``
    0.5 times Bonito's ``truncated_normal`` (of 5 normal draws, the first
    inside ±2, else the first, clamped to ±2); ``bias_hh`` zero
    (``disable_state_bias``); the convolutions and the head keep
    PyTorch's default, uniform in ``±1/sqrt(fan_in)``.  One numpy
    generator, the parameters in ``param_shapes``' order.

    ``gains`` (a configuration's ``init_gains``) then multiplies the
    convolutions' weights (``conv_weight``), every layer's ``weight_ih``
    (``lstm_weight_ih``) and the head's weight (``crf_head_weight``),
    each 1 if left out: untrained, Bonito's init gives scores that hardly
    follow the signal (each layer passes on a third to a half of its
    input's change over time), and the Viterbi path then stays, or
    moves, at every step."""
    rng = np.random.default_rng(int(seed) & (2**64 - 1))
    h = model["lstm"]["size"]

    def orthogonal(rows, cols):
        a = rng.normal(0.0, 1.0, (rows, cols))
        if rows < cols:
            a = a.T
        q, r = np.linalg.qr(a)
        q *= np.sign(np.diag(r))
        return (q.T if rows < cols else q).astype(np.float32)

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for name, shape in param_shapes(model).items():
        leaf = name.rsplit(".", 1)[1]
        if leaf.startswith("weight_"):
            out[name] = np.concatenate([orthogonal(h, shape[1])
                                        for _ in range(4)])
        elif leaf.startswith("bias_ih"):
            x = rng.normal(0.0, 1.0, (*shape, 5))
            pick = ((x > -2) & (x < 2)).argmax(-1)[..., None]
            x = np.clip(np.take_along_axis(x, pick, -1)[..., 0], -2, 2)
            out[name] = (0.5 * x).astype(np.float32)
        elif leaf.startswith("bias_hh"):
            out[name] = np.zeros(shape, np.float32)
        elif ".conv." in name:
            s = model["stem"][int(name.split(".")[1])]
            out[name] = uniform(shape, s["insize"] * s["winlen"])
        else:
            out[name] = uniform(shape, h)
    gains = gains or {}
    for name in out:
        if name.endswith(".conv.weight"):
            out[name] *= np.float32(gains.get("conv_weight", 1.0))
        elif name.endswith(".rnn.weight_ih_l0"):
            out[name] *= np.float32(gains.get("lstm_weight_ih", 1.0))
        elif name == f"{head(model)}.weight":
            out[name] *= np.float32(gains.get("crf_head_weight", 1.0))
    return out


# -- the model --------------------------------------------------------------

def stride(model: dict) -> int:
    """Samples a decoded step: the stem's stride (no upsampling)."""
    return math.prod(s["stride"] for s in model["stem"])


def stem(p, model: dict, x: torch.Tensor, rounding=None) -> torch.Tensor:
    """``[N, C]`` samples → ``[T, N, size]`` (after the permute)."""
    h = x[:, None]
    for i, layer in enumerate(model["stem"]):
        w = tx.round_to(p[f"encoder.{i}.conv.weight"], rounding)
        h = F.conv1d(tx.round_to(h, rounding), w, p[f"encoder.{i}.conv.bias"],
                     stride=layer["stride"], padding=layer["padding"])
        h = h * torch.sigmoid(h)
    return h.permute(2, 0, 1)


def lstm(p, i: int, x: torch.Tensor, reverse: bool, rounding=None):
    """LSTM layer ``i`` over ``[T, N, in]`` → ``[T, N, size]``, a step at
    a time."""
    pre = f"encoder.{i}.rnn"
    if reverse:
        x = x.flip(0)
    xg = tx.linear(x, p[f"{pre}.weight_ih_l0"], p[f"{pre}.bias_ih_l0"],
                   rounding)
    w_hh = tx.round_to(p[f"{pre}.weight_hh_l0"], rounding)
    b_hh = p[f"{pre}.bias_hh_l0"]
    n, size = x.shape[1], w_hh.shape[1]
    h = torch.zeros(n, size, device=x.device)
    c = torch.zeros(n, size, device=x.device)
    out = []
    for t in range(x.shape[0]):
        g = xg[t] + tx.round_to(h, rounding) @ w_hh.T + b_hh
        gi, gf, gg, go = g.chunk(4, -1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        out.append(h)
    y = torch.stack(out)
    return y.flip(0) if reverse else y


def forward(p, model: dict, chunks: torch.Tensor, rounding=None):
    """Chunks ``[N, C]`` of normalised samples → their CRF scores ``[N,
    T, 4^state_len·5]`` float32, ``T = C / stride``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = stem(p, model, chunks.float(), rounding)
    n = model["lstm"]["num_layers"]
    for k, i in enumerate(lstm_layers(model)):
        x = lstm(p, i, x, (n - k) % 2 == 1, rounding)
    crf, name = model["crf"], head(model)
    s = torch.tanh(tx.linear(x.transpose(0, 1), p[f"{name}.weight"],
                             p[f"{name}.bias"], rounding)) * crf["scale"]
    s = s.view(*s.shape[:2], -1, 4)
    blank = torch.full_like(s[..., :1], crf["blank_score"])
    return torch.cat([blank, s], -1).reshape(*s.shape[:2], -1)


def read_scores(p, model: dict, signal: np.ndarray, size: int, overlap: int,
                clip: float, device, rounding=None):
    """A read's chunks' scores ``[n, T, 4^state_len·5]``, its chunks in
    one forward; None for a read whose MAD is zero."""
    norm = tx.mad_normalise(signal, clip)
    if norm is None:
        return None
    ch = torch.from_numpy(tx.chunks(norm, size, overlap)).to(device)
    return forward(p, model, ch, rounding)


def basecall(p, model: dict, signal: np.ndarray, size: int, overlap: int,
             clip: float, device, rounding=None):
    """A read's string (None: skipped) from its raw samples."""
    s = read_scores(p, model, signal, size, overlap, clip, device, rounding)
    if s is None:
        return None
    paths = tx.viterbi(s, model["crf"]["state_len"]).cpu().numpy()
    return tx.stitch(paths, len(signal), size, overlap, stride(model))
