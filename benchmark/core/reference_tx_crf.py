"""Plain float32 reference of Bonito's v5 transformer-CRF basecaller.

Written from Bonito's published sources (https://github.com/nanoporetech/
bonito: ``bonito/transformer/model.py``, ``bonito/crf/model.py``,
``bonito/nn.py``, ``bonito/util.py``'s ``chunk`` / ``stitch`` and
``bonito/crf/basecall.py``'s ``stitch_results``) at the widths of
``dna_r10.4.1_e8.2_400bps_sup@v5.0.0``.  It imports only ``torch`` and
``numpy``: nothing of the port, no kernel, no batching and no cache.
The benchmark holds the port to it, and so do the port's CPU tests and
``chip_smoke.py``.  It also draws the seeded weights both sides take
(``bonito_init``), so that the port's layout of them is checked, not
assumed.

The model, one chunk of ``chunksize`` samples at a time, in float32
with TF32 off (``rounding`` below computes every product in a lower
precision instead):

- stem: 1-d convolutions with bias, each followed by swish ``x·σ(x)``;
- ``num_layers`` DeepNorm post-norm encoder layers, ``x = RMSNorm(MHA(x)
  + α·x)`` then ``x = RMSNorm(FF(x) + α·x)``: multi-head attention with
  a fused ``Wqkv`` (no bias), rotary embeddings on every dimension of q
  and k (non-interleaved halves, positions 0…T′−1 of the chunk), dense
  softmax attention masked to the window ``i−left ≤ j ≤ i+right``, and
  ``out_proj`` with bias; FF is SwiGLU, ``fc2(y·silu(gate))`` with
  ``(y, gate)`` the halves of ``fc1(x)`` (no biases);
- ``LinearUpsample``: a linear layer to ``scale_factor·d_model`` with
  bias, reshaped to ``scale_factor`` steps a token;
- ``LinearCRFEncoder``: a linear layer (no bias) to ``4^state_len·4``
  scores, ``tanh`` times ``scale``, with ``blank_score`` put in front of
  each state's 4 move scores: ``[T, 4^state_len·5]``.

The decode is the Viterbi path of Bonito's ``CTC_CRF``: a state is the
last ``state_len`` bases, the newest in the low 2 bits; column 0 of a
state's scores is the stay and column ``1+r`` the move from the state
that drops base ``r``; α starts at 0 for every state, and ties go to the
lowest column, then to the lowest final state.  A move into state ``s``
emits ``"ACGT"[s % 4]``.

Departures from the published model (each also in the benchmark's
configuration file):

- MAD normalisation (``(x − median) / (1.4826·MAD)``, clipped) replaces
  v5's pA standardisation: the reads carry no pA calibration;
- the stem has no normalisation layer (assumed);
- the CRF head's ``tanh``·``scale`` (scale 5) is assumed;
- the decode is Viterbi, not the closed beam search (beam 32) of Dorado's
  kernels;
- the weights are drawn from a seed with Bonito's init: no published
  weights are loaded;
- the program's scores are bf16 (Dorado's are fp16).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BASES = "ACGT"
MAD_SCALE = 1.4826


# -- precisions -----------------------------------------------------------

def round_to(x: torch.Tensor, rounding: str | None) -> torch.Tensor:
    """``x`` (float32) rounded to ``rounding``'s precision, kept float32
    (None: unchanged; 'bf16'; 'tf32'; 'fp8': e4m3 with one scale a
    tensor)."""
    if rounding is None:
        return x
    if rounding == "bf16":
        return x.to(torch.bfloat16).float()
    if rounding == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if rounding == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown rounding {rounding!r}")


def linear(x, w, b=None, rounding=None):
    """``x @ w.T (+ b)``, the product's operands in ``rounding``."""
    y = round_to(x, rounding) @ round_to(w, rounding).T
    return y if b is None else y + b


# -- the weights ------------------------------------------------------------

def param_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, named as in Bonito's modules (``Wqkv`` is ``[Q; K;
    V]`` rows, ``fc1`` is ``[y; gate]`` rows, the CRF head's rows are
    state-major with the 4 moves of a state together), and its shape, in
    the order ``bonito_init`` draws them."""
    shapes: dict[str, tuple[int, ...]] = {}
    for i, s in enumerate(model["stem"]):
        shapes[f"stem.{i}.weight"] = (s["size"], s["insize"], s["winlen"])
        shapes[f"stem.{i}.bias"] = (s["size"],)
    enc = model["encoder"]
    d, ff = enc["d_model"], enc["dim_feedforward"]
    for i in range(enc["num_layers"]):
        pre = f"encoder.{i}"
        shapes[f"{pre}.self_attn.Wqkv.weight"] = (3 * d, d)
        shapes[f"{pre}.self_attn.out_proj.weight"] = (d, d)
        shapes[f"{pre}.self_attn.out_proj.bias"] = (d,)
        shapes[f"{pre}.ff.fc1.weight"] = (2 * ff, d)
        shapes[f"{pre}.ff.fc2.weight"] = (d, ff)
        shapes[f"{pre}.norm1.weight"] = (d,)
        shapes[f"{pre}.norm2.weight"] = (d,)
    up = model["upsample"]["scale_factor"]
    shapes["upsample.weight"] = (up * d, d)
    shapes["upsample.bias"] = (up * d,)
    shapes["crf.weight"] = (4 ** model["crf"]["state_len"] * 4, d)
    return shapes


def bonito_init(model: dict, seed: int) -> dict[str, np.ndarray]:
    """Float32 weights from ``seed`` with Bonito's init: its
    ``TransformerEncoderLayer.reset_parameters`` draws ``fc1``, ``fc2``,
    ``out_proj`` and the V rows of ``Wqkv`` Xavier-normal with the
    DeepNorm gain ``deepnorm_beta``, the Q and K rows with gain 1 (each
    slice its own fans); every other weight and bias keeps PyTorch's
    default, uniform in ``±1/sqrt(fan_in)``; RMSNorm weights are ones.
    One numpy generator, the parameters in ``param_shapes``' order."""
    rng = np.random.default_rng(int(seed) & (2**64 - 1))
    enc = model["encoder"]
    beta, d = enc["deepnorm_beta"], enc["d_model"]

    def xavier(rows, cols, gain):
        std = gain * math.sqrt(2.0 / (rows + cols))
        return rng.normal(0.0, std, (rows, cols)).astype(np.float32)

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for name, shape in param_shapes(model).items():
        if name.endswith(("norm1.weight", "norm2.weight")):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("Wqkv.weight"):
            out[name] = np.concatenate([xavier(2 * d, d, 1.0),
                                        xavier(d, d, beta)])
        elif name.endswith(("fc1.weight", "fc2.weight",
                            "out_proj.weight")):
            out[name] = xavier(*shape, beta)
        elif name.startswith("stem."):
            s = model["stem"][int(name.split(".")[1])]
            out[name] = uniform(shape, s["insize"] * s["winlen"])
        else:
            out[name] = uniform(shape, d)
    return out


# -- the model --------------------------------------------------------------

def params(weights: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The weights as float32 tensors on ``device``, names kept."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in weights.items()}


def stem(p, model: dict, x: torch.Tensor, rounding=None) -> torch.Tensor:
    """``[C]`` samples → ``[T′, d_model]`` tokens."""
    h = x[None, None]
    for i, layer in enumerate(model["stem"]):
        w = round_to(p[f"stem.{i}.weight"], rounding)
        h = F.conv1d(round_to(h, rounding), w, p[f"stem.{i}.bias"],
                     stride=layer["stride"], padding=layer["padding"])
        h = h * torch.sigmoid(h)
    return h[0].T


def rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotary embedding of ``[T, H, D]`` at positions ``0…T−1``, the two
    halves of each head rotated together."""
    t, _, d = x.shape
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=x.device,
                                      dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p, pre: str, enc: dict, x: torch.Tensor, rounding=None):
    """Windowed multi-head self-attention of ``[T′, d]`` tokens, dense
    scores masked outside ``i−left ≤ j ≤ i+right``."""
    t, d = x.shape
    h = enc["nhead"]
    hd = d // h
    qkv = linear(x, p[f"{pre}.self_attn.Wqkv.weight"], None,
                 rounding).view(t, 3, h, hd)
    q = rotary(qkv[:, 0], enc["rotary_base"])
    k = rotary(qkv[:, 1], enc["rotary_base"])
    v = qkv[:, 2]
    s = torch.einsum("ihd,jhd->hij", round_to(q, rounding),
                     round_to(k, rounding)) / math.sqrt(hd)
    left, right = enc["attn_window"]
    i = torch.arange(t, device=x.device)
    off = i[None, :] - i[:, None]
    s = s.masked_fill(~((off >= -left) & (off <= right)), float("-inf"))
    a = torch.softmax(s, -1)
    o = torch.einsum("hij,jhd->ihd", round_to(a, rounding),
                     round_to(v, rounding)).reshape(t, d)
    return linear(o, p[f"{pre}.self_attn.out_proj.weight"],
                  p[f"{pre}.self_attn.out_proj.bias"], rounding)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def encoder_layer(p, i: int, enc: dict, x: torch.Tensor, rounding=None):
    pre = f"encoder.{i}"
    alpha, eps = enc["deepnorm_alpha"], enc["norm_eps"]
    x = rms_norm(attention(p, pre, enc, x, rounding) + alpha * x,
                 p[f"{pre}.norm1.weight"], eps)
    y, gate = linear(x, p[f"{pre}.ff.fc1.weight"], None,
                     rounding).chunk(2, -1)
    ff = linear(y * F.silu(gate), p[f"{pre}.ff.fc2.weight"], None, rounding)
    return rms_norm(ff + alpha * x, p[f"{pre}.norm2.weight"], eps)


def forward(p, model: dict, chunk: torch.Tensor, rounding=None):
    """One chunk ``[C]`` of normalised samples → its CRF scores ``[T,
    4^state_len·5]`` float32, ``T = C / stride``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc, crf = model["encoder"], model["crf"]
    x = stem(p, model, chunk.float(), rounding)
    for i in range(enc["num_layers"]):
        x = encoder_layer(p, i, enc, x, rounding)
    up = model["upsample"]["scale_factor"]
    x = linear(x, p["upsample.weight"], p["upsample.bias"], rounding)
    x = x.reshape(x.shape[0] * up, -1)
    s = torch.tanh(linear(x, p["crf.weight"], None, rounding)) * crf["scale"]
    s = s.view(s.shape[0], -1, 4)
    blank = torch.full_like(s[..., :1], crf["blank_score"])
    return torch.cat([blank, s], -1).reshape(s.shape[0], -1)


def stride(model: dict) -> int:
    """Samples a decoded step: the stem's stride over the upsampling."""
    total = math.prod(layer["stride"] for layer in model["stem"])
    return total // model["upsample"]["scale_factor"]


# -- signal, chunks and stitch ---------------------------------------------

def mad_normalise(signal: np.ndarray, clip: float):
    """``(x − median) / (1.4826·MAD)`` clipped to ``±clip``, float32; None
    for a read whose MAD is zero (it is skipped)."""
    x = np.asarray(signal, np.float64)
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    if not mad > 0:
        return None
    z = np.clip((x - med) / (MAD_SCALE * mad), -clip, clip)
    return z.astype(np.float32)


def chunk_starts(length: int, size: int, overlap: int) -> list[int]:
    """Bonito's ``chunk``: the start of each chunk of a read of ``length``
    samples.  A read shorter than a chunk is one chunk (tiled, start 0);
    else the chunks step by ``size − overlap`` from ``stub = (length −
    overlap) mod (size − overlap)``, with ``[0, size)`` put in front when
    ``stub > 0``."""
    if length < size:
        return [0]
    stub = (length - overlap) % (size - overlap)
    n = (length - stub - overlap) // (size - overlap)
    starts = [stub + i * (size - overlap) for i in range(n)]
    return ([0] + starts) if stub > 0 else starts


def chunks(signal: np.ndarray, size: int, overlap: int) -> np.ndarray:
    """``[n, size]`` chunks of a read; a short read repeated up to
    ``size`` samples."""
    n = len(signal)
    if n < size:
        return signal[np.arange(size) % n][None]
    return np.stack([signal[s:s + size]
                     for s in chunk_starts(n, size, overlap)])


def kept_steps(length: int, size: int, overlap: int,
               step: int) -> list[tuple[int, int]]:
    """Bonito's ``stitch`` / ``stitch_results``: the steps ``[lo, hi)`` of
    each chunk that the read's path keeps.  A short read keeps its first
    ``length // step``; a read of one chunk all of it; else the first
    chunk ``[0, first_end)``, the middle ones ``[semi, size − semi)`` and
    the last ``[semi, size)``, in steps, ``semi = overlap // 2``."""
    steps = size // step
    if length < size:
        return [(0, length // step)]
    n = len(chunk_starts(length, size, overlap))
    if n == 1:
        return [(0, steps)]
    semi = overlap // 2
    start, end = semi // step, (size - semi) // step
    stub = (length - overlap) % (size - overlap)
    first_end = (stub + semi) // step if stub > 0 else end
    return [(0, first_end)] + [(start, end)] * (n - 2) + [(start, steps)]


def viterbi(scores: torch.Tensor, state_len: int) -> torch.Tensor:
    """The Viterbi path of ``[N, T, 4^state_len·5]`` scores → ``[N, T]``
    int8: the base a move into step ``t``'s state emits, -1 for a stay.
    Sums in float32."""
    n, t_len, _ = scores.shape
    s_n = 4 ** state_len
    sc = scores.float().view(n, t_len, s_n, 5)
    dev = scores.device
    states = torch.arange(s_n, device=dev)
    prev = [r * (s_n // 4) + states // 4 for r in range(4)]
    alpha = torch.zeros(n, s_n, device=dev)
    bp = torch.empty(n, t_len, s_n, dtype=torch.uint8, device=dev)
    for t in range(t_len):
        best = alpha + sc[:, t, :, 0]
        col = torch.zeros(n, s_n, dtype=torch.uint8, device=dev)
        for r in range(4):
            v = alpha[:, prev[r]] + sc[:, t, :, 1 + r]
            better = v > best
            best = torch.where(better, v, best)
            col = torch.where(better, torch.full_like(col, r + 1), col)
        alpha = best
        bp[:, t] = col
    top = alpha.max(1, keepdim=True).values
    state = torch.where(alpha == top, states, s_n).min(1).values
    path = torch.empty(n, t_len, dtype=torch.int8, device=dev)
    rows = torch.arange(n, device=dev)
    for t in reversed(range(t_len)):
        c = bp[rows, t, state].long()
        path[:, t] = torch.where(c > 0, state % 4, -1).to(torch.int8)
        state = torch.where(c > 0, (c - 1) * (s_n // 4) + state // 4, state)
    return path


def stitch(paths: np.ndarray, length: int, size: int, overlap: int,
           step: int) -> str:
    """A read's string from its chunks' paths ``[n, T]``."""
    out = []
    for path, (lo, hi) in zip(paths, kept_steps(length, size, overlap, step)):
        seg = np.asarray(path[lo:hi])
        out.extend(BASES[b] for b in seg[seg >= 0])
    return "".join(out)


def read_scores(p, model: dict, signal: np.ndarray, size: int, overlap: int,
                clip: float, device, rounding=None):
    """A read's chunks' scores ``[n, T, 4^state_len·5]``, one chunk at a
    time; None for a read whose MAD is zero."""
    norm = mad_normalise(signal, clip)
    if norm is None:
        return None
    ch = torch.from_numpy(chunks(norm, size, overlap)).to(device)
    return torch.stack([forward(p, model, c, rounding) for c in ch])


def basecall(p, model: dict, signal: np.ndarray, size: int, overlap: int,
             clip: float, device, rounding=None):
    """A read's string (None: skipped) from its raw samples."""
    s = read_scores(p, model, signal, size, overlap, clip, device, rounding)
    if s is None:
        return None
    paths = viterbi(s, model["crf"]["state_len"]).cpu().numpy()
    return stitch(paths, len(signal), size, overlap, stride(model))
