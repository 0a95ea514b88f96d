"""Seeded parameter init, equal to the JAX package's ``init_params``.

The JAX package draws a fresh model's weights with
``model.init(jax.random.PRNGKey(seed), ...)`` (flax ``he_normal``
kernels, zero biases).  This module rebuilds those numbers in numpy, so
``--seed`` gives the same weights, and so the same strings, in both
packages:

- ``threefry2x32``, ``fold_in`` and ``random_bits``: JAX's default PRNG,
  the Threefry-2x32 hash, with the partitionable bit stream (each
  element hashes its flat index, split into high and low 32-bit words,
  and keeps the XOR of the two output words);
- ``_fold_in_static``: flax's per-parameter key, one ``fold_in`` of the
  first 4 bytes (big-endian) of a SHA-1 over the module path and the
  scope's ``make_rng`` counter;
- ``truncated_normal`` and ``he_normal``: ``jax.random.truncated_normal``
  (a uniform on ``[erf(-√2), erf(√2))`` through ``√2·erfinv``, clipped
  inside ``(-2, 2)``) times ``sqrt(2/fan_in)/0.87962566``, every step in
  float32 in JAX's order.  ``erfinv`` is XLA's float32 polynomial
  (``ErfInv32``) over XLA's CPU ``log1p`` and ``log``, with the
  multiply-adds fused where XLA's CPU code fuses them, so the weights
  equal those the JAX package draws on the CPU, bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

import numpy as np

from radian_tpu_torch.config import DotDict, default_config

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# lax.erf(∓2/√2) in float32, the uniform's bounds in
# jax.random.truncated_normal(key, -2, 2): ∓0.95449972, the correctly
# rounded erf(√2)
_ERF_LO = np.array(0xBF745A18, np.uint32).view(np.float32)
_ERF_HI = np.array(0x3F745A18, np.uint32).view(np.float32)

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): a degree-8
# polynomial in w - 2.5 where w = -log1p(-x²) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941], np.float32)
_ERFINV_GE5 = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682], np.float32)

# XLA's CPU log1p: below sqrt(2)-1 in magnitude, Cephes' rational
# x - x²/2 + x³·N(x)/D(x) (highest degree first), else log(1 + x)
_LOG1P_N = np.array(
    [4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
     6.5787325942061044846969e0, 2.9911919328553073277375e1,
     6.0949667980987787057556e1, 5.7112963590585538103336e1,
     2.0039553499201281259648e1], np.float32)
_LOG1P_D = np.array(
    [1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
     2.2176239823732856465394e2, 3.0909872225312059774938e2,
     2.1642788614495947685003e2, 6.0118660497603843919306e1], np.float32)
# XLA's CPU log (Eigen's plog, from Cephes): p0..p8, q1, q2
_LOG_P = np.array(
    [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
     3.3333331174e-1], np.float32)
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key = (k0, k1)``; uint32 arrays in, the two output words out."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` on the partitionable stream."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _fold_in_static(key, data: Iterable[str | int]) -> np.ndarray:
    """flax's static fold-in: one SHA-1 over the strings and ints of
    ``data`` (flax's default, no separator), its first 4 bytes as a
    big-endian uint32 folded into ``key``."""
    data = list(data)
    if not data:
        return np.asarray(key, np.uint32)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a string, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def _uniform(key, shape, lo: np.float32, hi: np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``: 23 random
    mantissa bits under exponent 0, minus 1, scaled and shifted."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, as XLA's CPU code contracts it
    (the float32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` for positive normal ``x``: Eigen's
    ``plog`` (mantissa in [sqrt(1/2), sqrt(2)), a Cephes polynomial),
    with the multiply-adds LLVM contracts into FMAs."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    e = np.float32(1) + ((bits >> np.uint32(23)).astype(np.int32)
                         - 0x7F).astype(np.float32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(
        np.float32)
    small = m < np.float32(0.707106781186547524)
    e = e - np.where(small, np.float32(1), np.float32(0))
    m = (m - np.float32(1)) + np.where(small, m, np.float32(0))
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    m = _fma(-x2, np.float32(0.5), m) + y
    return _fma(_LOG_Q2, e, m)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` for ``x`` in (-1, 0]."""
    x = np.asarray(x, np.float32)
    num = np.full_like(x, _LOG1P_N[0])
    den = np.full_like(x, _LOG1P_D[0])
    for cn, cd in zip(_LOG1P_N[1:], _LOG1P_D[1:]):
        num, den = _fma(num, x, cn), _fma(den, x, cd)
    x2 = x * x
    small = (x * x2) * (num / den)
    small = x + (np.float32(-0.5) * x2 + small)
    with np.errstate(divide="ignore"):
        large = _log_f32(np.maximum(np.float32(1) + x, np.float32(1e-38)))
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small,
                    large)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``ErfInv`` (``ErfInv32``) on the CPU, step for step
    for ``|x| < 1``."""
    x = np.asarray(x, np.float32)
    w = -_log1p_f32(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]))
    return p * x


def truncated_normal(key, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32)``."""
    sqrt2 = np.float32(np.sqrt(2))
    u = _uniform(key, shape, _ERF_LO, _ERF_HI)
    out = sqrt2 * erfinv_f32(u)
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf)))


def he_normal(key, shape) -> np.ndarray:
    """flax ``he_normal`` for a kernel ``[..., fan_in_axis, out]``:
    variance 2/fan_in, fan_in = ``prod(shape[:-1])``."""
    fan_in = int(np.prod(shape[:-1]))
    variance = np.float32(2.0 / fan_in)
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def flax_param_shapes(config: DotDict | None = None) -> dict[str, tuple]:
    """The flax-layout parameter paths of ``config``'s SigToSeq and their
    shapes (conv kernels ``[k, in, out]``, dense kernels ``[in, out]``),
    in the order flax creates them."""
    cfg = config if config is not None else default_config()
    m, t = cfg.model, cfg.model.tcn
    shapes: dict[str, tuple] = {}
    c, b = 1, 0
    for _ in range(t.nb_stacks):
        for _ in t.dilations:
            for j, cin in enumerate((c, t.nb_filters)):
                path = f"tcn/block{b}/conv{j}/Conv_0"
                shapes[f"{path}/kernel"] = (t.kernel_size, cin, t.nb_filters)
                shapes[f"{path}/bias"] = (t.nb_filters,)
            if c != t.nb_filters:
                shapes[f"tcn/block{b}/shortcut/kernel"] = (1, c, t.nb_filters)
                shapes[f"tcn/block{b}/shortcut/bias"] = (t.nb_filters,)
            c, b = t.nb_filters, b + 1
    shapes["dense_relu/kernel"] = (t.nb_filters, m.relu_units)
    shapes["dense_relu/bias"] = (m.relu_units,)
    shapes["dense_out/kernel"] = (m.relu_units, m.softmax_units)
    shapes["dense_out/bias"] = (m.softmax_units,)
    return shapes


def init_params(config: DotDict | None = None,
                seed: int = 0) -> dict[str, np.ndarray]:
    """``{flax_path: float32 array}``: the JAX package's
    ``init_params(build_model(config), jax.random.PRNGKey(seed))``,
    flattened; load it with ``params_from_flax``.

    Every kernel is flax's ``make_rng('params')`` call 1 in its module's
    scope (the bias, call 2, is zeros), so its key is one static fold-in
    of the module path and the counter 1 into the seed's key.
    """
    root = prng_key(seed)
    out: dict[str, np.ndarray] = {}
    for name, shape in flax_param_shapes(config).items():
        *scope, leaf = name.split("/")
        if leaf == "kernel":
            out[name] = he_normal(_fold_in_static(root, [*scope, 1]), shape)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def tx_crf_param_shapes(model: DotDict) -> dict[str, tuple[int, ...]]:
    """The ``bonito_tx_crf`` model's parameter names (``TxCrfModel``'s
    state dict) and shapes, in the order ``init_tx_crf`` draws them."""
    shapes: dict[str, tuple[int, ...]] = {}
    for i, s in enumerate(model.stem):
        shapes[f"stem.{i}.weight"] = (s.size, s.insize, s.winlen)
        shapes[f"stem.{i}.bias"] = (s.size,)
    enc = model.encoder
    d, ff = enc.d_model, enc.dim_feedforward
    for i in range(enc.num_layers):
        pre = f"encoder.{i}"
        shapes[f"{pre}.self_attn.Wqkv.weight"] = (3 * d, d)
        shapes[f"{pre}.self_attn.out_proj.weight"] = (d, d)
        shapes[f"{pre}.self_attn.out_proj.bias"] = (d,)
        shapes[f"{pre}.ff.fc1.weight"] = (2 * ff, d)
        shapes[f"{pre}.ff.fc2.weight"] = (d, ff)
        shapes[f"{pre}.norm1.weight"] = (d,)
        shapes[f"{pre}.norm2.weight"] = (d,)
    up = model.upsample.scale_factor
    shapes["upsample.weight"] = (up * d, d)
    shapes["upsample.bias"] = (up * d,)
    shapes["crf.weight"] = (4 ** model.crf.state_len * 4, d)
    return shapes


def init_tx_crf(model: DotDict, seed: int = 0) -> dict[str, np.ndarray]:
    """``{name: float32 array}`` for a ``bonito_tx_crf`` model from
    ``seed``, with Bonito's init: its ``TransformerEncoderLayer.
    reset_parameters`` draws ``fc1``, ``fc2``, ``out_proj`` and the V rows
    of ``Wqkv`` Xavier-normal with the DeepNorm gain β, the Q and K rows
    with gain 1; every other weight and bias takes PyTorch's default
    (uniform in ``±1/sqrt(fan_in)``), and the RMSNorm weights are ones.
    One ``numpy`` generator, the parameters in ``tx_crf_param_shapes``'
    order."""
    model = DotDict(model)
    rng = np.random.default_rng(int(seed) & (2**64 - 1))
    beta = model.encoder.deepnorm_beta
    d = model.encoder.d_model

    def xavier(shape, gain):
        std = gain * np.sqrt(2.0 / (shape[0] + shape[1]))
        return rng.normal(0.0, std, shape).astype(np.float32)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for name, shape in tx_crf_param_shapes(model).items():
        leaf = name.rsplit(".", 2)[-2]
        if leaf in ("norm1", "norm2"):
            out[name] = np.ones(shape, np.float32)
        elif leaf == "Wqkv":
            out[name] = np.concatenate([xavier((2 * d, d), 1.0),
                                        xavier((d, d), beta)])
        elif leaf in ("fc1", "fc2") or name.endswith("out_proj.weight"):
            out[name] = xavier(shape, beta)
        elif name.startswith("stem."):
            i = int(name.split(".")[1])
            s = model.stem[i]
            out[name] = uniform(shape, s.insize * s.winlen)
        else:
            out[name] = uniform(shape, d)
    return out


def lstm_crf_param_shapes(model: DotDict) -> dict[str, tuple[int, ...]]:
    """The ``bonito_lstm_crf`` model's parameter names (``LstmCrfModel``'s
    state dict, Bonito's ``Serial`` numbering) and shapes, in the order
    ``init_lstm_crf`` draws them."""
    shapes: dict[str, tuple[int, ...]] = {}
    for i, s in enumerate(model.stem):
        shapes[f"encoder.{i}.conv.weight"] = (s.size, s.insize, s.winlen)
        shapes[f"encoder.{i}.conv.bias"] = (s.size,)
    h, insize = model.lstm.size, model.stem[-1].size
    first = len(model.stem) + 1  # after the permute
    for i in range(first, first + model.lstm.num_layers):
        pre = f"encoder.{i}.rnn"
        shapes[f"{pre}.weight_ih_l0"] = (4 * h, insize)
        shapes[f"{pre}.weight_hh_l0"] = (4 * h, h)
        shapes[f"{pre}.bias_ih_l0"] = (4 * h,)
        shapes[f"{pre}.bias_hh_l0"] = (4 * h,)
        insize = h
    pre = f"encoder.{first + model.lstm.num_layers}.linear"
    shapes[f"{pre}.weight"] = (4 ** model.crf.state_len * 4, h)
    shapes[f"{pre}.bias"] = (4 ** model.crf.state_len * 4,)
    return shapes


def init_lstm_crf(model: DotDict, seed: int = 0) -> dict[str, np.ndarray]:
    """``{name: float32 array}`` for a ``bonito_lstm_crf`` model from
    ``seed``, with Bonito's init (``bonito/nn.py``'s ``RNNWrapper``): each
    ``hidden``-row gate block of an LSTM weight orthogonal (``torch.nn.
    init.orthogonal_``'s QR with the signs of R's diagonal), ``bias_ih``
    0.5 times Bonito's ``truncated_normal`` (the first of 5 normal draws
    inside ±2, clamped), ``bias_hh`` zero (``disable_state_bias``); the
    convolutions and the head keep PyTorch's default, uniform in
    ``±1/sqrt(fan_in)``.  One ``numpy`` generator, the parameters in
    ``lstm_crf_param_shapes``' order."""
    model = DotDict(model)
    rng = np.random.default_rng(int(seed) & (2**64 - 1))
    h = model.lstm.size

    def orthogonal(rows, cols):
        a = rng.normal(0.0, 1.0, (rows, cols))
        if rows < cols:
            a = a.T
        q, r = np.linalg.qr(a)
        q *= np.sign(np.diag(r))
        return (q.T if rows < cols else q).astype(np.float32)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for name, shape in lstm_crf_param_shapes(model).items():
        if ".rnn.weight_" in name:
            out[name] = np.concatenate([orthogonal(h, shape[1])
                                        for _ in range(4)])
        elif ".rnn.bias_ih" in name:
            x = rng.normal(0.0, 1.0, (*shape, 5))
            first = ((x > -2) & (x < 2)).argmax(-1)[..., None]
            out[name] = (0.5 * np.clip(np.take_along_axis(x, first, -1)[
                ..., 0], -2, 2)).astype(np.float32)
        elif ".rnn.bias_hh" in name:
            out[name] = np.zeros(shape, np.float32)
        elif ".conv." in name:
            s = model.stem[int(name.split(".")[1])]
            out[name] = uniform(shape, s.insize * s.winlen)
        else:  # the CRF head
            out[name] = uniform(shape, h)
    return out
