"""The transformer-CRF encoder's windowed attention kernel's plain version
(``radian_tpu_torch/ops/tx_attention.py``) against the model's own
``rotary`` + ``band_attention`` on the CPU, and the rule the model takes
the kernel by.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``); the kernel itself is held to the plain
version on the card by ``chip_smoke.py`` phase 5e.
"""

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import MODEL

LENGTHS = (1, 5, 127, 128, 129, 200, 1024)
# float32: the plain version's online softmax (exp2 of prescaled scores,
# 64 keys a step, the output times the reciprocal of the row sum) and
# SDPA's softmax sum in other orders; at inputs of scale 2 they stayed
# within 7.2e-6 of each other on this CPU; 3e-5 leaves room for another
# order and still fails a dropped key or a window edge off by one (1e-2+)
F32_ATOL = 3e-5
# bfloat16, in roundings: each probability rounds to bf16 before P.V, and
# the output rounds once, on both paths, at other points; a difference is
# counted against one flip of every probability (2^-8 of the
# softmax-weighted mean of |v|, from float64) plus one ulp of the output.
# Measured at most 0.70 on this CPU
BF16_MAX_FLIPS = 1.0


def _reference(q, k, v, left, right):
    """The windowed attention in float64 of rotated ``q``, ``k`` and ``v``
    ``[N, T, H, D]``; and its softmax-weighted ``|v|``."""
    import torch

    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("nihd,njhd->nhij", q.double(), k.double()) / d ** 0.5
    i = torch.arange(t)
    off = i[None, :] - i[:, None]
    s = s.masked_fill(~((off >= -left) & (off <= right)), float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.einsum("nhij,njhd->nihd", p, v.double())
    pv = torch.einsum("nhij,njhd->nihd", p, v.double().abs())
    return o.flatten(2), pv.flatten(2)


def test_plain_matches_rotary_and_band_attention():
    """At the published window (127, 128) and heads of 64, lengths inside
    one step, across tiles and off the tile, and a narrow window: the
    rotated q and k equal ``rotary``'s bit for bit, the output equals
    ``band_attention``'s within F32_ATOL in float32 and BF16_MAX_FLIPS
    roundings in bfloat16; the wrapper runs the plain version on the
    CPU."""
    import torch

    from radian_tpu_torch.models.tx_crf import band_attention, band_mask, rotary
    from radian_tpu_torch.ops import tx_attention as txa

    rng = np.random.default_rng(17)
    cases = [(t, 127, 128) for t in LENGTHS] + [(200, 7, 8)]
    for t, left, right in cases:
        x = torch.from_numpy(rng.normal(0, 2, (2, t, 3, 2, 64)))
        cos, sin = txa.rotary_table(t, 64, 10000.0, "cpu")
        for dt in (torch.float32, torch.bfloat16):
            qkv = x.to(dt)
            q, k, v = (rotary(qkv[:, :, 0], 10000.0),
                       rotary(qkv[:, :, 1], 10000.0), qkv[:, :, 2])
            assert torch.equal(txa.rotate(qkv[:, :, 0], cos, sin), q), (t, dt)
            assert torch.equal(txa.rotate(qkv[:, :, 1], cos, sin), k), (t, dt)
            want = band_attention(q, k, v, left, right,
                                  band_mask(t, left, right, "cpu"))
            want = want.reshape(2, t, -1)
            got = txa.tx_attention(qkv, cos, sin, left, right)
            assert got.shape == want.shape and got.dtype == dt
            if dt == torch.float32:
                gap = float((got - want).abs().max())
                assert gap <= F32_ATOL, (t, left, gap)
                continue
            exact, pv = _reference(q, k, v, left, right)
            ulp = torch.exp2(torch.floor(torch.log2(
                exact.abs().clamp_min(1e-30))) - 7)
            room = ulp + 2.0 ** -8 * pv
            flips = float(((got.double() - want.double()).abs() / room).max())
            assert flips <= BF16_MAX_FLIPS, (t, left, flips)
    assert txa.tx_attention.launches == 0


def test_engagement_rule_and_table_cache():
    """The kernel engages only for a CUDA input to a bf16 model with
    autograd off, heads of 64 and a window of at most 256 keys, each side
    at most a tile; on the CPU the model keeps ``band_attention`` and
    launches nothing; the rotary table is made once a length and device,
    by ``rotary``'s own ops."""
    import copy

    import torch

    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.tx_crf import TxCrfModel
    from radian_tpu_torch.ops import tx_attention as txa

    def model(dtype, nhead=2, window=(7, 8)):
        cfg = copy.deepcopy(MODEL)
        cfg["encoder"].update(d_model=128, nhead=nhead, dim_feedforward=256,
                              attn_window=list(window))
        cfg["stem"][-1]["size"] = 128
        return TxCrfModel(DotDict(cfg), dtype).eval()

    bf16 = model(torch.bfloat16)
    with torch.no_grad():
        assert txa.fusable(bf16)
        assert not txa.fusable(model(torch.float32))
        assert not txa.fusable(model(torch.bfloat16, nhead=4))  # D 32
        assert txa.fusable(model(torch.bfloat16, window=(127, 128)))
        assert not txa.fusable(model(torch.bfloat16, window=(128, 128)))
        assert not txa.fusable(model(torch.bfloat16, window=(200, 0)))
        # the CPU keeps band_attention
        x = torch.zeros(1, 16, 128, dtype=torch.bfloat16)
        assert not txa.engages(bf16, x)
    assert not txa.fusable(bf16)  # autograd on
    with torch.inference_mode():
        assert txa.fusable(bf16)
        scores = bf16(torch.from_numpy(
            np.random.default_rng(3).normal(size=(2, 1200)).astype(np.float32)))
    assert torch.isfinite(scores.float()).all()
    assert txa.tx_attention.launches == 0 and not bf16._tables
    # the table: one entry a (length, device), rotary's numbers
    tab = bf16._table(100, torch.device("cpu"))
    assert bf16._table(100, "cpu") is tab
    assert bf16._table(101, "cpu") is not tab
    assert sorted(bf16._tables) == [(100, "cpu"), (101, "cpu")]
    want = txa.rotary_table(100, 64, 10000.0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tab, want))
    assert tab[0].shape == (100, 32) and tab[0].dtype == torch.float32
