"""The transformer-CRF encoder's DeepNorm residual + RMSNorm
(``radian_tpu_torch/ops/tx_norm.py``) on the CPU: the plain version
against the arithmetic the model ran before it had a kernel, the wrapper
on CPU tensors, and the rule the model takes the kernel by.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``); the kernel itself is held to the plain
version on the card by ``chip_smoke.py`` phase 5e.
"""

import types

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import config

# rows off a warp's 32 and a block's 8 warps; widths the kernel takes and
# the narrow model's
ROWS = (1, 7, 33, 257)
WIDTHS = (64, 512, 768)
# the reference's tolerance for the float32 forward (see
# tests/test_torch_tx_forward.py: only the order of float32 sums differs)
SCORE_ATOL = 1e-4


def _old_forward(y, x, weight, alpha, eps):
    """``AddRMSNorm.forward`` as the model computed it before the kernel."""
    import torch

    h = y.float() + alpha * x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    return (h * weight.float()).to(x.dtype)


def test_plain_equals_old_arithmetic_on_cpu():
    """``add_rmsnorm_plain`` is bit-equal to the model's former arithmetic
    and to the reference's ``rms_norm(y + α·x)`` in bfloat16 and float32;
    the wrapper and ``AddRMSNorm`` run it on CPU tensors and launch
    nothing; the launch itself refuses a CPU tensor."""
    import pytest
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.models.tx_crf import AddRMSNorm
    from radian_tpu_torch.ops import tx_norm as txn

    rng = np.random.default_rng(19)
    alpha, eps = 2.4494897, 1e-5
    for rows in ROWS:
        for d in WIDTHS:
            y0 = torch.from_numpy(rng.normal(0, 3, (rows, d)))
            x0 = torch.from_numpy(rng.normal(0, 1, (rows, d)))
            w0 = torch.from_numpy(rng.normal(1, 0.2, d))
            for dt in (torch.float32, torch.bfloat16):
                y, x, w = y0.to(dt), x0.to(dt), w0.to(dt)
                got = txn.add_rmsnorm_plain(y, x, w, alpha, eps)
                assert got.dtype == dt and got.shape == (rows, d)
                assert torch.equal(got, _old_forward(y, x, w, alpha, eps))
                want = ref.rms_norm(y.float() + alpha * x.float(), w.float(),
                                    eps).to(dt)
                assert torch.equal(got, want), (rows, d, dt)
                assert torch.equal(txn.add_rmsnorm(y, x, w, alpha, eps), got)
                norm = AddRMSNorm(d, alpha, eps).to(dt)
                with torch.no_grad():
                    norm.weight.copy_(w)
                    assert torch.equal(norm(y.view(1, rows, d),
                                            x.view(1, rows, d)),
                                       got.view(1, rows, d))
    assert txn.tx_norm.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        txn.tx_norm(y, x, w, alpha, eps)


def test_engagement_rule_and_float32_forward():
    """The kernel engages only for a CUDA input to a bf16 model with
    autograd off and ``d_model`` a multiple of 256 up to 1,024; the
    float32 forward (the narrow model, ``d_model`` 64) still meets the
    reference within the forward test's tolerance, and neither it nor a
    bf16 forward on the CPU launches the kernel."""
    import copy

    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.models.tx_crf import TxCrfModel
    from radian_tpu_torch.ops import tx_norm as txn

    assert [d for d in range(0, 1400, 64) if txn.d_fits(d)] == [256, 512,
                                                                 768, 1024]

    def model(dtype, d_model=512):
        cfg = copy.deepcopy(config()["model"])
        cfg["encoder"].update(d_model=d_model, nhead=d_model // 64,
                              dim_feedforward=2 * d_model)
        cfg["stem"][-1]["size"] = d_model
        return TxCrfModel(DotDict(cfg), dtype).eval()

    def card(d):  # what the rule reads of a CUDA input
        return types.SimpleNamespace(is_cuda=True, shape=(2, 16, d))

    bf16 = model(torch.bfloat16)
    with torch.no_grad():
        assert txn.engages(bf16, card(512))
        assert txn.engages(model(torch.bfloat16, 256), card(256))
        assert not txn.engages(model(torch.bfloat16, 320), card(320))
        assert not txn.engages(model(torch.float32), card(512))
        assert not txn.engages(bf16, torch.zeros(2, 16, 512,
                                                 dtype=torch.bfloat16))
    assert not txn.engages(bf16, card(512))  # autograd on
    with torch.inference_mode():
        assert txn.engages(bf16, card(512))
        scores = bf16(torch.from_numpy(
            np.random.default_rng(3).normal(size=(2, 1200)).astype(np.float32)))
    assert torch.isfinite(scores.float()).all()

    cfg = config()
    weights = ref.bonito_init(cfg["model"], 12)
    f32 = build_model(DotDict(cfg))
    f32.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    f32.eval()
    p = ref.params(weights, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 200 * 12)).astype(np.float32))
    with torch.inference_mode():
        got = f32(x)
    want = torch.stack([ref.forward(p, cfg["model"], x[i]) for i in range(2)])
    gap = float((got - want).abs().max())
    assert gap <= SCORE_ATOL, gap
    assert txn.tx_norm.launches == 0
