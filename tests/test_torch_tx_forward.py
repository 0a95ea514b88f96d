"""The transformer-CRF model (``models/tx_crf.py``) against its plain
float32 reference (``benchmark/core/reference_tx_crf.py``) on the CPU,
with the reference's seeded Bonito weights at a narrow size (``tests/torch_tx_tiny.py``).
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import config

# The port's float32 forward and the reference's differ only in the
# order of their float32 sums: banded against dense masked attention,
# batched against one chunk at a time.  Over 2 layers the scores (tanh·5,
# so |s| <= 5) stayed within 3e-6 of each other on this CPU; 1e-4 leaves
# room for another BLAS's order and still fails any change of the
# arithmetic (a dropped window edge or rotary half moves them by 1e-2+).
SCORE_ATOL = 1e-4


def test_forward_matches_reference():
    """Chunks of 1 token, of 5 tokens (under the window's 7), and of 200
    tokens (off the 128-query block), two chunks a batch."""
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.models.tx_crf import TxCrfModel

    cfg = config()
    weights = ref.bonito_init(cfg["model"], 11)
    model = build_model(DotDict(cfg))
    assert isinstance(model, TxCrfModel)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    model.eval()
    p = ref.params(weights, "cpu")
    rng = np.random.default_rng(4)
    for tokens in (1, 5, 200):
        samples = tokens * 12
        x = torch.from_numpy(rng.normal(size=(2, samples)).astype(np.float32))
        with torch.inference_mode():
            got = model(x)
        want = torch.stack([ref.forward(p, cfg["model"], x[i])
                            for i in range(2)])
        assert got.shape == want.shape == (2, 2 * tokens, 5 * 4 ** 5)
        gap = float((got - want).abs().max())
        assert gap <= SCORE_ATOL, (tokens, gap)
        # the blank column is the constant, the moves tanh·5
        assert torch.equal(got[..., ::5], torch.full_like(got[..., ::5], 2))


def test_band_attention_equals_dense_masked_attention():
    """The banded attention at the published window (127, 128) and block
    equals dense attention under the window mask, at lengths inside one
    block, across blocks and off the block."""
    import torch

    from radian_tpu_torch.models.tx_crf import band_attention, band_mask

    gen = torch.Generator().manual_seed(0)
    for t in (1, 100, 128, 300):
        q, k, v = (torch.randn(2, t, 3, 16, generator=gen, dtype=torch.float64)
                   for _ in range(3))
        got = band_attention(q, k, v, 127, 128,
                             band_mask(t, 127, 128, "cpu"))
        s = torch.einsum("nihd,njhd->nhij", q, k) / 4.0
        i = torch.arange(t)
        off = i[None, :] - i[:, None]
        s = s.masked_fill(~((off >= -127) & (off <= 128)), float("-inf"))
        want = torch.einsum("nhij,njhd->nihd", torch.softmax(s, -1), v)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) < 1e-12, t
