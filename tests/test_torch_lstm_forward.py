"""The LSTM-CRF model (``models/lstm_crf.py``) against its plain float32
reference (``benchmark/core/reference_lstm_crf.py``) on the CPU, with
the reference's seeded Bonito weights at a narrow size
(``tests/torch_lstm_tiny.py``); and its sizes at the published widths.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import json
from pathlib import Path

import numpy as np

from tests.torch_lstm_tiny import config
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]

# The port's float32 forward (torch.nn.LSTM: the input products of all
# steps in one product, the gates in one fused kernel) and the
# reference's step loop differ only in the order of their float32 sums.
# The recurrence contracts (forget gates ~0.5), so the rounding of a
# step does not grow over the steps: over 3 layers and 200-1,666 steps
# the scores (tanh·5, |s| <= 5) stayed within 5e-7 of the largest score
# on this CPU (3.2e-7 at 200 steps, 4.9e-7 at 1,666).  1e-5 of it
# leaves room for another BLAS's order and fails any change of the
# arithmetic: a layer run in the wrong direction, a gate out of order or
# a dropped bias moves them by 1e-2+.
SCORE_RTOL = 1e-5


def test_forward_matches_reference():
    """Chunks of 200 and 1,666 steps (a chunk of the published 9,996
    samples), two a batch, through the stem, 3 layers (the first and the
    last reversed) and the head."""
    import torch

    from benchmark.core import reference_lstm_crf as ref
    from benchmark.core import reference_tx_crf as tx
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.lstm_crf import LstmCrfModel
    from radian_tpu_torch.models.sig2seq import build_model

    cfg = config()
    weights = ref.bonito_lstm_init(cfg["model"], 11)
    model = build_model(DotDict(cfg))
    assert isinstance(model, LstmCrfModel)
    assert model.reversed == [True, False, True]
    assert (model.sample_stride, model.stride, model.state_len) == (6, 6, 5)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    model.eval()
    p = tx.params(weights, "cpu")
    rng = np.random.default_rng(4)
    for steps in (200, 1666):
        x = torch.from_numpy(rng.normal(size=(2, 6 * steps))
                             .astype(np.float32))
        with torch.inference_mode():
            got = model(x)
        want = ref.forward(p, cfg["model"], x)
        assert got.shape == want.shape == (2, steps, 5 * 4 ** 5)
        gap = float((got - want).abs().max()) / float(want.abs().max())
        assert gap <= SCORE_RTOL, (steps, gap)
        # the blank column is the constant, the moves tanh·5
        assert torch.equal(got[..., ::5], torch.full_like(got[..., ::5], 2))
    # each layer is its own direction: flipping layer 1 moves the scores
    model.reversed = [True, True, True]
    with torch.inference_mode():
        assert float((model(x) - want).abs().max()) > 1e-2


def test_published_widths():
    """At ``dna_r10.4.1_e8.2_400bps_sup@v4.2.0``'s widths: 46,496,112
    parameters under the reference's (Bonito's) names and shapes, 1,666
    steps a 9,996-sample chunk, ~15.49 MFLOP a sample, ~90 % of them in
    the recurrence."""
    from benchmark.core import counts_lstm_crf as cnt
    from benchmark.core import reference_lstm_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.init import lstm_crf_param_shapes
    from radian_tpu_torch.models.sig2seq import build_model, param_count

    cfg = json.loads((REPO / "benchmark" / "configs"
                      / "bonito-lstm-sup-v4-bf16.json").read_text())
    mc = cfg["model_config"]
    model = build_model(DotDict(mc))
    assert param_count(model) == 46_496_112
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == ref.param_shapes(mc["model"])
    assert shapes == lstm_crf_param_shapes(DotDict(mc["model"]))
    assert "encoder.4.rnn.weight_ih_l0" in shapes
    assert "encoder.9.linear.bias" in shapes
    size = mc["basecaller"]["chunksize"]
    assert cnt.steps(mc["model"], size) == size // ref.stride(mc["model"])
    flops = cnt.flops_per_sample(mc["model"], size)
    assert abs(flops / 15.49e6 - 1) < 1e-3, flops
    lstm = cnt.lstm_flops(mc["model"], 1, size) / size
    assert 0.89 < lstm / flops < 0.91
