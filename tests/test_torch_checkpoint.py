"""The weight bridge refuses checkpoints that do not fit the model.

``torch`` and the port are imported inside the test (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np
import pytest

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_weight_bridge_rejects_missing_and_extra_keys():
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )

    flat = load_params_npz(TRAINED)
    assert len(flat) == 30
    extra = dict(flat, **{"tcn/block9/bogus/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="bogus"):
        params_from_flax(extra)
    missing = {k: v for k, v in flat.items()
               if k != "tcn/block3/conv1/Conv_0/bias"}
    with pytest.raises(KeyError, match="blocks.3.conv1.bias"):
        params_from_flax(missing)
