"""Checks of the yardstick that need the card (``-m card``); they skip
without one.  Run on the card machine with
``python -m pytest benchmark/tests -m card``."""

import numpy as np
import pytest

pytestmark = pytest.mark.card


def _mats(rng, n, t_lo, t_hi):
    out = []
    for _ in range(n):
        m = rng.dirichlet(np.full(5, 0.3), size=int(rng.integers(t_lo, t_hi)))
        out.append(m.astype(np.float32))
    return out


@pytest.mark.parametrize("lm", [False, True])
def test_graph_replay_equals_step_by_step(cuda_device, lm):
    """The reference decode's CUDA-graph blocks give the strings its
    step-by-step run gives, with and without the LM."""
    import torch

    from benchmark.core import inputs
    from benchmark.core import reference as plain

    rng = np.random.default_rng(5)
    mats = _mats(rng, 7, 150, 700)
    fusion = None
    if lm:
        rows4, ent4 = inputs.markov_lm_rows(0.9)
        rows = torch.from_numpy(np.concatenate([rows4, ent4[:, None]], 1))
        fusion = plain.Lm(rows.to(cuda_device), 3, 0.5, 0.5)
    graph = plain.beam_search(mats, 6, cuda_device, fusion, graph_block=64)
    step = plain.beam_search(mats, 6, cuda_device, fusion, graph_block=0)
    assert graph == step
