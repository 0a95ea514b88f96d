"""Training Bonito's LSTM-CRF through the port's ``Trainer``: three
clipped AdamW steps equal to the benchmark's plain reference
(``benchmark/core/reference_crf_loss.py``) at a tiny size on the CPU,
with the loss's spans and counters; the families the ``Trainer``
refuses; and the ``adamw`` rule against optax's.  ``torch`` and the
port are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import copy

import numpy as np

from tests.torch_lstm_tiny import config
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

CHUNK = 600  # samples: 100 steps after the stem's stride 6
ROWS = 4
OPT = {"lr": 2e-3, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-8,
       "weight_decay": 0.01, "clipnorm": 2.0}


def _config(state_len: int = 3) -> dict:
    cfg = config()
    cfg["model"]["crf"]["state_len"] = state_len
    cfg["train"] = {"batch_size": ROWS, "chunksize": CHUNK,
                    "opt": {"type": "adamw", "adamw": dict(OPT)}}
    return cfg


def _batches(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(3, 60, ROWS).astype(np.int32)
        lengths[0] = 3  # a target of exactly state_len bases
        out.append({
            "signal": rng.normal(0, 1, (ROWS, CHUNK)).astype(np.float32),
            "targets": rng.integers(0, 4, (ROWS, lengths.max())
                                    ).astype(np.int32),
            "target_length": lengths})
    return out


def test_trainer_steps_equal_the_plain_reference(tmp_path):
    """Three float32 steps of the tiny LSTM-CRF (state_len 3, chunks of
    100 steps, batches of ragged targets padded to the pool's widest)
    from Bonito's seeded init: each step's loss, the first step's clipped
    gradient (AdamW's first moment after one step over ``1 − b1``) and
    each parameter after three steps equal the reference's, which runs
    its own float32 step loops (the LSTM, both lattices) through
    autograd.  The two sum in other orders, and Adam's first steps move
    every element by about ``lr`` whatever its gradient's size, so the
    losses agree to 1e-5 relative, the gradients to 1e-4 of each leaf's
    largest entry, the parameters to 1e-5 absolute (a twentieth of
    ``lr``); so do the first batch's row losses that ``row_losses``
    takes before the first step and the reference's first step has
    (1e-5).  ``bias_hh`` is not trained.  Traced, a step records the
    loss's two spans (the backward's inside ``radian.train.backward``)
    and its counters, and launches no kernel on the CPU."""
    import torch

    from benchmark.core import reference_crf_loss as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.init import init_lstm_crf
    from radian_tpu_torch.ops.crf_loss import crf_loss
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils import profiling

    cfg = _config()
    tr = Trainer(DotDict(cfg), TrainConfig(checkpoint_dir=None, seed=4,
                                           device="cpu"))
    assert not any("bias_hh" in k for k in tr.params)
    batches = _batches(1, 3)
    pool = tr.preload_batches(batches)
    assert pool["target_length"].device.type == "cpu"
    assert pool["targets"].shape[2] == max(b["targets"].shape[1]
                                           for b in batches)
    with torch.no_grad():
        rows = tr.row_losses({k: v[0] for k, v in pool.items()})
    losses = []
    for s in range(3):
        losses.append(float(tr.train_step({k: v[s]
                                           for k, v in pool.items()})))
        if s == 0:
            first = {k: v / (1 - OPT["beta_1"])
                     for k, v in tr.opt_state.slots["mu"].items()}

    p = {k: torch.tensor(v, requires_grad=ref.trainable(k))
         for k, v in init_lstm_crf(DotDict(cfg["model"]), 4).items()}
    want = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    for b in want:
        b["weight"] = torch.ones(ROWS)
    want_losses, want_first, want_rows = ref.adamw_steps(
        p, cfg["model"], want, OPT, rows_per_block=3)
    assert np.allclose(losses, want_losses, rtol=1e-5, atol=0)
    assert rows.shape == want_rows.shape == (ROWS,)
    assert torch.allclose(rows, want_rows, rtol=1e-5, atol=0)
    assert set(first) == set(want_first)
    for k, g in want_first.items():
        assert float((first[k] - g).abs().max()) <= 1e-4 * float(
            g.abs().max()) + 1e-12, k
    for k, v in tr.params.items():
        assert float((v.detach() - p[k].detach()).abs().max()) <= 1e-5, k

    crf_loss.launches = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        tr.train_step({k: v[0] for k, v in pool.items()})
        spans = {s["name"]: s for s in profiling.spans()}
        counts = profiling.counters()
    assert crf_loss.launches == 0
    assert spans["radian.train.crf_loss"]["parent"] == \
        spans["radian.train.forward"]["id"]
    assert spans["radian.train.crf_loss.backward"]["parent"] == \
        spans["radian.train.backward"]["id"]
    lengths = batches[0]["target_length"]
    assert counts["target_bases"] == int(lengths.sum())
    assert counts["crf_loss_state_steps"] == int(
        ROWS * 100 * 64 + 100 * (lengths - 2).sum())


def test_trainer_refusals_and_adamw_equal_optax():
    """A ``bonito_tx_crf`` config is refused by name (its card kernels
    have no backward), and so is the LSTM-CRF over a model row of two
    devices; the ``adamw`` rule, clipped to a global norm, in the leaf
    order its caller gives, gives optax's ``chain(clip_by_global_norm,
    adamw)`` parameters after 5 updates to within 1e-6 of each leaf's
    largest entry (float32 on both sides, the moments in other orders);
    without an order it takes radian's flax order, which refuses a name
    that is not radian's."""
    import jax.numpy as jnp
    import optax
    import pytest
    import torch

    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.train.optimizers import build_optimizer
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from tests.torch_tx_tiny import MODEL as TX_MODEL

    tx_cfg = DotDict({"model": copy.deepcopy(TX_MODEL),
                      "train": _config()["train"]})
    with pytest.raises(NotImplementedError, match="bonito_tx_crf"):
        Trainer(tx_cfg, TrainConfig(checkpoint_dir=None, device="cpu"))
    with pytest.raises(NotImplementedError, match="bonito_lstm_crf"):
        Trainer(DotDict(_config()), TrainConfig(
            checkpoint_dir=None, device="cpu", mesh_model=2))

    rng = np.random.default_rng(0)
    params = {"a.weight": rng.normal(0, 1, (6, 5)).astype(np.float32),
              "b.bias": rng.normal(0, 1, (7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 3, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    tx = build_optimizer(DotDict({"type": "adamw", "adamw": dict(OPT)}))
    mine = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(mine)
    with pytest.raises(KeyError, match="a.weight"):
        tx.apply(mine, {k: torch.from_numpy(v) for k, v in grads[0].items()},
                 state)
    for g in grads:
        state = tx.apply(mine, {k: torch.from_numpy(v) for k, v in g.items()},
                         state, list(mine))
    opt = optax.chain(optax.clip_by_global_norm(OPT["clipnorm"]),
                      optax.adamw(OPT["lr"], OPT["beta_1"], OPT["beta_2"],
                                  OPT["epsilon"],
                                  weight_decay=OPT["weight_decay"]))
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    ostate = opt.init(theirs)
    for g in grads:
        upd, ostate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 ostate, theirs)
        theirs = optax.apply_updates(theirs, upd)
    for k in params:
        want = np.asarray(theirs[k])
        assert np.abs(mine[k].numpy() - want).max() <= 1e-6 * np.abs(
            want).max(), k
