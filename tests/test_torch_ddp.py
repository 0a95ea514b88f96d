"""The port's data-parallel ``Trainer`` in two processes over gloo, on the
CPU, against one process and against the JAX ``Trainer``.

Each worker forms a two-rank group through ``parallel.distributed.
initialize`` with a ``file://`` store in ``tmp_path`` (no port to race
for), with a timeout on the group and on each process.  Three steps on a
global batch of 8 rows: rank 0 holds 5 of them and rank 1 the other 3,
padded with 2 zero-weight filler rows to the config's batch of 5.  So
the mean of the ranks' means (DDP's default) would differ from the mean
over the global batch, which the port takes as the JAX ``loss_fn`` does.

Both ranks end with bit-equal parameters; their losses, and the
parameters, agree with the port's single-process ``Trainer`` and with
the JAX ``Trainer(mesh_data=1)`` on the global batches (the JAX one with
one CPU device: XLA's CPU collectives are what abort
``tests/test_train.py``).  The first step's loss is held to
``tests/test_torch_train_step.py``'s 1e-5 relative, the curve to its
1e-3.  ``torch`` and the port are imported
inside the tests and the workers (see ``tests/torch_one_cpu.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
from flax import traverse_util

from radian_tpu.config import default_config
from radian_tpu.train.trainer import TrainConfig as JTrainConfig
from radian_tpu.train.trainer import Trainer as JTrainer
from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
FIRST_LOSS_RTOL = 1e-5  # test_torch_train_step.py's first-step loss rtol
CURVE_RTOL = 1e-3  # test_torch_train_step.py's loss-curve rtol
PARAM_ATOL = 1e-5  # measured 3.4e-7 against one process, 4.2e-6 vs JAX
SPLIT = 5  # rank 0's rows of each global batch of 8
TIMEOUT_S = 240

_WORKER = r"""
def run():
    import datetime, json, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.parallel.distributed import initialize
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    initialize(f"file://{store}", 2, rank, device="cpu",
               timeout=datetime.timedelta(seconds=120))
    cfg = DotDict(json.loads(sys.argv[4]))
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=None, device="cpu"))
    data = np.load(sys.argv[5])
    rows = slice(0, 5) if rank == 0 else slice(5, None)
    losses, shapes = [], []
    for s in range(3):
        local = {k[2:]: data[k][rows] for k in data if k.startswith(f"{s}/")}
        batch = tr._put_batch(local)
        shapes.append([batch["signal"].shape[0], float(batch["weight"].sum())])
        losses.append(float(tr.train_step(batch)))
    np.savez(out, **params_to_flax(tr.model))
    print(json.dumps({"rank": rank, "world": tr.world, "losses": losses,
                      "shapes": shapes}))
    torch.distributed.destroy_process_group()


run()
"""


def _tiny(cfg, batch_size):
    cfg.model.tcn.nb_filters = 32
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 32
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    cfg.train.batch_size = batch_size
    cfg.train.opt.adam.lr = 0.003
    return cfg


def _run_ranks(tmp_path, batches_npz, config):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.npz"), json.dumps(config.to_dict()),
         str(batches_npz)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def test_two_ranks_equal_one_process_and_jax_on_a_ragged_batch(tmp_path):
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.ops.ctc import ctc_loss
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    batches = [synth_windows(rng, 8, window=256, levels=levels, max_label=64)
               for _ in range(3)]
    npz = tmp_path / "batches.npz"
    np.savez(npz, **{f"{s}/{k}": v for s, b in enumerate(batches)
                     for k, v in b.items()})
    outs = _run_ranks(tmp_path, npz, _tiny(tdefault(), SPLIT))

    # both ranks: the group of 2, the ragged split padded, one loss curve
    assert [o["world"] for o in outs] == [2, 2]
    assert outs[0]["shapes"] == [[5, 5.0]] * 3
    assert outs[1]["shapes"] == [[5, 3.0]] * 3
    assert outs[0]["losses"] == outs[1]["losses"]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)

    # one process over the global batches; first, its per-row losses at
    # the init, for the mean of the ranks' own means
    one = Trainer(_tiny(tdefault(), 8),
                  TrainConfig(checkpoint_dir=None, device="cpu"))
    b0 = one._put_batch(batches[0])
    with torch.no_grad():
        rows = ctc_loss(one.model(b0["signal"][..., None]),
                        b0["input_length"], b0["labels"],
                        b0["label_length"]).numpy()
    ddp_mean = (rows[:SPLIT].mean() + rows[SPLIT:].mean()) / 2
    one_losses = [float(one.train_step(one._put_batch(b))) for b in batches]
    one_params = params_to_flax(one.model)
    # the JAX Trainer, one CPU device
    jt = JTrainer(_tiny(default_config(), 8),
                  JTrainConfig(checkpoint_dir=None, mesh_data=1))
    j_losses = []
    for b in batches:
        jt.state, loss = jt._train_step(jt.state, jt._put_batch(b))
        j_losses.append(float(loss))
    j_params = traverse_util.flatten_dict(jax.device_get(jt.state.params),
                                          sep="/")

    got = np.asarray(outs[0]["losses"])
    # the trap shows on this batch: DDP's mean of means is off the curve
    assert abs(ddp_mean - one_losses[0]) > CURVE_RTOL * one_losses[0]
    for want, params in ((one_losses, one_params), (j_losses, j_params)):
        np.testing.assert_allclose(got[0], want[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
        assert set(params) == set(ranks[0])
        for k, v in params.items():
            np.testing.assert_allclose(ranks[0][k], np.asarray(v), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def test_one_rank_group_is_bit_exact_and_mesh_data_checked(tmp_path):
    """In a one-rank group the step runs its collectives (the weight sum,
    then the gradients and the loss in one all-reduce) and equals the
    step without a group bit for bit; ``mesh_data`` must be the group's
    size, and so must a given mesh's data axis (or 1); ``mesh_model``
    above 1 splits the model over the process's own row."""
    import datetime

    import pytest
    import torch
    import torch.distributed as dist

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(1)
    batches = [synth_windows(rng, 6, window=256,
                             levels=kmer_level_table(rng), max_label=64)
               for _ in range(2)]
    runs = {}
    for grouped in (False, True):
        if grouped:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp_path / 'store'}",
                world_size=1, rank=0,
                timeout=datetime.timedelta(seconds=60))
        try:
            tr = Trainer(_tiny(tdefault(), 8),
                         TrainConfig(checkpoint_dir=None, device="cpu"))
            assert (tr.grouped, tr.world, tr.rank) == (grouped, 1, 0)
            losses = [tr.train_step(tr._put_batch(b)) for b in batches]
            evals = [tr.evaluate(batches), tr.eval_step(tr._put_batch(
                batches[0]))]
            runs[grouped] = (losses, evals, {k: v.detach().clone()
                                             for k, v in tr.params.items()})
            with pytest.raises(ValueError, match="one process per GPU"):
                Trainer(train_config=TrainConfig(mesh_data=2, device="cpu"))
        finally:
            if grouped:
                dist.destroy_process_group()
    (l0, e0, p0), (l1, e1, p1) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert e0[0] == e1[0] and torch.equal(e0[1], e1[1])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    from radian_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="data rows in a group of 1"):
        Trainer(train_config=TrainConfig(device="cpu"),
                mesh=make_mesh(2, 1, ["cpu", "cpu"]))
    tp = Trainer(_tiny(tdefault(), 8), TrainConfig(
        checkpoint_dir=None, mesh_model=2, device="cpu"))
    assert tp.row == [torch.device("cpu")] * 2
    assert tp.mesh.shape == {"data": 1, "model": 2}
    assert Trainer(_tiny(tdefault(), 8), TrainConfig(
        checkpoint_dir=None, mesh_data=1, device="cpu")).world == 1
