"""Tensor parallelism inside data parallelism: two gloo processes, each
with a model row of two CPU devices (a 2×2 ``[data, model]`` mesh), on
``tests/test_torch_ddp.py``'s ragged global batches (rank 0 holds 5 of
each 8 rows, rank 1 the other 3 padded with 2 zero-weight rows).

Each rank's trainer splits every conv and ``dense_relu`` over its row,
gathers its gradients to the row's first device for the group's one
flat all-reduce and scatters them back.  Both ranks end with bit-equal
parameters and one loss curve, within ``test_torch_ddp.py``'s gates of
the port's single-process, unsharded ``Trainer`` on the global batches.
``torch`` and the port are imported inside the test and the workers
(see ``tests/torch_one_cpu.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_ddp.py's gates
FIRST_LOSS_RTOL = 1e-5
CURVE_RTOL = 1e-3
PARAM_ATOL = 1e-5
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
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.parallel.distributed import initialize
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    initialize(f"file://{store}", 2, rank, device="cpu",
               timeout=datetime.timedelta(seconds=120))
    cfg = DotDict(json.loads(sys.argv[4]))
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=None, device="cpu"),
                 mesh=make_mesh(2, 2, ["cpu"] * 4))
    data = np.load(sys.argv[5])
    rows = slice(0, 5) if rank == 0 else slice(5, None)
    losses = []
    for s in range(3):
        local = {k[2:]: data[k][rows] for k in data if k.startswith(f"{s}/")}
        losses.append(float(tr.train_step(tr._put_batch(local))))
    np.savez(out, **params_to_flax(tr.model))
    print(json.dumps({"rank": rank, "world": tr.world, "losses": losses,
                      "row": len(tr.row),
                      "shards": sum(k.endswith(".1") for k in tr.params)}))
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


def test_tp_ranks_bit_equal_and_equal_one_process(tmp_path):
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    batches = [synth_windows(rng, 8, window=256, levels=levels, max_label=64)
               for _ in range(3)]
    npz = tmp_path / "batches.npz"
    np.savez(npz, **{f"{s}/{k}": v for s, b in enumerate(batches)
                     for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.npz"),
         json.dumps(_tiny(tdefault(), SPLIT).to_dict()), str(npz)],
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

    # a 2x2 grid: two ranks, each a row of two with every split leaf's
    # second shard (each conv's and the shortcut's kernel and bias,
    # dense_relu's)
    assert [(o["world"], o["row"], o["shards"]) for o in outs] == [
        (2, 2, 16)] * 2
    assert outs[0]["losses"] == outs[1]["losses"]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)

    one = Trainer(_tiny(tdefault(), 8),
                  TrainConfig(checkpoint_dir=None, device="cpu"))
    want = [float(one.train_step(one._put_batch(b))) for b in batches]
    got = np.asarray(outs[0]["losses"])
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    params = params_to_flax(one.model)
    assert set(params) == set(ranks[0])
    for k, v in params.items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
