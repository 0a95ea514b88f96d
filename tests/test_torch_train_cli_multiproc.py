"""The port's training CLI in two processes over gloo, on the CPU.

Two ``python -m radian_tpu_torch.cli.train``-equivalent runs (each a
worker calling ``cli.train.main``) with ``--num-processes 2
--process-id I --coordinator file://...`` and ``--device cpu``: each
rank reads its own half of the train shards (``host_shard_files``, data
seed ``seed + rank``), only rank 0 writes the checkpoints, the logs and
the export, and both ranks end with bit-equal parameters.  Each process
and the group have a timeout.  ``torch`` and the port are imported
inside the test and the workers (see ``tests/torch_one_cpu.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

_WORKER = r"""
def run():
    import json, sys
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from radian_tpu_torch.cli import train as cli
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.train import data, trainer as trainer_mod

    rank, out = int(sys.argv[1]), sys.argv[2]
    read, writes = [], []
    init = data.ShardDataset.__init__

    def recording_init(self, shard_files, *args, **kwargs):
        read.append([[Path(f).name for f in shard_files], kwargs.get("seed")])
        init(self, shard_files, *args, **kwargs)

    write = trainer_mod.Trainer._write

    def recording_write(root, epoch, payload, keep):
        writes.append(str(root))
        write(root, epoch, payload, keep)

    data.ShardDataset.__init__ = recording_init
    trainer_mod.Trainer._write = staticmethod(recording_write)
    tr = cli.main(sys.argv[3:])
    np.savez(out, **params_to_flax(tr.model))
    print(json.dumps({"rank": tr.rank, "world": tr.world, "step": tr.step,
                      "read": read, "writes": writes,
                      "group_left": torch.distributed.is_initialized()}))


run()
"""


def _shards(root):
    from radian_tpu_torch.io.tfrecord import write_shard
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    for split, n_shards in (("train", 4), ("val", 1)):
        (root / split).mkdir(parents=True)
        for s in range(n_shards):
            b = synth_windows(rng, 24, window=256, levels=levels)
            write_shard(root / split / f"{s}.tfrecords", [
                {"signal": b["signal"][i],
                 "label": b["labels"][i][: b["label_length"][i]].astype(
                     np.float32),
                 "signal_length": 256,
                 "label_length": int(b["label_length"][i])}
                for i in range(24)])


def test_two_process_cli_shards_files_and_agrees(tmp_path):
    from radian_tpu_torch.config import default_config

    cfg = default_config()
    cfg.model.tcn.nb_filters = 16
    cfg.model.tcn.dilations = [1, 2]
    cfg.model.relu_units = 16
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    cfg.train.batch_size = 8
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    _shards(tmp_path / "shards")
    argv = ["-s", str(tmp_path / "shards"), "-g", str(tmp_path / "tiny.yaml"),
            "--steps-per-epoch", "3", "--n-epochs", "2", "--device", "cpu",
            "--seed", "7", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "logs"),
            "--export-npz", str(tmp_path / "export.npz"),
            "--num-processes", "2",
            "--coordinator", f"file://{tmp_path / 'store'}"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / f"r{r}.npz"),
         *argv, "--process-id", str(r)],
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

    assert [(o["rank"], o["world"], o["step"]) for o in outs] == [
        (0, 2, 6), (1, 2, 6)]
    # each rank its own half of the train shards, seed + rank; all val
    assert outs[0]["read"][0] == [["0.tfrecords", "2.tfrecords"], 7]
    assert outs[1]["read"][0] == [["1.tfrecords", "3.tfrecords"], 8]
    assert all(r == [["0.tfrecords"], None] for o in outs
               for r in o["read"][1:])
    # rank 0 writes the epochs' checkpoints and the best one; rank 1 none
    ck = tmp_path / "ckpt"
    assert len(outs[0]["writes"]) >= 2 and outs[1]["writes"] == []
    assert sorted(p.name for p in ck.iterdir()) == ["0", "1", "best"]
    tags = [json.loads(x)["tag"] for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("train/epoch_loss") == 2  # one writer
    assert len(list((tmp_path / "logs").glob("events.out.tfevents.*"))) == 1
    # the group is gone when main returns; the ranks' parameters agree
    assert not any(o["group_left"] for o in outs)
    params = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    export = dict(np.load(tmp_path / "export.npz"))
    assert set(params[0]) == set(export)
    for k, v in params[0].items():
        np.testing.assert_array_equal(v, params[1][k], err_msg=k)
        np.testing.assert_array_equal(v, export[k], err_msg=k)
        assert np.isfinite(v).all()
