"""The port's training CLI on the CPU, against the JAX package.

``python -m radian_tpu_torch.cli.train --device cpu`` on tiny shards
(the narrow config of ``tests/test_train.py``, from a yaml) lowers the
val loss below 0.7× that of the seed-0 init, as
``test_training_reduces_loss`` asks of the JAX ``Trainer``; prints the
JAX CLI's final lines; and ``--export-npz`` writes weights that the JAX
package's ``load_params_npz`` reads as the trained parameters and that
both packages' ``load_basecaller`` basecall to the same strings.  Without
a card the CUDA default raises, a --mesh-data other than the process
group raises, --mesh-model 2 builds a trainer on a row of two devices,
and a failed build of the shard parser raises.  ``torch`` and the port are
imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest
import yaml
from flax import traverse_util

from radian_tpu import pipeline as jpipe
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _tiny_yaml(path):
    from radian_tpu_torch.config import default_config

    cfg = default_config()
    cfg.model.tcn.nb_filters = 32
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 32
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    cfg.train.batch_size = 8
    cfg.train.opt.adam.lr = 0.003
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return cfg


def _shards(root, rng, levels):
    from radian_tpu_torch.io.tfrecord import write_shard
    from radian_tpu_torch.utils.synthetic import synth_windows

    for split, n_shards in (("train", 3), ("val", 1)):
        (root / split).mkdir(parents=True)
        for s in range(n_shards):
            b = synth_windows(rng, 40, window=256, levels=levels)
            write_shard(root / split / f"{s}.tfrecords", [
                {"signal": b["signal"][i],
                 "label": b["labels"][i][: b["label_length"][i]].astype(
                     np.float32),
                 "signal_length": 256,
                 "label_length": int(b["label_length"][i])}
                for i in range(40)])


def test_cli_trains_and_exports(tmp_path, capsys):
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.cli import train as cli
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.train.data import ShardDataset, list_shards
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    _shards(tmp_path / "shards", rng, levels)
    cfg = _tiny_yaml(tmp_path / "tiny.yaml")
    val = list(ShardDataset(list_shards(tmp_path / "shards", "val"), 8,
                            train=False, window=256))
    first = Trainer(cfg, TrainConfig(checkpoint_dir=None, device="cpu")
                    ).evaluate(val)
    npz = tmp_path / "params.npz"
    trainer = cli.main([
        "-s", str(tmp_path / "shards"), "-g", str(tmp_path / "tiny.yaml"),
        "--steps-per-epoch", "15", "--n-epochs", "3", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--log-dir", str(tmp_path / "logs"), "--eval-edit-distance",
        "--export-npz", str(npz)])
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("final train loss: ")
    assert out[-1].startswith("final val loss: ")
    last = float(out[-1].split(": ")[1])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first * 0.7, f"loss did not decrease: {first} -> {last}"
    assert trainer.step == 45
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "0", "1", "2", "best"]

    # the export: the JAX reader sees the trained parameters
    want = params_to_flax(trainer.model)
    got = traverse_util.flatten_dict(jload(npz), sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    # and both packages basecall it to the same strings
    sigs = [(synth_read(rng, n, levels)[0] * 60 + 500).astype(np.int16)
            for n in (70, 110, 90)]
    kw = dict(read_batch=3, bucket_quantum=1024)
    j_seqs = jpipe.load_basecaller(
        npz, config_path=tmp_path / "tiny.yaml",
        options=jpipe.BasecallOptions(decode_backend="xla", **kw)
    ).basecall_signals(sigs)
    t_seqs = tpipe.load_basecaller(
        npz, config_path=tmp_path / "tiny.yaml", device="cpu",
        options=tpipe.BasecallOptions(**kw)).basecall_signals(sigs)
    assert all(t_seqs) and t_seqs == j_seqs

    # resume: the newest checkpoint, one more epoch
    trainer = cli.main([
        "-s", str(tmp_path / "shards"), "-g", str(tmp_path / "tiny.yaml"),
        "--steps-per-epoch", "2", "--n-epochs", "4", "--device", "cpu",
        "-c", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs")])
    assert "resuming at epoch 3" in capsys.readouterr().out
    assert trainer.step == 47
    assert torch.isfinite(next(iter(trainer.params.values()))).all()


def test_no_fallback(tmp_path, monkeypatch):
    import torch

    from radian_tpu_torch import _build
    from radian_tpu_torch.cli import train as cli
    from radian_tpu_torch.io import tfrecord
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-s", str(tmp_path)])
    # multi-process training is ported (tests/test_torch_ddp.py,
    # test_torch_train_cli_multiproc.py), and so is tensor parallelism
    # (tests/test_torch_tensor_parallel.py runs the CLI's --mesh-model);
    # a data axis other than the process group is refused
    assert cli.build_parser().parse_args(
        ["-s", str(tmp_path), "--mesh-model", "2"]).mesh_model == 2
    assert len(Trainer(train_config=TrainConfig(
        checkpoint_dir=None, mesh_model=2, device="cpu")).row) == 2
    with pytest.raises(ValueError, match="one process per GPU"):
        cli.main(["-s", str(tmp_path), "--device", "cpu", "--mesh-data", "2"])
    with pytest.raises(ValueError, match="one process per GPU"):
        Trainer(train_config=TrainConfig(mesh_data=2, device="cpu"))
    with pytest.raises(ValueError, match="process_id"):
        cli.main(["-s", str(tmp_path), "--device", "cpu",
                  "--num-processes", "2"])

    # a failed build of csrc/tfrecord.cc raises; nothing falls back to
    # the Python codec
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "GXX_FLAGS", [*_build.GXX_FLAGS,
                                              "--no-such-option"])
    monkeypatch.setattr(_build, "_LIBS", {})
    ex = [{"signal": np.zeros(4, np.float32), "label": np.ones(2, np.float32),
           "signal_length": 4, "label_length": 2}]
    with pytest.raises(RuntimeError, match="tfrecord.cc"):
        tfrecord.write_shard(tmp_path / "x.tfrecords", ex)
    tfrecord.write_shard(tmp_path / "x.tfrecords", ex, use_native=False)
    with pytest.raises(RuntimeError, match="tfrecord.cc"):
        tfrecord.read_shard(tmp_path / "x.tfrecords", 4, 2)
    assert tfrecord.read_shard(tmp_path / "x.tfrecords", 4, 2,
                               use_native=False)[3].tolist() == [2]
