"""The port's utilities against the JAX package's: ``trace()`` writes a
Chrome trace on the CPU (``utils/profiling.py``, ``torch.profiler`` in
place of ``jax.profiler``); ``get_label_stats`` and the other ``utils/inspect.py``
helpers equal JAX's on the same TFRecord shards, read by each package's
``ShardDataset``; and the plots (``utils/viz.py``, ``print_dataset``,
``print_same_label_signals``) write PNG files.  The port is imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

import json

import numpy as np

from radian_tpu.train.data import ShardDataset as JShardDataset
from radian_tpu.utils import inspect as jinspect
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

PNG = b"\x89PNG\r\n\x1a\n"


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from radian_tpu_torch.utils.profiling import trace

    with trace(tmp_path / "tr") as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names or "aten::matmul" in names
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") in ("aten::mm", "aten::matmul")
               for e in events["traceEvents"])


def test_inspect_equals_jax_and_plots_write_png(tmp_path, capsys):
    from radian_tpu_torch.io.tfrecord import write_shard
    from radian_tpu_torch.train.data import ShardDataset
    from radian_tpu_torch.utils import inspect as tinspect
    from radian_tpu_torch.utils import viz
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    rng = np.random.default_rng(5)
    levels = kmer_level_table(rng)
    files = []
    for s in range(2):
        b = synth_windows(rng, 20, window=256, levels=levels,
                          dwell_mean=40.0, dwell_std=8.0)
        files.append(str(tmp_path / f"{s}.tfrecords"))
        write_shard(files[-1], [
            {"signal": b["signal"][i],
             "label": b["labels"][i][: b["label_length"][i]].astype(
                 np.float32),
             "signal_length": 256, "label_length": int(b["label_length"][i])}
            for i in range(20)])
    kw = dict(train=False, window=256, max_label=64)
    got = tinspect.get_label_stats(ShardDataset(files, 8, **kw),
                                   tmp_path / "t.json")
    want = jinspect.get_label_stats(JShardDataset(files, 8, **kw),
                                    tmp_path / "j.json")
    assert got == want and sum(got.values()) == 40
    assert json.loads((tmp_path / "t.json").read_text()) == want
    assert tinspect.count_steps_per_epoch(ShardDataset(files, 8, **kw)) == \
        jinspect.count_steps_per_epoch(JShardDataset(files, 8, **kw)) == 5
    assert tinspect.benchmark_dataset(ShardDataset(files, 8, **kw),
                                      max_batches=2) >= 0
    assert tinspect.label_to_sequence([0, 1, 2, 3, 0], 4) == "ACGT"

    batch = next(iter(ShardDataset(files, 8, **kw)))
    target = tinspect.label_to_sequence(batch["labels"][0],
                                        batch["label_length"][0])
    capsys.readouterr()
    tinspect.print_dataset(ShardDataset(files, 8, **kw), n_windows=4,
                           out_path=tmp_path / "ds.png")
    found = tinspect.print_same_label_signals(
        ShardDataset(files, 8, **kw), target, max_signals=2,
        out_path=tmp_path / "same.png")
    assert len(found) >= 1
    mats = [np.random.default_rng(i).dirichlet(np.ones(5), 64)
            for i in range(3)]
    viz.plot_assembly(mats, np.concatenate(mats)[:64 + 2 * 16], 64, 16,
                      str(tmp_path / "asm.png"))
    viz.plot_signals(batch["signal"][:3], str(tmp_path / "sig.png"),
                     title="windows")
    for name in ("ds", "same", "asm", "sig"):
        assert (tmp_path / f"{name}.png").read_bytes()[:8] == PNG, name
