"""The port's spans and counters (``utils/profiling.py``) on the CPU.

With no profiler running, a ``Basecaller`` call records nothing and
enters no profiler range (``record_function``), creates no CUDA event
and takes the recorder's lock never.  Under ``profiling.trace()``, a global and a
chunk-fused call record the named spans, each child under its call's
span with its batch's number; ``real_samples`` and ``forward_samples``
equal the bucket, filler-row and head arithmetic; a host-only span
starts within 1 ms of its profiler range; ``spans.json`` is written
beside ``trace.json``.  A ``Trainer.train_step`` records its forward,
backward and update, in that order, under its step.  ``torch`` and the
port are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import json

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

LENGTHS = (200, 250, 400, 450, 700)
READ_BATCH = 2
OPTS = dict(read_batch=READ_BATCH, chunk_len=256, step_size=32,
            bucket_quantum=256)
HOST_ONLY = ("radian.batches", "radian.pad", "radian.render",
             "radian.stitch")


def _tiny_config():
    from radian_tpu_torch.config import default_config

    cfg = default_config()
    cfg.model.tcn.nb_filters = 8
    cfg.model.tcn.dilations = [1, 2]
    cfg.model.relu_units = 8
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    return cfg


def _reads():
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(3)
    levels = kmer_level_table(rng)
    out = []
    for n in LENGTHS:
        sig, _ = synth_read(rng, n // 8 + 40, levels)
        out.append((sig[:n] * 60 + 500).astype(np.int16))
    return out


class _CountingLock:
    def __init__(self, lock):
        self.lock, self.n = lock, 0

    def __enter__(self):
        self.n += 1
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


def test_basecaller_spans_and_counters(tmp_path, monkeypatch):
    import torch

    from radian_tpu_torch import pipeline as tp
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.ops.preprocess import max_windows_for
    from radian_tpu_torch.utils import profiling

    cfg = _tiny_config()
    torch.manual_seed(0)
    params = build_model(cfg).state_dict()
    reads = _reads()
    entered = []
    real_range = profiling._range

    def counting_range(name, *a, **k):
        entered.append(name)
        return real_range(name, *a, **k)

    events = []

    class CountingEvent:
        def __init__(self, *a, **k):
            events.append(1)

    lock = _CountingLock(profiling._REC.lock)
    monkeypatch.setattr(profiling, "_range", counting_range)
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    monkeypatch.setattr(profiling._REC, "lock", lock)

    def bucket(n):
        return max(-(-n // 256) * 256, 256)

    buckets = sorted(bucket(n) for n in LENGTHS)
    # batches of READ_BATCH reads of one bucket, filler rows to the top
    rows = {}
    for b in buckets:
        rows[b] = rows.get(b, 0) + 1
    batch_buckets = [b for b, k in rows.items()
                     for _ in range(-(-k // READ_BATCH))]
    full_read = sum(READ_BATCH * b for b in batch_buckets)

    for mode in ("global", "chunk"):
        bc = tp.Basecaller(params, cfg, options=tp.BasecallOptions(
            decode_type=mode, **OPTS), device="cpu")
        profiling.reset()
        lock.n = 0
        want = bc.basecall_signals(reads)
        # off: no profiler range, no event, no lock, nothing recorded
        assert entered == [] and events == [] and lock.n == 0
        assert profiling.spans() == [] and profiling.counters() == {}

        with profiling.trace(tmp_path / mode) as prof:
            got = bc.basecall_signals(reads)
        assert got == want
        assert (tmp_path / mode / "trace.json").exists()
        saved = json.loads((tmp_path / mode / "spans.json").read_text())
        spans = profiling.spans()
        assert saved == {"spans": spans, "counters": profiling.counters()}

        names = [s["name"] for s in spans]
        call = spans[0]
        assert call["name"] == "radian.call" and call["parent"] is None
        n_batches = len(bc.batches(reads))
        assert n_batches == len(batch_buckets)
        render = "radian.render" if mode == "global" else "radian.stitch"
        for name in ("radian.pad", "radian.h2d", "radian.forward",
                     "radian.decode", "radian.d2h", render):
            mine = [s for s in spans if s["name"] == name]
            assert [s["batch"] for s in mine] == list(range(n_batches)), name
            assert all(s["parent"] == call["id"] for s in mine), name
        assert names.count("radian.batches") == 1
        assert all(s["call"] == call["call"] for s in spans)
        assert all(s["host_start_ns"] <= s["host_end_ns"] for s in spans)
        # the host-only spans alone are profiler ranges
        assert sorted(set(entered)) == sorted(
            {n for n in names if n in HOST_ONLY})
        assert all(s["device"] is None for s in spans
                   if s["name"] in HOST_ONLY)
        assert all(s["device"] == "cpu" for s in spans
                   if s["name"] not in HOST_ONLY)

        heads = 0
        extra = 0
        if mode == "chunk":
            assert bc.path.use_chunk_fused and bc.path.chunk_head > 0
            extra = 256  # the full-read forward runs over L + chunk_len
            heads = sum(READ_BATCH * max_windows_for(b, 256, 32)
                        * bc.path.chunk_head for b in batch_buckets)
        assert profiling.counters() == {
            "reads": len(LENGTHS), "real_samples": sum(LENGTHS),
            "forward_samples": full_read + extra * READ_BATCH
            * len(batch_buckets) + heads}

        # a host-only span's start on the profiler's clock
        starts = {}
        for e in prof.profiler.kineto_results.events():
            if e.name() == "radian.pad":
                starts.setdefault(e.name(), []).append(e.start_ns())
        pads = [s["host_start_ns"] for s in spans
                if s["name"] == "radian.pad"]
        assert len(starts["radian.pad"]) == len(pads)
        for a, b in zip(sorted(starts["radian.pad"]), pads):
            assert abs(a - b) < 1_000_000, (a, b)
        entered.clear()


def test_train_step_spans(tmp_path):
    import torch

    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils import profiling
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    cfg = _tiny_config()
    cfg.train.batch_size = 4
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=None, device="cpu"))
    rng = np.random.default_rng(0)
    batch = synth_windows(rng, 4, window=256,
                          levels=kmer_level_table(rng), max_label=64)
    feed = tr._put_batch(batch)
    profiling.reset()
    tr.train_step(feed)
    assert profiling.spans() == []
    with profiling.trace(tmp_path):
        loss = tr.train_step(feed)
    assert torch.isfinite(loss)
    spans = profiling.spans()
    assert [s["name"] for s in spans] == [
        "radian.train.step", "radian.train.forward",
        "radian.train.backward", "radian.train.update"]
    step = spans[0]
    assert step["parent"] is None and step["batch"] == 1
    kids = spans[1:]
    assert all(s["parent"] == step["id"] and s["batch"] == 1 for s in kids)
    assert all(a["host_end_ns"] <= b["host_start_ns"]
               for a, b in zip(kids, kids[1:]))
    assert step["host_start_ns"] <= kids[0]["host_start_ns"]
    assert kids[-1]["host_end_ns"] <= step["host_end_ns"]
    assert json.loads((tmp_path / "spans.json").read_text())["spans"] \
        == spans
