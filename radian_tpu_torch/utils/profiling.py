"""Profiling & throughput instrumentation (counterpart of
radian_tpu/utils/profiling.py).

``trace`` captures a ``torch.profiler`` trace (host and, where a card is
present, CUDA activity) around any block and exports it as a Chrome
trace (``chrome://tracing``, Perfetto), in place of ``jax.profiler``.
``ThroughputMeter`` keeps running reads/s and samples/s counters.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; on exit write ``log_dir/trace.json`` (Chrome
    trace format).  Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sums time by operator and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class ThroughputMeter:
    """Running reads/s and samples/s counters."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.reads = 0
        self.samples = 0

    def add(self, reads: int, samples: int) -> None:
        self.reads += reads
        self.samples += samples

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "reads_per_s": self.reads / dt,
            "samples_per_s": self.samples / dt,
            "elapsed_s": dt,
        }

    def __repr__(self) -> str:
        r = self.rates()
        return (
            f"{self.reads} reads in {r['elapsed_s']:.2f}s "
            f"({r['reads_per_s']:.2f} reads/s, "
            f"{r['samples_per_s'] / 1e6:.2f} Msamples/s)"
        )
