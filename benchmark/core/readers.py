"""What the metric readers (``benchmark/metrics/<name>.py``) share.
Each returns None where its run has nothing to read."""

from __future__ import annotations

import numpy as np

DECODE_KERNELS = ("beam_decode", "beam_backtrace")


def idle_pct(run):
    """Share of the traced window in which no device operation ran."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def decode_device_s(run):
    """Device seconds of the beam-search decode and backtrace kernels."""
    if run.trace is None:
        return None
    s = run.trace.device_seconds(*DECODE_KERNELS)
    return s if s > 0 else None


def read_latencies_s(run) -> np.ndarray:
    """Every read's latency: from its call to the call's return."""
    c = run.counts
    return np.repeat(c["call_latencies_s"], c["reads_per_call"])
