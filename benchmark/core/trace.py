"""The device trace of a ``--trace 1`` window: ``torch.profiler`` (CPU
and CUDA) around the window, reduced to device-busy time, device time by
operation name, and the idle gaps labelled with what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

WINDOW_SPAN = "benchmark.window"


@dataclasses.dataclass
class Trace:
    """A traced window, times in seconds."""

    window_s: float
    busy_s: float
    ops: list[tuple[str, float, float]]  # (name, start, duration), device
    gaps: list[tuple[str, float]]  # (what the host ran, idle seconds)

    def device_seconds(self, *substrings: str) -> float:
        """Device time of the operations whose name holds any substring."""
        return sum(d for n, _, d in self.ops
                   if any(s in n for s in substrings))

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, _, d in self.ops:
            by[name[:160]] = by.get(name[:160], 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def top_gaps(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, d in self.gaps:
            by[name[:160]] = by.get(name[:160], 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


@contextlib.contextmanager
def traced(enabled: bool, sync):
    """Run the body as the measured window; with ``enabled``, under the
    profiler.  Yields a holder whose ``trace`` is set on exit."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            sync()
    t0 = time.perf_counter()
    holder.trace = reduce(prof.profiler.kineto_results.events())
    holder.reduce_s = time.perf_counter() - t0


def reduce(events) -> Trace:
    """The window's device operations (clipped to the window span), the
    union of their intervals, and the gaps between them."""
    from torch.autograd import DeviceType

    win = None
    host, dev = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name == WINDOW_SPAN:  # the span's own device-side record
                continue
            dev.append((name, e.start_ns(), e.duration_ns()))
        elif name == WINDOW_SPAN:
            win = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win
    ops = []
    for name, s, d in dev:
        a, b = max(s, w0), min(s + d, w1)
        if b > a:
            ops.append((name, (a - w0) * 1e-9, (b - a) * 1e-9))
    ops.sort(key=lambda o: o[1])
    busy, idle = 0.0, []
    cur_s = cur_e = None
    edge = 0.0
    for _, s, d in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            idle.append((edge, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
        edge = cur_e
    if cur_e is not None:
        busy += cur_e - cur_s
    window_s = (w1 - w0) * 1e-9
    idle.append((edge, window_s))
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    for a, b in idle:
        if b - a <= 0:
            continue
        mid = w0 + (a + b) / 2 * 1e9
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            s, e, name = host[j]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        gaps.append((best[2] if best else "(no host op)", b - a))
    return Trace(window_s, busy, ops, gaps)
