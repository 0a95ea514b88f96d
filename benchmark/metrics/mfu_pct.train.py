"""Forward, data-gradient and filter-gradient FLOPs (three times the
forward's, from the shapes) of every window stepped, over the window's
time, against the peak of the configuration's dtype (f32: 67 TFLOP/s)."""

from benchmark.core import counts as cnt


def read(run):
    c = run.counts
    if "windows" not in c:
        return None
    flops = c["windows"] * c["flops_per_window"]
    return 100.0 * flops / run.window_s / cnt.PEAK_FLOPS[c["dtype"]]
