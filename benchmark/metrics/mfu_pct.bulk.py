"""Useful model FLOPs over the window's time, against the published peak
of the configuration's dtype (bf16 989 TFLOP/s; f32 without tensor cores
67): ``2·k·C_in·C_out`` a convolution and ``2·in·out`` a dense layer for
every real sample returned, counted once (no padding, no chunk head
recomputation)."""

from benchmark.core import counts as cnt


def read(run):
    c = run.counts
    if "samples" not in c:
        return None
    flops = c["samples"] * cnt.model_flops_per_sample(c["model"])
    return 100.0 * flops / run.window_s / cnt.PEAK_FLOPS[c["dtype"]]
