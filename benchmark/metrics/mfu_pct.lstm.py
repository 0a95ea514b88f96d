"""Useful model FLOPs of the LSTM-CRF model over the window's time,
against the bf16 peak (989 TFLOP/s): every real sample returned times
the FLOPs a sample (``core/counts_lstm_crf.py``: ~15.49 M at the
published widths), counted once (no chunk overlap, tiling or filler
rows)."""

from benchmark.core import counts_lstm_crf as cnt


def read(run):
    c = run.counts
    if "chunksize" not in c or "samples" not in c:
        return None
    flops = c["samples"] * cnt.flops_per_sample(c["model"], c["chunksize"])
    return 100.0 * flops / run.window_s / cnt.PEAK_FLOPS_BF16
