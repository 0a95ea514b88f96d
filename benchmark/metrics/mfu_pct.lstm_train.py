"""Training FLOPs of the LSTM-CRF over the window's time, against the
bf16 peak (989 TFLOP/s): every chunk stepped times three times the
forward's FLOPs a chunk (the forward, the data gradient and the weight
gradient; ``core/counts_lstm_crf.py``: ~15.49 MFLOP a sample at the
published widths), counted from the shapes; the loss and the optimizer
not counted."""

from benchmark.core import counts_lstm_crf as cnt


def read(run):
    c = run.counts
    if "windows" not in c or "flops_per_chunk" not in c:
        return None
    flops = 3 * c["windows"] * c["flops_per_chunk"]
    return 100.0 * flops / run.window_s / cnt.PEAK_FLOPS_BF16
