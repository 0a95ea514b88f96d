"""The LSTM recurrence's share of its roofline: the window's useful
recurrent FLOPs (real chunks × steps × ``2·4H·(H_in + H)`` a layer,
``core/counts_lstm_crf.py``, counted from the shapes whatever computes
them) over 989 TFLOP/s, over the device time of the port's
``radian.lstm`` spans (a layer's flips and recurrence, CUDA events)."""

from benchmark.core import counts_lstm_crf as cnt
from radian_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    c = run.counts
    if spans is None or "chunks" not in c:
        return None
    lstm_ms = sum(s["device_end_ms"] - s["device_start_ms"] for s in spans()
                  if s["name"] == "radian.lstm"
                  and s["device_start_ms"] is not None)
    if lstm_ms <= 0:
        return None
    flops = cnt.lstm_flops(c["model"], c["chunks"], c["chunksize"])
    return 100.0 * flops / cnt.PEAK_FLOPS_BF16 / (lstm_ms * 1e-3)
