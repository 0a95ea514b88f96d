"""Share of the forward's device time spent in the LSTM layers: the
port's ``radian.lstm`` spans (a layer's flips and recurrence) over its
``radian.forward`` spans, both from their CUDA events."""

from radian_tpu_torch.utils import profiling


def _device_ms(spans, name):
    return sum(s["device_end_ms"] - s["device_start_ms"] for s in spans
               if s["name"] == name and s["device_start_ms"] is not None)


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans()
    lstm, fwd = _device_ms(got, "radian.lstm"), _device_ms(got,
                                                          "radian.forward")
    if lstm <= 0 or fwd <= 0:
        return None
    return 100.0 * lstm / fwd
