"""Mean device time of the port's ``radian.forward`` span a batch: its
CUDA events on the device's stream around the global forward, or the
chunk full-read forward with the head fix-up (a span a batch slice)."""

from radian_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    ms = [s["device_end_ms"] - s["device_start_ms"] for s in spans()
          if s["name"] == "radian.forward"
          and s["device_start_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
