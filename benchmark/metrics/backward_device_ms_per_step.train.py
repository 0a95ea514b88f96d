"""Mean device time of the port's ``radian.train.backward`` span a step:
its CUDA events on the device's stream around ``autograd.grad``."""

from radian_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    ms = [s["device_end_ms"] - s["device_start_ms"] for s in spans()
          if s["name"] == "radian.train.backward"
          and s["device_start_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
