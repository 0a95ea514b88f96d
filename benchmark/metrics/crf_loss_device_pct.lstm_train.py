"""Share of a training step's device time spent in the CTC-CRF loss:
the port's ``radian.train.crf_loss`` (the forward pass) and
``radian.train.crf_loss.backward`` (the gradient) spans over its
``radian.train.step`` spans, all from their CUDA events."""

from radian_tpu_torch.utils import profiling

LOSS = ("radian.train.crf_loss", "radian.train.crf_loss.backward")


def _device_ms(spans, names):
    return sum(s["device_end_ms"] - s["device_start_ms"] for s in spans
               if s["name"] in names and s["device_start_ms"] is not None)


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans()
    loss = _device_ms(got, LOSS)
    step = _device_ms(got, ("radian.train.step",))
    if loss <= 0 or step <= 0:
        return None
    return 100.0 * loss / step
