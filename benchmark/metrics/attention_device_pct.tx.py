"""Share of the forward's device time spent in attention: the port's
``radian.tx.attention`` spans (a layer's ``Wqkv``, rotary embedding,
banded attention and ``out_proj``) over its ``radian.forward`` spans,
both from their CUDA events."""

from radian_tpu_torch.utils import profiling


def _device_ms(spans, name):
    return sum(s["device_end_ms"] - s["device_start_ms"] for s in spans
               if s["name"] == name and s["device_start_ms"] is not None)


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans()
    attn, fwd = (_device_ms(got, "radian.tx.attention"),
                 _device_ms(got, "radian.forward"))
    if attn <= 0 or fwd <= 0:
        return None
    return 100.0 * attn / fwd
