"""Share of the traced window the device sat idle while the host ran one
of the port's host-only spans (sort and bucketing, pad, render, stitch):
the idle gaps the trace labels with those spans' names."""

from radian_tpu_torch.utils import profiling

HOST_SPANS = ("radian.batches", "radian.pad", "radian.render",
              "radian.stitch")


def read(run):
    spans = getattr(profiling, "spans", None)
    if run.trace is None or run.trace.window_s <= 0 or spans is None \
            or not spans():
        return None
    idle = sum(d for label, d in run.trace.gaps if label in HOST_SPANS)
    return 100.0 * idle / run.trace.window_s
