"""Host time inside the port's ``radian.forward`` span per read: the
enqueue of the launch-bound forward, from the spans' host clock, over
the port's ``reads`` counter."""

from radian_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    reads = profiling.counters().get("reads")
    ns = [s["host_end_ns"] - s["host_start_ns"] for s in spans()
          if s["name"] == "radian.forward"]
    if not ns or not reads:
        return None
    return 1e-6 * sum(ns) / reads
