"""Share of the samples the forward runs over that are real: the port's
``real_samples`` counter (the reads' own samples) over its
``forward_samples`` (rows × columns of every forward input: bucket
padding, filler rows and, in chunk mode, every window's head fix-up)."""

from radian_tpu_torch.utils import profiling


def read(run):
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("forward_samples"):
        return None
    return 100.0 * c.get("real_samples", 0) / c["forward_samples"]
