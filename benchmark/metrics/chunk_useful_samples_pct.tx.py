"""Share of the samples the forward runs over that are real: the port's
``real_samples`` counter (the reads' own samples) over its
``chunk_samples`` (rows × chunk samples of every chunk batch: overlaps,
a short read's repeats and filler rows included)."""

from radian_tpu_torch.utils import profiling


def read(run):
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("chunk_samples"):
        return None
    return 100.0 * c.get("real_samples", 0) / c["chunk_samples"]
