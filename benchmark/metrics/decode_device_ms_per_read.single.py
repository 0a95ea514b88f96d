"""Device time of the decode and backtrace kernels per read completed."""

from benchmark.core.readers import decode_device_s


def read(run):
    s = decode_device_s(run)
    if s is None or not run.counts.get("reads"):
        return None
    return 1e3 * s / run.counts["reads"]
