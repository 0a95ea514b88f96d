"""The decode kernels' (beam decode, with or without the LM, and
backtrace) share of their roofline: the least time the work could take
(operations over 67 TOP/s, or bytes over 3.35 TB/s, whichever is
longer; both counted from the inputs) over their device time."""

from benchmark.core import counts as cnt
from benchmark.core.readers import decode_device_s


def read(run):
    kernel_s = decode_device_s(run)
    c = run.counts
    if kernel_s is None or "decode_active_steps" not in c:
        return None
    bound_s, _ = cnt.decode_bound_s(c["decode_active_steps"], c["beam"],
                                    c["lm"], c["emitted_bases"],
                                    c["lm_row_bytes"])
    return 100.0 * bound_s / kernel_s
