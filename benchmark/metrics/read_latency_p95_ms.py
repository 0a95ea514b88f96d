"""95th percentile over every read completed in the window of the time
from its call to its return."""

import numpy as np

from benchmark.core.readers import read_latencies_s


def read(run):
    if "call_latencies_s" not in run.counts:
        return None
    return 1e3 * float(np.percentile(read_latencies_s(run), 95))
