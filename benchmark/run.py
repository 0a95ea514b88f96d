"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

It builds the cell's inputs from the seed, sets up and warms the port
(``radian_tpu_torch``), measures for ``S`` seconds (under the profiler
with ``--trace 1``), checks what the window produced against the plain
reference, and prints one JSON line last on standard output, the
compared numbers beside their limits last on standard error.  It needs
as many CUDA devices as the cell asks for, and fails without them.
"""

import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()
ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / ".benchcache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path.insert(0, str(ROOT))
    from benchmark.core.harness import main

    sys.exit(main(sys.argv[1:], ROOT, T_START))
