"""Module fixture for the port's CPU tests: run after the others, on one CPU.

``tests/test_train.py`` runs 8-device XLA CPU collectives that abort their
process (XLA's 40 s rendezvous termination timeout) in some runs of the
tier-1 suite, and a pytest-xdist run then hangs until its time limit.
How often depends on what the other workers do while it starts: an extra
busy process raises the rate, and so did workers left idle.  So the
port's test modules leave the rest of the run as it would be without
them:

- they import ``torch`` and ``radian_tpu_torch`` inside their tests and
  fixtures, never at module level: collection imports every test module
  into every xdist worker;
- each holds at most two test items: ``--dist loadfile`` queues files by
  item count, most first, so such a module is handed out only after
  every file with more items, ``test_train.py`` among them, is under way;
- on an xdist worker, this fixture then waits until the machine is quiet
  but for the port's own modules, and keeps all the module's threads,
  JAX's and torch's, on one CPU of their own.
"""

import os
import time
from pathlib import Path

import pytest

IDLE_MARGIN_CPUS = 0.5  # busy CPUs allowed beside the port's own modules
POLL_SECONDS = 1.0
MAX_WAIT_SECONDS = 300.0


def _pin_threads(cpus):
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except ProcessLookupError:  # the thread ended meanwhile
            pass


def _busy_cpu_seconds() -> float:
    """CPU seconds the machine has spent busy so far, from the first line
    of /proc/stat (user nice system idle iowait irq softirq steal ...)."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:8]]
    return (sum(ticks) - ticks[3] - ticks[4]) / os.sysconf("SC_CLK_TCK")


def _wait_for_quiet_machine(registry: Path) -> None:
    """Poll until the machine kept fewer CPUs busy in the last poll than
    the port's modules already past this wait (one CPU each, listed in
    ``registry``) plus IDLE_MARGIN_CPUS, or MAX_WAIT_SECONDS pass.  Only
    the machine-wide counters are read: polling other processes' /proc
    entries made tests/test_train.py abort more often."""
    deadline = time.monotonic() + MAX_WAIT_SECONDS
    busy, t = _busy_cpu_seconds(), time.monotonic()
    while t < deadline:
        time.sleep(POLL_SECONDS)
        busy_now, t_now = _busy_cpu_seconds(), time.monotonic()
        running = len(list(registry.iterdir()))
        if (busy_now - busy) / (t_now - t) < running + IDLE_MARGIN_CPUS:
            return
        busy, t = busy_now, t_now


@pytest.fixture(scope="module", autouse=True)
def one_cpu(tmp_path_factory):
    cpus = os.sched_getaffinity(0)
    mine = max(cpus)
    registered = None
    worker = os.environ.get("PYTEST_XDIST_WORKER")  # "gw0", "gw1", ...
    if worker:
        # the workers' base temp dirs share this parent
        registry = tmp_path_factory.getbasetemp().parent / "torch-modules"
        registry.mkdir(exist_ok=True)
        _wait_for_quiet_machine(registry)
        registered = registry / str(os.getpid())
        registered.touch()
        # a CPU per worker, so the port's modules do not share one
        mine = sorted(cpus)[-1 - int(worker[2:]) % len(cpus)]

    import torch

    n_threads = torch.get_num_threads()
    _pin_threads({mine})
    torch.set_num_threads(1)
    yield
    _pin_threads(cpus)
    torch.set_num_threads(n_threads)
    if registered is not None:
        registered.unlink()
