"""Share of the traced window with no operation running on the device
(the complement of the union of device-operation intervals)."""

from benchmark.core.readers import idle_pct


def read(run):
    return idle_pct(run)
