"""``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by its name:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration;
- ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters;
- ``benchmark/metrics/<metric>.py``: a metric's reader, ``read(run)``;
- ``benchmark/checks/<cell>.json``: the limits of a cell's check;
- ``benchmark/kinds/<kind>.py``: the code that drives a configuration's
  entry point (``kind`` in its file).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(root: Path, name: str) -> dict:
    """The cell with its configuration and traffic loaded, and the
    metrics it reports in each mode."""
    spec = load(root)
    root = Path(root)
    wl = by_name(spec["workloads"], name, "workload")
    cfg_entry = by_name(spec["configs"], wl["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic"
                          / f"{wl['traffic']}.json").read_text())
    checks = json.loads((root / "benchmark" / "checks"
                         / f"{name}.json").read_text())

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "workload": wl, "config_entry": cfg_entry,
            "config": config, "traffic": traffic, "checks": checks,
            "end_to_end": reported(spec["end_to_end"]),
            "per_layer": reported(spec["per_layer"])}


def kind(config: dict):
    """The module that drives this configuration's kind of entry point."""
    return importlib.import_module(f"benchmark.kinds.{config['kind']}")


def reader(root: Path, metric: str):
    """``read(run) -> float | None`` of ``benchmark/metrics/<metric>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
