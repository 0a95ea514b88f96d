"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path

from benchmark.core import compare, isolation, spec
from benchmark.core.trace import traced


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell, its set-up and window on
    the host clock, the counts of the work done in the window, and the
    device trace of a ``--trace 1`` run (else None)."""

    cell: dict
    setup_s: float
    window_s: float
    counts: dict
    trace: object = None


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             require_cuda: bool = True) -> tuple[dict, list[str]]:
    """Run the cell once → ``(result line, lines for standard error)``.

    ``require_cuda`` is the look for a chip: without a card, or with
    fewer than the cell asks for, it raises before anything runs.
    """
    import torch

    c = spec.cell(root, name)
    chips = c["workload"]["chips"]
    if require_cuda and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= chips):
        raise SystemExit(f"cell {name} needs {chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()} "
                         f"(available: {torch.cuda.is_available()})")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    kind = spec.kind(c["config"])
    t_setup = time.perf_counter()
    cell = kind.setup(root, c, seed, dev)
    phases = {"start_s": t_setup - t_start, **cell.phases}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    setup_s = time.perf_counter() - t_start
    with traced(trace, sync) as held:
        window_s = cell.window(seconds)
    counts = cell.counts()
    dev_info = device_info(dev, chips)
    if held.trace is not None:
        dev_info["busy_s"] = held.trace.busy_s
        dev_info["window_s"] = held.trace.window_s
    run = Run(c, setup_s, window_s, counts, held.trace)

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check: the program's outputs gathered, its state freed, then
    # the reference
    t_check = time.perf_counter()
    served = cell.served()
    del cell
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = kind.reference(root, c, seed, served, dev, rounding=None)
    numbers = kind.compare(c, served, ref)
    limits = c["checks"]["limits"]
    correct = compare.judge(numbers, limits)
    phases.update(window_s=window_s, check_s=time.perf_counter() - t_check)
    if held.trace is not None:
        phases["trace_reduce_s"] = held.reduce_s
    checks = compare.report(numbers, limits)

    result = {"correct": bool(correct), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics,
              "device": dev_info}
    if held.trace is not None:
        result["breakdown"] = {"device_ops": held.trace.top_ops(),
                               "idle_gaps": held.trace.top_gaps()}
    result["checks"] = checks
    err = ["phases: " + " ".join(f"{k}={v:.3f}" for k, v in phases.items())]
    if counts.get("launches"):
        err.append(f"kernel launches in the window: {counts['launches']}")
    err += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
           for k, v in checks.items()]
    return result, err


def main(argv, root: Path, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run one benchmark cell once and print its result "
                    "as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faults = isolation.source_faults(root / "benchmark")
    if faults:
        print("\n".join(faults), file=sys.stderr)
        return 4
    result, err = run_cell(root, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start)
    bad = isolation.loaded_forbidden()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 5
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        print(f"a metric is not finite: {result['metrics']}",
              file=sys.stderr)
        return 6
    print(json.dumps(result), flush=True)
    print("\n".join(err), file=sys.stderr, flush=True)
    return 0
