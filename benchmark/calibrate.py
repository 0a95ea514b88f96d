"""Readings that the limits of ``benchmark/checks/<cell>.json`` are set
from; never run by the benchmark's own runs.

    python3 benchmark/calibrate.py --workload CELL --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds S] [--out FILE]

For each seed: the cell's inputs, a short window at the cell's own load
(at least one call), the program's numbers against the plain reference,
and on the control seeds the control's: the reference computed in the
precision one step below the configuration's (bf16 → fp8, f32 → TF32),
put in the program's place.  Training cells also read the fault that
leaves out half of each batch.  One JSON line a seed, then the lower
reading of each number (the program's largest) and the upper (the
smallest of the control and the faults).  One process: the basecaller
is set up once and fed each seed's reads.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core import inputs, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    c = spec.cell(ROOT, args.workload)
    kind = spec.kind(c["config"])
    control = CONTROL[c["config"]["dtype"]]
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    rows = []
    cell = None
    for seed in seeds:
        t0 = time.perf_counter()
        if c["config"]["kind"] == "basecaller":
            if cell is None:
                cell = kind.setup(ROOT, c, seed, dev)
            else:
                cell.seed, cell.done = seed, []
                cell.calls = inputs.read_calls(seed, c["traffic"])
            cell.window(args.seconds)
        else:
            cell = kind.setup(ROOT, c, seed, dev)
        served = cell.served()
        if c["config"]["kind"] != "basecaller":
            cell = None
        torch.cuda.empty_cache()
        ref = kind.reference(ROOT, c, seed, served, dev)
        row = {"seed": seed, "program": kind.compare(c, served, ref)}
        if seed in cseeds:
            ctl = kind.reference(ROOT, c, seed, served, dev, rounding=control)
            row[control] = kind.compare(c, {**served, **ctl}, ref)
            if c["config"]["kind"] == "trainer":
                half = kind.reference(ROOT, c, seed, served, dev,
                                      half_batch=True)
                row["half_batch"] = kind.compare(c, {**served, **half}, ref)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    names = rows[0]["program"]
    summary = {"cell": args.workload, "card": torch.cuda.get_device_name(dev),
               "lower": {k: max(r["program"][k] for r in rows)
                         for k in names}}
    for other in (control, "half_batch"):
        got = [r[other] for r in rows if other in r]
        if got:
            summary[other] = {k: min(g[k] for g in got) for k in names}
    print(json.dumps(summary), flush=True)
    if out:
        print(json.dumps(summary), file=out, flush=True)
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
