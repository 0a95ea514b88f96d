#!/usr/bin/env python3
"""Reads/s of one checkout's ``radian_tpu_torch.Basecaller`` on
``chip_smoke.py`` phase 5's input, to compare two checkouts' host
dispatch on one card in one call.

Phase 5's input: 512 synthetic reads of 5,120-15,360 samples, the
trained model (``bench_data/trained/params.npz``), global mode without
an LM, float32, beam 6, read_batch 256, bucket quantum 4,096.  One
warm-up run, then ``--reps`` timed runs of ``basecall_signals``, each
synchronised.  ``--data N`` makes it a mesh of N replicas on cuda:0.

    python3 scripts/ab_dispatch.py --tree PARENT_CHECKOUT --label parent
    python3 scripts/ab_dispatch.py --tree . --label change

Prints one JSON line: the label, data, per-run reads/s and the card
(``nvidia-smi --query-gpu=name,power.limit``).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="checkout whose radian_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--data", type=int, default=None,
                    help="a mesh of this many replicas on cuda:0")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller
    from radian_tpu_torch.utils.synthetic import kmer_level_table

    sys.path.insert(1, str(HERE))
    from chip_smoke import TRAINED, synth_signals

    if not torch.cuda.is_available():
        print("ab_dispatch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    mesh = None
    if args.data is not None:
        from radian_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=args.data, devices=[dev] * args.data)
    opts = BasecallOptions(beam_width=6, read_batch=256, bucket_quantum=4096)
    bc = load_basecaller(TRAINED, options=opts, mesh=mesh, device=dev)
    levels = kmer_level_table(np.random.default_rng(1))
    rng = np.random.default_rng(3)
    reads = synth_signals(rng, rng.integers(5120, 15361, 512), levels)
    bc.basecall_signals(reads)  # cuDNN plans, allocator, kernel builds
    rates = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bc.basecall_signals(reads)
        torch.cuda.synchronize()
        rates.append(len(reads) / (time.perf_counter() - t0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"label": args.label or str(tree), "data": args.data,
                      "reads_per_s": rates, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
