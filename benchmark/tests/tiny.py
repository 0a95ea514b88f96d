"""A tiny copy of the benchmark for CPU tests: the same harness and
files, with configurations and traffic cut to sizes a CPU test can run,
written into a temporary directory beside a copy of ``benchmark/``."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"relu_units": 8, "softmax_units": 5, "timesteps": 256,
              "tcn": {"nb_filters": 8, "kernel_size": 3, "nb_stacks": 1,
                      "dilations": [1, 2], "padding": "causal",
                      "use_skip_connections": False, "dropout_rate": 0.0,
                      "return_sequences": True, "activation": "relu",
                      "kernel_initializer": "he_normal",
                      "use_batch_norm": False}}
TINY_OPTS = {"chunk_len": 256, "step_size": 32, "bucket_quantum": 512}


def make(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` holding ``benchmark/`` and a ``BENCHMARK.json`` whose cells
    are the real ones at tiny sizes, in float32 (the CPU has no bf16
    convolutions worth timing); returns ``tmp``."""
    import torch

    from benchmark.core import inputs

    tmp = Path(tmp)
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "data"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in spec["configs"]:
        path = tmp / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["model_config"]["model"] = copy.deepcopy(TINY_MODEL)
        cfg["model_config"]["data"]["window_size"] = 256
        cfg["model_config"]["train"]["batch_size"] = 4
        cfg["dtype"] = "float32"
        if cfg["kind"] == "basecaller":
            cfg["options"].update(TINY_OPTS)
            w = inputs.seeded_weights(3, TINY_MODEL, torch.device("cpu"))
            cfg["weights"] = "benchmark/data/tiny.npz"
            (tmp / "benchmark" / "data").mkdir(exist_ok=True)
            np.savez(tmp / cfg["weights"], **w)
        path.write_text(json.dumps(cfg))
    for name in ("bulk", "single", "train_step"):
        path = tmp / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(length_min=300, length_max=700, dwell_mean=8.0,
                 dwell_std=2.0, pool_batches=4)
        if name == "bulk":
            t.update(reads_per_call=6, options={"read_batch": 3},
                     check_reads=4, check_batches=2)
        if name == "single":
            t.update(distinct_calls=6, check_reads=3, check_batches=3)
        path.write_text(json.dumps(t))
    for cell in spec["workloads"]:
        path = tmp / "benchmark" / "checks" / f"{cell['name']}.json"
        chk = json.loads(path.read_text())
        chk["limits"] = {k: (limits or {}).get(k, 1e-3 if k != "reads_missing"
                                               else 0.0)
                         for k in chk["limits"]}
        path.write_text(json.dumps(chk))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
