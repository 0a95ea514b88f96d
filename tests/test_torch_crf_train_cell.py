"""The benchmark's ``lstm_crf_trainer`` kind (``benchmark/kinds/
lstm_crf_trainer.py``, the cell ``lstm_sup_bf16.train``) at a tiny size
on the CPU: its set-up, its gathering of what the port served, the
plain reference and the comparison, judged by the cell's own limits;
and the whole cell through the harness, traced.  ``torch`` and the port
are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import copy
import json
import shutil
import time
from pathlib import Path

from tests.torch_lstm_tiny import config
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CELL = "lstm_sup_bf16.train"
SEED = 3100000000123  # past 32 bits, as a benchmark run's seed may be


def _tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell's configuration and traffic at a CPU test's size: the
    narrow LSTM-CRF (state_len 3), 4 chunks of 600 samples a batch, a
    pool of 3, float32."""
    cfg = copy.deepcopy(cfg)
    model = config()["model"]
    model["crf"]["state_len"] = 3
    cfg["model_config"]["model"] = model
    cfg["model_config"]["train"].update(batch_size=4, chunksize=600)
    cfg["dtype"] = "float32"
    return cfg, dict(traffic, pool_batches=3)


def test_kind_runs_correct_and_fails_the_half_batch_fault():
    """The kind's set-up, ``served``, ``reference`` and ``compare`` at the
    tiny size in float32 come out within the cell's limits (set for the
    bf16 program at the published widths, far above float32's rounding),
    and the fault that keeps half of each batch's rows is over them;
    the counts cover the window's steps.  The fault is a program whose
    steps weigh the second half of each batch's rows 0: its row losses
    read 0 where the reference's do not, ``row_gap`` 1."""
    import torch

    from benchmark.core import compare, spec
    from benchmark.kinds import lstm_crf_trainer as kind

    c = spec.cell(REPO, CELL)
    assert c["config"]["kind"] == "lstm_crf_trainer"
    cfg, traffic = _tiny(c["config"], c["traffic"])
    c = {**c, "config": cfg, "traffic": traffic}
    cell = kind.setup(REPO, c, SEED, torch.device("cpu"))
    assert len(cell.losses) == kind.CHECK_STEPS
    cell.window(0.2)
    counts = cell.counts()
    assert counts["failed"] == 0 and counts["steps"] >= 1
    assert counts["windows"] == 4 * counts["steps"]
    assert counts["chunk_steps"] == 100 and counts["state_len"] == 3
    served = cell.served()
    ref = kind.reference(REPO, c, SEED, served, torch.device("cpu"))
    limits = c["checks"]["limits"]
    numbers = kind.compare(c, served, ref)
    assert compare.judge(numbers, limits), (numbers, limits)
    half = kind.setup(REPO, c, SEED, torch.device("cpu"), half_batch=True)
    fault = kind.compare(c, half.served(), ref)
    assert fault["row_gap"] == 1.0, fault
    assert not compare.judge(fault, limits), (fault, limits)


def test_cell_runs_through_the_harness_traced(tmp_path):
    """The cell through ``harness.run_cell`` on a copy of the benchmark
    whose configuration and traffic are cut to the tiny size: correct,
    its host-clock metric reported, and the device metrics (kernels and
    CUDA-event spans, which the CPU has not) left out, not raised."""
    from benchmark.core import harness

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "data"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    wl = next(w for w in spec["workloads"] if w["name"] == CELL)
    entry = next(e for e in spec["configs"] if e["name"] == wl["config"])
    cfg_path = tmp_path / entry["file"]
    t_path = tmp_path / "benchmark" / "traffic" / f"{wl['traffic']}.json"
    cfg, traffic = _tiny(json.loads(cfg_path.read_text()),
                         json.loads(t_path.read_text()))
    cfg_path.write_text(json.dumps(cfg))
    t_path.write_text(json.dumps(traffic))
    result, err = harness.run_cell(tmp_path, CELL, SEED, 0.3, True,
                                   time.perf_counter(), device="cpu",
                                   require_cuda=False)
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"mfu_pct.lstm_train"}, result
    assert result["metrics"]["mfu_pct.lstm_train"]["value"] > 0
    assert set(result["checks"]) == {"loss_gap", "row_gap", "grad_gap",
                                     "change_gap"}
