"""The harness end to end on the CPU at tiny sizes: every cell runs and
comes out correct, each fault a cell can have makes it come out not
correct, the control fails its check, and a run with no card stops."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark.core import harness, isolation, spec
from benchmark.tests import tiny

CELLS = [w["name"] for w in spec.load(tiny.ROOT)["workloads"]]
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    root = tiny.make(tmp_path_factory.mktemp("tiny"))
    sys.path.insert(0, str(root))
    yield root
    sys.path.remove(str(root))


def run(root, cell, trace=False):
    res, err = harness.run_cell(root, cell, SEED, 0.5, trace, 0.0,
                                device="cpu", require_cuda=False)
    return res, err


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny_root, cell):
    res, err = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert err[-len(res["checks"]):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in spec.cell(tiny_root, cell)["end_to_end"]}
    assert set(res["metrics"]) == names
    assert all(np.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())
    json.dumps(res)
    assert isolation.loaded_forbidden() == []


def _altered(fn):
    def call(self, signals):
        out = fn(self, signals)
        return [None if s is None else ("T" if s[:1] != "T" else "A") + s[1:]
                for s in out]
    return call


def _half_missing(fn):
    def call(self, signals):
        out = fn(self, signals)
        return [None if i % 2 else s for i, s in enumerate(out)]
    return call


def _unchanged(fn):
    def step(self, batch):
        return self.loss(batch).detach()
    return step


def _half_batch(fn):
    def step(self, batch):
        rows = batch["signal"].shape[0] // 2
        return fn(self, {k: v[:rows] for k, v in batch.items()})
    return step


FAULTS = [
    ("global_lm_bf16.bulk", "basecall_signals", _altered),
    ("global_lm_bf16.bulk", "basecall_signals", _half_missing),
    ("chunk_f32.bulk", "basecall_signals", _altered),
    ("global_lm_bf16.single", "basecall_signals", _altered),
    ("train_f32.step", "train_step", _unchanged),
    ("train_f32.step", "train_step", _half_batch),
]


@pytest.mark.parametrize("cell,method,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            method, fault):
    """The timed path broken underneath: an answer altered where it is
    produced, half the answers missing, a step that leaves the state
    unchanged, half of each batch left out.  (One chip: no exchange
    between chips to leave out.)"""
    from radian_tpu_torch.pipeline import Basecaller
    from radian_tpu_torch.train.trainer import Trainer

    owner = Basecaller if method == "basecall_signals" else Trainer
    monkeypatch.setattr(owner, method, fault(getattr(owner, method)))
    res, _ = run(tiny_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,rounding", [
    ("global_lm_bf16.bulk", "fp8"), ("global_lm_bf16.bulk", "tf32"),
    ("chunk_f32.bulk", "tf32"), ("train_f32.step", "tf32")])
def test_control_fails_the_check(tiny_root, cell, rounding):
    """The reference in a lower precision (the cells' controls: fp8 for
    bf16, TF32 for float32; the tiny cells compute in float32), put in
    the program's place, reads at least three times what the program
    reads on one of the numbers."""
    import torch

    c = spec.cell(tiny_root, cell)
    kind = spec.kind(c["config"])
    dev = torch.device("cpu")
    cell_run = kind.setup(tiny_root, c, SEED, dev)
    cell_run.window(0.2)
    served = cell_run.served()
    ref = kind.reference(tiny_root, c, SEED, served, dev)
    prog = kind.compare(c, served, ref)
    ctl = kind.compare(c, {**served, **kind.reference(
        tiny_root, c, SEED, served, dev, rounding=rounding)}, ref)
    assert any(ctl[k] > 3 * prog[k] and ctl[k] > 0 for k in prog), (prog,
                                                                    ctl)


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(tiny.ROOT / "benchmark" / "run.py"),
         "--workload", "global_lm_bf16.bulk", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout
