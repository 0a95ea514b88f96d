"""Cells that drive ``radian_tpu_torch.train.trainer.Trainer.train_step``:
a closed loop of steps over a pool of device batches from the seed.

Set-up builds one ``Trainer``, loads the benchmark's seeded weights into
it, and drives it through its first three steps, on batches whose rows
all differ, with the window's own call and feed; the window continues
from there.  The check compares those three steps with the plain
reference's: each step's loss, the first gradient as Adam's first moment
holds it after one step (``mu / (1 - b1)``), and each leaf's change
after the three steps.
"""

from __future__ import annotations

import re
import time

import numpy as np

from benchmark.core import compare as cmp
from benchmark.core import counts as cnt
from benchmark.core import inputs
from benchmark.core import reference as plain

CHECK_STEPS = 3


def flax_name(name: str) -> str:
    """The program's parameter name → the published (flax) one."""
    m = re.fullmatch(r"tcn\.blocks\.(\d+)\.(conv0|conv1|shortcut)\."
                     r"(weight|bias)", name)
    if m:
        leaf = "kernel" if m[3] == "weight" else "bias"
        mid = "" if m[2] == "shortcut" else "/Conv_0"
        return f"tcn/block{m[1]}/{m[2]}{mid}/{leaf}"
    m = re.fullmatch(r"(dense_relu|dense_out)\.(weight|bias)", name)
    if m:
        return f"{m[1]}/{'kernel' if m[2] == 'weight' else 'bias'}"
    raise KeyError(name)


def _norms(tensors: dict) -> dict[str, float]:
    import torch

    names = list(tensors)
    vals = torch.stack([tensors[k].double().norm() for k in names])
    return dict(zip(names, vals.cpu().tolist()))


class TrainCell:
    def __init__(self, root, c: dict, seed: int, device):
        import torch

        from radian_tpu_torch.config import DotDict
        from radian_tpu_torch.models.checkpoint import params_from_flax
        from radian_tpu_torch.train.trainer import TrainConfig, Trainer

        cfg, t = c["config"], c["traffic"]
        mc = cfg["model_config"]
        self.c, self.seed, self.device = c, seed, device
        t0 = time.perf_counter()
        self.model = mc["model"]
        self.window_len = mc["data"]["window_size"]
        self.weights = inputs.seeded_weights(seed, self.model, device)
        self.batches = inputs.train_batches(
            seed, t, mc["train"]["batch_size"], self.window_len,
            cfg["outlier_clip"])
        self.tr = Trainer(DotDict(mc), TrainConfig(
            checkpoint_dir=None, log_dir=None, compute_dtype=cfg["dtype"],
            device=str(device)))
        state = params_from_flax(self.weights)
        with torch.no_grad():
            for k, p in self.tr.params.items():
                p.copy_(state[k])
        init = {k: p.detach().clone() for k, p in self.tr.params.items()}
        t1 = time.perf_counter()
        pool = self.tr.preload_batches(self.batches)
        self.feed = [{k: v[i] for k, v in pool.items()}
                     for i in range(len(self.batches))]
        b1 = mc["train"]["opt"]["adam"]["beta_1"]
        self.losses = []
        for s in range(CHECK_STEPS):
            self.losses.append(float(self.tr.train_step(self.feed[s])))
            if s == 0:
                mu = self.tr.opt_state.slots["mu"]
                self.grad = _norms({flax_name(k): v / (1 - b1)
                                    for k, v in mu.items()})
        self.change = _norms({flax_name(k): p.detach() - init[k]
                              for k, p in self.tr.params.items()})
        del init
        self.phases = {"inputs_program_s": t1 - t0,
                       "first_steps_s": time.perf_counter() - t1}
        self.steps = CHECK_STEPS
        self.window_losses = []

    def window(self, seconds: float) -> float:
        import torch

        t0 = time.perf_counter()
        n = len(self.feed)
        while time.perf_counter() - t0 < seconds:
            self.window_losses.append(
                self.tr.train_step(self.feed[self.steps % n]))
            self.steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def counts(self) -> dict:
        import torch

        losses = torch.stack(self.window_losses).float().cpu().numpy()
        rows = self.c["config"]["model_config"]["train"]["batch_size"]
        return {
            "attempted": len(losses),
            "failed": int((~np.isfinite(losses)).sum()),
            "steps": len(losses),
            "windows": len(losses) * rows,
            "flops_per_window": cnt.train_flops_per_window(
                self.model, self.window_len),
            "dtype": self.c["config"]["dtype"],
        }

    def served(self) -> dict:
        out = {"losses": self.losses, "grad": self.grad,
               "change": self.change, "weights": self.weights,
               "batches": self.batches[:CHECK_STEPS]}
        del self.tr, self.feed
        return out


def setup(root, c: dict, seed: int, device) -> TrainCell:
    return TrainCell(root, c, seed, device)


def reference(root, c: dict, seed: int, served: dict, device,
              rounding: str | None = None, half_batch: bool = False) -> dict:
    """The plain reference's first three steps from the same weights on
    the same batches (``half_batch``: the fault that keeps the first half
    of each batch's rows)."""
    import torch

    mc = c["config"]["model_config"]
    adam = mc["train"]["opt"]["adam"]
    model = mc["model"]
    p = plain.torch_params(served["weights"], model, device,
                               requires_grad=True)
    init = {k: v.detach().clone() for k, v in p.items()}
    batches = []
    for b in served["batches"]:
        rows = len(b["signal"]) // 2 if half_batch else len(b["signal"])
        batches.append({k: torch.from_numpy(np.asarray(v)[:rows]).to(device)
                        for k, v in b.items()})
    losses, first = plain.adam_steps(
        p, model, batches, adam["lr"], adam["beta_1"], adam["beta_2"],
        adam["epsilon"], rounding)
    change = _norms({k: p[k].detach() - init[k] for k in p})
    return {"losses": losses, "grad": _norms(first), "change": change}


def compare(c: dict, served: dict, ref: dict) -> dict:
    """``loss_gap``: the worst of the three steps' relative loss gaps;
    ``grad_gap`` and ``change_gap``: the worst leaf's gap of norms (the
    change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's: they move by round-off alone)."""
    med = float(np.median(list(ref["grad"].values())))
    keep = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(served["losses"], ref["losses"])),
        "grad_gap": cmp.leaf_norm_gap(served["grad"], ref["grad"]),
        "change_gap": cmp.leaf_norm_gap(served["change"], ref["change"],
                                        keep),
    }
