"""CTC training, on one device or data-parallel over a process group
(counterpart of radian_tpu/train/trainer.py).

The JAX ``Trainer`` step, in torch: the seeded init of the JAX package
(``models/init.py``, bit for bit), the CTC loss weighted by real rows
(``ops/ctc.py``), optax's update rules (``train/optimizers.py``), the
per-step loop and the preloaded pool (``preload_batches``: uploaded once,
each step indexes it on the device), checkpoints that keep the optimizer
state and a best-on-val copy, and scalar logging to ``metrics.jsonl``
and TensorBoard event files with the JAX package's tags and steps.

``compute_dtype='bfloat16'`` runs the convolutions and the head in
bfloat16; parameters, optimizer state, residual sums, the softmax and
the loss stay float32, as in the JAX package.  In float32 on the card,
TF32 stays off (``models/sig2seq.py``).

The model family is chosen once, from the config's ``model.type``:
radian's TCN with the CTC loss (``CtcFamily``, all of the above), or
Bonito's LSTM-CRF (``CrfFamily``) with Bonito's CTC-CRF loss
(``ops/crf_loss.py``), float32 parameters under a bf16 autocast when
``compute_dtype='bfloat16'``, on one device.  The transformer-CRF is
refused: its card kernels have no backward.

Three deliberate deviations from the JAX ``Trainer``:

- ``evaluate_scan`` weights each batch's loss by its real rows, as
  ``evaluate`` does (the JAX one takes the unweighted mean of batch
  losses, so a short final batch counts as a full one);
- the edit-distance forward is the model itself (the JAX one re-jits a
  new lambda on every call);
- ``fit`` materialises the val batches only where ``epoch_scan`` or
  ``eval_edit_distance`` needs them (the JAX one always lists them).

Data parallelism is one process per GPU, torch's idiom: inside a
``torch.distributed`` group (``parallel/distributed.py``) the data axis
spans the group's processes, so ``mesh_data`` must be the world size
(``None`` takes it).  The JAX package can also shard the data axis over
several chips in one process; the port cannot (a deliberate deviation,
ROADMAP.md Queue 3).  Each process contributes its whole local batch,
padded with zero-weight filler rows to ``config.train.batch_size``, to a
global batch; the loss is the JAX one over that global batch,
``Σ(w·loss) / max(Σw, 1)``: the weight sum is all-reduced first, each
rank divides its own ``Σ(w·loss)`` by it, and the gradients are summed
(not averaged, as DDP would, which is wrong wherever the ranks' weight
sums differ).  Rank 0's initial parameters are broadcast; the optimizer,
its global-norm clip and its schedule then run the same on every rank.
Only rank 0 writes checkpoints and logs; every rank restores.

Tensor parallelism (``mesh_model`` above 1, or a ``mesh`` with a
``model`` axis) runs inside the process, as the JAX mesh has it: the
process owns one model row of devices (its row of ``mesh``, or
``parallel.model_row_devices`` of ``device``), the JAX
``param_shardings`` rule splits the conv and dense layers over it
(``models/tensor_parallel.py``), and the parameters and optimizer state
stay split, each shard on its device.  The batch, the loss and every
collective live on the row's first device: in a group, the gradients
are gathered there for the one flat all-reduce and scattered back, so
NCCL drives one device a process.  Checkpoints hold the full leaves and
full optimizer slots, so a checkpoint written at one model size
restores at another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from radian_tpu_torch.config import DotDict, default_config
from radian_tpu_torch.models.checkpoint import (
    gather_params,
    params_to_flax,
    split_params,
)
from radian_tpu_torch.models import lstm_crf, tx_crf
from radian_tpu_torch.models.init import init_lstm_crf
from radian_tpu_torch.models.sig2seq import build_model
from radian_tpu_torch.models.tensor_parallel import shard_model
from radian_tpu_torch.ops.crf_loss import crf_loss
from radian_tpu_torch.ops.ctc import ctc_loss
from radian_tpu_torch.ops.greedy import batch_mean_edit_distance
from radian_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    model_row_devices,
    param_shardings,
)
from radian_tpu_torch.pipeline import resolve_device
from radian_tpu_torch.train.optimizers import (
    OptState,
    build_optimizer,
    flax_order,
)
from radian_tpu_torch.utils import profiling
from radian_tpu_torch.utils.tensorboard import EventWriter

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_STATE_FILE = "state.pt"


@dataclasses.dataclass
class TrainConfig:
    steps_per_epoch: int | None = None  # None: one pass over train data
    checkpoint_dir: str | None = "checkpoints"
    log_dir: str | None = None
    seed: int = 0
    keep_checkpoints: int = 5
    blank_id: int = 4
    mesh_data: int | None = None
    mesh_model: int = 1
    log_every: int = 50
    # 'bfloat16': conv/dense math in bfloat16; parameters, optimizer
    # state, residual sums, softmax and the CTC loss stay float32 (a CRF
    # model: bf16 autocast over float32 parameters, the loss float32)
    compute_dtype: str = "float32"
    device: str = "cuda"


class CtcFamily:
    """Radian's TCN and the CTC loss, as the JAX ``Trainer`` has them:
    the seeded init, the parameters split over the process's model row,
    ``compute_dtype`` the model's own (bf16 math, float32 sums)."""

    host_keys: tuple[str, ...] = ()
    # the optimizer's leaf order: optax's, over the flax tree
    order = staticmethod(flax_order)

    def __init__(self, config: DotDict, tcfg: TrainConfig):
        if config.model.tcn.dropout_rate > 0.0:
            raise NotImplementedError(
                f"dropout_rate={config.model.tcn.dropout_rate}: the "
                "JAX Trainer cannot train with dropout (its train step "
                "passes no 'dropout' rng), so the port does not either; "
                "the model infers with it (a no-op at train=False)")

    def build(self, tr: "Trainer", mesh: Mesh) -> torch.nn.Module:
        model = build_model(
            tr.config, compute_dtype=_DTYPES[tr.tcfg.compute_dtype])
        model.reset_parameters(tr.tcfg.seed)
        return shard_model(model, tr.row,
                           param_shardings(params_to_flax(model), mesh))

    def losses(self, tr: "Trainer", batch: dict, train: bool):
        log_probs = tr.model(batch["signal"][..., None], train=train)
        return ctc_loss(log_probs, batch["input_length"], batch["labels"],
                        batch["label_length"], blank_id=tr.tcfg.blank_id)


class CrfFamily:
    """Bonito's LSTM-CRF and its CTC-CRF loss (``ops/crf_loss.py``), as
    ``bonito train`` has them: float32 parameters from Bonito's seeded
    init (``init_lstm_crf``), ``compute_dtype='bfloat16'`` a bf16
    autocast over them, the loss in float32 inside the span
    ``radian.train.crf_loss``.  A batch: ``signal [N, chunksize]``
    (normalised chunks), ``targets [N, n_max]`` (bases 0–3),
    ``target_length [N]`` (kept on the host: ``host_keys``) and
    ``weight [N]``.  One device: no mesh, no process group."""

    host_keys = ("target_length",)
    # the optimizer's leaf order: the model's own, as torch's
    order = staticmethod(list)

    def __init__(self, config: DotDict, tcfg: TrainConfig):
        self.kind = config.model.type
        self.state_len = config.model.crf.state_len

    def build(self, tr: "Trainer", mesh: Mesh) -> torch.nn.Module:
        if tr.grouped or len(tr.row) > 1 or mesh.shape["data"] > 1:
            raise NotImplementedError(
                f"a {self.kind} model trains on one device, not a mesh or "
                "a process group")
        model = build_model(tr.config, compute_dtype=torch.float32)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               init_lstm_crf(tr.config.model,
                                             tr.tcfg.seed).items()})
        return model.to(tr.device)

    def losses(self, tr: "Trainer", batch: dict, train: bool):
        dev = tr.device
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=tr.tcfg.compute_dtype == "bfloat16"):
            scores = tr.model(batch["signal"])
        with profiling.span("radian.train.crf_loss", dev):
            return crf_loss(scores, batch["targets"], batch["target_length"],
                            self.state_len)


def _family(config: DotDict, tcfg: TrainConfig):
    """The config's model family: radian's unless ``model.type`` names
    Bonito's LSTM-CRF; the transformer-CRF is refused."""
    kind = config.model.get("type")
    if kind == tx_crf.MODEL_TYPE:
        raise NotImplementedError(
            f"model.type {kind!r}: the transformer-CRF does not train, as "
            "its card kernels (csrc/tx_attention.cu, csrc/tx_norm.cu) have "
            "no backward")
    if kind == lstm_crf.MODEL_TYPE:
        return CrfFamily(config, tcfg)
    if kind is not None:
        raise ValueError(f"model.type {kind!r}: {lstm_crf.MODEL_TYPE!r} or "
                         "none for radian's SigToSeq")
    return CtcFamily(config, tcfg)


class Trainer:
    """``mesh``, as in the JAX package, wins over ``mesh_data`` and
    ``mesh_model``: its data axis is the process group (its size, or 1
    when each process passes its own row), and this process trains on
    its row of the model axis (row ``rank``, or the one row)."""

    def __init__(self, config: DotDict | None = None,
                 train_config: TrainConfig | None = None,
                 mesh: Mesh | None = None):
        # a copy: update_learning_rate rewrites the optimizer config
        self.config = (config if config is not None
                       else default_config()).copy()
        self.tcfg = train_config or TrainConfig()
        # in a group (of any size, one rank too) every step all-reduces
        self.grouped = dist.is_initialized()
        self.world = dist.get_world_size() if self.grouped else 1
        self.rank = dist.get_rank() if self.grouped else 0
        if mesh is None:
            if self.tcfg.mesh_data not in (None, self.world):
                raise ValueError(
                    f"mesh_data={self.tcfg.mesh_data} in a group of "
                    f"{self.world} process(es): the data axis is the "
                    "process group, one process per GPU; start mesh_data "
                    "processes (the training CLI's --num-processes/"
                    "--process-id/--coordinator, or torchrun)")
            row = model_row_devices(resolve_device(self.tcfg.device),
                                    self.tcfg.mesh_model)
            mesh = make_mesh(1, len(row), row)
        elif mesh.shape["data"] not in (1, self.world):
            raise ValueError(
                f"a mesh of {mesh.shape['data']} data rows in a group of "
                f"{self.world} process(es): its data axis is the process "
                "group (one row a process), or 1 (this process's own row)")
        self.mesh = mesh
        self.row = [resolve_device(d) for d in mesh.model_row(
            self.rank if mesh.shape["data"] > 1 else 0)]
        # the model family, chosen once: its model, weights and loss
        self.family = _family(self.config, self.tcfg)
        # the batch, the loss and the collectives: the row's first device
        self.device = self.row[0]
        self.model = self.family.build(self, mesh)
        # the trained parameters (Bonito's LSTMs keep bias_hh at zero)
        self.params = {k: p for k, p in self.model.named_parameters()
                       if p.requires_grad}
        if self.grouped:
            with torch.no_grad():
                for p in self.params.values():
                    t = p.detach().to(self.device)
                    dist.broadcast(t, src=0)
                    p.copy_(t)
        self.order = self.family.order(self.params)
        self.tx = build_optimizer(self.config.train.opt)
        self.opt_state = self.tx.init(self.params)
        self.step = 0

        self.best_val_loss = float("inf")
        self.best_epoch: int | None = None
        self._ckpt_dir = self._best_dir = None
        if self.tcfg.checkpoint_dir:
            self._ckpt_dir = Path(self.tcfg.checkpoint_dir).absolute()
            # best-on-val-loss checkpoint (reference ModelCheckpoint
            # monitor='val_loss' save_best_only, train.py:72-78), in its
            # own directory so the keep-N rotation never deletes it
            self._best_dir = self._ckpt_dir / "best"
        self._jsonl = None
        self._writer = None
        if self.tcfg.log_dir and self.rank == 0:
            Path(self.tcfg.log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(self.tcfg.log_dir) / "metrics.jsonl",
                               "a")
            self._writer = EventWriter(self.tcfg.log_dir)

    def close(self) -> None:
        """Close the log files."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._writer.close()
            self._jsonl = self._writer = None

    # -- the step ----------------------------------------------------------

    def _all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group's processes (``x`` without one)."""
        if self.grouped:
            x = x.clone()
            dist.all_reduce(x)
        return x

    def row_losses(self, batch: dict, train: bool = True) -> torch.Tensor:
        """Each row's ``w·loss`` (``weight`` 1 a real row, 0 a filler
        row): the terms ``loss`` sums."""
        return self.family.losses(self, batch, train) * batch["weight"]

    def loss(self, batch: dict, train: bool = True) -> torch.Tensor:
        """This process's share of the mean loss over the global batch's
        real rows: its own ``Σ(w·loss)`` over the group's ``Σw``.  Summed
        over the group, the shares are the loss; without a group, the
        share is."""
        w = batch["weight"]
        return (self.row_losses(batch, train).sum()
                / self._all_sum(w.sum()).clamp_min(1.0))

    def train_step(self, batch: dict) -> torch.Tensor:
        """One update on a device batch (its ``family.host_keys`` on the
        host); returns the global batch's loss (on the device).  In a
        group, the gradients and the loss shares are summed in one
        all-reduce on the row's first device."""
        dev = self.device
        with profiling.span("radian.train.step", dev, batch=self.step):
            with profiling.span("radian.train.forward", dev):
                loss = self.loss(batch)
            with profiling.span("radian.train.backward", dev):
                grads = torch.autograd.grad(loss,
                                            list(self.params.values()))
            if self.grouped:
                with profiling.span("radian.train.allreduce", dev):
                    flat = torch.cat([*(g.to(dev).reshape(-1)
                                        for g in grads),
                                      loss.detach().reshape(1)])
                    dist.all_reduce(flat)
                    loss = flat[-1]
                    grads = [part.view_as(g).to(g.device)
                             for part, g in zip(flat[:-1].split(
                                 [g.numel() for g in grads]), grads)]
            with profiling.span("radian.train.update", dev):
                self.opt_state = self.tx.apply(
                    self.params, dict(zip(self.params, grads)),
                    self.opt_state, self.order)
            self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        """The global batch's loss."""
        return self._all_sum(self.loss(batch))

    # -- checkpointing ------------------------------------------------------

    def _payload(self, epoch: int, val_loss: float | None) -> dict:
        """The full leaves and full optimizer slots, on the CPU."""
        return {
            "params": gather_params(self.params, "cpu"),
            "opt_state": {"count": self.opt_state.count, "slots": {
                s: gather_params(b, "cpu")
                for s, b in self.opt_state.slots.items()}},
            "step": self.step,
            "epoch": epoch,
            "val_loss": float("nan") if val_loss is None else float(val_loss),
        }

    @staticmethod
    def _epochs(root: Path) -> list[int]:
        if not root.is_dir():
            return []
        return sorted(int(p.name) for p in root.iterdir()
                      if p.name.isdigit() and (p / _STATE_FILE).exists())

    @staticmethod
    def _write(root: Path, epoch: int, payload: dict, keep: int) -> None:
        """``root/<epoch>/state.pt``, written whole or not at all; then only
        the newest ``keep`` epochs stay."""
        d = root / str(epoch)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"{_STATE_FILE}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, d / _STATE_FILE)
        for old in Trainer._epochs(root)[:-keep]:
            shutil.rmtree(root / str(old))

    def save_checkpoint(self, epoch: int,
                        val_loss: float | None = None) -> None:
        """Save the epoch checkpoint; when ``val_loss`` improves on the
        best seen so far, also replace the best-on-val checkpoint."""
        if self._ckpt_dir is None:
            return
        best = val_loss is not None and float(val_loss) < self.best_val_loss
        if best:
            self.best_val_loss = float(val_loss)
            self.best_epoch = epoch
        if self.rank != 0:  # rank 0 writes; every rank holds the same
            return
        payload = self._payload(epoch, val_loss)
        self._write(self._ckpt_dir, epoch, payload,
                    self.tcfg.keep_checkpoints)
        if best:
            self._write(self._best_dir, epoch, payload, 1)

    def _restore_from(self, root: Path | None, epoch: int | None) -> int:
        if root is None:
            return 0
        if epoch is None:
            epochs = self._epochs(root)
            if not epochs:
                return 0
            epoch = epochs[-1]
        payload = torch.load(root / str(epoch) / _STATE_FILE,
                             map_location="cpu", weights_only=True)
        # full leaves, split as this trainer's model is split
        with torch.no_grad():
            for k, v in split_params(payload["params"], self.params).items():
                self.params[k].copy_(v)
        state = payload["opt_state"]
        self.opt_state = OptState(int(state["count"]), {
            s: split_params(b, self.params)
            for s, b in state["slots"].items()})
        self.step = int(payload["step"])
        return int(payload["epoch"]) + 1

    def restore_checkpoint(self, epoch: int | None = None) -> int:
        """Restore params *and* optimizer state (the newest epoch unless
        ``epoch`` is given); returns the epoch to resume from (0 when
        there is no checkpoint)."""
        return self._restore_from(self._ckpt_dir, epoch)

    def restore_best_checkpoint(self) -> int:
        """Restore the best-on-val-loss checkpoint; returns the epoch
        after the one restored (0 if no best checkpoint exists)."""
        return self._restore_from(self._best_dir, None)

    def update_learning_rate(self, new_rate: float) -> None:
        """Mid-training rate override that keeps the optimizer state (the
        reference's ``update_learning_rate``, radian/model.py:155-158):
        the rule is rebuilt with the new rate and continues from the same
        moments (for cc_opt the new rate is its ``init_rate``)."""
        c = self.config.train.opt
        kind = c.get("type", "adam")
        if kind == "cc_opt":
            c.cc_opt.init_rate = float(new_rate)
        else:
            c[kind].lr = float(new_rate)
        self.tx = build_optimizer(c)

    # -- logging ------------------------------------------------------------

    def _log(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": step,
                            "time": time.time()}) + "\n"
            )
            self._jsonl.flush()
            self._writer.scalar(tag, float(value), step)

    # -- batches ------------------------------------------------------------

    def _host_batch(self, batch: dict) -> dict:
        """The host batch with its ``weight``: 1 a real row.  Over two
        ranks or more, a short local batch is padded to
        ``config.train.batch_size`` rows with zero-weight filler rows
        (copies of its first), as the JAX ``_host_batch`` pads the global
        batch to its data axis."""
        out = {k: np.asarray(v) for k, v in batch.items()}
        n = out["signal"].shape[0]
        out["weight"] = np.ones(n, np.float32)
        pad = (max(self.config.train.batch_size - n, 0)
               if self.world > 1 else 0)
        if pad:
            for k, v in out.items():
                filler = (np.zeros((pad,) + v.shape[1:], v.dtype)
                          if k == "weight" else np.repeat(v[:1], pad, axis=0))
                out[k] = np.concatenate([v, filler], axis=0)
        return out

    def _to_device(self, key: str, v: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(v)
        return t if key in self.family.host_keys else t.to(self.device)

    def _put_batch(self, batch: dict) -> dict:
        return {k: self._to_device(k, v)
                for k, v in self._host_batch(batch).items()}

    # -- device-resident pool -----------------------------------------------

    def preload_batches(self, batches: list[dict]) -> dict:
        """Stack equal-width host batches into device tensors ``{k: [S,
        rows, ...]}``, uploaded once; each step then indexes the pool on
        the device, with no host copy.  A short batch is padded to the
        pool's row count with zero-weight filler rows."""
        proc = [self._host_batch(b) for b in batches]
        rows = max(p["signal"].shape[0] for p in proc)
        for p in proc:
            pad = rows - p["signal"].shape[0]
            if pad:
                for k, v in p.items():
                    filler = (np.zeros((pad,) + v.shape[1:], v.dtype)
                              if k == "weight"
                              else np.repeat(v[:1], pad, axis=0))
                    p[k] = np.concatenate([v, filler], axis=0)
        out = {}
        for k in proc[0]:
            # ragged columns (targets padded to each batch's longest) are
            # padded with zeros to the pool's widest
            width = [max(d) for d in zip(*(p[k].shape[1:] for p in proc))]
            out[k] = self._to_device(k, np.stack([np.pad(
                p[k], [(0, 0)] + [(0, w - d) for w, d in zip(
                    width, p[k].shape[1:])]) for p in proc]))
        return out

    def train_epoch_scan(self, stacked: dict, epoch: int, steps: int,
                         start: int = 0) -> float:
        """``steps`` train steps over the pool, the batch of step ``s``
        being ``stacked[(start + s) % S]``; the losses come to the host
        once, at the end."""
        s_total = stacked["signal"].shape[0]
        t0 = time.time()
        losses = [self.train_step({k: v[(start + s) % s_total]
                                   for k, v in stacked.items()})
                  for s in range(steps)]
        losses = torch.stack(losses).cpu().numpy()
        for i in range(0, len(losses), self.tcfg.log_every):
            chunk = losses[i : i + self.tcfg.log_every]
            self._log("train/loss", float(chunk.mean()),
                      self.step - len(losses) + i + len(chunk))
        n_windows = steps * stacked["signal"].shape[1]
        self._log("train/windows_per_s",
                  n_windows / max(time.time() - t0, 1e-9), self.step)
        mean = float(losses.mean())
        self._log("train/epoch_loss", mean, epoch)
        return mean

    def evaluate_scan(self, stacked: dict, epoch: int | None = None,
                      tag: str = "val/loss") -> float:
        """Val loss over the pool, each batch weighted by its real rows
        (over the group)."""
        real = self._all_sum(stacked["weight"].sum(1))
        losses = torch.stack([self.eval_step({k: v[i]
                                              for k, v in stacked.items()})
                              for i in range(real.shape[0])])
        mean = float((losses * real).sum() / real.sum())
        if epoch is not None:
            self._log(tag, mean, epoch)
        return mean

    # -- loops --------------------------------------------------------------

    def train_epoch(self, dataset: Iterable[dict], epoch: int) -> float:
        losses = []
        t0 = time.time()
        n_windows = 0
        for i, batch in enumerate(dataset):
            if (self.tcfg.steps_per_epoch is not None
                    and i >= self.tcfg.steps_per_epoch):
                break
            n_windows += batch["signal"].shape[0]
            losses.append(self.train_step(self._put_batch(batch)))
            if (i + 1) % self.tcfg.log_every == 0:
                recent = torch.stack(losses[-self.tcfg.log_every:])
                self._log("train/loss", float(recent.mean()), self.step)
                self._log("train/windows_per_s",
                          n_windows / (time.time() - t0), self.step)
        mean = float(torch.stack(losses).mean()) if losses else float("nan")
        self._log("train/epoch_loss", mean, epoch)
        return mean

    @torch.no_grad()
    def edit_distance_eval(self, dataset: Iterable[dict],
                           epoch: int | None = None,
                           tag: str = "val/edit_distance") -> float:
        """Greedy-decode edit distance on a dataset, the working version
        of the reference's no-op EditDistanceCallback (train.py:31-46)."""
        if not isinstance(self.family, CtcFamily):
            raise NotImplementedError(
                f"model.type {self.config.model.type!r}: the edit distance "
                "is radian's greedy CTC decode")
        dists, weights = [], []
        for batch in dataset:
            signal = torch.from_numpy(np.asarray(batch["signal"]))
            lp = self.model(signal.to(self.device)[..., None])
            dists.append(batch_mean_edit_distance(
                lp, batch["labels"], batch["label_length"],
                batch.get("input_length")))
            weights.append(batch["signal"].shape[0])
        mean = (float(np.average(dists, weights=weights)) if dists
                else float("nan"))
        if epoch is not None:
            self._log(tag, mean, epoch)
        return mean

    def _evaluate(self, dataset: Iterable[dict]) -> tuple[float, int]:
        """Each batch's global loss, weighted by its real rows (over the
        group): every rank must see the same number of batches."""
        losses, weights = [], []
        for batch in dataset:
            dev_batch = self._put_batch(batch)
            losses.append(float(self.eval_step(dev_batch)))
            weights.append(batch["signal"].shape[0] if not self.grouped else
                           float(self._all_sum(dev_batch["weight"].sum())))
        if not losses:
            return float("nan"), 0
        return float(np.average(losses, weights=weights)), len(losses)

    def evaluate(self, dataset: Iterable[dict], epoch: int | None = None,
                 tag: str = "val/loss") -> float:
        mean, _ = self._evaluate(dataset)
        if epoch is not None:
            self._log(tag, mean, epoch)
        return mean

    def fit(
        self,
        train_data_factory,
        val_data_factory=None,
        n_epochs: int | None = None,
        initial_epoch: int = 0,
        val_freq: int | None = None,
        epoch_scan: bool = False,
        eval_edit_distance: bool = False,
    ) -> dict:
        """Run the training loop (reference fit loop, train.py:82-90).

        ``*_factory`` are zero-arg callables returning fresh iterables.
        ``epoch_scan=True`` uploads the whole train (and val) pool once
        (:meth:`preload_batches`) and runs each epoch over it on the
        device; with ``steps_per_epoch`` set, epochs cycle through the
        pool.  ``eval_edit_distance=True`` adds the greedy-decode edit
        distance on the val set at each val epoch.  Each epoch ends with
        a checkpoint.
        """
        n_epochs = n_epochs or self.config.train.n_epochs
        val_freq = val_freq or self.config.train.val_freq
        history = {"train_loss": [], "val_loss": [],
                   "val_edit_distance": []}

        val_batches = None
        if val_data_factory is not None and (epoch_scan
                                             or eval_edit_distance):
            val_batches = list(val_data_factory())

        if epoch_scan:
            train_batches = list(train_data_factory())
            stacked = self.preload_batches(train_batches)
            pool = len(train_batches)
            steps = self.tcfg.steps_per_epoch or pool
            val_stacked = (self.preload_batches(val_batches)
                           if val_batches else None)
        else:
            train_iter = iter(train_data_factory())

        for epoch in range(initial_epoch, n_epochs):
            if epoch_scan:
                start = (((epoch - initial_epoch) * steps) % pool
                         if self.tcfg.steps_per_epoch is not None else 0)
                tl = self.train_epoch_scan(stacked, epoch, steps,
                                           start=start)
            else:
                source = (train_iter
                          if self.tcfg.steps_per_epoch is not None
                          else train_data_factory())
                tl = self.train_epoch(source, epoch)
            history["train_loss"].append(tl)
            vl = None
            if val_data_factory is not None and (epoch + 1) % val_freq == 0:
                if epoch_scan:
                    if val_stacked is not None:
                        vl = self.evaluate_scan(val_stacked, epoch)
                else:
                    vl, n = self._evaluate(val_batches if val_batches
                                           is not None else val_data_factory())
                    if n:
                        self._log("val/loss", vl, epoch)
                    else:
                        vl = None  # an empty val set, as the JAX fit skips
                if vl is not None:
                    history["val_loss"].append(vl)
                    if eval_edit_distance:
                        ed = self.edit_distance_eval(val_batches, epoch)
                        history["val_edit_distance"].append(ed)
            self.save_checkpoint(epoch, val_loss=vl)
        return history
