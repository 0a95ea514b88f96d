"""Cells that train Bonito's v4 LSTM-CRF through
``radian_tpu_torch.train.trainer.Trainer.train_step``: a closed loop of
steps over a pool of device batches of chunks from the seed.

Each chunk is a read of its own from the benchmark's read generator
(``core/inputs.py``: the traffic's levels, chain, dwell and noise, as
int16 ADC counts), cut to the configuration's chunksize, normalised by
its MAD and clipped; its target is the bases whose dwell starts inside
it, padded with zeros to the batch's longest.

Set-up draws the seeded weights with the configuration's
``init_gains`` (``core/reference_lstm_crf.py::bonito_lstm_init``),
builds one ``Trainer``, loads them, and drives it through its first
three steps on the pool's first batches, with the window's own call and
feed, then on through the pool to ``WARM_PASSES`` passes over it (the
warm-up); the window continues from there.  Before the first step it takes
each row's loss of the first batch through the ``Trainer``'s own
``row_losses``, as weighed in the step.  The check compares those three
steps with the plain reference's (``core/reference_crf_loss.py``): the
first step's loss, each row's of it, the first step's clipped gradient
as AdamW's first moment holds it after one step (``mu / (1 - b1)``), and
each leaf's change after the three steps.  Only the first step starts
from the weights both sides share: at this rate from seeded weights the
loss rises over the next steps on most seeds, and bf16 rounding then
moves the third step's loss as far as fp8 rounding does.  The gradient is
compared element by element, not by its norm: two halves of a batch
give gradients of about the same norm, so a norm gap cannot see a step
that drops rows; at 64 rows of one generator, bf16 rounding moves the
gradient about half as far as dropping half of them does, so the row
losses are what sees such a step.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import compare as cmp
from benchmark.core import counts_crf_loss
from benchmark.core import counts_lstm_crf as cnt
from benchmark.core import inputs
from benchmark.core import reference_crf_loss as ref_loss
from benchmark.core import reference_lstm_crf as plain

MODEL_TYPE = "bonito_lstm_crf"
CHECK_STEPS = 3
# set-up's passes over the pool, the check's steps included: on an H100 a
# step's device time runs ~7 % over its later value for the first 10-25 s
# of a process's training, so the window starts after ~13 s of steps
WARM_PASSES = 4
# the reference's rows a block: its float32 step loops keep every step's
# activations for the backward, ~0.5 GB a row at the published widths
REFERENCE_ROWS = 64


def chunk(rng, levels, t: dict, size: int, clip: float):
    """``(normalised chunk [size] float32, its bases int32)``."""
    kw = {"dwell_mean": t["dwell_mean"], "dwell_std": t["dwell_std"],
          "noise": t["noise"]}
    n_bases = int(size / max(t["dwell_mean"] - 2 * t["dwell_std"], 3)) + 8
    sigs, bases, dwells = [], [], []
    while sum(len(s) for s in sigs) < size:
        b = inputs.markov_bases(rng, n_bases, t["markov_p"])
        s, d = inputs.squiggle(rng, b, levels, **kw)
        sigs.append(s)
        bases.append(b)
        dwells.append(d)
    sig = np.concatenate(sigs)[:size]
    starts = np.cumsum(np.concatenate(dwells)) - np.concatenate(dwells)
    raw = inputs.to_adc(sig, t["adc_scale"], t["adc_offset"])
    norm = inputs.mad_normalise(raw.astype(np.float64), clip)
    return (norm.astype(np.float32),
            np.concatenate(bases)[starts < size].astype(np.int32))


def train_chunks(seed: int, t: dict, rows: int, size: int,
                 clip: float) -> list[dict]:
    """``t['pool_batches']`` batches of ``rows`` chunks: ``signal [rows,
    size]`` float32, ``targets [rows, n_max]`` int32 (zeros past each
    row's length, ``n_max`` the batch's longest) and ``target_length
    [rows]`` int32."""
    rng = inputs.make_rng(seed)
    levels = inputs.kmer_levels(t["level_seed"])
    out = []
    for _ in range(t["pool_batches"]):
        made = [chunk(rng, levels, t, size, clip) for _ in range(rows)]
        lengths = np.array([len(b) for _, b in made], np.int32)
        targets = np.zeros((rows, lengths.max()), np.int32)
        for i, (_, b) in enumerate(made):
            targets[i, :len(b)] = b
        out.append({"signal": np.stack([s for s, _ in made]),
                    "targets": targets, "target_length": lengths})
    return out


def _norms(tensors: dict) -> dict[str, float]:
    import torch

    names = list(tensors)
    vals = torch.stack([tensors[k].double().norm() for k in names])
    return dict(zip(names, vals.cpu().tolist()))


class LstmTrainCell:
    def __init__(self, root, c: dict, seed: int, device,
                 half_batch: bool = False):
        import torch

        # the port's CTC-CRF loss: a tree without it stops here, before
        # any input is made
        from radian_tpu_torch.ops import crf_loss  # noqa: F401
        from radian_tpu_torch.config import DotDict
        from radian_tpu_torch.train.trainer import TrainConfig, Trainer

        cfg, t = c["config"], c["traffic"]
        mc = cfg["model_config"]
        if mc["model"].get("type") != MODEL_TYPE:
            raise ValueError(f"the lstm_crf_trainer kind trains a "
                             f"{MODEL_TYPE} model; the configuration's "
                             f"model.type is {mc['model'].get('type')!r}")
        self.c, self.seed, self.device = c, seed, device
        self.model, train = mc["model"], mc["train"]
        self.rows, self.size = train["batch_size"], train["chunksize"]
        t0 = time.perf_counter()
        self.weights = plain.bonito_lstm_init(self.model, seed,
                                              cfg.get("init_gains"))
        self.batches = train_chunks(seed, t, self.rows, self.size,
                                    cfg["options"]["outlier_clip"])
        self.tr = Trainer(DotDict(mc), TrainConfig(
            checkpoint_dir=None, log_dir=None, compute_dtype=cfg["dtype"],
            device=str(device)))
        with torch.no_grad():
            for k, p in self.tr.params.items():
                p.copy_(torch.from_numpy(self.weights[k]))
        init = {k: p.detach().clone() for k, p in self.tr.params.items()}
        t1 = time.perf_counter()
        pool = self.tr.preload_batches(self.batches)
        if half_batch:  # the fault: the step drops the second half's rows
            pool["weight"][:, self.rows // 2:] = 0
        self.feed = [{k: v[i] for k, v in pool.items()}
                     for i in range(len(self.batches))]
        with torch.no_grad():
            self.row_losses = self.tr.row_losses(self.feed[0]).float().cpu()
        b1 = train["opt"]["adamw"]["beta_1"]
        self.losses = []
        for s in range(CHECK_STEPS):
            self.losses.append(float(self.tr.train_step(self.feed[s])))
            if s == 0:
                mu = self.tr.opt_state.slots["mu"]
                self.grad = {k: (v / (1 - b1)).cpu() for k, v in mu.items()}
        self.change = _norms({k: p.detach() - init[k]
                              for k, p in self.tr.params.items()})
        del init
        t2 = time.perf_counter()
        self.steps = CHECK_STEPS
        self._warm()
        self.phases = {"inputs_program_s": t1 - t0, "first_steps_s": t2 - t1,
                       "warm_steps_s": time.perf_counter() - t2}
        self.window_losses = []
        self.window_batches = []

    def _warm(self) -> None:
        """Step on through the pool until ``WARM_PASSES`` passes over it
        have been taken: every batch's shape is seen before the window,
        and the steps' device time has settled."""
        import torch

        n = len(self.feed)
        while self.steps < WARM_PASSES * n:
            self.tr.train_step(self.feed[self.steps % n])
            self.steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> float:
        import torch

        t0 = time.perf_counter()
        n = len(self.feed)
        while time.perf_counter() - t0 < seconds:
            self.window_batches.append(self.steps % n)
            self.window_losses.append(
                self.tr.train_step(self.feed[self.steps % n]))
            self.steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def counts(self) -> dict:
        import torch

        losses = torch.stack(self.window_losses).float().cpu().numpy()
        state_len = self.model["crf"]["state_len"]
        return {
            "attempted": len(losses),
            "failed": int((~np.isfinite(losses)).sum()),
            "steps": len(losses),
            "windows": len(losses) * self.rows,
            "flops_per_chunk": cnt.flops_per_sample(self.model, self.size)
            * self.size,
            "dtype": self.c["config"]["dtype"],
            "state_len": state_len,
            "chunk_steps": cnt.steps(self.model, self.size),
            "target_positions": sum(counts_crf_loss.positions(
                self.batches[i]["target_length"], state_len)
                for i in self.window_batches),
        }

    def served(self) -> dict:
        out = {"losses": self.losses, "row_losses": self.row_losses,
               "grad": self.grad, "change": self.change,
               "weights": self.weights,
               "batches": self.batches[:CHECK_STEPS]}
        del self.tr, self.feed
        return out


def setup(root, c: dict, seed: int, device,
          half_batch: bool = False) -> LstmTrainCell:
    """The cell set up, its first three steps taken (``half_batch``: the
    fault whose steps weigh the second half of each batch's rows 0, as
    filler rows)."""
    return LstmTrainCell(root, c, seed, device, half_batch)


def reference(root, c: dict, seed: int, served: dict, device,
              rounding: str | None = None,
              rows_per_block: int = REFERENCE_ROWS) -> dict:
    """The plain reference's first three steps from the same weights on
    the same batches (``rounding``: its products' operands in that
    precision, the control)."""
    import torch

    mc = c["config"]["model_config"]
    p = {k: torch.tensor(v, device=device,
                         requires_grad=ref_loss.trainable(k))
         for k, v in served["weights"].items()}
    init = {k: v.detach().clone() for k, v in p.items()}
    batches = []
    for b in served["batches"]:
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in b.items()}
        batch["weight"] = torch.ones(len(b["signal"]), device=device)
        batches.append(batch)
    losses, first, rows = ref_loss.adamw_steps(
        p, mc["model"], batches, mc["train"]["opt"]["adamw"],
        rows_per_block, rounding)
    change = _norms({k: p[k].detach() - init[k] for k in p
                     if ref_loss.trainable(k)})
    return {"losses": losses, "row_losses": rows.cpu(),
            "grad": {k: g.cpu() for k, g in first.items()}, "change": change}


def row_gap(have, want) -> float:
    """The worst row's ``|have − want| / max(|have|, |want|)`` of two
    sides' row losses (``w·loss``), a row that one side lacks read as 0:
    a row one side drops reads 1."""
    have, want = (np.asarray(x, np.float64) for x in (have, want))
    n = max(len(have), len(want))
    have, want = (np.pad(x, (0, n - len(x))) for x in (have, want))
    scale = np.maximum(np.abs(have), np.abs(want))
    return float((np.abs(have - want) / np.maximum(scale, 1e-30)).max())


def compare(c: dict, served: dict, ref: dict) -> dict:
    """``loss_gap``: the first step's relative loss gap; ``row_gap``: its
    worst row's (:func:`row_gap`); ``grad_gap``:
    the worst leaf's ``‖prog − ref‖`` of the first step's
    clipped gradient over the larger of its reference norm and the
    median leaf's; ``change_gap``: the worst leaf's gap of norms of the
    change (leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's: they move by round-off alone)."""
    ref_grad = _norms(ref["grad"])
    diff = _norms({k: served["grad"][k].double() - g.double()
                   for k, g in ref["grad"].items()})
    med = float(np.median(list(ref_grad.values())))
    keep = {k for k, v in ref_grad.items() if v >= 1e-3 * med}
    return {
        "loss_gap": abs(served["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "row_gap": row_gap(served["row_losses"], ref["row_losses"]),
        "grad_gap": max(diff[k] / max(v, med, 1e-30)
                        for k, v in ref_grad.items()),
        "change_gap": cmp.leaf_norm_gap(served["change"], ref["change"],
                                        keep),
    }
