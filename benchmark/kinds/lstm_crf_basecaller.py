"""Cells that drive ``radian_tpu_torch.pipeline.Basecaller`` with a
``bonito_lstm_crf`` model (Bonito's v4 LSTM-CRF basecaller): the
``crf_basecaller`` kind's closed loop of ``basecall_signals`` calls on
lists of long reads from the seed, its window, its gathering of what the
port served and its comparison, imported from there.

What differs is the model: its weights are Bonito's init for the seed
with the configuration's ``init_gains``, drawn here
(``core/reference_lstm_crf.py::bonito_lstm_init``, under Bonito's
state-dict names) and given to the program and the reference alike; a step is the stem's stride (no upsampling); and the
reference works the scores out again from the raw reads with the
LSTM-CRF reference, which runs the sampled chunks along its batch
dimension.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import inputs
from benchmark.core import reference_lstm_crf as plain
from benchmark.core import reference_tx_crf as tx
from benchmark.kinds import crf_basecaller as crf

MODEL_TYPE = "bonito_lstm_crf"
compare = crf.compare


def geometry(cfg: dict) -> tuple[int, int, int]:
    """``(chunksize, overlap, samples a step)`` of the configuration."""
    mc = cfg["model_config"]
    return (mc["basecaller"]["chunksize"], mc["basecaller"]["overlap"],
            plain.stride(mc["model"]))


class LstmCell(crf.CrfCell):
    def __init__(self, root, c: dict, seed: int, device):
        import torch

        from radian_tpu_torch.config import DotDict
        from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

        cfg, t = c["config"], c["traffic"]
        mc = DotDict(cfg["model_config"])
        if mc.model.get("type") != MODEL_TYPE:
            raise ValueError(f"the lstm_crf_basecaller kind runs a "
                             f"{MODEL_TYPE} model; the configuration's "
                             f"model.type is {mc.model.get('type')!r}")
        self.c, self.seed, self.device = c, seed, device
        t0 = time.perf_counter()
        self.opts = {**cfg["options"], **t.get("options", {})}
        self.weights = plain.bonito_lstm_init(cfg["model_config"]["model"],
                                              seed, cfg.get("init_gains"))
        self.bc = Basecaller(
            {k: torch.from_numpy(v) for k, v in self.weights.items()}, mc,
            None, BasecallOptions(**self.opts), getattr(torch, cfg["dtype"]),
            device=device)
        t1 = time.perf_counter()
        self.calls = crf.read_calls(seed, t)
        t2 = time.perf_counter()
        # every batch has chunk_batch rows: one call runs every shape
        self.bc.basecall_signals(self.calls[0])
        self.phases = {"program_s": t1 - t0, "reads_s": t2 - t1,
                       "warm_s": time.perf_counter() - t2}
        self.done: list[tuple[int, list, float]] = []

    def counts(self) -> dict:
        cfg = self.c["config"]
        size, overlap, step = geometry(cfg)
        lengths = [len(r) for k, _, _ in self.done for r in self.calls[k]]
        strings = [x for _, out, _ in self.done for x in out]
        model = cfg["model_config"]["model"]
        return {
            "attempted": len(strings),
            "failed": sum(x is None for x in strings),
            "reads": len(strings),
            "samples": int(sum(lengths)),
            "call_latencies_s": [d for _, _, d in self.done],
            "reads_per_call": self.c["traffic"]["reads_per_call"],
            "chunks": sum(len(tx.chunk_starts(n, size, overlap))
                          for n in lengths),
            "chunksize": size,
            "steps": size // step,
            "state_len": model["crf"]["state_len"],
            "dtype": cfg["dtype"],
            "model": model,
            "launches": self.launches,
        }

    def _sample(self):
        """The check's chunks and reads, drawn from the seed as the
        ``crf_basecaller`` kind draws them: ``check_chunks`` chunks, and
        ``check_reads`` whole reads, the longest among them."""
        t = self.c["traffic"]
        size, overlap, _ = geometry(self.c["config"])
        rng = inputs.make_rng(self.seed, 1)
        reads = [(d, j) for d, (k, _, _) in enumerate(self.done)
                 for j in range(len(self.calls[k]))]
        length = {(d, j): len(self.calls[self.done[d][0]][j])
                  for d, j in reads}
        chunks = [(d, j, m) for d, j in reads
                  for m in range(len(tx.chunk_starts(length[d, j], size,
                                                     overlap)))]
        longest = max(reads, key=length.get)
        rest = [r for r in reads if r != longest]
        pick = rng.choice(len(rest), size=min(len(rest),
                                              t["check_reads"] - 1),
                          replace=False)
        whole = [longest] + [rest[x] for x in sorted(pick)]
        pick = rng.choice(len(chunks), size=min(len(chunks),
                                                t["check_chunks"]),
                          replace=False)
        return [chunks[x] for x in sorted(pick)], whole


def setup(root, c: dict, seed: int, device) -> LstmCell:
    return LstmCell(root, c, seed, device)


def reference(root, c: dict, seed: int, served: dict, device,
              rounding: str | None = None) -> dict:
    """The plain reference's scores for the sampled chunks, from the raw
    reads, in one forward; and its strings for the sampled reads: its
    Viterbi and stitch of the port's own scores (``rounding`` None), or
    of its own scores computed in ``rounding``'s precision (the
    control)."""
    import torch

    cfg = c["config"]
    model = cfg["model_config"]["model"]
    size, overlap, step = geometry(cfg)
    clip = served["opts"]["outlier_clip"]
    p = tx.params(served["weights"], device)
    with torch.inference_mode():
        ch = np.stack([tx.chunks(tx.mad_normalise(read, clip), size,
                                 overlap)[m]
                       for read, m in zip(served["chunk_reads"],
                                          served["chunk_index"])])
        chunk_scores = list(plain.forward(
            p, model, torch.from_numpy(ch).to(device), rounding).cpu())
        if rounding is None:
            per_read = served["read_scores"]
        else:
            per_read = [list(plain.read_scores(p, model, read, size, overlap,
                                               clip, device, rounding))
                        for read in served["reads"]]
        flat = torch.stack([s.to(device) for r in per_read for s in r])
        paths = tx.viterbi(flat, model["crf"]["state_len"]).cpu().numpy()
    strings, at = [], 0
    for read, r in zip(served["reads"], per_read):
        strings.append(tx.stitch(paths[at:at + len(r)], len(read), size,
                                 overlap, step))
        at += len(r)
    return {"chunk_scores": chunk_scores, "strings": strings, "missing": 0}
