"""Cells that drive ``radian_tpu_torch.pipeline.Basecaller`` with a
``bonito_tx_crf`` model (Bonito's transformer-CRF basecaller): a closed
loop of ``basecall_signals`` calls on lists of long reads from the seed.

The weights are Bonito's init for the seed, drawn here
(``core/reference_tx_crf.py::bonito_init``, under Bonito's parameter
names) and given to the program and the reference alike, so the
program's reading of them is checked.  The reads' lengths are log-normal; their signal is the
``basecaller`` kind's generator (``core/inputs.py``) at the traffic's
dwell.  The window's strings are what it serves.  The check takes the
CRF scores of sampled chunks and of every chunk of sampled whole reads
from the port's own timed path (``chunk_batches``, ``pad_batch`` and
``crf_scores``, public methods of the ``Basecaller``) at the window's
batches, after the window.  The reference (``core/reference_tx_crf.py``)
works the scores out again from the raw reads, and decodes and stitches
the port's own scores.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import compare as cmp
from benchmark.core import inputs
from benchmark.core import reference_tx_crf as plain

MODEL_TYPE = "bonito_tx_crf"


def read_lengths(rng: np.random.Generator, t: dict) -> np.ndarray:
    """``reads_per_call`` log-normal lengths: median ``length_median``,
    ``length_sigma`` in log space, clipped to ``[length_min,
    length_max]``."""
    x = rng.normal(np.log(t["length_median"]), t["length_sigma"],
                   t["reads_per_call"])
    return np.clip(np.round(np.exp(x)), t["length_min"],
                   t["length_max"]).astype(int)


def make_read(rng: np.random.Generator, length: int, levels,
              t: dict) -> np.ndarray:
    """One int16 read of exactly ``length`` samples (``inputs.make_read``'s
    signal, drawn ~20 % longer than the mean dwell needs, not for the
    shortest dwell)."""
    kw = dict(dwell_mean=t["dwell_mean"], dwell_std=t["dwell_std"],
              noise=t["noise"])
    n_bases = int(1.2 * length / t["dwell_mean"]) + 8
    sig, _ = inputs.squiggle(rng, inputs.markov_bases(
        rng, n_bases, t["markov_p"]), levels, **kw)
    while len(sig) < length:
        more, _ = inputs.squiggle(rng, inputs.markov_bases(
            rng, n_bases, t["markov_p"]), levels, **kw)
        sig = np.concatenate([sig, more])
    return inputs.to_adc(sig[:length], t["adc_scale"], t["adc_offset"])


def read_calls(seed: int, t: dict) -> list[list[np.ndarray]]:
    """The traffic's ``distinct_calls`` calls of ``reads_per_call``
    reads."""
    rng = inputs.make_rng(seed)
    levels = inputs.kmer_levels(t["level_seed"])
    return [[make_read(rng, int(n), levels, t) for n in read_lengths(rng, t)]
            for _ in range(t["distinct_calls"])]


def geometry(cfg: dict) -> tuple[int, int, int]:
    """``(chunksize, overlap, samples a step)`` of the configuration."""
    mc = cfg["model_config"]
    return (mc["basecaller"]["chunksize"], mc["basecaller"]["overlap"],
            plain.stride(mc["model"]))


class CrfCell:
    def __init__(self, root, c: dict, seed: int, device):
        import torch

        from radian_tpu_torch.config import DotDict
        from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

        cfg, t = c["config"], c["traffic"]
        mc = DotDict(cfg["model_config"])
        if mc.model.get("type") != MODEL_TYPE:
            raise ValueError(f"the crf_basecaller kind runs a {MODEL_TYPE} "
                             f"model; the configuration's model.type is "
                             f"{mc.model.get('type')!r}")
        self.c, self.seed, self.device = c, seed, device
        t0 = time.perf_counter()
        self.opts = {**cfg["options"], **t.get("options", {})}
        self.weights = plain.bonito_init(cfg["model_config"]["model"], seed)
        self.bc = Basecaller(
            {k: torch.from_numpy(v) for k, v in self.weights.items()}, mc,
            None, BasecallOptions(**self.opts), getattr(torch, cfg["dtype"]),
            device=device)
        t1 = time.perf_counter()
        self.calls = read_calls(seed, t)
        t2 = time.perf_counter()
        # every batch has chunk_batch rows: one call runs every shape
        self.bc.basecall_signals(self.calls[0])
        self.phases = {"program_s": t1 - t0, "reads_s": t2 - t1,
                       "warm_s": time.perf_counter() - t2}
        self.done: list[tuple[int, list, float]] = []

    def window(self, seconds: float) -> float:
        from radian_tpu_torch.ops import crf_viterbi

        names = ("crf_viterbi", "crf_backtrace")
        before = {n: getattr(crf_viterbi, n).launches for n in names}
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            out = self.bc.basecall_signals(self.calls[i % len(self.calls)])
            te = time.perf_counter()
            self.done.append((i % len(self.calls), out, te - ts))
            i += 1
            if te - t0 >= seconds:
                break
        self.launches = {n: getattr(crf_viterbi, n).launches - before[n]
                         for n in names}
        return te - t0

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
            "chunks": sum(len(plain.chunk_starts(n, size, overlap))
                          for n in lengths),
            "chunksize": size,
            "steps": size // step,
            "state_len": model["crf"]["state_len"],
            "dtype": cfg["dtype"],
            "model": model,
            "launches": self.launches,
        }

    def _sample(self):
        """The check's chunks and reads, drawn from the seed among those
        the window served: ``check_chunks`` chunks, and ``check_reads``
        whole reads, the longest among them.  A chunk is ``(call served,
        read, its chunk number)``; a read ``(call served, read)``."""
        t = self.c["traffic"]
        size, overlap, _ = geometry(self.c["config"])
        rng = inputs.make_rng(self.seed, 1)
        reads = [(d, j) for d, (k, _, _) in enumerate(self.done)
                 for j in range(len(self.calls[k]))]
        length = {(d, j): len(self.calls[self.done[d][0]][j])
                  for d, j in reads}
        chunks = [(d, j, m) for d, j in reads
                  for m in range(len(plain.chunk_starts(length[d, j], size,
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

    def served(self) -> dict:
        """The sampled reads' served strings, and the port's scores
        (host bfloat16 or float32 tensors) for the sampled chunks and for
        every chunk of the sampled reads, each at its window batch."""
        import torch

        sampled, whole = self._sample()
        want = set(sampled) | {(d, j) for d, j in whole}
        scores: dict = {}
        with torch.inference_mode():
            for d, (k, _, _) in enumerate(self.done):
                sig = self.calls[k]
                seen: dict[int, int] = {}
                for idxs, b in self.bc.chunk_batches(sig):
                    rows = []
                    for r in range(b.n_chunks):
                        j = b.reads[b.row_read[r]]
                        m = seen.get(j, 0)
                        seen[j] = m + 1
                        if (d, j, m) in want or (d, j) in want:
                            rows.append((r, (d, j, m)))
                    if not rows:
                        continue
                    s, _ = self.bc.crf_scores(*self.bc.pad_batch(idxs, b,
                                                                 sig))
                    for r, key in rows:
                        scores[key] = s[r].cpu()
                    del s
        strings = [x for _, out, _ in self.done for x in out]
        n_chunks = {(d, j): sum(1 for key in scores
                                if key[:2] == (d, j)) for d, j in whole}
        return {
            "chunk_reads": [self.calls[self.done[d][0]][j]
                            for d, j, _ in sampled],
            "chunk_index": [m for _, _, m in sampled],
            "chunk_scores": [scores[key] for key in sampled],
            "reads": [self.calls[self.done[d][0]][j] for d, j in whole],
            "strings": [self.done[d][1][j] for d, j in whole],
            "read_scores": [[scores[(d, j, m)] for m in range(n_chunks[d, j])]
                            for d, j in whole],
            "missing": sum(x is None for x in strings),
            "weights": self.weights,
            "opts": self.opts,
        }


def setup(root, c: dict, seed: int, device) -> CrfCell:
    return CrfCell(root, c, seed, device)


def reference(root, c: dict, seed: int, served: dict, device,
              rounding: str | None = None) -> dict:
    """The plain reference's scores for the sampled chunks, from the raw
    reads, and its strings for the sampled reads: its Viterbi and stitch
    of the port's own scores (``rounding`` None), or of its own scores
    computed in ``rounding``'s precision (the control)."""
    import torch

    cfg = c["config"]
    model = cfg["model_config"]["model"]
    size, overlap, step = geometry(cfg)
    clip = served["opts"]["outlier_clip"]
    p = plain.params(served["weights"], device)
    chunk_scores = []
    with torch.inference_mode():
        for read, m in zip(served["chunk_reads"], served["chunk_index"]):
            ch = plain.chunks(plain.mad_normalise(read, clip), size,
                              overlap)[m]
            chunk_scores.append(plain.forward(
                p, model, torch.from_numpy(ch).to(device), rounding).cpu())
        if rounding is None:
            per_read = served["read_scores"]
        else:
            per_read = [list(plain.read_scores(p, model, read, size, overlap,
                                               clip, device, rounding))
                        for read in served["reads"]]
        flat = torch.stack([s.to(device) for r in per_read for s in r])
        paths = plain.viterbi(flat, model["crf"]["state_len"]).cpu().numpy()
    strings, at = [], 0
    for read, r in zip(served["reads"], per_read):
        strings.append(plain.stitch(paths[at:at + len(r)], len(read), size,
                                    overlap, step))
        at += len(r)
    return {"chunk_scores": chunk_scores, "strings": strings, "missing": 0}


def compare(c: dict, served: dict, ref: dict) -> dict:
    """``score_gap``: the widest gap between a served and a reference
    CRF score over the sampled chunks; ``path_mismatch``: edit distance
    per reference base of the served strings (0: the decode and stitch
    are exact given the scores); ``reads_missing``: reads of the window
    served no string."""
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(served["chunk_scores"], ref["chunk_scores"]))
    dist = sum(len(r) if s is None else (0 if s == r
                                         else cmp.edit_distance(s, r))
               for s, r in zip(served["strings"], ref["strings"]))
    return {"score_gap": gap,
            "path_mismatch": dist / max(1, sum(len(r)
                                               for r in ref["strings"])),
            "reads_missing": float(served["missing"])}
