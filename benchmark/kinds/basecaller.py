"""Cells that drive ``radian_tpu_torch.pipeline.Basecaller``: a closed
loop of ``basecall_signals`` calls on lists of reads from the seed.

The window's strings are what it serves.  The check also takes the
per-step probabilities of the sampled reads from the port's own device
programs at the window's batches (``Basecaller.forward`` in global
mode; ``chunk_geometry``, ``chunk_forward`` and ``chunk_window_probs``
in chunk mode, each a public method of the timed path), after the
window.  The reference works everything out again from the raw reads.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import compare as cmp
from benchmark.core import inputs
from benchmark.core import reference as plain

def bucket(length: int, quantum: int) -> int:
    return max(-(-length // quantum) * quantum, quantum)


class BasecallCell:
    def __init__(self, root, c: dict, seed: int, device):
        import torch

        from radian_tpu_torch.config import DotDict
        from radian_tpu_torch.lm.kmer import KmerLM
        from radian_tpu_torch.models.checkpoint import params_from_flax
        from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

        cfg, t = c["config"], c["traffic"]
        self.c, self.seed, self.device = c, seed, device
        t0 = time.perf_counter()
        self.opts = {**cfg["options"], **t.get("options", {})}
        self.weights = inputs.load_weights(root / cfg["weights"])
        lm = None
        if cfg.get("lm"):
            probs, ent = inputs.markov_lm_tables(cfg["lm"]["markov_p"],
                                                 self.opts["context_len"])
            lm = KmerLM(self.opts["context_len"], probs, ent)
        dtype = getattr(torch, cfg["dtype"])
        self.bc = Basecaller(params_from_flax(self.weights),
                             DotDict(cfg["model_config"]), lm,
                             BasecallOptions(**self.opts), dtype,
                             device=device)
        t1 = time.perf_counter()
        self.calls = inputs.read_calls(seed, t)
        t2 = time.perf_counter()
        self._warm()
        self.phases = {"program_s": t1 - t0, "reads_s": t2 - t1,
                       "warm_s": time.perf_counter() - t2}
        self.done: list[tuple[int, list, float]] = []

    def _warm(self) -> None:
        """One call per bucket the traffic uses, each as full as its
        batches will be: every shape the window runs."""
        rb, q = self.opts["read_batch"], self.opts["bucket_quantum"]
        by_bucket: dict[int, list] = {}
        for call in self.calls:
            for r in call:
                by_bucket.setdefault(bucket(len(r), q), []).append(r)
        for b in sorted(by_bucket):
            self.bc.basecall_signals(by_bucket[b][:rb])

    def window(self, seconds: float) -> float:
        from radian_tpu_torch.ops import beam_cuda

        names = ("beam_decode_cuda", "beam_decode_lm_cuda",
                 "beam_backtrace_cuda")
        before = {n: getattr(getattr(beam_cuda, n, None), "launches", None)
                  for n in names}
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
        self.launches = {n: getattr(getattr(beam_cuda, n, None), "launches",
                                    None) for n in names}
        self.launches = {n: (None if before[n] is None or v is None
                             else v - before[n])
                         for n, v in self.launches.items()}
        return te - t0

    def counts(self) -> dict:
        o = self.opts
        chunk = o.get("decode_type", "global") == "chunk"
        w, s = o.get("chunk_len", 1024), o.get("step_size", 128)
        reads = [self.calls[k][j] for k, _, _ in self.done
                 for j in range(len(self.calls[k]))]
        lengths = np.array([len(r) for r in reads])
        if chunk:
            n_full = np.maximum((lengths - w) // s + 1, 0)
            steps = int((n_full * w + lengths - n_full * s).sum())
        else:
            steps = int(lengths.sum())
        strings = [x for _, out, _ in self.done for x in out]
        lm = bool(self.c["config"].get("lm")) and not chunk
        return {
            "attempted": len(strings),
            "failed": sum(x is None for x in strings),
            "reads": len(strings),
            "samples": int(lengths.sum()),
            "call_latencies_s": [d for _, _, d in self.done],
            "reads_per_call": self.c["traffic"]["reads_per_call"],
            "decode_active_steps": steps,
            "emitted_bases": sum(len(x) for x in strings if x),
            "beam": o["beam_width"],
            "lm": lm,
            # bf16 tables for a bf16 forward ('auto'), else float32
            "lm_row_bytes": (5 * (2 if self.c["config"]["dtype"] == "bfloat16"
                                  else 4) if lm else 0),
            "dtype": self.c["config"]["dtype"],
            "model": self.c["config"]["model_config"]["model"],
            "launches": self.launches,
        }

    def _sample(self):
        """The check's reads, drawn from the seed among those the window
        served: ``check_batches`` of the window's batches, the one with
        the longest read among them, and ``check_reads`` of their
        reads, the longest among them."""
        t = self.c["traffic"]
        rng = inputs.make_rng(self.seed, 1)
        batches = []  # (done index, read indices, bucket)
        for d, (k, _, _) in enumerate(self.done):
            for idxs, b in self.bc.batches(self.calls[k]):
                batches.append((d, list(idxs), b))
        length = {(d, j): len(self.calls[self.done[d][0]][j])
                  for d, idxs, _ in batches for j in idxs}
        longest = max(length, key=length.get)
        first = next(i for i, (d, idxs, _) in enumerate(batches)
                     if d == longest[0] and longest[1] in idxs)
        rest = [i for i in range(len(batches)) if i != first]
        pick = [first] + list(rng.choice(
            rest, size=min(len(rest), t["check_batches"] - 1),
            replace=False))
        pool = [(i, j) for i in pick for j in batches[i][1]
                if (batches[i][0], j) != longest]
        take = rng.choice(len(pool), size=min(len(pool),
                                              t["check_reads"] - 1),
                          replace=False)
        chosen = [(first, longest[1])] + [pool[x] for x in sorted(take)]
        return batches, chosen

    def served(self) -> dict:
        """The sampled reads' served strings and the port's per-step
        probabilities for them at their window batches (host arrays)."""
        import torch

        batches, chosen = self._sample()
        chunk = self.opts.get("decode_type", "global") == "chunk"
        probs = {}
        with torch.inference_mode():
            for bi in sorted({i for i, _ in chosen}):
                d, idxs, b = batches[bi]
                sig = self.calls[self.done[d][0]]
                padded, lengths = self.bc.pad_batch(idxs, b, sig)
                want = [j for i, j in chosen if i == bi]
                if not chunk:
                    mats, _, _ = self.bc.forward(padded, lengths)
                    for j in want:
                        row = idxs.index(j)
                        probs[(bi, j)] = mats[row, :len(sig[j])].float(
                            ).cpu().numpy()
                    continue
                geom = self.bc.chunk_geometry(lengths, b)
                norm, full, _ = self.bc.chunk_forward(padded, lengths)
                wp = self.bc.chunk_window_probs(norm, full, geom)
                n_d = geom.starts.shape[1]
                n_dec, lens = geom.n_dec.cpu().numpy(), geom.lens.cpu().numpy()
                for j in want:
                    row = idxs.index(j)
                    probs[(bi, j)] = [
                        wp[row * n_d + k, :lens[row, k]].float().cpu().numpy()
                        for k in range(int(n_dec[row]))]
        strings = [x for _, out, _ in self.done for x in out]
        return {
            "reads": [self.calls[self.done[batches[i][0]][0]][j]
                      for i, j in chosen],
            "strings": [self.done[batches[i][0]][1][j] for i, j in chosen],
            "probs": [probs[(i, j)] for i, j in chosen],
            "missing": sum(x is None for x in strings),
            "weights": self.weights,
            "opts": self.opts,
        }


def setup(root, c: dict, seed: int, device) -> BasecallCell:
    return BasecallCell(root, c, seed, device)


def reference(root, c: dict, seed: int, served: dict, device,
              rounding: str | None = None) -> dict:
    """The plain reference's probabilities and strings for the sampled
    reads (``rounding``: the precision of its products; None: float32)."""
    import torch

    cfg, o = c["config"], served["opts"]
    model = cfg["model_config"]["model"]
    p = plain.torch_params(served["weights"], model, device)
    w, s = o["chunk_len"], o["step_size"]
    chunk = o.get("decode_type", "global") == "chunk"
    win_probs, pads, mats = [], [], []
    for read in served["reads"]:
        norm = plain.mad_normalise(read, o["outlier_clip"])
        wp = plain.window_probs(p, model, norm, o, device, rounding)
        win_probs.append(wp)
        pads.append(plain.windows(norm, w, s)[1])
        mats.append(plain.first_assembly(wp, len(read), w, s))
    del p
    if chunk:
        strings = plain.chunk_strings(win_probs, pads, o["beam_width"],
                                          device)
        probs = [[wp[i, :w - (pad if i == len(wp) - 1 else 0)]
                  for i in range(len(wp))]
                 for wp, pad in zip(win_probs, pads)]
        return {"strings": strings, "probs": probs, "missing": 0}
    lm = None
    if cfg.get("lm"):
        rows4, ent4 = inputs.markov_lm_rows(cfg["lm"]["markov_p"])
        rows = torch.from_numpy(np.concatenate([rows4, ent4[:, None]], 1))
        rows = plain.round_to(rows, rounding).to(device)
        lm = plain.Lm(rows, o["context_len"], o["sig_threshold"],
                          o["rna_threshold"])
    strings = plain.beam_search(mats, o["beam_width"], device, lm)
    return {"strings": strings, "probs": mats, "missing": 0}


def compare(c: dict, served: dict, ref: dict) -> dict:
    """``prob_gap``: the widest gap between a served and a reference
    probability over the sampled reads' steps; ``base_mismatch``: edit
    distance per reference base of the served strings; ``reads_missing``:
    reads of the window served no string."""

    def flat(x):
        return np.concatenate([np.ravel(a) for a in x]) if isinstance(
            x, list) else np.ravel(x)

    gap = max(float(np.max(np.abs(flat(a) - flat(b))))
              for a, b in zip(served["probs"], ref["probs"]))
    return {"prob_gap": gap,
            "base_mismatch": cmp.base_mismatch(served["strings"],
                                               ref["strings"]),
            "reads_missing": float(served["missing"])}
