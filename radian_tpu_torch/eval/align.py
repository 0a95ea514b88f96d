"""Pairwise-alignment read-identity evaluation (the port's copy of
radian_tpu/eval/align.py, numpy only).

Reimplements the reference's Biopython-based eval (reference
radian/align.py) without the Biopython dependency: a Gotoh affine-gap
global aligner with the reference's minimap2-like scoring
(match=2, mismatch=-4, gap open=-4, gap extend=-2; reference
align.py:88), the same leading/trailing soft-clip rule (sequence starts
at 3 consecutive non-insertions; reference align.py:28-43), and the same
match/sub/ins/del accounting and median/mean summary (align.py:93-109).
"""

from __future__ import annotations

import numpy as np

NEG = -1e9


def global_align(ref: str, query: str, match: float = 2.0,
                 mismatch: float = -4.0, gap_open: float = -4.0,
                 gap_extend: float = -2.0) -> tuple[str, str]:
    """Affine-gap global alignment; returns (ref_aligned, query_aligned).

    Scoring matches Biopython ``pairwise2.align.globalms(ref, query, 2,
    -4, -4, -2)``: opening a gap costs ``gap_open`` for its first
    position and ``gap_extend`` for each additional one.
    """
    n, m = len(ref), len(query)
    a = np.frombuffer(ref.encode(), np.uint8)
    b = np.frombuffer(query.encode(), np.uint8)

    M = np.full((n + 1, m + 1), NEG)  # match/mismatch ending
    X = np.full((n + 1, m + 1), NEG)  # gap in query (deletion) ending
    Y = np.full((n + 1, m + 1), NEG)  # gap in ref (insertion) ending
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        X[i, 0] = gap_open + (i - 1) * gap_extend
    for j in range(1, m + 1):
        Y[0, j] = gap_open + (j - 1) * gap_extend

    sub = np.where(a[:, None] == b[None, :], match, mismatch)

    # Y's left-to-right dependency y[j] = max(c[j], y[j-1] + e) with
    # c[j] = max(M, X)[i, j-1] + gap_open unrolls to
    # y[j] = j·e + max_{k≤j}(v[k] − k·e), v = [y[0], c[1:]] — a max-plus
    # prefix scan, vectorised as a running maximum.  Exact for the
    # integer-valued scoring used here; row cost drops from a Python
    # per-cell loop to O(m) numpy ops (≥20× on kb-scale pairs).
    off = np.arange(m + 1) * gap_extend
    v = np.empty(m + 1)
    for i in range(1, n + 1):
        prevM, prevX, prevY = M[i - 1], X[i - 1], Y[i - 1]
        best_prev = np.maximum(np.maximum(prevM, prevX), prevY)
        M[i, 1:] = best_prev[:-1] + sub[i - 1]
        X[i] = np.maximum(
            np.maximum(prevM + gap_open, prevX + gap_extend),
            prevY + gap_open,
        )
        X[i, 0] = gap_open + (i - 1) * gap_extend
        v[0] = Y[i, 0]
        v[1:] = np.maximum(M[i, :-1], X[i, :-1]) + gap_open
        Y[i] = off + np.maximum.accumulate(v - off)

    # traceback
    out_r, out_q = [], []
    i, j = n, m
    state = int(np.argmax([M[n, m], X[n, m], Y[n, m]]))
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            out_r.append(ref[i - 1])
            out_q.append(query[j - 1])
            prev = [M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1]]
            i, j = i - 1, j - 1
            state = int(np.argmax(prev))
        elif state == 1 and i > 0:
            out_r.append(ref[i - 1])
            out_q.append("-")
            cand = [
                M[i - 1, j] + gap_open,
                X[i - 1, j] + gap_extend,
                Y[i - 1, j] + gap_open,
            ]
            i -= 1
            state = int(np.argmax(cand))
        elif state == 2 and j > 0:
            out_r.append("-")
            out_q.append(query[j - 1])
            cand = [
                M[i, j - 1] + gap_open,
                X[i, j - 1] + gap_open,
                Y[i, j - 1] + gap_extend,
            ]
            j -= 1
            state = int(np.argmax(cand))
        elif i > 0:
            out_r.append(ref[i - 1])
            out_q.append("-")
            i -= 1
        else:
            out_r.append("-")
            out_q.append(query[j - 1])
            j -= 1
    return "".join(reversed(out_r)), "".join(reversed(out_q))


def alignment_stats(ref_aln: str, query_aln: str,
                    soft_clip: bool = True) -> tuple[int, int, int, int]:
    """(n_match, n_sub, n_ins, n_del) with the reference's soft-clip rule."""
    bases = set("ACGT")
    n = len(ref_aln)
    if soft_clip:
        start = 0
        for i in range(n):
            start = i
            if (
                i + 2 < n
                and ref_aln[i] != "-" and ref_aln[i + 1] != "-"
                and ref_aln[i + 2] != "-"
            ):
                break
        end = n - 1
        for i in range(n - 1, -1, -1):
            end = i
            if (
                i - 2 >= 0
                and ref_aln[i] != "-" and ref_aln[i - 1] != "-"
                and ref_aln[i - 2] != "-"
            ):
                break
        ref_aln = ref_aln[start : end + 1]
        query_aln = query_aln[start : end + 1]

    n_mat = n_sub = n_ins = n_del = 0
    for r, q in zip(ref_aln, query_aln):
        if r == q and r in bases:
            n_mat += 1
        elif r in bases and q in bases:
            n_sub += 1
        elif r == "-" and q in bases:
            n_ins += 1
        elif q == "-" and r in bases:
            n_del += 1
    return n_mat, n_sub, n_ins, n_del


def read_identity(ref: str, query: str) -> dict:
    """Full per-read metrics (U→T normalisation like reference align.py:85)."""
    query = query.replace("U", "T")
    ra, qa = global_align(ref, query)
    n_mat, n_sub, n_ins, n_del = alignment_stats(ra, qa)
    total = max(n_mat + n_sub + n_ins + n_del, 1)
    return {
        "n_match": n_mat, "n_sub": n_sub, "n_ins": n_ins, "n_del": n_del,
        "accuracy": 100.0 * n_mat / total,
        "p_ins": 100.0 * n_ins / total,
        "p_del": 100.0 * n_del / total,
        "p_sub": 100.0 * n_sub / total,
        "p_err": 100.0 * (n_ins + n_del + n_sub) / total,
    }


def random_identity_baseline(ref: str, call_len: int, rng=None) -> float:
    """Identity the aligner awards a RANDOM same-length call.

    The Gotoh aligner with soft-clipping scores a uniform-random call at
    ~40% "identity" against a same-length reference (NOTES round 3: the
    round-2 demo's 41% was exactly this) — identity numbers are
    uninterpretable without this floor alongside them.
    """
    rng = rng if rng is not None else np.random.default_rng(0)
    call = "ACGT"
    call = "".join(call[i] for i in rng.integers(0, 4, max(call_len, 1)))
    return read_identity(ref, call)["accuracy"]


def evaluate_fasta(fasta_path, ref_tsv_path, out_tsv_path=None, *,
                   with_baseline: bool = False) -> dict:
    """Evaluate a fasta against a ``read_id\\ttranscript\\tseq`` TSV
    (reference align.py:59-109); returns median/mean summary.

    ``with_baseline=True`` adds a ``random_baseline`` column (what a
    random same-length call would score — the interpretability floor for
    the accuracy numbers) at the cost of a second Gotoh alignment per
    read, so it is opt-in."""
    from radian_tpu_torch.io.fasta import read_fasta

    refs = {}
    with open(ref_tsv_path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            read, _txt, seq = line.rstrip("\n").split("\t")
            refs[read] = seq

    rows = []
    baselines = []
    rng = np.random.default_rng(0)
    out = open(out_tsv_path, "w") if out_tsv_path else None
    if out:
        out.write("read_id\tn_match\tn_ins\tn_del\tn_sub\n")
    for rid, seq in read_fasta(fasta_path).items():
        if rid not in refs:
            continue
        st = read_identity(refs[rid], seq)
        rows.append(st)
        if with_baseline:
            baselines.append(
                random_identity_baseline(refs[rid], len(seq), rng)
            )
        if out:
            out.write(
                f"{rid}\t{st['n_match']}\t{st['n_ins']}\t{st['n_del']}\t"
                f"{st['n_sub']}\n"
            )
    if out:
        out.close()
    if not rows:
        return {}
    summary = {}
    for key in ("accuracy", "p_ins", "p_del", "p_sub", "p_err"):
        vals = [r[key] for r in rows]
        summary[key] = {
            "median": float(np.median(vals)), "mean": float(np.mean(vals))
        }
    if baselines:
        summary["random_baseline"] = {
            "median": float(np.median(baselines)),
            "mean": float(np.mean(baselines)),
        }
    summary["n_reads"] = len(rows)
    return summary


def main(argv=None):
    """CLI: ``python -m radian_tpu_torch.eval.align FASTA REF_TSV
    [--baseline]`` — prints the reference-format summary (reference
    align.py:104-109)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="read-identity eval (reference align.py)")
    ap.add_argument("fasta")
    ap.add_argument("ref_tsv")
    ap.add_argument("--baseline", action="store_true",
                    help="add the random-call identity baseline column "
                         "(second Gotoh alignment per read)")
    a = ap.parse_args(argv)
    out = a.fasta.replace(".fasta", ".tsv")
    summary = evaluate_fasta(a.fasta, a.ref_tsv, out,
                             with_baseline=a.baseline)
    for label, key in (
        ("Accuracy", "accuracy"), ("Insertions", "p_ins"),
        ("Deletions", "p_del"), ("Substitutions", "p_sub"),
        ("Total error", "p_err"),
        ("Random-call baseline", "random_baseline"),
    ):
        if key not in summary:
            continue
        s = summary[key]
        print(f"{label}\tMEDIAN: {s['median']:.2f}\tMEAN: {s['mean']:.2f}")


if __name__ == "__main__":
    main()
