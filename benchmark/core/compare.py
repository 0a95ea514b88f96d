"""The numbers that decide ``correct``, and their judgement."""

from __future__ import annotations

import math

import numpy as np


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, one numpy pass a row of ``a``."""
    if not a or not b:
        return len(a) + len(b)
    bb = np.frombuffer(b.encode(), np.uint8)
    prev = np.arange(len(b) + 1)
    offs = np.arange(len(b) + 1)
    for i, ca in enumerate(a.encode(), start=1):
        diag = prev[:-1] + (bb != ca)
        row = np.empty_like(prev)
        row[0] = i
        row[1:] = np.minimum(prev[1:] + 1, diag)
        # insertions run along the row: row[j] = min_k (row[k] + j - k)
        row = np.minimum.accumulate(row - offs) + offs
        prev = row
    return int(prev[-1])


def base_mismatch(served: list, ref: list[str]) -> float:
    """Σ edit distance / Σ reference length over the compared reads; a
    read that came back without a string counts as wholly wrong."""
    dist = sum(len(r) if s is None else edit_distance(s, r)
               for s, r in zip(served, ref))
    return dist / max(1, sum(len(r) for r in ref))


def leaf_norm_gap(prog: dict[str, float], ref: dict[str, float],
                  keep=None) -> float:
    """Worst leaf's ``|‖prog‖ - ‖ref‖|`` over the larger of its reference
    norm and the median leaf's (the training bullet's measure)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number finite and within its limit; a number without a
    limit, or a limit without its number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())


def report(numbers: dict[str, float], limits: dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` in the limits' order."""
    return {k: {"value": numbers.get(k, float("nan")),
                "limit": limits[k]} for k in limits}
