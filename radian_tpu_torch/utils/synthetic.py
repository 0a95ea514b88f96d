"""Synthetic nanopore squiggles (copy of radian_tpu/utils/synthetic.py's
read generator): each base emits a noisy dwell at a level set by its
k-mer context.  Used by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

N_BASES = 4


def kmer_level_table(rng: np.random.Generator, k: int = 3) -> np.ndarray:
    """Random but fixed current levels per k-mer, spread over [-2, 2]."""
    n = N_BASES**k
    return rng.permutation(np.linspace(-2.0, 2.0, n)).astype(np.float32)


def synth_signal(
    rng: np.random.Generator,
    labels: np.ndarray,
    levels: np.ndarray,
    k: int = 3,
    dwell_mean: float = 9.0,
    dwell_std: float = 2.0,
    noise: float = 0.25,
    return_dwells: bool = False,
):
    """Squiggle for a given base sequence (k-mer levels, noisy dwells)."""
    n_bases = len(labels)
    ctx = np.zeros(n_bases, np.int64)
    for i in range(n_bases):
        v = 0
        for j in range(max(0, i - k + 1), i + 1):
            v = v * N_BASES + labels[j]
        ctx[i] = v
    dwells = np.maximum(
        rng.normal(dwell_mean, dwell_std, size=n_bases).round().astype(int), 3
    )
    sig = np.repeat(levels[ctx % len(levels)], dwells)
    sig = (sig + rng.normal(0, noise, size=sig.shape)).astype(np.float32)
    if return_dwells:
        return sig, dwells
    return sig


def synth_read(
    rng: np.random.Generator,
    n_bases: int,
    levels: np.ndarray,
    k: int = 3,
    dwell_mean: float = 9.0,
    dwell_std: float = 2.0,
    noise: float = 0.25,
):
    """One synthetic read of i.i.d. uniform bases: returns
    ``(signal f32[n_samples], labels i32[n_bases])``."""
    labels = rng.integers(0, N_BASES, size=n_bases).astype(np.int32)
    sig = synth_signal(rng, labels, levels, k=k, dwell_mean=dwell_mean,
                       dwell_std=dwell_std, noise=noise)
    return sig, labels
