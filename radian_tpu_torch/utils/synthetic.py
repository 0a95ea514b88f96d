"""Synthetic nanopore squiggles (copy of radian_tpu/utils/synthetic.py):
each base emits a noisy dwell at a level set by its k-mer context.
Reads for the basecaller, and CTC training windows in the training
schema (``synth_windows``, ``synth_norm_windows``), optionally from a
first-order Markov chain whose 11-mer LM is known exactly
(``markov_labels``, ``markov_kmer_lm``).  From the same
``np.random.default_rng`` state every generator draws the same numbers in
the same order as the JAX package's, so both give the same arrays.  Used
by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

N_BASES = 4


def kmer_level_table(rng: np.random.Generator, k: int = 3) -> np.ndarray:
    """Random but fixed current levels per k-mer, spread over [-2, 2]."""
    n = N_BASES**k
    return rng.permutation(np.linspace(-2.0, 2.0, n)).astype(np.float32)


def markov_labels(
    rng: np.random.Generator, n_bases: int, trans: np.ndarray
) -> np.ndarray:
    """Base sequence from a first-order Markov chain; ``trans[b]`` is the
    next-base distribution after base ``b``."""
    labels = np.empty(n_bases, np.int32)
    labels[0] = rng.integers(0, N_BASES)
    for i in range(1, n_bases):
        labels[i] = rng.choice(N_BASES, p=trans[labels[i - 1]])
    return labels


def markov_kmer_lm(trans: np.ndarray, context_len: int = 11):
    """Dense :class:`~radian_tpu_torch.lm.kmer.KmerLM` of a first-order
    chain: the next-base distribution given a context depends only on its
    last base, the low base-4 digit of the packed context."""
    from radian_tpu_torch.lm.kmer import KmerLM, _entropy_rows

    trans = np.asarray(trans, np.float32)
    reps = N_BASES ** (context_len - 1)
    probs = np.tile(trans, (reps, 1)).astype(np.float32)  # row ctx -> ctx%4
    return KmerLM(context_len, probs, _entropy_rows(probs.astype(np.float64)))


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
    trans: np.ndarray | None = None,
):
    """One synthetic read: returns ``(signal f32[n_samples], labels
    i32[n_bases])``, of i.i.d. uniform bases or, with ``trans``, of the
    first-order Markov chain it describes."""
    if trans is None:
        labels = rng.integers(0, N_BASES, size=n_bases).astype(np.int32)
    else:
        labels = markov_labels(rng, n_bases, trans)
    sig = synth_signal(rng, labels, levels, k=k, dwell_mean=dwell_mean,
                       dwell_std=dwell_std, noise=noise)
    return sig, labels


def synth_windows(
    rng: np.random.Generator,
    n_windows: int,
    window: int = 1024,
    levels: np.ndarray | None = None,
    max_label: int = 64,
    **read_kw,
):
    """Fixed-size windows with CTC labels, in the training schema
    (signal / labels / input_length / label_length); a base is labelled
    when at least half its dwell lies in the window."""
    if levels is None:
        levels = kmer_level_table(rng)
    k = read_kw.get("k", 3)
    dwell_mean = read_kw.get("dwell_mean", 9.0)
    dwell_std = read_kw.get("dwell_std", 2.0)
    noise = read_kw.get("noise", 0.25)
    if window / dwell_mean > max_label:
        raise ValueError(
            f"window {window} at dwell_mean {dwell_mean} holds "
            f"~{window / dwell_mean:.0f} bases > max_label {max_label}; "
            "raise max_label or dwell_mean (RNA002-realistic dwell is "
            "~40 samples/base at 3012 Hz)"
        )

    signals = np.zeros((n_windows, window), np.float32)
    labels = np.zeros((n_windows, max_label), np.int32)
    label_lengths = np.zeros(n_windows, np.int32)
    for i in range(n_windows):
        while True:
            sig_parts: list[np.ndarray] = []
            labs: list[int] = []
            total = 0
            hist: list[int] = []
            while total < window:
                b = int(rng.integers(0, N_BASES))
                hist.append(b)
                v = 0
                for x in hist[-k:]:
                    v = v * N_BASES + x
                dwell = max(int(round(rng.normal(dwell_mean, dwell_std))), 3)
                part = np.full(dwell, levels[v % len(levels)], np.float32)
                if total + dwell // 2 < window:
                    labs.append(b)
                sig_parts.append(part)
                total += dwell
            sig = np.concatenate(sig_parts)[:window]
            sig = sig + rng.normal(0, noise, size=window).astype(np.float32)
            if 0 < len(labs) <= max_label:
                signals[i] = sig
                labels[i, : len(labs)] = labs
                label_lengths[i] = len(labs)
                break
    return {
        "signal": signals,
        "labels": labels,
        "input_length": np.full(n_windows, window, np.int32),
        "label_length": label_lengths,
    }


def synth_norm_windows(
    rng: np.random.Generator,
    n_windows: int,
    window: int = 1024,
    levels: np.ndarray | None = None,
    trans: np.ndarray | None = None,
    max_label: int = 64,
    adc_scale: float = 100.0,
    adc_offset: float = 500.0,
    **read_kw,
):
    """Training windows cut from MAD-normalised synthetic reads, as the
    basecaller feeds the model: signal → int16 ADC → per-read MAD
    normalisation → one window at a random offset of a read spanning ~2
    windows.  Labels by the at-least-half-dwell rule of
    :func:`synth_windows`; ``trans`` draws the bases from a Markov chain."""
    from radian_tpu_torch.ops.preprocess import mad_normalise_np

    if levels is None:
        levels = kmer_level_table(rng)
    dwell_mean = read_kw.get("dwell_mean", 9.0)

    signals = np.zeros((n_windows, window), np.float32)
    labels_out = np.zeros((n_windows, max_label), np.int32)
    label_lengths = np.zeros(n_windows, np.int32)
    i = 0
    while i < n_windows:
        n_bases = max(int(2.2 * window / dwell_mean), 8)
        if trans is None:
            labs = rng.integers(0, N_BASES, size=n_bases).astype(np.int32)
        else:
            labs = markov_labels(rng, n_bases, trans)
        sig, dwells = synth_signal(rng, labs, levels, return_dwells=True,
                                   **read_kw)
        if len(sig) < window:
            continue
        adc = np.round(sig * adc_scale + adc_offset).astype(np.int16)
        norm = mad_normalise_np(adc.astype(np.float64), 4.0).astype(
            np.float32)
        off = int(rng.integers(0, len(sig) - window + 1))
        starts = np.concatenate([[0], np.cumsum(dwells)[:-1]])
        mids = starts + dwells // 2
        keep = (mids >= off) & (mids < off + window)
        n_keep = int(keep.sum())
        if not 0 < n_keep <= max_label:
            continue
        signals[i] = norm[off : off + window]
        labels_out[i, :n_keep] = labs[keep]
        label_lengths[i] = n_keep
        i += 1
    return {
        "signal": signals,
        "labels": labels_out,
        "input_length": np.full(n_windows, window, np.int32),
        "label_length": label_lengths,
    }
