"""The benchmark's inputs, made from ``--seed``: raw reads, training
windows, the Markov chain's exact k-mer LM, and the model's weights.

The read generator is a frozen, vectorised copy of the one the trained
weights were trained on (``utils/synthetic.py`` with the settings of
``scripts/train_accuracy_run.py``): bases from a first-order Markov
chain, 3-mer current levels spread over [-2, 2], a dwell of
``N(dwell_mean, dwell_std)`` samples a base (at least 3), Gaussian
noise, written as int16 ADC counts.  The same distribution, drawn in
another order, so its numbers are not the original's.

numpy only (the weights: torch on the caller's device).  Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np

N_BASES = 4
MAD_SCALE = 1.4826


def make_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number; negatives wrap to 64
    bits) and an optional stream id, so that the inputs and the check's
    sample draw from separate streams."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def kmer_levels(level_seed: int, k: int = 3) -> np.ndarray:
    """The fixed current level of each k-mer: ``kmer_level_table`` of
    ``default_rng(level_seed)`` (the trained weights' table for 7)."""
    rng = np.random.default_rng(level_seed)
    return rng.permutation(np.linspace(-2.0, 2.0, N_BASES**k)).astype(
        np.float32)


def markov_trans(p: float) -> np.ndarray:
    """``[4, 4]`` float32: after base ``b``, base ``(b+1) % 4`` with
    probability ``p``, each other base with ``(1-p)/3``."""
    trans = np.full((N_BASES, N_BASES), (1.0 - p) / 3.0, np.float32)
    for b in range(N_BASES):
        trans[b, (b + 1) % N_BASES] = p
    return trans


def markov_bases(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    """``n`` bases of the chain ``markov_trans(p)``: each step adds 1
    (mod 4) with probability ``p``, else 0, 2 or 3 alike."""
    first = rng.integers(0, N_BASES)
    step = np.where(rng.random(n - 1) < p, 1,
                    np.array([0, 2, 3])[rng.integers(0, 3, n - 1)])
    return ((first + np.concatenate([[0], np.cumsum(step)])) % N_BASES
            ).astype(np.int32)


def squiggle(rng: np.random.Generator, bases: np.ndarray, levels, *,
             dwell_mean: float, dwell_std: float, noise: float, k: int = 3):
    """``(signal f32, dwells int)``: each base's k-mer level (the bases
    up to it, at most ``k``) held for its dwell, plus noise."""
    ctx = np.zeros(len(bases), np.int64)
    for j in range(k):
        shifted = np.concatenate([np.zeros(j, np.int64),
                                  bases[:len(bases) - j]])
        ctx += shifted * N_BASES**j
    dwells = np.maximum(np.round(rng.normal(dwell_mean, dwell_std,
                                            len(bases))).astype(int), 3)
    sig = np.repeat(levels[ctx % len(levels)], dwells)
    sig = sig + rng.normal(0.0, noise, sig.shape)
    return sig.astype(np.float32), dwells


def to_adc(sig: np.ndarray, scale: float, offset: float) -> np.ndarray:
    return np.round(sig * scale + offset).astype(np.int16)


def read_lengths(rng: np.random.Generator, n: int, lo: int,
                 hi: int) -> np.ndarray:
    """``n`` lengths on an even grid over ``[lo, hi]``: every seed gets
    the same set, in its own order."""
    return rng.permutation(np.round(np.linspace(lo, hi, n)).astype(int))


def make_read(rng: np.random.Generator, length: int, levels, *, p: float,
              dwell_mean: float, dwell_std: float, noise: float,
              adc_scale: float, adc_offset: float) -> np.ndarray:
    """One int16 read of exactly ``length`` samples."""
    n_bases = int(length / max(dwell_mean - 2 * dwell_std, 3)) + 8
    sig, _ = squiggle(rng, markov_bases(rng, n_bases, p), levels,
                      dwell_mean=dwell_mean, dwell_std=dwell_std, noise=noise)
    while len(sig) < length:  # a run of short dwells: extend
        more, _ = squiggle(rng, markov_bases(rng, n_bases, p), levels,
                           dwell_mean=dwell_mean, dwell_std=dwell_std,
                           noise=noise)
        sig = np.concatenate([sig, more])
    return to_adc(sig[:length], adc_scale, adc_offset)


def read_calls(seed: int, t: dict) -> list[list[np.ndarray]]:
    """The traffic's calls: ``t['distinct_calls']`` lists of
    ``t['reads_per_call']`` reads.  The lengths are one grid of
    ``distinct_calls × reads_per_call`` values dealt out in turn, so
    each call gets an even spread of it; the seed draws the order and
    every read's content."""
    rng = make_rng(seed)
    levels = kmer_levels(t["level_seed"])
    n_calls, per_call = t["distinct_calls"], t["reads_per_call"]
    grid = np.sort(read_lengths(rng, n_calls * per_call, t["length_min"],
                                t["length_max"]))
    calls = []
    for c in rng.permutation(n_calls):
        lengths = rng.permutation(grid[c::n_calls])
        calls.append([make_read(
            rng, int(n), levels, p=t["markov_p"], dwell_mean=t["dwell_mean"],
            dwell_std=t["dwell_std"], noise=t["noise"],
            adc_scale=t["adc_scale"], adc_offset=t["adc_offset"])
            for n in lengths])
    return calls


def mad_normalise(x: np.ndarray, clip: float) -> np.ndarray:
    """Modified z-score ``(x - median) / (1.4826 MAD)``, clipped, float64."""
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    return np.clip((x - med) / (MAD_SCALE * mad), -clip, clip)


def train_batches(seed: int, t: dict, batch_size: int, window: int,
                  clip: float) -> list[dict]:
    """``t['pool_batches']`` training batches of ``batch_size`` windows,
    every window cut from its own read as the basecaller feeds the
    model: int16 ADC, MAD-normalised, one window at a random offset of a
    read of ~``read_windows`` windows, labelled with the bases whose dwell
    midpoint lies inside it (``synth_norm_windows``'s rule)."""
    rng = make_rng(seed)
    levels = kmer_levels(t["level_seed"])
    max_label = t["max_label"]
    n_bases = max(int(t["read_windows"] * window / t["dwell_mean"]), 8)
    out = []
    for _ in range(t["pool_batches"]):
        sig = np.zeros((batch_size, window), np.float32)
        labels = np.zeros((batch_size, max_label), np.int32)
        lab_len = np.zeros(batch_size, np.int32)
        i = 0
        while i < batch_size:
            bases = markov_bases(rng, n_bases, t["markov_p"])
            raw, dwells = squiggle(rng, bases, levels,
                                   dwell_mean=t["dwell_mean"],
                                   dwell_std=t["dwell_std"], noise=t["noise"])
            if len(raw) < window:
                continue
            norm = mad_normalise(to_adc(raw, t["adc_scale"], t["adc_offset"]
                                        ).astype(np.float64), clip)
            off = int(rng.integers(0, len(raw) - window + 1))
            mids = np.concatenate([[0], np.cumsum(dwells)[:-1]]) + dwells // 2
            keep = bases[(mids >= off) & (mids < off + window)]
            if not 0 < len(keep) <= max_label:
                continue
            sig[i] = norm[off:off + window]
            labels[i, :len(keep)] = keep
            lab_len[i] = len(keep)
            i += 1
        out.append({"signal": sig, "labels": labels,
                    "input_length": np.full(batch_size, window, np.int32),
                    "label_length": lab_len})
    return out


def markov_lm_rows(p: float) -> tuple[np.ndarray, np.ndarray]:
    """The chain's next-base distribution after each last base and its
    entropy: ``([4, 4] float32, [4] float32)``.  An LM context's row is
    that of its last base, so these 4 rows are the whole LM."""
    probs = markov_trans(p)
    p64 = probs.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p64 > 0, p64 * np.log(p64), 0.0)
    return probs, (-terms.sum(-1)).astype(np.float32)


def markov_lm_tables(p: float, context_len: int):
    """The chain's exact dense LM over ``4**context_len`` contexts
    (packed base 4, last base lowest): ``(probs [R, 4], entropy [R])``,
    row ``c`` = row ``c % 4`` of :func:`markov_lm_rows`."""
    probs, ent = markov_lm_rows(p)
    reps = N_BASES ** (context_len - 1)
    return np.tile(probs, (reps, 1)), np.tile(ent, reps)


def flax_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """The sig2seq TCN's parameter shapes in the published (flax) layout
    and names: conv kernels ``[k, C_in, C_out]``, dense ``[in, out]``."""
    tcn = model["tcn"]
    f, k = tcn["nb_filters"], tcn["kernel_size"]
    shapes: dict[str, tuple[int, ...]] = {}
    c = 1
    for b in range(tcn["nb_stacks"] * len(tcn["dilations"])):
        pre = f"tcn/block{b}"
        shapes[f"{pre}/conv0/Conv_0/kernel"] = (k, c, f)
        shapes[f"{pre}/conv0/Conv_0/bias"] = (f,)
        shapes[f"{pre}/conv1/Conv_0/kernel"] = (k, f, f)
        shapes[f"{pre}/conv1/Conv_0/bias"] = (f,)
        if c != f:
            shapes[f"{pre}/shortcut/kernel"] = (1, c, f)
            shapes[f"{pre}/shortcut/bias"] = (f,)
        c = f
    shapes["dense_relu/kernel"] = (f, model["relu_units"])
    shapes["dense_relu/bias"] = (model["relu_units"],)
    shapes["dense_out/kernel"] = (model["relu_units"], model["softmax_units"])
    shapes["dense_out/bias"] = (model["softmax_units"],)
    return shapes


def seeded_weights(seed: int, model: dict, device) -> dict[str, np.ndarray]:
    """He-normal kernels (std ``sqrt(2/fan_in)``, folded into ±2 std by
    ``fmod``) and zero biases, drawn in one call on ``device`` from a
    ``torch.Generator`` seeded with ``seed``; flax layout, as float32
    host arrays (the form a checkpoint file gives)."""
    import torch

    shapes = flax_shapes(model)
    kernels = [n for n in shapes if n.endswith("kernel")]
    sizes = [int(np.prod(shapes[n])) for n in kernels]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    flat = torch.fmod(torch.randn(sum(sizes), generator=gen, device=device),
                      2.0).cpu().numpy()
    out, at = {}, 0
    for name, size in zip(kernels, sizes):
        shape = shapes[name]
        std = np.float32(np.sqrt(2.0 / np.prod(shape[:-1])))
        out[name] = (flat[at:at + size].reshape(shape) * std).astype(
            np.float32)
        at += size
    for name, shape in shapes.items():
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
    return out


def load_weights(path) -> dict[str, np.ndarray]:
    """Flat ``{flax name: array}`` from an ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
