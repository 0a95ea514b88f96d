"""Dataset introspection & timing utilities (the port's copy of
radian_tpu/utils/inspect.py), on the port's ``ShardDataset`` batches.

Counterparts of the reference's dev helpers (reference
radian/utilities.py:20-148): dataset iteration timing, steps-per-epoch
counting, label statistics, and label↔sequence rendering.
"""

from __future__ import annotations

import json
import time
from collections import Counter

BASES = "ACGT"


def benchmark_dataset(dataset, max_batches: int | None = None) -> float:
    """Time one pass over a dataset; returns seconds elapsed
    (reference utilities.py:20-25)."""
    t0 = time.perf_counter()
    for i, _ in enumerate(dataset):
        if max_batches is not None and i + 1 >= max_batches:
            break
    dt = time.perf_counter() - t0
    print(f"execution time: {dt}")
    return dt


def count_steps_per_epoch(dataset) -> int:
    """Count batches in one epoch (reference utilities.py:27-32 /
    train.py STEPS_PER_EPOCH tables)."""
    n = 0
    for _ in dataset:
        n += 1
    return n


def label_to_sequence(label, label_length) -> str:
    """Int labels → base string (reference utilities.py:89-93)."""
    return "".join(BASES[int(b)] for b in label[: int(label_length)])


def get_label_stats(dataset, out_path: str | None = None) -> dict:
    """Histogram of label sequences over a dataset
    (reference utilities.py:98-116)."""
    counts: Counter = Counter()
    for batch in dataset:
        for lab, ln in zip(batch["labels"], batch["label_length"]):
            counts[label_to_sequence(lab, ln)] += 1
    stats = dict(counts)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(stats, f)
    return stats


def print_dataset(dataset, n_windows: int = 20, out_path=None):
    """Plot the first batch's signal windows in a 10×2 grid (reference
    utilities.py:63-88 ``print_dataset``).

    ``dataset`` yields dict batches (``radian_tpu_torch.train.data``); with
    ``out_path`` the figure is saved instead of shown (headless hosts).
    """
    import matplotlib

    if out_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    batch = next(iter(dataset))
    signals = batch["signal"]
    n = min(n_windows, len(signals))
    rows = (n + 1) // 2
    fig, axs = plt.subplots(rows, 2, sharey="all", squeeze=False)
    for i in range(n):
        print(label_to_sequence(batch["labels"][i],
                                batch["label_length"][i]))
        axs[i % rows][i // rows].plot(signals[i])
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
    else:
        plt.show()
    return fig


def print_same_label_signals(dataset, target: str, max_signals: int = 6,
                             out_path=None):
    """Collect windows whose label sequence equals ``target`` and plot
    them side by side (reference utilities.py:120-148) — the dev tool
    for eyeballing signal variance under a fixed k-mer sequence.
    """
    import matplotlib

    if out_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    found = []
    for batch in dataset:
        for sig, lab, ln in zip(batch["signal"], batch["labels"],
                                batch["label_length"]):
            if label_to_sequence(lab, ln) == target:
                found.append(sig)
                print(len(found))
        if len(found) >= max_signals:
            break
    rows = max((len(found) + 1) // 2, 1)
    fig, axs = plt.subplots(rows, 2, sharey="all", squeeze=False)
    for i, sig in enumerate(found[: rows * 2]):
        axs[i % rows][i // rows].plot(sig)
    fig.suptitle(f"Signals for {target}")
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
    else:
        plt.show()
    return found
