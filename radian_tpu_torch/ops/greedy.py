"""Greedy CTC decoding and edit distance, the training-time quality
metric (counterpart of radian_tpu/ops/greedy.py).

Argmax per timestep, collapse repeats, drop blanks (``greedy_labels``
runs on the tensor's device; the rest is host numpy), then the
Levenshtein distance to the label.
"""

from __future__ import annotations

import numpy as np
import torch


def greedy_labels(log_probs: torch.Tensor):
    """``[B, T, C]`` log-probs → ``([B, T]`` argmax labels, ``[B, T]`` keep
    mask``)``: keep marks positions that survive the CTC collapse, not
    blank and not a repeat of the previous timestep's argmax."""
    am = torch.argmax(log_probs, dim=-1)
    blank = log_probs.shape[-1] - 1
    prev = torch.nn.functional.pad(am[:, :-1], (1, 0), value=-1)
    keep = (am != blank) & (am != prev)
    return am, keep


def greedy_decode(log_probs, input_lengths=None) -> list[np.ndarray]:
    """Decode a batch to label arrays."""
    am, keep = greedy_labels(torch.as_tensor(log_probs))
    am = am.cpu().numpy()
    keep = keep.cpu().numpy()
    out = []
    for b in range(am.shape[0]):
        k = keep[b]
        if input_lengths is not None:
            k = k & (np.arange(am.shape[1]) < int(input_lengths[b]))
        out.append(am[b][k])
    return out


def edit_distance(a, b) -> int:
    """Levenshtein distance between two int sequences."""
    a = np.asarray(a)
    b = np.asarray(b)
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        for j in range(1, len(b) + 1):
            cur[j] = min(cur[j - 1] + 1, prev[j] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def batch_mean_edit_distance(log_probs, labels, label_lengths,
                             input_lengths=None) -> float:
    """Mean normalised edit distance over a batch (0 = perfect)."""
    decoded = greedy_decode(log_probs, input_lengths)
    dists = []
    for b, d in enumerate(decoded):
        truth = np.asarray(labels[b][: int(label_lengths[b])])
        dists.append(edit_distance(d, truth) / max(len(truth), 1))
    return float(np.mean(dists)) if dists else float("nan")
