"""Signal preprocessing (counterpart of radian_tpu/ops/preprocess.py).

``mad_normalise`` computes the modified z-score ``(x - median) /
(1.4826 * MAD)`` clipped to ``±outlier_clip`` (reference
radian/preprocess.py:24-49) over a batch of length-padded signals, with
the JAX device version's float32 operation order: sort with ``+inf``
padding, median ``0.5*(lo+hi)``, divide, clip, zero past the length.  A
zero or non-finite MAD marks a read the pipeline skips.
"""

from __future__ import annotations

import numpy as np
import torch

MAD_SCALE = 1.4826  # consistency constant: MAD -> sigma for normal data


def mad_normalise_np(signal: np.ndarray, outlier_clip: float) -> np.ndarray:
    """Host-side modified z-score normalisation (float64, like the reference)."""
    if signal.shape[0] == 0:
        raise ValueError("Signal must not be empty to normalise")
    median = np.median(signal)
    mad = np.median(np.abs(signal - median))
    if mad == 0:
        raise ValueError("MAD is zero, issue with signal.")
    z = (signal - median) / (MAD_SCALE * mad)
    return np.clip(z, -outlier_clip, outlier_clip)


def _masked_median(sorted_vals: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the first ``n[i]`` entries of each ascending-sorted row."""
    lo = sorted_vals.gather(1, torch.clamp((n - 1) // 2, min=0)[:, None])
    hi = sorted_vals.gather(1, torch.clamp(n // 2, min=0)[:, None])
    return 0.5 * (lo + hi)  # [N, 1]


def mad_normalise(signals: torch.Tensor, lengths: torch.Tensor,
                  outlier_clip: float = 4.0):
    """Batched MAD normalisation of length-padded signals.

    Args:
      signals: ``[N, L]`` (any real dtype, cast to float32); entries at
        index ``>= lengths[i]`` are ignored.
      lengths: ``[N]`` integer true lengths.
      outlier_clip: symmetric clip for the modified z-score.

    Returns:
      ``(normalised [N, L] f32, mad [N] f32)``.
    """
    x = signals.float()
    n = lengths.to(device=x.device, dtype=torch.int64)
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < n[:, None]
    big = torch.tensor(float("inf"), device=x.device)
    median = _masked_median(torch.sort(torch.where(valid, x, big), 1).values, n)
    dev = torch.abs(x - median)
    mad = _masked_median(torch.sort(torch.where(valid, dev, big), 1).values, n)
    # a float32 constant, like JAX's weak-typed MAD_SCALE * mad
    scale = torch.tensor(MAD_SCALE, dtype=torch.float32, device=x.device)
    z = (x - median) / (scale * mad)
    z = torch.clamp(z, -outlier_clip, outlier_clip)
    return torch.where(valid, z, torch.zeros((), device=x.device)), mad[:, 0]


def bucket_length(length: int, quantum: int = 4096) -> int:
    """Round a read length up to its bucket (fixed batch shapes)."""
    return max(((length + quantum - 1) // quantum) * quantum, quantum)
