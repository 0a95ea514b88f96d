"""Signal preprocessing (counterpart of radian_tpu/ops/preprocess.py).

``mad_normalise`` computes the modified z-score ``(x - median) /
(1.4826 * MAD)`` clipped to ``±outlier_clip`` (reference
radian/preprocess.py:24-49) over a batch of length-padded signals, with
the JAX device version's float32 operation order: sort with ``+inf``
padding, median ``0.5*(lo+hi)``, divide, clip, zero past the length.  A
zero or non-finite MAD marks a read the pipeline skips.

``get_windows_np`` and the batched ``window_signal`` /
``preprocess_read`` cut a read into overlapped windows as the reference
does (reference radian/preprocess.py:4-22): a ``window`` slides by
``step`` while a full window fits, then one zero-padded tail window
starts at the next step offset, so ``pad_end >= 1`` always.
``strip_signal`` / ``preprocess_read_strips`` cut the global 'strips'
forward's uniform ``ctx + step`` strips instead.
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


def get_windows_np(signal: np.ndarray, window_size: int, step_size: int):
    """Host-side overlapped windowing; returns ``(windows, pad_end)``."""
    if step_size <= 0:
        raise ValueError("Step size must be > 0")
    if step_size > window_size:
        raise ValueError("Step size must be <= window size")
    length = signal.shape[0]
    n_full = max((length - window_size) // step_size + 1, 0)
    tail_start = n_full * step_size
    tail = signal[tail_start:]
    pad_end = window_size - tail.shape[0]
    windows = np.zeros((n_full + 1, window_size), dtype=signal.dtype)
    if n_full > 0:
        idx = (np.arange(n_full)[:, None] * step_size
               + np.arange(window_size)[None, :])
        windows[:n_full] = signal[idx]
    windows[n_full, : tail.shape[0]] = tail
    return windows, pad_end


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
    # constants filled on the device: a host scalar copied in would
    # synchronise the stream, and wait for the batches queued before
    big = torch.full((), float("inf"), device=x.device)
    median = _masked_median(torch.sort(torch.where(valid, x, big), 1).values, n)
    dev = torch.abs(x - median)
    mad = _masked_median(torch.sort(torch.where(valid, dev, big), 1).values, n)
    # a float32 constant, like JAX's weak-typed MAD_SCALE * mad
    scale = torch.full((), MAD_SCALE, dtype=torch.float32, device=x.device)
    z = (x - median) / (scale * mad)
    z = torch.clamp(z, -outlier_clip, outlier_clip)
    return torch.where(valid, z, torch.zeros((), device=x.device)), mad[:, 0]


def bucket_length(length: int, quantum: int = 4096) -> int:
    """Round a read length up to its bucket (fixed batch shapes)."""
    return max(((length + quantum - 1) // quantum) * quantum, quantum)


def max_windows_for(bucket: int, window_size: int, step_size: int) -> int:
    """Upper bound on the window count of a signal of ``bucket`` samples."""
    n_full = max((bucket - window_size) // step_size + 1, 0)
    return n_full + 1


def window_signal(signals: torch.Tensor, lengths: torch.Tensor,
                  window_size: int, step_size: int, max_windows: int):
    """Overlapped windowing of a batch of length-padded signals.

    Returns ``(windows [N, max_windows, window_size], n_windows [N],
    pad_end [N])``.  Rows at index ``>= n_windows`` repeat the tail
    window and must be masked by the caller.
    """
    n = lengths.to(device=signals.device, dtype=torch.int64)
    n_full = torch.clamp((n - window_size) // step_size + 1, min=0)
    tail_start = n_full * step_size
    pad_end = window_size - (n - tail_start)
    w = torch.arange(max_windows, device=signals.device)
    starts = torch.minimum(w[None, :] * step_size, tail_start[:, None])
    idx = (starts[..., None]
           + torch.arange(window_size, device=signals.device))  # [N, W, T]
    gathered = signals.gather(
        1, torch.minimum(idx, n[:, None, None] - 1).flatten(1))
    windows = torch.where(idx < n[:, None, None], gathered.view(idx.shape),
                          torch.zeros((), device=signals.device))
    return windows, n_full + 1, pad_end


def strip_signal(signals: torch.Tensor, lengths: torch.Tensor,
                 step_size: int, ctx: int, n_strips: int) -> torch.Tensor:
    """Uniform strips of a batch of normalised signals → ``[N, n_strips,
    ctx + step]``.

    Strip ``j`` covers absolute positions ``[j·step - ctx, (j+1)·step)``,
    zero outside ``[0, length)``, so with ``ctx >= RF-1`` a causal forward
    over it gives, at its last ``step`` positions, the reference window
    forward's values at ``[j·step, (j+1)·step)``: the rows "first"
    assembly keeps (the earliest window covering ``t`` has ``t``'s whole
    receptive field in it, or the read's own zero history).
    """
    dev = signals.device
    n = lengths.to(device=dev, dtype=torch.int64)
    starts = torch.arange(n_strips, device=dev) * step_size - ctx
    idx = starts[:, None] + torch.arange(ctx + step_size, device=dev)
    ok = (idx >= 0)[None] & (idx[None] < n[:, None, None])
    gathered = signals[:, torch.clamp(idx, 0, signals.shape[1] - 1)]
    return torch.where(ok, gathered, torch.zeros((), device=dev))


def preprocess_read_strips(signals: torch.Tensor, lengths: torch.Tensor,
                           window_size: int = 1024, step_size: int = 128,
                           ctx: int = 256, n_strips: int = 1,
                           outlier_clip: float = 4.0):
    """Normalise then strip a batch of reads: ``(strips [N, n_strips,
    ctx+step], n_windows, pad_end, mad)``, the window accounting of
    ``window_signal`` for the trim and renormalisation after it."""
    norm, mad = mad_normalise(signals, lengths, outlier_clip)
    n = lengths.to(device=signals.device, dtype=torch.int64)
    n_full = torch.clamp((n - window_size) // step_size + 1, min=0)
    pad_end = window_size - (n - n_full * step_size)
    strips = strip_signal(norm, lengths, step_size, ctx, n_strips)
    return strips, n_full + 1, pad_end, mad


def preprocess_read(signals: torch.Tensor, lengths: torch.Tensor,
                    window_size: int = 1024, step_size: int = 128,
                    max_windows: int = 1, outlier_clip: float = 4.0):
    """Normalise then window a batch of reads: ``(windows, n_windows,
    pad_end, mad)``; a zero or non-finite ``mad`` marks a skipped read."""
    norm, mad = mad_normalise(signals, lengths, outlier_clip)
    windows, n_windows, pad_end = window_signal(
        norm, lengths, window_size, step_size, max_windows)
    return windows, n_windows, pad_end, mad
