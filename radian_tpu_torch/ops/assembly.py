"""Global-mode matrix assembly (counterpart of radian_tpu/ops/assembly.py).

The reference stitches overlapping per-window softmax matrices into one
full-read matrix (reference radian/matrix_assembly.py:6-53), but its
``average_dist`` drops the result of ``np.add``, so the row at timestep
``t`` is the distribution of the *earliest-starting* window covering
``t``: L1-normalised where more than one window covers it, verbatim
where one does.  That is ``mode='first'``, the default;
``mode='mean'`` is the corrected average the JAX package offers beside
it.

For timestep ``t`` the earliest covering window is ``i0 = max(0,
(t - window)//step + 1)`` and the cover count ``min(t//step,
n_windows-1) - i0 + 1``, so assembly over a batch is a gather and a
masked normalise ('first'), or ``window//step + 1`` masked gathers
summed in float32 in JAX's order ('mean'), on the matrices' device.
"""

from __future__ import annotations

import numpy as np
import torch


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1, keepdim=True)`` added left to right, as XLA's CPU
    reduction adds a 5-class row (torch's vectorised sum adds in another
    order and lands an ulp away on ~1 row in 3)."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s[..., None]


def assemble_matrices(matrices: torch.Tensor, n_windows: torch.Tensor,
                      pad_end: torch.Tensor, *, step: int = 128,
                      window: int = 1024, out_len: int,
                      mode: str = "first"):
    """Stitch a batch's ``[N, max_windows, window, C]`` window outputs.

    Args:
      matrices: model outputs per window; rows ``>= n_windows`` ignored.
      n_windows: ``[N]`` true window counts (tail window last).
      pad_end: ``[N]`` zero-pad length of each tail window (>= 1); the
        tail window's last ``pad_end`` steps are trimmed (reference
        basecall.py:96).
      out_len: output length (>= every signal length).

    Returns:
      ``(assembled [N, out_len, C] f32, t_read [N])``, rows ``>= t_read``
      zeroed.
    """
    n, _, _, c = matrices.shape
    dev = matrices.device
    nw = n_windows.to(device=dev, dtype=torch.int64)[:, None]
    t = torch.arange(out_len, device=dev)[None, :]
    t_read = (n_windows.to(device=dev, dtype=torch.int64) - 1) * step \
        + window - pad_end.to(device=dev, dtype=torch.int64)
    i0 = torch.minimum(torch.clamp((t - window) // step + 1, min=0), nw - 1)
    i_hi = torch.minimum(t // step, nw - 1)
    count = i_hi - i0 + 1
    rows_of = torch.arange(n, device=dev)[:, None]
    zero = torch.zeros((), device=dev)
    if mode == "first":
        # t - i0·step < window on every row the trim keeps; the clamp only
        # keeps the index inside the window past the read's end
        rows = matrices[rows_of, i0,
                        torch.clamp(t - i0 * step, max=window - 1)].float()
        s = row_sum(rows)
        rows = torch.where((count[..., None] > 1) & (s > 0), rows / s, rows)
    elif mode == "mean":
        acc = torch.zeros((n, out_len, c), dtype=torch.float32, device=dev)
        for k in range(window // step + 1):
            i = i0 + k
            off = torch.clamp(t - i * step, 0, window - 1)
            got = matrices[rows_of, torch.minimum(i, nw - 1), off].float()
            acc = acc + torch.where((i <= i_hi)[..., None], got, zero)
        cnt = count[..., None].float()
        rows = acc / cnt
        s = row_sum(rows)
        # XLA rewrites JAX's (acc / count) / s as acc / (count · s)
        rows = torch.where(s > 0, acc / (cnt * s), rows)
    else:
        raise ValueError(f"unknown assembly mode {mode!r}")
    return torch.where((t < t_read[:, None])[..., None], rows, zero), t_read


def assemble_matrices_np(matrices: list[np.ndarray], step: int,
                         mode: str = "first") -> np.ndarray:
    """Host assembly of one read's trimmed matrix list (the reference's
    shape of the problem): ``matrices`` are ``[T_i, C]`` arrays, the tail
    already trimmed, as the reference driver holds them."""
    n = len(matrices)
    t_read = (n - 1) * step + matrices[-1].shape[0]
    c = matrices[0].shape[1]
    out = np.zeros((t_read, c), np.float32)
    count = np.zeros(t_read, np.int64)
    acc = np.zeros((t_read, c), np.float64)
    first = np.full(t_read, -1, np.int64)
    for i, m in enumerate(matrices):
        lo = i * step
        hi = lo + m.shape[0]
        acc[lo:hi] += m
        idx = np.nonzero(first[lo:hi] < 0)[0] + lo
        first[idx] = i
        out[idx] = m[idx - lo]
        count[lo:hi] += 1
    if mode == "first":
        multi = count > 1
        s = out[multi].sum(-1, keepdims=True)
        nz = (s > 0).ravel()
        rows = out[multi]
        rows[nz] = rows[nz] / s[nz]
        out[multi] = rows
        return out
    rows = (acc / count[:, None]).astype(np.float32)
    s = rows.sum(-1, keepdims=True)
    with np.errstate(invalid="ignore"):  # 0/0 rows are kept as they are
        return np.where(s > 0, rows / s, rows)
