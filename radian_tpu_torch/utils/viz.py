"""Debug visualisations (matplotlib, imported where it is used), saved to
files (the port's copy of radian_tpu/utils/viz.py).

Counterparts of the reference's interactive debug plots: the
assembly-stitch viewer (reference radian/matrix_assembly.py:55-77) and
signal/window plotting (reference radian/utilities.py:63-148).
"""

from __future__ import annotations

import numpy as np


def plot_assembly(matrices, global_matrix, window_size: int, step_size: int,
                  out_path: str, display_windows: int = 5) -> str:
    """Render the first windows stacked over the assembled matrix."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matrices = list(matrices)[:display_windows]
    len_global = window_size + (len(matrices) - 1) * step_size
    gm = np.asarray(global_matrix)[:len_global]

    fig, axs = plt.subplots(len(matrices) + 1, 1, sharex="all",
                            figsize=(10, 2 * (len(matrices) + 1)))
    for i, matrix in enumerate(matrices):
        padded = np.zeros((len_global, matrix.shape[1]))
        start = i * step_size
        padded[start : start + matrix.shape[0]] = matrix
        axs[i].imshow(padded.T, cmap="gray_r", aspect="auto")
        axs[i].set_ylabel(f"w{i}")
    axs[-1].imshow(gm.T, cmap="gray_r", aspect="auto")
    axs[-1].set_ylabel("stitched")
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


def plot_signals(signals, out_path: str, title: str = "") -> str:
    """Grid plot of raw/normalised signals (reference print_dataset-style)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(signals)
    cols = 2
    rows = (n + 1) // 2
    fig, axs = plt.subplots(rows, cols, sharey="all",
                            figsize=(10, 2 * rows), squeeze=False)
    for i, sig in enumerate(signals):
        axs[i % rows][i // rows].plot(np.asarray(sig))
    if title:
        fig.suptitle(title)
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path
