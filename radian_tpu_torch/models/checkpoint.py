"""npz parameter checkpoints in the flax layout, and the weight bridge.

The JAX package saves ``SigToSeq`` parameters as a flat npz whose keys
are flax paths (``tcn/block0/conv0/Conv_0/kernel``, ``dense_relu/bias``,
...).  :func:`params_from_flax` maps those arrays onto this package's
``state_dict``: conv kernels ``[K, Cin, Cout]`` → ``[Cout, Cin, K]``,
dense kernels ``[in, out]`` → ``[out, in]``, biases unchanged.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

_CONV = re.compile(r"tcn/block(\d+)/(conv0|conv1)/Conv_0/(kernel|bias)")
_SHORTCUT = re.compile(r"tcn/block(\d+)/shortcut/(kernel|bias)")
_DENSE = re.compile(r"(dense_relu|dense_out)/(kernel|bias)")


def load_params_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Flat ``{flax_path: array}`` from an npz checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _tensor(name: str, leaf: str, arr: np.ndarray, conv: bool):
    a = np.asarray(arr, np.float32)
    if leaf == "kernel":
        want = 3 if conv else 2
        if a.ndim != want:
            raise ValueError(f"{name}: expected a {want}-d kernel, got "
                             f"shape {a.shape}")
        a = a.transpose(2, 1, 0) if conv else a.T
    elif a.ndim != 1:
        raise ValueError(f"{name}: expected a 1-d bias, got {a.shape}")
    return torch.tensor(np.ascontiguousarray(a))


def params_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flax-layout flat params → a ``SigToSeq`` ``state_dict``.

    Raises ``KeyError`` on a key it does not know and on a missing one
    (every block needs both convs' kernel and bias; a shortcut needs
    both; the two dense layers are required).
    """
    sd: dict[str, torch.Tensor] = {}
    blocks: set[int] = set()
    for name, arr in flat.items():
        if m := _CONV.fullmatch(name):
            b, conv, leaf = int(m[1]), m[2], m[3]
            blocks.add(b)
            key = f"tcn.blocks.{b}.{conv}.{'weight' if leaf == 'kernel' else 'bias'}"
            sd[key] = _tensor(name, leaf, arr, conv=True)
        elif m := _SHORTCUT.fullmatch(name):
            b, leaf = int(m[1]), m[2]
            key = f"tcn.blocks.{b}.shortcut.{'weight' if leaf == 'kernel' else 'bias'}"
            sd[key] = _tensor(name, leaf, arr, conv=True)
        elif m := _DENSE.fullmatch(name):
            layer, leaf = m[1], m[2]
            key = f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"
            sd[key] = _tensor(name, leaf, arr, conv=False)
        else:
            raise KeyError(f"unknown flax parameter {name!r}")
    need = [f"{layer}.{leaf}" for layer in ("dense_relu", "dense_out")
            for leaf in ("weight", "bias")]
    for b in range(max(blocks, default=-1) + 1):
        need += [f"tcn.blocks.{b}.{conv}.{leaf}" for conv in ("conv0", "conv1")
                 for leaf in ("weight", "bias")]
        if any(k.startswith(f"tcn.blocks.{b}.shortcut.") for k in sd):
            need += [f"tcn.blocks.{b}.shortcut.{leaf}"
                     for leaf in ("weight", "bias")]
    missing = sorted(set(need) - set(sd))
    if missing or not blocks:
        raise KeyError(f"flax parameters missing for {missing or 'tcn'}")
    return sd
