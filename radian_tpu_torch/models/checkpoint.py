"""npz parameter checkpoints in the flax layout, and the weight bridge.

The JAX package saves ``SigToSeq`` parameters as a flat npz whose keys
are flax paths (``tcn/block0/conv0/Conv_0/kernel``, ``dense_relu/bias``,
...).  :func:`params_from_flax` maps those arrays onto this package's
``state_dict``: conv kernels ``[K, Cin, Cout]`` → ``[Cout, Cin, K]``,
dense kernels ``[in, out]`` → ``[out, in]``, biases unchanged.
:func:`params_to_flax` is its inverse, and :func:`save_params_npz` writes
the npz the JAX package's ``load_params_npz`` (and this package's
``load_basecaller``) reads.

A tensor-parallel model (``models/tensor_parallel.py``) keeps shard ``j``
of a split leaf ``name`` under ``name.j``; :func:`gather_params` joins
the shards into the full leaves (so a sharded model exports the same npz
as an unsharded one) and :func:`split_params` splits full leaves back.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

_CONV = re.compile(r"tcn/block(\d+)/(conv0|conv1)/Conv_0/(kernel|bias)")
_SHORTCUT = re.compile(r"tcn/block(\d+)/shortcut/(kernel|bias)")
_DENSE = re.compile(r"(dense_relu|dense_out)/(kernel|bias)")
_TORCH = re.compile(r"tcn\.blocks\.(\d+)\.(conv0|conv1|shortcut)\.(weight|bias)"
                    r"|(dense_relu|dense_out)\.(weight|bias)")
_SHARD = re.compile(r"(.+\.(?:weight|bias))\.(\d+)")


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


def flax_name(name: str) -> str:
    """The flax path of a ``SigToSeq`` ``state_dict`` key."""
    m = _TORCH.fullmatch(name)
    if m is None:
        raise KeyError(f"unknown parameter {name!r}")
    if m[1] is not None:
        leaf = "kernel" if m[3] == "weight" else "bias"
        conv = "shortcut" if m[2] == "shortcut" else f"{m[2]}/Conv_0"
        return f"tcn/block{m[1]}/{conv}/{leaf}"
    return f"{m[4]}/{'kernel' if m[5] == 'weight' else 'bias'}"


def leaf_name(key: str) -> tuple[str, int | None]:
    """``(leaf, shard)`` of a parameter key: ``name.j`` is shard ``j`` of
    the leaf ``name``; any other key is a whole leaf (shard ``None``)."""
    m = _SHARD.fullmatch(key)
    return (m[1], int(m[2])) if m else (key, None)


def gather_params(named, device=None) -> dict[str, torch.Tensor]:
    """``{key: tensor}`` whose keys may be shards → ``{leaf: full
    tensor}``: each split leaf's shards joined along dimension 0 in shard
    order on ``device`` (by default its first shard's), a whole leaf
    moved there; detached from autograd.  Unsharded keys pass through."""
    parts: dict[str, list] = {}
    for key, t in named.items():
        name, j = leaf_name(key)
        parts.setdefault(name, []).append((j or 0, t))
    out = {}
    for name, shards in parts.items():
        shards.sort(key=lambda p: p[0])
        dev = shards[0][1].device if device is None else device
        ts = [t.detach().to(dev) for _, t in shards]
        out[name] = ts[0] if len(ts) == 1 else torch.cat(ts)
    return out


def split_params(full, like) -> dict[str, torch.Tensor]:
    """Full leaves ``{leaf: tensor}`` → ``{key: tensor}`` keyed and
    placed as ``like`` (a sharded or whole model's parameters, or
    anything keyed as they are): shard ``j`` of ``M`` is the ``j``-th
    equal slice of its leaf along dimension 0, each a copy on its
    ``like`` tensor's device."""
    counts: dict[str, int] = {}
    for key in like:
        name, _ = leaf_name(key)
        counts[name] = counts.get(name, 0) + 1
    out = {}
    for key, t in like.items():
        name, j = leaf_name(key)
        v = full[name] if j is None else full[name].chunk(counts[name])[j]
        out[key] = v.to(t.device, copy=True)
    return out


def tensors_to_flax(named) -> dict[str, np.ndarray]:
    """``{state_dict key: tensor}`` (parameters, or anything shaped like
    them, such as optimizer moments; shards are gathered first) →
    flax-layout ``{flax path: float32 array}``: conv kernels ``[Cout,
    Cin, K]`` → ``[K, Cin, Cout]``, dense kernels transposed, biases
    unchanged."""
    out = {}
    for name, t in gather_params(named, "cpu").items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim > 1:
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
        # a copy: a bias's array would share the parameter's memory, and
        # a JAX array made from it on the CPU shares it in turn, so an
        # update in place would reach the JAX side
        out[flax_name(name)] = np.array(a, order="C")
    return out


def params_to_flax(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """A model's parameters as the flat flax-layout dict
    :func:`params_from_flax` reads."""
    return tensors_to_flax(dict(model.named_parameters()))


def save_params_npz(model: torch.nn.Module, path: str | Path) -> None:
    """The JAX package's npz checkpoint: ``"/"``-joined flax paths."""
    np.savez(path, **params_to_flax(model))
