"""Keras ``.h5`` weights import and export (counterpart of
radian_tpu/models/keras_import.py).

The reference trains with Keras and checkpoints weights-only HDF5 files
(reference radian/train.py:72-78, ``model-{epoch:02d}.h5``; loaded at
radian/model.py:42-45).  Their weights map one to one onto the flax
paths that ``params_from_flax`` takes:

  keras ``tcn/residual_block_<i>/conv1D_<j>``   → ``tcn/block<i>/conv<j>/Conv_0``
  keras ``tcn/residual_block_0/matching_conv1D`` → ``tcn/block0/shortcut``
  keras ``dense`` / ``dense_1``                  → ``dense_relu`` / ``dense_out``

Keras Conv1D kernels are ``[k, in, out]`` and Dense kernels ``[in, out]``,
as in flax, so nothing is transposed here.  The importer matches names
by pattern and checks shapes; the exporter writes the same layout, so a
checkpoint round-trips and goes back to a reference user.  ``h5py`` is
imported inside the functions: a host without it still imports the
package.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from radian_tpu_torch.config import DotDict, default_config


def _collect_weights(path: str | Path) -> list[tuple[str, np.ndarray]]:
    """``(name, array)`` pairs of a Keras ``save_weights`` file, in its
    layer order."""
    import h5py

    out: list[tuple[str, np.ndarray]] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in root.attrs.get("layer_names", list(root.keys()))
        ]
        for lname in layer_names:
            if lname not in root:
                continue
            grp = root[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in grp.attrs.get("weight_names", [])]
            if not wnames:  # no weight_names: every dataset of the group
                grp.visit(lambda n: wnames.append(n)
                          if isinstance(grp[n], h5py.Dataset) else None)
            for wn in wnames:
                out.append((wn, np.asarray(grp[wn])))
    return out


def load_keras_h5(path: str | Path,
                  config: DotDict | None = None) -> dict[str, np.ndarray]:
    """A Keras weights-only ``.h5`` → flat ``{flax_path: array}``."""
    cfg = config if config is not None else default_config()
    params: dict[str, np.ndarray] = {}
    dense: dict[str, list[np.ndarray]] = {"kernel": [], "bias": []}
    for name, arr in _collect_weights(path):
        kind = ("kernel" if "kernel" in name
                else "bias" if "bias" in name else None)
        if kind is None:
            continue
        m = re.search(r"residual_block_(\d+)", name)
        if m:
            block = f"tcn/block{int(m.group(1))}"
            if re.search(r"matching|shortcut|1x1", name):
                params[f"{block}/shortcut/{kind}"] = arr
                continue
            cm = re.search(r"conv1 ?D?_(\d+)", name, re.IGNORECASE)
            if cm:
                conv = int(cm.group(1))
            else:  # unnumbered: the JAX importer's rule, as it stands
                c0 = f"{block}/conv0/Conv_0/"
                conv = 0 if not any(k.startswith(c0) for k in params) \
                    or c0 + kind in params else 1
            params[f"{block}/conv{conv}/Conv_0/{kind}"] = arr
        elif "dense" in name.lower():
            dense[kind].append(arr)
    if len(dense["kernel"]) != 2 or len(dense["bias"]) != 2:
        raise ValueError(
            f"expected 2 dense layers, found {len(dense['kernel'])} kernels "
            f"/ {len(dense['bias'])} biases in {path}")
    # the relu head comes before the softmax head in Keras' layer order
    for i, layer in enumerate(("dense_relu", "dense_out")):
        params[f"{layer}/kernel"] = dense["kernel"][i]
        params[f"{layer}/bias"] = dense["bias"][i]
    _validate(params, cfg)
    return params


def _validate(params: dict[str, np.ndarray], cfg: DotDict) -> None:
    t = cfg.model.tcn
    for i in range(t.nb_stacks * len(t.dilations)):
        block = f"tcn/block{i}"
        if not any(k.startswith(block + "/") for k in params):
            raise ValueError(f"missing weights for block{i}")
        for j in range(2):
            k = params.get(f"{block}/conv{j}/Conv_0/kernel")
            if k is None or k.shape[0] != t.kernel_size \
                    or k.shape[2] != t.nb_filters:
                raise ValueError(f"block{i}/conv{j} kernel shape "
                                 f"{None if k is None else k.shape}")
        if i == 0 and f"{block}/shortcut/kernel" not in params:
            raise ValueError("block0 missing shape-match (1x1) conv")
    if params["dense_relu/kernel"].shape[1] != cfg.model.relu_units:
        raise ValueError("dense_relu shape mismatch")
    if params["dense_out/kernel"].shape[1] != cfg.model.softmax_units:
        raise ValueError("dense_out shape mismatch")


def export_keras_h5(params: dict[str, np.ndarray], path: str | Path) -> None:
    """Write flat flax-path params in the Keras ``save_weights`` layout
    (round-trips through :func:`load_keras_h5`; the reference loads it)."""
    import h5py

    blocks = sorted({int(m.group(1)) for k in params
                     if (m := re.match(r"tcn/block(\d+)/", k))})
    with h5py.File(path, "w") as f:
        layer_names = ["inputs", "tcn", "dense", "activation", "dense_1",
                       "activation_1"]
        f.attrs["layer_names"] = [n.encode() for n in layer_names]
        for ln in layer_names:
            f.create_group(ln)
        tgrp = f["tcn"]
        wnames = []
        for bi, b in enumerate(blocks):
            pairs = [(f"conv1D_{j}", f"tcn/block{b}/conv{j}/Conv_0")
                     for j in range(2)]
            if f"tcn/block{b}/shortcut/kernel" in params:
                pairs.append(("matching_conv1D", f"tcn/block{b}/shortcut"))
            for keras, flax in pairs:
                for kind in ("kernel", "bias"):
                    name = f"tcn/residual_block_{bi}/{keras}/{kind}:0"
                    tgrp.create_dataset(
                        name, data=np.asarray(params[f"{flax}/{kind}"]))
                    wnames.append(name)
        tgrp.attrs["weight_names"] = [n.encode() for n in wnames]
        for lname, pkey in (("dense", "dense_relu"), ("dense_1", "dense_out")):
            grp = f[lname]
            wnames = []
            for kind in ("kernel", "bias"):
                name = f"{lname}/{kind}:0"
                grp.create_dataset(name,
                                   data=np.asarray(params[f"{pkey}/{kind}"]))
                wnames.append(name)
            grp.attrs["weight_names"] = [n.encode() for n in wnames]
        for empty in ("inputs", "activation", "activation_1"):
            f[empty].attrs["weight_names"] = []
