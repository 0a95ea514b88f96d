"""Device meshes and batch splitting (counterpart of
radian_tpu/parallel/mesh.py).

A ``Mesh`` here is a ``[data, model]`` grid of ``torch.device``s with
the JAX package's axis names.  Inference shards each read batch's rows
over the ``data`` axis in one process (``Basecaller(mesh=...)``), one
model replica on each device, exactly as the JAX package's
``shard_map`` does: reads are independent, so no collective runs.
Training shards the data axis over processes instead, one row of the
mesh each (``parallel/distributed.py``), and the ``model`` axis inside
the process: ``param_shardings`` is the JAX package's tensor-parallel
rule, and ``models/tensor_parallel.py`` splits a model's layers over
the process's model row (``Mesh.model_row``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` shaped like
    ``axis_names``.  The same device may appear more than once (several
    replicas on one card, or on the CPU)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as "
                             f"many axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> list[torch.device]:
        """One device per ``data`` index: the first of each model row."""
        return [row[0] for row in self._rows()]

    def model_row(self, index: int = 0) -> list[torch.device]:
        """The devices of data index ``index``, in ``model`` order: one
        process's share of a training mesh, over which its sharded layers
        split (``models/tensor_parallel.py``)."""
        return self._rows()[index]

    def _rows(self) -> list[list[torch.device]]:
        grid = np.moveaxis(self.devices, self.axis_names.index("data"), 0)
        return [list(row.flat) for row in grid]


def make_mesh(data: int | None = None, model: int = 1,
              devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A ``(data, model)`` mesh; ``data=None`` takes every device given,
    by default every local CUDA device (raising when there is none:
    pass ``devices`` to run on the CPU, e.g. ``["cpu", "cpu"]``)."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=[...] (e.g. "
                "['cpu', 'cpu']) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    if data is None:
        data = len(devices) // model
    n = data * model
    if data < 1 or model < 1 or n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(data, model), AXES)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's leading (batch) axis split over a mesh's ``data``
    devices, as ``data_sharding`` gives it."""

    mesh: Mesh

    def parts(self, x: torch.Tensor) -> list[tuple[torch.Tensor,
                                                   torch.device]]:
        """``(part, device)`` per data device: ``x``'s equal row slices in
        order; nothing is copied yet."""
        devices = self.mesh.data_devices()
        if x.shape[0] % len(devices):
            raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                             f"the mesh's {len(devices)} data devices")
        return list(zip(torch.chunk(x, len(devices)), devices))


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading (batch) axis over 'data' (``ndim`` is the JAX
    signature's; the split is always of the leading axis)."""
    del ndim
    return Sharding(mesh)


def replicated_sharding(mesh: Mesh) -> list[torch.device]:
    """The devices a replicated value lives on: one copy on each data
    device (``Basecaller(mesh=...)`` puts a model replica on each)."""
    return mesh.data_devices()


def model_row_devices(device: torch.device, model: int) -> list[torch.device]:
    """A process's ``model`` devices from its own ``device``: ``model``
    copies of a CPU device; on CUDA ``cuda:(i·model + j) mod count`` for
    ``j < model``, ``i`` being ``device``'s index (the process's local
    rank once ``initialize`` has set it), so the rows of one host's
    processes tile its cards."""
    if device.type != "cuda":
        return [device] * model
    n = torch.cuda.device_count()
    return [torch.device("cuda", (device.index * model + j) % n)
            for j in range(model)]


def param_shardings(params, mesh: Mesh) -> dict[str, int | None]:
    """The JAX package's tensor-parallel rule over the 'model' axis, leaf
    for leaf: ``params`` is ``{flax path: array}`` in the flax layout
    (``models/checkpoint.py::params_to_flax``).  A kernel (2-d or more,
    ``kernel`` in its path) whose last dimension divides by the model
    size ``M`` is split over it, and so is a 1-d ``bias`` that divides
    and holds at least ``8·M`` entries; everything else is replicated,
    as is every leaf at ``M`` 1.

    Returns, for each path, the torch dimension split (0: the flax
    layout's last is the first of a ``CausalConv1D`` weight ``[out, in,
    k]``, of an ``nn.Linear`` weight ``[out, in]`` and of a bias) or
    ``None`` for a replicated leaf."""
    m = mesh.shape.get("model", 1)

    def split(path: str, shape: tuple[int, ...]) -> int | None:
        if m > 1 and shape and shape[-1] % m == 0:
            if len(shape) >= 2 and "kernel" in path:
                return 0
            if len(shape) == 1 and "bias" in path and shape[-1] >= 8 * m:
                return 0
        return None

    return {k: split(k, tuple(np.shape(v))) for k, v in params.items()}
