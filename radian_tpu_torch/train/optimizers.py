"""Optimizers from the config, with optax's update rules
(counterpart of radian_tpu/train/optimizers.py).

The JAX package builds its optimizers with optax; this module writes
the same rules in torch ops, element for element, where torch's own
optimizers differ:

- ``adam``: ``m̂ / (sqrt(v̂) + eps)`` with the config's ``eps``, the
  bias corrections in float32;
- ``amsgrad``: the running max of the *bias-corrected* ``v̂`` (torch's
  keeps the max of the raw second moment);
- ``adagrad``: the accumulator starts at 0.1 and the update is
  ``rsqrt(sum + 1e-7)``, 0 where the sum is 0 (torch's starts at 0 and
  divides by ``sqrt(sum) + 1e-10``);
- ``sgd``: momentum 0 keeps no trace; ``nesterov`` as ``optax.sgd``;
- ``clipnorm`` is ``optax.clip_by_global_norm`` over all parameters (not
  Keras's per-variable clip), ``clipvalue`` an elementwise clamp, both
  before the optimizer;
- ``cc_opt``: Adam at the constant rates ``init_rate·decays[i]``,
  switching where the update count (0 at the first update) reaches
  ``int(max_steps·b)``, as ``optax.join_schedules``; with
  ``cc_opt_fixed_rate=True``, Adam at ``values[0]`` (the reference's
  behaviour: it evaluates its schedule at a constant step 0).

A :class:`Transform` holds the rule; its state is an :class:`OptState`
the caller keeps, so a rebuilt rule (a new learning rate) continues from
the same moments.  ``opt_state_to_optax`` / ``opt_state_from_optax``
carry that state to and from optax's, as the list of its leaves in
``jax.tree.leaves`` order.

The parameters may be a tensor-parallel model's (``models/
tensor_parallel.py``): shard ``j`` of a leaf, ``name.j``, on its own
device.  The update is elementwise and runs on each shard's device; the
global norm sums each shard's squares once, in optax's order of the
leaves; the optax bridge works on the full leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from radian_tpu_torch.config import DotDict
from radian_tpu_torch.models.checkpoint import (
    flax_name,
    leaf_name,
    params_from_flax,
    split_params,
    tensors_to_flax,
)


@dataclasses.dataclass
class OptState:
    """Update count and per-parameter buffers ``{slot: {name: tensor}}``."""

    count: int
    slots: dict[str, dict[str, torch.Tensor]]


@dataclasses.dataclass
class Transform:
    """One optax rule: ``kind`` ('adam', 'amsgrad', 'sgd', 'adagrad')
    scaled by ``-lr`` (a float, or a schedule of the update count), after
    the clips."""

    kind: str
    lr: float | Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float | None = None
    nesterov: bool = False
    clipnorm: float | None = None
    clipvalue: float | None = None

    @property
    def slot_names(self) -> tuple[str, ...]:
        return {"adam": ("mu", "nu"), "amsgrad": ("mu", "nu", "nu_max"),
                "adagrad": ("sum_of_squares",),
                "sgd": ("trace",) if self.momentum is not None else ()
                }[self.kind]

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        fill = 0.1 if self.kind == "adagrad" else 0.0
        return OptState(0, {s: {k: torch.full_like(p, fill, dtype=torch.float32)
                                for k, p in params.items()}
                            for s in self.slot_names})

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: OptState) -> OptState:
        """One update: writes the new parameters in place and returns the
        new state (its buffers replaced, the old ones untouched)."""
        names = _flax_order(params)
        g = {k: grads[k] for k in names}
        if self.clipnorm:
            norm = torch.zeros((), device=g[names[0]].device)
            for k in names:  # optax sums the leaves' squares in tree order
                norm = norm + (g[k] * g[k]).sum().to(norm.device)
            norm = norm.sqrt()
            on = _per_device(lambda d: norm.to(d))
            g = {k: torch.where(on(v.device) < self.clipnorm, v,
                                v / on(v.device) * self.clipnorm)
                 for k, v in g.items()}
        elif self.clipvalue:
            g = {k: v.clamp(-self.clipvalue, self.clipvalue)
                 for k, v in g.items()}
        count = state.count + 1
        slots = {s: dict(b) for s, b in state.slots.items()}
        # float32 bias corrections on each device: torch's CUDA division
        # by a host scalar multiplies by its reciprocal instead
        corrections = _per_device(lambda d: [
            torch.full((), float(np.float32(1) - np.float32(b)
                                 ** np.float32(count)), device=d)
            for b in (self.b1, self.b2)])
        step = -np.float32(self.lr(state.count) if callable(self.lr)
                           else self.lr)
        for k in names:
            gk = g[k]
            if self.kind in ("adam", "amsgrad"):
                bc1, bc2 = corrections(gk.device)
                mu = (1 - self.b1) * gk + self.b1 * slots["mu"][k]
                nu = (1 - self.b2) * (gk * gk) + self.b2 * slots["nu"][k]
                slots["mu"][k], slots["nu"][k] = mu, nu
                nu_hat = nu / bc2
                if self.kind == "amsgrad":
                    nu_hat = torch.maximum(slots["nu_max"][k], nu_hat)
                    slots["nu_max"][k] = nu_hat
                u = (mu / bc1) / (nu_hat.sqrt() + self.eps)
            elif self.kind == "adagrad":
                acc = gk * gk + slots["sum_of_squares"][k]
                slots["sum_of_squares"][k] = acc
                u = torch.where(acc > 0, torch.rsqrt(acc + 1e-7),
                                torch.zeros((), device=acc.device)) * gk
            elif self.momentum is not None:
                tr = gk + self.momentum * slots["trace"][k]
                slots["trace"][k] = tr
                u = gk + self.momentum * tr if self.nesterov else tr
            else:
                u = gk
            params[k].add_(float(step) * u)
        return OptState(count, slots)


def _per_device(make: Callable[[torch.device], object]
                ) -> Callable[[torch.device], object]:
    """``make(device)``, made once a device."""
    made: dict[torch.device, object] = {}

    def get(device: torch.device):
        if device not in made:
            made[device] = make(device)
        return made[device]

    return get


def _flax_order(params) -> list[str]:
    """Parameter names in the order ``jax.tree.leaves`` visits their
    leaves' flax paths (nested dict keys, sorted), a leaf's shards in
    shard order."""
    def key(k):
        name, j = leaf_name(k)
        return tuple(flax_name(name).split("/")), j or 0

    return sorted(params, key=key)


def build_optimizer(opt_config: DotDict,
                    cc_opt_fixed_rate: bool = False) -> Transform:
    kind = opt_config.type
    if kind == "adam":
        c = opt_config.adam
        return Transform("amsgrad" if c.get("amsgrad") else "adam", c.lr,
                         c.beta_1, c.beta_2, c.epsilon, **_clips(c))
    if kind == "sgd":
        c = opt_config.sgd
        return Transform("sgd", c.lr, momentum=c.momentum or None,
                         nesterov=bool(c.nesterov), **_clips(c))
    if kind == "adagrad":
        return Transform("adagrad", opt_config.adagrad.lr)
    if kind == "cc_opt":
        c = opt_config.cc_opt
        values = [c.init_rate * d for d in c.decays]
        if cc_opt_fixed_rate:
            return Transform("adam", values[0])
        return Transform("adam", piecewise_constant(
            values, [int(c.max_steps * b) for b in c.boundaries]))
    raise ValueError(f"unknown optimizer type {kind!r}")


def piecewise_constant(values, boundaries) -> Callable[[int], float]:
    """``optax.join_schedules`` of constant schedules: ``values[i]`` from
    the count where it reaches ``boundaries[i-1]``."""
    def schedule(count: int) -> float:
        out = values[0]
        for b, v in zip(boundaries, values[1:]):
            if count >= b:
                out = v
        return out

    return schedule


def _clips(c: DotDict) -> dict:
    # clipnorm wins where both are set, as in the JAX package's _with_clips
    if c.get("clipnorm"):
        return {"clipnorm": float(c.clipnorm)}
    if c.get("clipvalue"):
        return {"clipvalue": float(c.clipvalue)}
    return {}


# -- the bridge to optax's state -------------------------------------------

def opt_state_to_optax(tx: Transform, state: OptState) -> list[np.ndarray]:
    """``state`` as the leaves of the optax state of the same rule, in
    ``jax.tree.leaves`` order (for ``jax.tree.unflatten`` with the optax
    state's treedef): the int32 count of Adam/AMSGrad, each slot's
    parameters in flax layout and sorted path order, and for a schedule
    its own count."""
    leaves = []
    if tx.kind in ("adam", "amsgrad"):
        leaves.append(np.asarray(state.count, np.int32))
    for s in tx.slot_names:
        flat = tensors_to_flax(state.slots[s])
        leaves += [flat[k] for k in sorted(flat, key=lambda k: k.split("/"))]
    if callable(tx.lr):
        leaves.append(np.asarray(state.count, np.int32))
    return leaves


def opt_state_from_optax(tx: Transform, leaves, params: dict[str, torch.Tensor]
                         ) -> OptState:
    """The inverse of :func:`opt_state_to_optax`; buffers take the names
    of ``params`` and their devices (split as they are split)."""
    leaves = list(leaves)
    names = list(dict.fromkeys(leaf_name(k)[0] for k in _flax_order(params)))
    count = int(leaves.pop(0)) if tx.kind in ("adam", "amsgrad") else 0
    slots = {}
    for s in tx.slot_names:
        flat = {flax_name(k): np.asarray(leaves.pop(0)) for k in names}
        slots[s] = split_params(params_from_flax(flat), params)
    if callable(tx.lr):
        count = int(leaves.pop(0))
    if leaves:
        raise ValueError(f"{len(leaves)} optax state leaves left over")
    return OptState(count, slots)
