"""The port's optimizers against optax, as the JAX package builds them.

For each variant of ``build_optimizer`` (adam, amsgrad, adam with
clipnorm, adam with clipvalue, sgd with nesterov momentum, sgd without
momentum, adagrad, cc_opt across a rate boundary, cc_opt at its fixed
rate), 5 updates from the same seeded parameters and the same gradients
(a zero gradient column among them) give optax's parameters and state
within 1e-6 of each leaf's largest entry.  The state bridge round-trips:
the port's state as optax leaves, and back, is the same state.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import traverse_util

from radian_tpu.config import default_config
from radian_tpu.train.optimizers import build_optimizer as jbuild
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TOL = 1e-6

VARIANTS = {
    "adam": {},
    "amsgrad": {"adam": {"amsgrad": True}},
    "adam_clipnorm": {"adam": {"clipnorm": 0.5}},
    "adam_clipvalue": {"adam": {"clipvalue": 0.01}},
    "sgd_nesterov": {"type": "sgd",
                     "sgd": {"momentum": 0.9, "nesterov": True}},
    "sgd": {"type": "sgd"},
    "adagrad": {"type": "adagrad"},
    # boundaries int(100·[0.03, 0.07, ...]) = 3, 7: the rate changes at
    # the 4th update (count 3)
    "cc_opt": {"type": "cc_opt", "cc_opt": {"max_steps": 100}},
    "cc_opt_fixed": {"type": "cc_opt"},
}


def _configure(cfg, changes):
    cfg.model.tcn.nb_filters = 32
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 32
    for k, v in changes.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                cfg.train.opt[k][kk] = vv
        else:
            cfg.train.opt[k] = v
    return cfg


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), np.finfo(np.float32).tiny)
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"{what}: {err:.3e}"


def test_updates_equal_optax():
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import (
        params_from_flax,
        params_to_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.train import optimizers as topt

    rng = np.random.default_rng(0)
    for name, changes in VARIANTS.items():
        jcfg = _configure(default_config(), changes)
        tcfg = _configure(tdefault(), changes)
        fixed = name == "cc_opt_fixed"
        jtx = jbuild(jcfg.train.opt, cc_opt_fixed_rate=fixed)
        ttx = topt.build_optimizer(tcfg.train.opt, cc_opt_fixed_rate=fixed)
        model = build_model(tcfg)
        model.reset_parameters(0)
        params = dict(model.named_parameters())
        flat = params_to_flax(model)
        jp = _tree(flat)
        js = jtx.init(jp)
        ts = ttx.init(params)
        for step in range(5):
            scale = 1.0 if step % 2 == 0 else 0.05
            grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                     for k, v in flat.items()}
            grads["dense_out/kernel"][:, 0] = 0.0
            updates, js = jtx.update(_tree(grads), js, jp)
            jp = optax.apply_updates(jp, updates)
            ts = ttx.apply(params, params_from_flax(grads), ts)
        want = traverse_util.flatten_dict(jax.device_get(jp), sep="/")
        got = params_to_flax(model)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"{name} {k}")
        j_leaves, treedef = jax.tree.flatten(js)
        t_leaves = topt.opt_state_to_optax(ttx, ts)
        assert len(t_leaves) == len(j_leaves), name
        for i, (g, w) in enumerate(zip(t_leaves, j_leaves)):
            assert g.dtype == np.asarray(w).dtype, (name, i)
            _close(g, w, f"{name} state leaf {i}")
        jax.tree.unflatten(treedef, t_leaves)  # the same tree structure
        # the bridge both ways: optax's state in the port is the port's
        back = topt.opt_state_from_optax(
            ttx, [np.asarray(x) for x in j_leaves], params)
        assert back.count == (5 if ttx.kind in ("adam", "amsgrad") else 0)
        for i, (g, w) in enumerate(zip(topt.opt_state_to_optax(ttx, back),
                                       j_leaves)):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{name} leaf {i}")
        again = topt.opt_state_from_optax(ttx, t_leaves, params)
        for s in ts.slots:
            for k, v in ts.slots[s].items():
                assert torch.equal(again.slots[s][k], v), (name, s, k)
