"""The port's train step against the JAX ``Trainer``, at the narrow
config of ``tests/test_train.py`` (32 filters, dilations 1/2/4, 32 relu
units, window 256, batch 8, Adam at 0.003), on the CPU.

The seed-0 init is the JAX ``Trainer``'s bit for bit; the first step's
loss (rtol 1e-5) and gradients (1e-4 of each leaf's largest entry)
equal the JAX ``loss_fn``'s; a 10-step loss curve over the same batches
stays within 1e-3 relative (measured: under 1e-4).  And the dropout
repair: a config with ``dropout_rate=0.1`` infers as the JAX model's
``apply(train=False)`` (within 1e-5), while training with it is refused
in both packages, and batch norm still raises.  The JAX ``Trainer`` is
built with ``mesh_data=1``: one CPU device, no collectives.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from radian_tpu.config import default_config
from radian_tpu.models import sig2seq as jsig
from radian_tpu.ops.ctc import ctc_loss as jctc
from radian_tpu.train.trainer import TrainConfig as JTrainConfig
from radian_tpu.train.trainer import Trainer as JTrainer
from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

CURVE_RTOL = 1e-3


def _tiny(cfg):
    cfg.model.tcn.nb_filters = 32
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 32
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    cfg.train.batch_size = 8
    cfg.train.opt.adam.lr = 0.003
    return cfg


def _batches(n):
    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    return [synth_windows(rng, 8, window=256, levels=levels, max_label=64)
            for _ in range(n)]


def test_init_first_step_and_loss_curve_equal_jax():
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import params_to_flax, tensors_to_flax
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _batches(10)
    jt = JTrainer(_tiny(default_config()),
                  JTrainConfig(checkpoint_dir=None, mesh_data=1))
    tt = Trainer(_tiny(tdefault()),
                 TrainConfig(checkpoint_dir=None, device="cpu"))
    want = traverse_util.flatten_dict(jax.device_get(jt.state.params),
                                      sep="/")
    got = params_to_flax(tt.model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    # the first step's loss and gradients
    hb = jt._host_batch(batches[0])

    def loss_fn(params):
        lp = jt.model.apply({"params": params}, hb["signal"][..., None],
                            train=True)
        losses = jctc(lp, hb["input_length"], hb["labels"],
                      hb["label_length"])
        return (losses * hb["weight"]).sum() / jnp.maximum(
            hb["weight"].sum(), 1.0)

    j_loss, j_grads = jax.value_and_grad(loss_fn)(jt.state.params)
    j_grads = traverse_util.flatten_dict(jax.device_get(j_grads), sep="/")
    batch = tt._put_batch(batches[0])
    t_loss = tt.loss(batch)
    t_grads = torch.autograd.grad(t_loss, list(tt.params.values()))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    t_grads = tensors_to_flax(dict(zip(tt.params, t_grads)))
    for k, w in j_grads.items():
        w = np.asarray(w)
        np.testing.assert_allclose(t_grads[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)

    # a 10-step loss curve over the same batches
    j_curve, t_curve = [], []
    for b in batches:
        jt.state, loss = jt._train_step(jt.state, jt._put_batch(b))
        j_curve.append(float(loss))
        t_curve.append(float(tt.train_step(tt._put_batch(b))))
    assert tt.step == int(jt.state.step) == 10
    assert t_curve[-1] < 0.6 * t_curve[0]  # it trains
    np.testing.assert_allclose(t_curve, j_curve, rtol=CURVE_RTOL)


def test_dropout_infers_as_jax_and_refuses_training():
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    jcfg = _tiny(default_config())
    jcfg.model.tcn.dropout_rate = 0.1
    tcfg = _tiny(tdefault())
    tcfg.model.tcn.dropout_rate = 0.1
    jmodel = jsig.build_model(jcfg)
    params = jsig.init_params(jmodel, jax.random.PRNGKey(0), 256)
    x = np.random.default_rng(1).normal(size=(3, 300, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   train=False))
    model = build_model(tcfg)
    model.load_state_dict(params_from_flax(
        traverse_util.flatten_dict(jax.device_get(params), sep="/")))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the seeded init does not depend on dropout: the same weights
    seeded = build_model(tcfg)
    seeded.reset_parameters(0)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in seeded.state_dict().items())

    # training with dropout: the JAX apply wants a 'dropout' rng its
    # Trainer never passes, so neither package trains with it
    with pytest.raises(Exception, match="dropout"):
        jmodel.apply({"params": params}, jnp.asarray(x), train=True)
    with pytest.raises(NotImplementedError, match="JAX"):
        model(torch.from_numpy(x), train=True)
    with pytest.raises(NotImplementedError, match="JAX Trainer"):
        Trainer(tcfg, TrainConfig(checkpoint_dir=None, device="cpu"))

    # batch norm: the JAX package keeps no batch_stats, so it cannot
    # apply it; the port refuses it at construction
    jcfg.model.tcn.dropout_rate = 0.0
    jcfg.model.tcn.use_batch_norm = True
    bn = jsig.build_model(jcfg)
    with pytest.raises(Exception, match="batch_stats"):
        bn.apply({"params": jsig.init_params(bn, jax.random.PRNGKey(0),
                                             256)}, jnp.asarray(x))
    tcfg.model.tcn.use_batch_norm = True
    with pytest.raises(NotImplementedError, match="batch_stats"):
        build_model(tcfg)
