"""The port's tensor parallelism inside one process, on the CPU, against
the unsharded port and the JAX package.

A narrow model (16 filters, dilations 1/2/4, 16 relu units) on
``make_mesh(1, 2, ["cpu", "cpu"])``: every conv and ``dense_relu`` split
over the row's two devices, ``dense_out`` whole (5 outputs do not
split).  The sharded forward equals the unsharded one and flax's
``SigToSeq.apply`` in float32 and bfloat16; 3 train steps with Adam and
a ``clipnorm`` that clips every step equal the port's unsharded
``Trainer`` and the JAX ``Trainer`` (one CPU device: a JAX tensor-
parallel trainer would all-gather across virtual devices, the XLA CPU
collectives that abort ``tests/test_train.py``; GSPMD's sharded program
computes the same function), losses and gathered parameters; a
checkpoint written at M 2 restores at M 1 and the reverse; and the
training CLI's ``--mesh-model 2 --export-npz`` writes the npz the JAX
``load_params_npz`` reads as the trained parameters.  ``torch`` and the
port are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import yaml
from flax import traverse_util

from radian_tpu.config import default_config
from radian_tpu.models import sig2seq as jsig
from radian_tpu.models.checkpoint import load_params_npz as jload
from radian_tpu.train.trainer import TrainConfig as JTrainConfig
from radian_tpu.train.trainer import Trainer as JTrainer
from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

# the sharded forward against the unsharded port (measured: 0 in both
# dtypes, each output channel's sum runs as in the whole convolution)
# and against flax: float32 log-probs as tests/test_torch_model.py holds
# them, bfloat16 probabilities as tests/test_torch_bf16.py does
SAME_ATOL = 1e-6
FLAX_F32_ATOL = 1e-5
FLAX_BF16_MAX, FLAX_BF16_MEAN = 2e-2, 5e-5
# tests/test_torch_ddp.py's gates for the losses and parameters
FIRST_LOSS_RTOL = 1e-5
CURVE_RTOL = 1e-3
PARAM_ATOL = 1e-5  # measured 6.0e-7 against the unsharded port
# against JAX with the clip on, the unsharded port is as far as the
# sharded one (both measured 4.4e-5): a clipped gradient of ~1e-7 meets
# Adam's epsilon of 1e-7 in lr·m̂/(√v̂ + ε), which turns a last-place
# difference of the gradient into 1.5 % of lr (unclipped: 2.8e-6)
JAX_PARAM_ATOL = 1e-4
CLIPNORM = 1.0


def _narrow(cfg):
    cfg.model.tcn.nb_filters = 16
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 16
    cfg.model.timesteps = 256
    cfg.data.window_size = 256
    cfg.train.batch_size = 8
    cfg.train.opt.adam.lr = 0.003
    cfg.train.opt.adam.clipnorm = CLIPNORM
    return cfg


def test_sharded_forward_matches_unsharded_and_flax():
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import (
        leaf_name,
        params_from_flax,
        params_to_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.models.tensor_parallel import (
        ColumnParallel,
        shard_model,
    )
    from radian_tpu_torch.parallel import make_mesh, param_shardings

    jcfg, tcfg = _narrow(default_config()), _narrow(tdefault())
    jparams = jsig.init_params(jsig.build_model(jcfg), jax.random.PRNGKey(0),
                               256)
    flat = traverse_util.flatten_dict(jax.device_get(jparams), sep="/")
    x = np.random.default_rng(1).normal(size=(3, 300, 1)).astype(np.float32)
    mesh = make_mesh(1, 2, ["cpu", "cpu"])
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        probs = tdt == torch.bfloat16
        want = np.asarray(jsig.build_model(jcfg, compute_dtype=jdt).apply(
            {"params": jparams}, jnp.asarray(x), probs=probs))
        whole, sharded = build_model(tcfg, tdt), build_model(tcfg, tdt)
        for m in (whole, sharded):
            m.load_state_dict(params_from_flax(flat))
        shard_model(sharded, mesh.model_row(0),
                    param_shardings(flat, mesh))
        assert isinstance(sharded.tcn.blocks[0].shortcut, ColumnParallel)
        assert isinstance(sharded.dense_relu, ColumnParallel)
        assert isinstance(sharded.dense_out, torch.nn.Linear)
        split = {leaf_name(k)[0] for k, _ in sharded.named_parameters()
                 if leaf_name(k)[1] is not None}
        assert len(split) == 16  # 3 blocks' convs, the shortcut, dense_relu
        got_flat = params_to_flax(sharded)
        for k, v in flat.items():
            np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
        with torch.no_grad():
            a = whole(torch.from_numpy(x), probs=probs).numpy()
            b = sharded(torch.from_numpy(x), probs=probs).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=SAME_ATOL)
        if probs:
            dp = np.abs(b - want)
            assert dp.max() <= FLAX_BF16_MAX and dp.mean() <= FLAX_BF16_MEAN, (
                dp.max(), dp.mean())
        else:
            np.testing.assert_allclose(b, want, rtol=0, atol=FLAX_F32_ATOL)


def _shards(root, rng, levels):
    from radian_tpu_torch.io.tfrecord import write_shard

    for split, n in (("train", 2), ("val", 1)):
        (root / split).mkdir(parents=True)
        for s in range(n):
            b = synth_windows(rng, 16, window=256, levels=levels)
            write_shard(root / split / f"{s}.tfrecords", [
                {"signal": b["signal"][i],
                 "label": b["labels"][i][: b["label_length"][i]].astype(
                     np.float32),
                 "signal_length": 256,
                 "label_length": int(b["label_length"][i])}
                for i in range(16)])


def test_sharded_training_checkpoints_and_export(tmp_path):
    import torch

    from radian_tpu_torch.cli import train as cli
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import (
        gather_params,
        params_to_flax,
    )
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    levels = kmer_level_table(rng)
    batches = [synth_windows(rng, 8, window=256, levels=levels, max_label=64)
               for _ in range(3)]
    tp = Trainer(_narrow(tdefault()), TrainConfig(
        checkpoint_dir=str(tmp_path / "m2"), device="cpu"),
        mesh=make_mesh(1, 2, ["cpu", "cpu"]))
    one = Trainer(_narrow(tdefault()), TrainConfig(
        checkpoint_dir=str(tmp_path / "m1"), device="cpu"))
    assert tp.row == [torch.device("cpu")] * 2
    assert "tcn.blocks.0.conv0.weight.1" in tp.params
    assert tp.params.keys() == tp.opt_state.slots["mu"].keys()
    # the clip is on: the first step's global norm is over CLIPNORM
    g = torch.autograd.grad(tp.loss(tp._put_batch(batches[0])),
                            list(tp.params.values()))
    assert float(torch.cat([x.reshape(-1) for x in g]).norm()) > 10 * CLIPNORM

    jt = JTrainer(_narrow(default_config()),
                  JTrainConfig(checkpoint_dir=None, mesh_data=1))
    losses = {"tp": [], "one": [], "jax": []}
    for b in batches:
        losses["tp"].append(float(tp.train_step(tp._put_batch(b))))
        losses["one"].append(float(one.train_step(one._put_batch(b))))
        jt.state, loss = jt._train_step(jt.state, jt._put_batch(b))
        losses["jax"].append(float(loss))
    got = np.asarray(losses["tp"])
    got_params = params_to_flax(tp.model)
    j_params = traverse_util.flatten_dict(jax.device_get(jt.state.params),
                                          sep="/")
    for want, params, atol in (
            (losses["one"], params_to_flax(one.model), PARAM_ATOL),
            (losses["jax"], j_params, JAX_PARAM_ATOL)):
        np.testing.assert_allclose(got[0], want[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
        assert set(params) == set(got_params)
        for k, v in params.items():
            np.testing.assert_allclose(got_params[k], np.asarray(v), rtol=0,
                                       atol=atol, err_msg=k)

    # checkpoints hold the full leaves: M 2 -> M 1, and M 1 -> M 2
    def state(tr):
        return (gather_params(tr.params, "cpu"), tr.opt_state.count,
                {s: gather_params(b, "cpu")
                 for s, b in tr.opt_state.slots.items()})

    def same(a, b):
        return (a[1] == b[1] and a[0].keys() == b[0].keys()
                and all(torch.equal(v, b[0][k]) for k, v in a[0].items())
                and all(torch.equal(v, b[2][s][k])
                        for s, d in a[2].items() for k, v in d.items()))

    tp.save_checkpoint(0)
    one.save_checkpoint(0)
    for src, dst in ((tp, one), (one, tp)):
        fresh = Trainer(_narrow(tdefault()), TrainConfig(
            checkpoint_dir=str(src.tcfg.checkpoint_dir), device="cpu"),
            mesh=dst.mesh)
        assert fresh.restore_checkpoint() == 1 and fresh.step == 3
        assert fresh.params.keys() == dst.params.keys()
        assert same(state(fresh), state(src))

    # the CLI: --mesh-model 2, exported as the whole model
    _shards(tmp_path / "shards", rng, levels)
    cfg = _narrow(tdefault())
    (tmp_path / "narrow.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    npz = tmp_path / "params.npz"
    trainer = cli.main([
        "-s", str(tmp_path / "shards"), "-g", str(tmp_path / "narrow.yaml"),
        "--steps-per-epoch", "2", "--n-epochs", "1", "--device", "cpu",
        "--mesh-model", "2", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--log-dir", str(tmp_path / "logs"), "--export-npz", str(npz)])
    assert trainer.step == 2 and len(trainer.row) == 2
    assert trainer.mesh.shape == {"data": 1, "model": 2}
    want = params_to_flax(trainer.model)
    exported = traverse_util.flatten_dict(jload(npz), sep="/")
    assert set(exported) == set(want) == set(j_params)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), v, err_msg=k)
