"""The port's ``Trainer.fit``, checkpoints and pool against the JAX
``Trainer``, at the narrow config of ``tests/test_train.py``, on the CPU.

``fit`` with val and the edit distance gives the JAX history (losses
within 1e-3 relative, edit distances within 0.02); checkpoints keep the
newest ``keep_checkpoints`` epochs and a best-on-val copy, and restore
params and optimizer state bit for bit with the JAX resume epochs.  The
pool (``epoch_scan``) trains to the per-step losses, a short final batch
included, and its val loss weights batches by their real rows, as
``evaluate`` (and the JAX ``evaluate``) does: the JAX ``evaluate_scan``'s
unweighted mean is the deviation ROADMAP Queue 3 records.
``update_learning_rate`` keeps the moments and takes effect.  The JAX
``Trainer`` is built with ``mesh_data=1``.  ``torch`` and the port are
imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import jax
import numpy as np

from radian_tpu.config import default_config
from radian_tpu.train.trainer import TrainConfig as JTrainConfig
from radian_tpu.train.trainer import Trainer as JTrainer
from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


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


def _state(tr):
    """Params and optimizer buffers, as host tensors, and the counts."""
    return ({k: v.detach().clone() for k, v in tr.params.items()},
            {(s, k): v.clone() for s, b in tr.opt_state.slots.items()
             for k, v in b.items()},
            tr.opt_state.count, tr.step)


def _assert_state_equal(a, b):
    import torch

    assert a[2:] == b[2:]
    for x, y in zip(a[:2], b[:2]):
        assert set(x) == set(y)
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_fit_with_val_and_checkpoints(tmp_path):
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _batches(8)
    train, val = batches[:6], batches[6:]
    jt = JTrainer(_tiny(default_config()),
                  JTrainConfig(checkpoint_dir=None, mesh_data=1))
    want = jt.fit(lambda: list(train), lambda: list(val), n_epochs=2,
                  val_freq=1, eval_edit_distance=True)
    ckpt = tmp_path / "ckpt"
    tt = Trainer(_tiny(tdefault()),
                 TrainConfig(checkpoint_dir=str(ckpt), log_dir=str(
                     tmp_path / "logs"), keep_checkpoints=2, log_every=4,
                     device="cpu"))
    got = tt.fit(lambda: list(train), lambda: list(val), n_epochs=2,
                 val_freq=1, eval_edit_distance=True)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-3)
    np.testing.assert_allclose(got["val_edit_distance"],
                               want["val_edit_distance"], rtol=0, atol=0.02)
    assert len(got["val_edit_distance"]) == 2
    assert tt.step == int(jt.state.step) == 12
    assert tt.best_epoch == int(np.argmin(got["val_loss"]))
    tt.close()
    # the JAX package's tags and steps in metrics.jsonl
    import json

    lines = [json.loads(x) for x in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    tags = [(x["tag"], x["step"]) for x in lines]
    assert tags[:3] == [("train/loss", 4), ("train/windows_per_s", 4),
                        ("train/epoch_loss", 0)]
    assert ("val/loss", 1) in tags and ("val/edit_distance", 1) in tags
    assert len(list((tmp_path / "logs").glob("events.out.tfevents.*"))) == 1

    # save and restore: params and optimizer state bit for bit, the JAX
    # package's resume epochs, keep-N rotation and the best-on-val copy
    tr = Trainer(_tiny(tdefault()),
                 TrainConfig(checkpoint_dir=str(tmp_path / "ck2"),
                             keep_checkpoints=2, device="cpu"))
    snaps = {}
    for epoch, vl in enumerate([2.0, 1.0, 3.0]):
        tr.train_epoch(train[epoch * 2: epoch * 2 + 2], epoch)
        snaps[epoch] = _state(tr)
        tr.save_checkpoint(epoch, val_loss=vl)
    assert tr.best_epoch == 1 and tr.best_val_loss == 1.0
    assert sorted(p.name for p in (tmp_path / "ck2").iterdir()) == [
        "1", "2", "best"]
    fresh = Trainer(_tiny(tdefault()),
                    TrainConfig(checkpoint_dir=str(tmp_path / "ck2"),
                                device="cpu"))
    assert fresh.restore_checkpoint() == 3
    _assert_state_equal(_state(fresh), snaps[2])
    assert fresh.restore_checkpoint(1) == 2
    _assert_state_equal(_state(fresh), snaps[1])
    assert fresh.restore_best_checkpoint() == 2
    _assert_state_equal(_state(fresh), snaps[1])
    # the restored state trains on exactly as the live one does
    fresh.restore_checkpoint()
    for t in (fresh, tr):
        t.train_step(t._put_batch(train[0]))
    _assert_state_equal(_state(fresh), _state(tr))
    empty = Trainer(_tiny(tdefault()),
                    TrainConfig(checkpoint_dir=str(tmp_path / "none"),
                                device="cpu"))
    assert empty.restore_checkpoint() == 0
    assert empty.restore_best_checkpoint() == 0


def test_pool_short_batch_and_learning_rate():
    import torch

    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    batches = _batches(8)
    short = {k: v[:3] for k, v in batches[2].items()}
    train = [batches[0], batches[1], short]
    val = [batches[6], {k: v[:2] for k, v in batches[7].items()}]

    cfg = _tiny(tdefault())

    def trainer(**kw):
        return Trainer(cfg, TrainConfig(checkpoint_dir=None, device="cpu",
                                        **kw))

    hists = {}
    for scan in (False, True):
        tr = trainer()
        hists[scan] = tr.fit(lambda: list(train), lambda: list(val),
                             n_epochs=2, val_freq=1, epoch_scan=scan)
    np.testing.assert_allclose(hists[True]["train_loss"],
                               hists[False]["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(hists[True]["val_loss"],
                               hists[False]["val_loss"], rtol=1e-6)

    # the pool's val loss weights batches by real rows, as evaluate (and
    # the JAX evaluate) does; the JAX evaluate_scan does not
    tr = trainer()
    pool = tr.preload_batches(val)
    assert pool["signal"].shape == (2, 8, 256)
    np.testing.assert_array_equal(pool["weight"].sum(1).numpy(), [8, 2])
    jt = JTrainer(_tiny(default_config()),
                  JTrainConfig(checkpoint_dir=None, mesh_data=1))
    want = jt.evaluate(val)
    np.testing.assert_allclose(tr.evaluate_scan(pool), want, rtol=1e-5)
    np.testing.assert_allclose(tr.evaluate(val), want, rtol=1e-5)
    unweighted = jt.evaluate_scan(jt.preload_batches(val))
    assert abs(unweighted - want) > 1e-3 * abs(want)

    # with steps_per_epoch the epochs cycle through the pool
    tr = trainer(steps_per_epoch=4)
    h = tr.fit(lambda: list(batches[:6]), None, n_epochs=3, epoch_scan=True)
    assert len(h["train_loss"]) == 3 and tr.step == 12
    assert all(np.isfinite(h["train_loss"]))

    # a new rate keeps the moments and takes effect
    tr = trainer()
    tr.train_epoch(batches[:2], epoch=0)
    before = {(s, k): v.clone() for s, b in tr.opt_state.slots.items()
              for k, v in b.items()}
    tr.update_learning_rate(1e-6)
    assert tr.tx.lr == 1e-6 and tr.opt_state.count == 2
    assert all(torch.equal(tr.opt_state.slots[s][k], v)
               for (s, k), v in before.items())
    p0 = {k: v.detach().clone() for k, v in tr.params.items()}
    tr.train_epoch(batches[2:3], epoch=1)
    delta = max(float((tr.params[k].detach() - v).abs().max())
                for k, v in p0.items())
    assert 0 < delta < 1e-4, delta
    # the trainer's copy of the config changed, not the caller's
    assert tr.config.train.opt.adam.lr == 1e-6
    assert cfg.train.opt.adam.lr == 0.003
