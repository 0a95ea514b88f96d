"""The port's CTC loss against the JAX package's ``ctc_loss``.

On padded batches with repeated labels and ragged input and label
lengths, the path (``F.ctc_loss``) and the plain version (the JAX
recursion in torch) give the JAX losses (rtol 1e-5, atol 1e-4), and the
path's gradient through ``log_softmax`` of shared logits gives
``jax.grad``'s (rtol 1e-4 of the largest entry).  ``F.ctc_loss``'s
backward is the gradient with respect to the logits, so gradients are
compared there, never with respect to ``log_probs``.  An infeasible row
is finite and above 1e5 with a finite gradient, and a zero weight on it
leaves a finite mean.  ``torch`` and the port are imported inside the
tests (see ``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from radian_tpu.ops.ctc import ctc_loss as jctc
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _batch(rng, b=7, t=60, u=12):
    logits = rng.normal(size=(b, t, 5)).astype(np.float32) * 2
    labels = rng.integers(0, 4, size=(b, u)).astype(np.int32)
    labels[0, :6] = [1, 1, 1, 2, 2, 3]  # repeats need blanks between
    lab_lens = rng.integers(1, u + 1, size=b).astype(np.int32)
    lab_lens[0] = 6
    lab_lens[1] = u
    labels[2] = labels[2, 0]  # one label throughout
    in_lens = rng.integers(3 * u, t + 1, size=b).astype(np.int32)
    in_lens[1] = t
    return logits, in_lens, labels, lab_lens


def test_ctc_loss_and_gradients_equal_jax():
    import torch

    from radian_tpu_torch.ops import ctc as tctc

    for seed in (0, 1):
        logits, in_lens, labels, lab_lens = _batch(np.random.default_rng(seed))
        args = [jnp.asarray(x) for x in (in_lens, labels, lab_lens)]
        lp = np.array(jax.nn.log_softmax(logits, -1))
        want = np.asarray(jctc(jnp.asarray(lp), *args))
        targs = [torch.from_numpy(x) for x in (in_lens, labels, lab_lens)]
        got = tctc.ctc_loss(torch.from_numpy(lp), *targs).numpy()
        plain = tctc.ctc_loss_reference(torch.from_numpy(lp), *targs).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-4)
        mean = float(tctc.ctc_loss_mean(torch.from_numpy(lp), *targs))
        np.testing.assert_allclose(mean, want.mean(), rtol=1e-5)
        # bfloat16 log-probs run the loss in float32
        half = torch.from_numpy(lp).bfloat16()
        np.testing.assert_allclose(
            tctc.ctc_loss(half, *targs).numpy(),
            tctc.ctc_loss(half.float(), *targs).numpy(), rtol=0, atol=0)

        w = np.linspace(0.5, 1.5, len(in_lens)).astype(np.float32)
        g_want = np.asarray(jax.grad(lambda x: (jctc(
            jax.nn.log_softmax(x, -1), *args) * w).sum())(
                jnp.asarray(logits)))
        for fn in (tctc.ctc_loss, tctc.ctc_loss_reference):
            x = torch.tensor(logits, requires_grad=True)
            (fn(torch.log_softmax(x, -1), *targs)
             * torch.from_numpy(w)).sum().backward()
            np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=0,
                                       atol=1e-4 * np.abs(g_want).max())


def test_infeasible_row_is_finite():
    import torch

    from radian_tpu_torch.ops import ctc as tctc

    logits, in_lens, labels, lab_lens = _batch(np.random.default_rng(2),
                                               b=4, t=20, u=6)
    labels[3] = [0, 0, 0, 1, 1, 2]
    lab_lens[3], in_lens[3] = 6, 8  # needs 6 labels + 3 blanks = 9 frames
    lab_lens[2], in_lens[2] = 3, 3  # exactly feasible
    labels[2, :3] = [0, 1, 2]
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    args = [jnp.asarray(x) for x in (in_lens, labels, lab_lens)]
    want = np.asarray(jctc(lp, *args))
    assert want[3] > 1e5 and np.isfinite(want).all()
    targs = [torch.from_numpy(x) for x in (in_lens, labels, lab_lens)]
    np.testing.assert_array_equal(
        tctc.min_frames(targs[1].long(), targs[2].long()).numpy(),
        [lab_lens[0] + np.sum(labels[0, 1:lab_lens[0]]
                               == labels[0, :lab_lens[0] - 1]),
         lab_lens[1] + np.sum(labels[1, 1:lab_lens[1]]
                               == labels[1, :lab_lens[1] - 1]), 3, 9])
    for fn in (tctc.ctc_loss, tctc.ctc_loss_reference):
        x = torch.tensor(logits, requires_grad=True)
        losses = fn(torch.log_softmax(x, -1), *targs)
        assert torch.isfinite(losses).all() and losses[3] > 1e5, fn
        np.testing.assert_allclose(losses[:3].detach().numpy(), want[:3],
                                   rtol=1e-5, atol=1e-4)
        # the trainer's weighting: a zero weight on the row gives a finite
        # mean and finite gradients (inf * 0 would be NaN)
        w = torch.tensor([1.0, 1.0, 1.0, 0.0])
        loss = (losses * w).sum() / w.sum()
        loss.backward()
        assert torch.isfinite(loss) and torch.isfinite(x.grad).all(), fn
        np.testing.assert_allclose(float(loss.detach()), want[:3].mean(),
                                   rtol=1e-5)
