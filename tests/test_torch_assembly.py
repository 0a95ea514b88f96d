"""The port's batched matrix assembly against the JAX package's.

``assemble_matrices`` stitches a batch of per-window matrices in both
modes; the JAX function assembles one read (vmapped here), and
``assemble_matrices_np`` is the reference-shaped host version.  Inputs
are seeded Dirichlet(0.3) rows with a few exact-zero rows (the
renormalisation's ``sum > 0`` guard), over the default geometry and the
fallback one (step 96, which does not divide the window).  'first' is
exact; 'mean' sums the same float32 values in the same order, so it is
exact too.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from radian_tpu.ops import assembly as jasm
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _batch(rng, n_wins, window, step, max_w):
    """Window matrices ``[N, max_w, window, 5]`` and each read's
    ``pad_end`` for tails of seeded lengths."""
    mats = rng.dirichlet(np.full(5, 0.3), (len(n_wins), max_w, window))
    mats = mats.astype(np.float32)
    mats[:, :, ::97] = 0.0  # exact-zero rows
    # the reference's accounting: a read of more than one window has a
    # tail window of window - step + r samples, 0 <= r < step
    n_wins = np.asarray(n_wins, np.int32)
    pad_end = np.where(n_wins == 1, rng.integers(1, window, len(n_wins)),
                       rng.integers(1, step + 1, len(n_wins)))
    return mats, n_wins, pad_end.astype(np.int32)


def test_assemble_matrices_matches_jax():
    import torch

    from radian_tpu_torch.ops.assembly import assemble_matrices

    rng = np.random.default_rng(0)
    for window, step in ((256, 32), (256, 96)):
        n_wins = [1, 2, 5, 9]
        max_w = max(n_wins)
        out_len = (max_w - 1) * step + window
        mats, nw, pe = _batch(rng, n_wins, window, step, max_w)
        for mode in ("first", "mean"):
            want, t_want = jax.vmap(lambda m, a, b: jasm.assemble_matrices(
                m, a, b, step=step, window=window, out_len=out_len,
                mode=mode))(jnp.asarray(mats), jnp.asarray(nw),
                            jnp.asarray(pe))
            got, t_got = assemble_matrices(
                torch.from_numpy(mats), torch.from_numpy(nw),
                torch.from_numpy(pe), step=step, window=window,
                out_len=out_len, mode=mode)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_want))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{mode} step {step}")


def test_assemble_matrices_matches_host_reference():
    """Each read's rows up to its length against ``assemble_matrices_np``
    (the port's copy, and the JAX package's) on its trimmed window list:
    'first' exactly, 'mean' within 1e-6 (float64 sums there)."""
    import torch

    from radian_tpu_torch.ops.assembly import (
        assemble_matrices,
        assemble_matrices_np,
    )

    rng = np.random.default_rng(1)
    window, step = 128, 32
    n_wins = [1, 3, 6]
    mats, nw, pe = _batch(rng, n_wins, window, step, 6)
    out_len = 5 * step + window
    for mode in ("first", "mean"):
        got, t_read = assemble_matrices(
            torch.from_numpy(mats), torch.from_numpy(nw),
            torch.from_numpy(pe), step=step, window=window, out_len=out_len,
            mode=mode)
        for i, w in enumerate(n_wins):
            wins = [mats[i, k] for k in range(w)]
            wins[-1] = wins[-1][:window - pe[i]]
            want = assemble_matrices_np(wins, step, mode)
            np.testing.assert_array_equal(
                want, jasm.assemble_matrices_np(wins, step, mode))
            t = int(t_read[i])
            assert t == want.shape[0]
            assert not got[i, t:].any()
            if mode == "first":
                np.testing.assert_array_equal(got[i, :t].numpy(), want)
            else:
                np.testing.assert_allclose(got[i, :t].numpy(), want,
                                           rtol=0, atol=1e-6)
