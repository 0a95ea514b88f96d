"""The port's plain beam search vs the JAX decoder.

The JAX ``beam_search_batch(lm_enabled=False)`` is the yardstick (its own
Pallas kernel is tested against it).  Both stacks get the same numpy
matrices.  Strings, label rows and ``n_labels`` must be identical; scores
agree to ``rtol 1e-6, atol 1e-5``: torch's and XLA's CPU ``exp``/``log1p``
differ in the last bit, and a score sums hundreds of such terms.

``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.ops import beam_search as jbs
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _mats(seed, n, t, alpha, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    mats = rng.dirichlet(np.full(5, alpha), size=(n, t)).astype(np.float32)
    if zero_frac:
        mats[rng.random((n, t, 5)) < zero_frac] = 0.0
    return mats


def _jax(mats, lengths, w):
    out = jbs.beam_search_batch(mats, lengths, beam_width=w,
                                lm_enabled=False)
    return [np.asarray(a) for a in out]


def _torch(fn, mats, lengths, w):
    import torch

    out = fn(torch.from_numpy(mats), torch.from_numpy(lengths), w)
    return [a.numpy() for a in out]


def _plain(mats, lengths, w):
    from radian_tpu_torch.ops.beam_search import beam_search_batch

    return _torch(beam_search_batch, mats, lengths, w)


def _assert_same(got, want):
    from radian_tpu_torch.ops.beam_search import rows_to_seqs

    rev_g, nlab_g, score_g = got
    rev_w, nlab_w, score_w = want
    assert rev_g.shape == rev_w.shape
    np.testing.assert_array_equal(rev_g, rev_w)
    np.testing.assert_array_equal(nlab_g, nlab_w)
    np.testing.assert_allclose(score_g, score_w, rtol=1e-6, atol=1e-5)
    assert rows_to_seqs(rev_g) == jbs.rows_to_seqs(rev_w)


def test_plain_decoder_matches_jax():
    """Beam widths 1, 2, 6, 8 and 9 on peaked (alpha 0.2) and flat
    (alpha 1.0) matrices, variable lengths down to 1 and 0."""
    n, t = 5, 160
    lengths = np.asarray([t, t - 1, 77, 1, 0], np.int32)
    for beam_width in (1, 2, 6, 8, 9):
        for alpha in (0.2, 1.0):
            mats = _mats(beam_width * 10 + int(alpha * 10), n, t, alpha)
            _assert_same(_plain(mats, lengths, beam_width),
                         _jax(mats, lengths, beam_width))


def test_plain_decoder_exact_zero_probabilities():
    """log(0) = -inf scores: the scan floors them at SCORE_FLOOR and its
    logaddexp takes the NaN branch; the port must do the same."""
    mats = _mats(7, 2, 40, 0.3, zero_frac=0.25)
    lengths = np.asarray([40, 40], np.int32)
    assert (mats == 0).any()
    for beam_width in (1, 6, 8):
        _assert_same(_plain(mats, lengths, beam_width),
                     _jax(mats, lengths, beam_width))
