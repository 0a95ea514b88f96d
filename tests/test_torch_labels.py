"""The port's backtrace and label helpers against the JAX decoder's.

Both get the same numpy backpointers and label rows and must give
identical arrays and strings.  ``torch`` and the port are imported inside
the tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from radian_tpu.ops import beam_search as jbs
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_backtrace_matches_jax():
    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops.beam_search import backtrace_batch

    rng = np.random.default_rng(11)
    for t, w, n in ((50, 6, 3), (70, 16, 2), (33, 1, 2)):
        bp = (rng.integers(0, w, (t, w, n)) * 8
              + rng.integers(0, 5, (t, w, n))).astype(np.int8)
        want = np.asarray(jbs.backtrace_batch(bp)).T
        got = backtrace_batch(torch.from_numpy(bp)).numpy()
        np.testing.assert_array_equal(got, want)
        # the wrapper takes the kernel's [N, T, W] layout
        got_w = beam_cuda.beam_backtrace_cuda(torch.from_numpy(
            np.ascontiguousarray(bp.transpose(2, 0, 1)))).numpy()
        np.testing.assert_array_equal(got_w, want)


def test_label_packing_and_rendering_match_jax():
    import torch

    from radian_tpu_torch.ops import beam_search as tbs

    rng = np.random.default_rng(5)
    rev = rng.integers(-1, 4, (3, 64)).astype(np.int32)
    packed = tbs.pack_labels(torch.from_numpy(rev)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jbs.pack_labels(rev)))
    np.testing.assert_array_equal(tbs.unpack_labels(packed),
                                  jbs.unpack_labels(packed))
    for reverse in (False, True):
        assert [tbs.labels_to_seq(r, reverse) for r in rev] == \
            [jbs.labels_to_seq(r, reverse) for r in rev]
        assert tbs.rows_to_seqs(rev, reverse) == jbs.rows_to_seqs(rev, reverse)
    with pytest.raises(ValueError, match="even"):
        tbs.pack_labels(torch.zeros((2, 3), dtype=torch.int32))
