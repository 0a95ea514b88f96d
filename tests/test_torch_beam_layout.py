"""The kernel wrappers' backpointer layout, on the CPU.

The CUDA kernels keep a read's steps contiguous: ``[N, T, W]``
backpointers.  The wrappers' CPU path returns that same layout, while
the plain functions keep JAX's ``[T, W, N]`` at their own interface;
both forms must walk back to the labels the JAX package gives.  ``torch``
and the port are imported inside the test (see ``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.ops import beam_search as jbs
from tests.test_torch_beam import _jax, _mats
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_wrappers_cpu_path_use_kernel_layout():
    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops import beam_search as plain

    mats = _mats(4, 3, 70, 0.3, zero_frac=0.05)
    lengths = np.asarray([70, 33, 1], np.int32)
    ln = torch.from_numpy(lengths)
    logm = beam_cuda.log_probs(torch.from_numpy(mats))
    for w in (6, 16):
        bp, nlab, score = beam_cuda.beam_decode_cuda(logm, ln, w)
        assert bp.shape == (3, 70, w) and bp.dtype == torch.int8
        assert bp.is_contiguous()
        bp_tw, nlab_p, score_p = plain.beam_search_bp(logm.permute(1, 2, 0),
                                                      ln, w)
        assert torch.equal(bp, bp_tw.permute(2, 0, 1))
        assert torch.equal(nlab, nlab_p) and torch.equal(score, score_p)
        rev = beam_cuda.beam_backtrace_cuda(bp)
        assert torch.equal(rev, plain.backtrace_batch(bp_tw))
        rev_w, nlab_w, _ = _jax(mats, lengths, w)
        np.testing.assert_array_equal(rev.numpy(), rev_w)
        np.testing.assert_array_equal(
            np.asarray(jbs.backtrace_batch(bp_tw.numpy())).T, rev_w)
        np.testing.assert_array_equal(nlab.numpy(), nlab_w)
