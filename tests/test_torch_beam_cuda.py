"""The CUDA beam-search wrappers on the CPU.

A wrapper given CPU tensors runs the plain PyTorch version; anything else
reaches its kernel or raises.  The kernels themselves run only on the
card: ``chip_smoke.py`` holds them against the plain version there.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from tests.test_torch_beam import _assert_same, _jax, _mats, _plain, _torch
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_wrapper_on_cpu_takes_plain_path():
    from radian_tpu_torch.ops import beam_cuda

    mats = _mats(3, 4, 96, 0.5, zero_frac=0.05)
    lengths = np.asarray([96, 50, 95, 3], np.int32)
    before = (beam_cuda.beam_decode_cuda.launches,
              beam_cuda.beam_backtrace_cuda.launches)
    got = _torch(beam_cuda.beam_search_cuda, mats, lengths, 6)
    assert (beam_cuda.beam_decode_cuda.launches,
            beam_cuda.beam_backtrace_cuda.launches) == before
    _assert_same(got, _plain(mats, lengths, 6))
    _assert_same(got, _jax(mats, lengths, 6))


def test_wrapper_raises_instead_of_falling_back():
    """Only a CPU tensor takes the plain path: anything else must reach
    the kernel or raise (here a meta tensor stands in for a non-CPU one),
    and beams wider than the kernels' 16 are refused."""
    import torch

    from radian_tpu_torch.ops import beam_cuda

    mats = torch.rand(2, 8, 5)
    lengths = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="beam_width 17"):
        beam_cuda.beam_search_cuda(mats, lengths, 17)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        beam_cuda.beam_search_cuda(mats.to("meta"), lengths.to("meta"), 6)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        beam_cuda.beam_backtrace_cuda(
            torch.zeros((2, 8, 6), dtype=torch.int8, device="meta"))
