"""The LM-fused CUDA decode wrappers on the CPU.

A wrapper given CPU tensors runs the plain PyTorch version; anything else
reaches its kernel or raises.  The kernel itself runs only on the card:
``chip_smoke.py`` holds it against the plain version there.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from radian_tpu.lm import kmer as jk
from radian_tpu.ops import beam_search as jbs
from tests.test_torch_beam import _mats
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _lm(packed, dtype):
    import torch

    from radian_tpu_torch.ops.beam_search import LMFusion

    lm = jk.build_dense_tables(jk.random_kmer_model(
        np.random.default_rng(2), 3, 40, 0.2), 3)
    t1, t2 = lm.compressed() if packed else (lm.probs, lm.entropy)
    t2 = torch.from_numpy(t2).to(dtype)
    t1 = torch.from_numpy(t1) if packed else torch.from_numpy(t1).to(dtype)
    return lm, LMFusion(t1, t2, packed, 3, 0.5, 0.5)


def test_lm_wrapper_on_cpu_takes_plain_path():
    """CPU tensors: no launch, the plain decoder's results in the
    kernel's layouts, equal to JAX's LM decode."""
    import torch

    from radian_tpu_torch.ops import beam_cuda

    mats = _mats(5, 3, 80, 0.3, zero_frac=0.02)
    lengths = np.asarray([80, 41, 1], np.int32)
    for packed in (False, True):
        lm, fusion = _lm(packed, torch.float32)
        before = (beam_cuda.beam_decode_lm_cuda.launches,
                  beam_cuda.beam_backtrace_cuda.launches)
        rev, nlab, score = beam_cuda.beam_search_lm_cuda(
            torch.from_numpy(mats), torch.from_numpy(lengths), 6, fusion)
        assert (beam_cuda.beam_decode_lm_cuda.launches,
                beam_cuda.beam_backtrace_cuda.launches) == before
        bp, _, _ = beam_cuda.beam_decode_lm_cuda(
            torch.from_numpy(mats), torch.from_numpy(lengths), 6, fusion)
        assert bp.shape == (3, 80, 6) and bp.dtype == torch.int8
        want = jbs.beam_search_batch(
            mats, lengths, beam_width=6, lm_probs=lm.probs, lm_ent=lm.entropy,
            s_threshold=0.5, r_threshold=0.5, ctx_len=3, lm_enabled=True)
        np.testing.assert_array_equal(rev.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(nlab.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(score.numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-5)


def test_lm_wrapper_raises_instead_of_falling_back():
    """Only a CPU tensor takes the plain path: anything else must reach
    the kernel or raise (a meta tensor stands in for a non-CPU one);
    beams wider than 16 are refused, and so are tables the kernel cannot
    read."""
    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops.beam_search import LMFusion

    _, fusion = _lm(False, torch.float32)
    mats = torch.rand(2, 8, 5)
    lengths = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="beam_width 17"):
        beam_cuda.beam_search_lm_cuda(mats, lengths, 17, fusion)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        beam_cuda.beam_decode_lm_cuda(mats.to("meta"), lengths.to("meta"),
                                      6, fusion)
    cpu = torch.device("cpu")
    for packed, dtype, kind in ((False, torch.float32, 0),
                                (False, torch.bfloat16, 1),
                                (True, torch.float32, 2),
                                (True, torch.bfloat16, 3)):
        assert beam_cuda._table_kind(_lm(packed, dtype)[1], cpu) == kind
    bad = (fusion._replace(t2=fusion.t2.double()),  # float64 entropy
           fusion._replace(t1=fusion.t1[:16]),  # fewer rows than 4^ctx
           fusion._replace(ctx_len=16),  # contexts beyond 32 bits
           _lm(True, torch.float32)[1]._replace(t1=torch.zeros(2, 3)))
    for lm in bad:
        with pytest.raises(ValueError):
            beam_cuda._table_kind(lm, cpu)
    # contiguous views whose start breaks the kernel's vector loads: dense
    # probs one value in (cp.async of a row), packed l1 one int32 in (int2)
    for packed, dtype in ((False, torch.float32), (False, torch.bfloat16),
                          (True, torch.float32)):
        lm = _lm(packed, dtype)[1]
        buf = torch.cat([lm.t1.flatten()[:1], lm.t1.flatten()])
        shifted = lm._replace(t1=buf[1:].view(lm.t1.shape))
        assert shifted.t1.is_contiguous() and torch.equal(shifted.t1, lm.t1)
        with pytest.raises(ValueError, match="aligned"):
            beam_cuda._table_kind(shifted, cpu)
        whole = buf.new_empty(buf.numel() + 7)[8:].view(lm.t1.shape)
        assert beam_cuda._table_kind(lm._replace(t1=whole), cpu) is not None
