"""The port's preprocessing and bucketing against the JAX package, on the CPU.

MAD normalisation is bit-exact (same float32 operation order); bucket
lengths are equal.  ``torch`` and the port are imported inside the tests
(see ``tests/torch_one_cpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from radian_tpu.ops.preprocess import bucket_length as j_bucket_length
from radian_tpu.ops.preprocess import mad_normalise as j_mad
from radian_tpu.ops.preprocess import mad_normalise_np as j_mad_np
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_mad_normalise_bit_exact():
    import torch

    from radian_tpu_torch.ops.preprocess import mad_normalise, mad_normalise_np

    rng = np.random.default_rng(4)
    n, length = 5, 700
    sigs = rng.integers(300, 700, (n, length)).astype(np.int16)
    lengths = np.asarray([700, 699, 350, 1, 500], np.int32)
    sigs[4, :500] = 512  # MAD = 0: the pipeline skips this read
    sigs[np.arange(length)[None, :] >= lengths[:, None]] = 0
    got_z, got_mad = mad_normalise(torch.from_numpy(sigs),
                                   torch.from_numpy(lengths), 4.0)
    for i in range(n):
        want_z, want_mad = j_mad(jnp.asarray(sigs[i]), lengths[i],
                                 outlier_clip=4.0)
        np.testing.assert_array_equal(got_z[i].numpy(), np.asarray(want_z))
        np.testing.assert_array_equal(got_mad[i].numpy(),
                                      np.asarray(want_mad))
    assert got_mad[4] == 0
    np.testing.assert_array_equal(mad_normalise_np(sigs[0], 4.0),
                                  j_mad_np(sigs[0], 4.0))
    with pytest.raises(ValueError, match="MAD is zero"):
        mad_normalise_np(sigs[4, :500], 4.0)


def test_bucket_ladder_batches():
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.ops.preprocess import bucket_length

    for n in (1, 1023, 1024, 1025, 9000):
        assert bucket_length(n, 1024) == j_bucket_length(n, 1024)
    bc = tpipe.load_basecaller(options=tpipe.BasecallOptions(
        read_batch=2, bucket_quantum=1024, bucket_lengths=(2048, 1024)),
        device="cpu")
    sigs = [np.zeros(n, np.int16) for n in (3000, 900, 2000, 1000, 1500)]
    # length-sorted, one bucket a batch, at most read_batch reads; above
    # the ladder's top entry lengths round up to the quantum
    assert bc.batches(sigs) == [([1, 3], 1024), ([4, 2], 2048), ([0], 3072)]
