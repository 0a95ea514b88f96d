"""Beams wider than 8, up to the port's ceiling of 16, against the JAX package.

The JAX ``beam_search_batch(lm_enabled=False)`` scan and its
``Basecaller(decode_backend="xla")`` decode any width; the port holds
up to 16 (the reference's int8 backpointers overflow from 17 on).  Both
stacks get the same numpy inputs; strings, label rows and ``n_labels``
must be identical, scores agree to ``rtol 1e-6, atol 1e-5`` (see
``tests/test_torch_beam.py``).  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np

from radian_tpu import pipeline as jpipe
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.test_torch_beam import _assert_same, _jax, _mats, _plain
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_plain_decoder_matches_jax_at_beams_12_and_16():
    """Peaked (alpha 0.2) and flat (alpha 1.0) matrices, both with exact
    zeros, variable lengths down to 1 and 0."""
    n, t = 4, 120
    lengths = np.asarray([t, 61, 1, 0], np.int32)
    for beam_width in (12, 16):
        for alpha in (0.2, 1.0):
            mats = _mats(beam_width * 10 + int(alpha * 10), n, t, alpha,
                         zero_frac=0.05)
            assert (mats == 0).any()
            _assert_same(_plain(mats, lengths, beam_width),
                         _jax(mats, lengths, beam_width))


def test_basecaller_beam_16_matches_jax_on_trained_weights():
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(21)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n_bases, levels)[0] * 60 + 500).astype(np.int16)
            for n_bases in (150, 140)]
    jbc = jpipe.Basecaller(jload(TRAINED), options=jpipe.BasecallOptions(
        decode_backend="xla", beam_width=16, read_batch=2,
        bucket_quantum=1024))
    want = jbc.basecall_signals(sigs)
    tbc = tpipe.load_basecaller(TRAINED, options=tpipe.BasecallOptions(
        beam_width=16, read_batch=2, bucket_quantum=1024), device="cpu")
    got = tbc.basecall_signals(sigs)
    assert all(want)
    assert got == want
