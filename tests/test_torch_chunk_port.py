"""The port's chunk-mode basecall against the JAX package's, on the CPU.

Both stacks basecall the same synthetic reads (900, 1,100, 2,500 and
4,000 samples, and one with MAD = 0) with the trained weights, in
float32, and must give identical strings on every chunk path: 'fused'
(the default), 'windows', and 'fullprobs' with the tiled crop on and
off.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np
import pytest

from radian_tpu import pipeline as jpipe
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"
KW = dict(decode_type="chunk", read_batch=3, bucket_quantum=1024)


def chunk_reads(seed: int = 11):
    """Synthetic reads of 900, 1,100, 2,500 and 4,000 samples, with a
    MAD-0 read of 1,500 samples third."""
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(seed)
    levels = kmer_level_table(rng)
    sigs = []
    for n in (900, 1100, 2500, 4000):
        sig, _ = synth_read(rng, n // 8 + 40, levels)
        sigs.append((sig[:n] * 60 + 500).astype(np.int16))
    sigs.insert(2, np.full(1500, 480, np.int16))
    return sigs


@pytest.fixture(scope="module")
def setup(one_cpu):  # noqa: F811  (runs after the wait)
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )

    return chunk_reads(), jload(TRAINED), params_from_flax(
        load_params_npz(TRAINED))


def _both(setup, **kw):
    from radian_tpu_torch import pipeline as tpipe

    sigs, jparams, params = setup
    want = jpipe.Basecaller(jparams, options=jpipe.BasecallOptions(
        decode_backend="xla", **KW, **kw)).basecall_signals(sigs)
    tbc = tpipe.Basecaller(params, options=tpipe.BasecallOptions(**KW, **kw),
                           device="cpu")
    return tbc, tbc.basecall_signals(sigs), want


def test_chunk_fused_and_windows_match_jax(setup):
    """'auto' (fused: full-read forward + zero-history heads) and
    'windows' (the forward over every window): exactly the JAX strings,
    and the same strings as each other; the MAD-0 read is skipped."""
    got = {}
    for prep in ("auto", "windows"):
        tbc, got[prep], want = _both(setup, chunk_prep=prep)
        assert tbc.path.use_chunk_fused is (prep == "auto")
        assert got[prep] == want, prep
    assert got["auto"] == got["windows"]
    assert got["auto"][2] is None
    # a one-window read assembles to "" (the reference's first-fragment
    # quirk); the others are real strings
    assert got["auto"][0] == "" and all(got["auto"][i] for i in (1, 3, 4))


def test_chunk_fullprobs_crop_on_and_off_match_jax(setup):
    """'fullprobs' with the tiled crop (concatenated spans) and without it
    (consensus stitch): exactly the JAX strings; the one-window read's
    tiled string is the port's global string."""
    from radian_tpu_torch import pipeline as tpipe

    sigs, _, params = setup
    for crop in (True, False):
        tbc, got, want = _both(setup, chunk_prep="fullprobs", chunk_crop=crop)
        assert tbc.path.chunk_tiled is crop
        assert (tbc.path.crop_off, tbc.path.crop_stride) == (
            (640, 2) if crop else (0, 1))
        assert got == want, crop
        assert got[2] is None
        if crop:
            glob = tpipe.Basecaller(params, options=tpipe.BasecallOptions(
                read_batch=3, bucket_quantum=1024), device="cpu")
            assert got[0] and got[0] == glob.basecall_signals(sigs[:1])[0]
