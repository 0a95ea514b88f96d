"""The port's global strips/windows/'mean' paths against the JAX package's.

Both stacks basecall the same synthetic reads (1,300, 1,700 and 1,990
samples, and one with MAD = 0) with the trained weights in float32, and
must give identical strings for ``prep_mode`` 'strips' and 'windows',
``assembly_mode`` 'mean' and the fallback geometry ``step_size=96``
(the windowed forward), the strips on a bucket ladder entry that is not
a multiple of the step (their matrix is ``bucket // step · step`` rows
long), and 'mean' with the bench-style LM.  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np
import pytest

from radian_tpu import pipeline as jpipe
from radian_tpu.lm import kmer as jk
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"
KW = dict(read_batch=4, bucket_quantum=2048)


@pytest.fixture(scope="module")
def setup(one_cpu):  # noqa: F811  (runs after the wait)
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(21)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n // 8 + 40, levels)[0][:n] * 60 + 500
             ).astype(np.int16) for n in (1300, 1700, 1990)]
    sigs.insert(1, np.full(1500, 480, np.int16))  # MAD = 0: skipped
    return sigs, jload(TRAINED), params_from_flax(load_params_npz(TRAINED))


def _both(setup, lm=None, **kw):
    from radian_tpu_torch import pipeline as tpipe

    sigs, jparams, params = setup
    want = jpipe.Basecaller(jparams, lm=None if lm is None else lm[0],
                            options=jpipe.BasecallOptions(
                                decode_backend="xla", **KW, **kw)
                            ).basecall_signals(sigs)
    tbc = tpipe.Basecaller(params, lm=None if lm is None else lm[1],
                           options=tpipe.BasecallOptions(**KW, **kw),
                           device="cpu")
    got = tbc.basecall_signals(sigs)
    assert got[1] is None and all(got[i] for i in (0, 2, 3))
    return tbc, got, want


def test_strips_windows_mean_and_fallback_match_jax(setup):
    """Every global path gives the JAX strings; the constructor picks the
    JAX package's forward; the strips matrix of a 2,000-sample ladder
    bucket is 1,920 rows.  The strips forward equals the full-read one
    from row RF-1 on; before it the strips' zero samples pass through the
    biases, unlike the causal padding, as in the JAX package."""
    import torch

    from radian_tpu_torch import pipeline as tpipe

    sigs, _, params = setup
    paths = {}
    for name, kw, fast in (
            ("strips", dict(prep_mode="strips", bucket_lengths=(2000,)),
             "strips"),
            ("windows", dict(prep_mode="windows"), None),
            ("mean", dict(assembly_mode="mean"), None),
            ("step96", dict(step_size=96), None)):
        tbc, got, want = _both(setup, **kw)
        assert got == want, name
        assert (tbc.path.use_strips, tbc.path.use_fullread) == (
            fast == "strips", False)
        paths[name] = (tbc, got)
    assert paths["windows"][1] != paths["mean"][1]
    tbc = paths["strips"][0]
    sig, ln = tbc.pad_batch([0, 2, 3], 2000, sigs)
    mats, t_reads, _ = tbc.forward(sig, ln)
    assert mats.shape[1] == 1920 and int(t_reads.max()) == 1990
    with pytest.raises(ValueError, match="prep_mode='strips' requires"):
        tpipe.Basecaller(params, options=tpipe.BasecallOptions(
            prep_mode="strips", assembly_mode="mean"), device="cpu")

    full = tpipe.Basecaller(params, options=tpipe.BasecallOptions(**KW),
                            device="cpu")
    sig, ln = full.pad_batch([0, 2, 3], 2048, sigs)
    want, _, _ = full.forward(sig, ln)
    rf = full.model.receptive_field
    for name in ("strips", "windows"):
        got, t_got, _ = paths[name][0].forward(sig, ln)
        dp = (got - want).abs()
        assert t_got[:3].tolist() == [1300, 1700, 1990]
        assert dp[:, rf - 1:].max() <= 1e-5, name  # float order only
        assert bool(dp[:, :rf - 1].max() > 1e-3) is (name == "strips"), name
        assert torch.isfinite(got).all()


def test_mean_with_bench_lm_matches_jax(setup):
    """'mean' assembly decoded with the bench-style LM (ctx 11, 200,000
    contexts, concentration 0.2) through the LM-fused decoder."""
    from radian_tpu_torch.lm import kmer as tk

    model = tk.random_kmer_model(np.random.default_rng(42), 11, 200_000, 0.2)
    lm = (jk.build_dense_tables(model, 11), tk.build_dense_tables(model, 11))
    tbc, got, want = _both(setup, lm=lm, assembly_mode="mean")
    assert tbc.lm_fusion is not None and not tbc.path.use_fullread
    assert got == want
