"""The port's k-mer LM tables (radian_tpu_torch.lm) against the JAX package's.

Both modules are numpy only: the same model dicts must give the same
arrays bit for bit, and the same seeded generator the same dict.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import json

import numpy as np

from radian_tpu.lm import kmer as jk
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _assert_lm_equal(got, want):
    assert got.context_len == want.context_len
    for name in ("probs", "entropy", "real_mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_tables_compression_and_json_match_jax(tmp_path):
    """Dense tables, ``compressed()`` with and without ``real_mask`` and
    the JSON loader, at ctx 3 (every context real) and ctx 5 (sparse,
    with an exact-zero probability and an all-zero row)."""
    from radian_tpu_torch.lm import kmer as tk

    for ctx, n_ctx in ((3, None), (5, 300)):
        model = jk.random_kmer_model(np.random.default_rng(ctx), ctx, n_ctx,
                                     0.2)
        first = next(iter(model))
        model[first] = [0.0, 0.7, 0.3, 0.0]
        if n_ctx:
            model[next(k for k in model if k != first)] = [0.0] * 4
        want = jk.build_dense_tables(model, ctx)
        got = tk.build_dense_tables(model, ctx)
        _assert_lm_equal(got, want)
        for real_mask in (want.real_mask, None):
            j = jk.KmerLM(ctx, want.probs, want.entropy, real_mask)
            t = tk.KmerLM(ctx, got.probs, got.entropy, real_mask)
            for g, w in zip(t.compressed(), j.compressed()):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        path = tmp_path / f"lm{ctx}.json"
        path.write_text(json.dumps(
            {"".join("ACGT"[b] for b in k): v for k, v in model.items()}))
        _assert_lm_equal(tk.load_kmer_json(path, ctx),
                         jk.load_kmer_json(path, ctx))
        assert tk.pack_context("GT" + "A" * (ctx - 2)) == jk.pack_context(
            "GT" + "A" * (ctx - 2))


def test_random_kmer_model_draws_as_jax():
    """Same generator state → same dict, including the bench's LM
    (rng 42, ctx 11, 200,000 contexts, concentration 0.2), whose dense
    tables are then equal too."""
    from radian_tpu_torch.lm import kmer as tk

    for ctx, n_ctx, conc in ((3, None, 0.3), (11, 200_000, 0.2)):
        got = tk.random_kmer_model(np.random.default_rng(42), ctx, n_ctx,
                                   conc)
        want = jk.random_kmer_model(np.random.default_rng(42), ctx, n_ctx,
                                    conc)
        assert got == want
    _assert_lm_equal(tk.build_dense_tables(got, 11),
                     jk.build_dense_tables(want, 11))
