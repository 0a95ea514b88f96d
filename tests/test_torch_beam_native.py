"""The port's host C++ decoder (``ops/beam_native.py`` over
``csrc/beamsearch.cc``, built by ``_build.py`` with ``-fopenmp``) gives
the JAX ``beam_search_batch``'s strings, with and without the k-mer LM,
on seeded matrices with variable lengths (0, 1, short and full), and
the JAX package's own C++ decoder's labels, counts and scores bit for
bit.  A failed build of it raises.  The port is imported inside the
tests (see ``tests/torch_one_cpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from radian_tpu.lm import build_dense_tables, random_kmer_model
from radian_tpu.ops.beam_native import beam_search_native as jnative
from radian_tpu.ops.beam_search import beam_search_batch, labels_to_seq
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _cases():
    rng = np.random.default_rng(17)
    n, t = 12, 160
    for conc in (1.0, 0.3):
        mats = rng.dirichlet(np.full(5, conc), size=(n, t)).astype(np.float32)
        lengths = rng.integers(2, t + 1, n).astype(np.int32)
        lengths[:3] = (t, 1, 0)
        yield mats, lengths


def test_native_matches_jax_scan_and_jax_native():
    from radian_tpu_torch.ops.beam_native import beam_search_native, native_seq

    rng = np.random.default_rng(3)
    lm = build_dense_tables(random_kmer_model(rng, context_len=3,
                                              concentration=0.3), 3)
    for mats, lengths in _cases():
        for w, use_lm in ((1, False), (6, False), (16, False), (6, True)):
            kw = dict(lm=lm, s_threshold=0.3, r_threshold=1.0,
                      ctx_len=3) if use_lm else {}
            rev, n_lab, scores = beam_search_native(mats, lengths, w, **kw)
            # the JAX package's C++ decoder: the same labels and scores
            j_rev, j_n, j_scores = jnative(mats, lengths, w, **kw)
            np.testing.assert_array_equal(rev, j_rev)
            np.testing.assert_array_equal(n_lab, j_n)
            np.testing.assert_array_equal(scores, j_scores)
            # the JAX scan: the same strings
            jkw = dict(lm_enabled=True, lm_probs=jnp.asarray(lm.probs),
                       lm_ent=jnp.asarray(lm.entropy), s_threshold=0.3,
                       r_threshold=1.0, ctx_len=3) if use_lm else {}
            s_rev, s_n, _ = beam_search_batch(
                jnp.asarray(mats), jnp.asarray(lengths), beam_width=w, **jkw)
            s_rev = np.asarray(s_rev)
            want = [labels_to_seq(s_rev[i]) for i in range(len(mats))]
            got = [native_seq(rev[i], int(n_lab[i])) for i in range(len(mats))]
            assert got == want, (w, use_lm)
            np.testing.assert_array_equal(n_lab, np.asarray(s_n))
            assert got[2] == "" and n_lab[2] == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    from radian_tpu_torch import _build
    from radian_tpu_torch.ops.beam_native import beam_search_native

    assert "-fopenmp" in _build._flags(_build._source("beamsearch"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "GXX_EXTRA_FLAGS",
                        {"beamsearch": ["-fopenmp", "--no-such-option"]})
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="beamsearch.cc"):
        beam_search_native(np.full((1, 4, 5), 0.2, np.float32), [4])
