"""The port's plain LM-fused beam search against the JAX decoder.

``beam_search_batch(lm_enabled=True)`` of both packages gets the same
numpy matrices and the same LM tables (dense at ctx 1, 3 and 11; packed
at ctx 12, where l1 is 4 MB), in float32 and bfloat16.  Labels and
``n_labels`` must be identical and scores within 1e-5 absolute (torch's
and XLA's CPU ``log``/``exp``/``log1p`` may differ in the last bit;
measured differences stay below 4e-6 at these lengths).  The LM must
change some strings against the no-LM decode, so the fusion is seen to
fire.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.lm import kmer as jk
from radian_tpu.ops import beam_search as jbs
from tests.test_torch_beam import _mats
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

LENGTHS = np.asarray([100, 57, 1, 99], np.int32)


def _decode_both(mats, w, ctx, thr, tables, packed, bf16):
    """Decode with both packages; returns (JAX no-LM labels, JAX LM labels)
    after asserting the port equals JAX."""
    import jax.numpy as jnp
    import torch

    from radian_tpu_torch.ops.beam_search import beam_search_batch

    names = ("lm_l1", "lm_vals") if packed else ("lm_probs", "lm_ent")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    # packed l1 is int32 in any table dtype
    jkw = {n: jnp.asarray(t) if t.dtype == np.int32 else
           jnp.asarray(t).astype(jdt) for n, t in zip(names, tables)}
    tkw = {n: torch.from_numpy(t) if t.dtype == np.int32 else
           torch.from_numpy(t).to(tdt) for n, t in zip(names, tables)}
    kw = dict(s_threshold=thr[0], r_threshold=thr[1], ctx_len=ctx,
              lm_enabled=True)
    want = [np.asarray(a) for a in jbs.beam_search_batch(
        mats, LENGTHS, beam_width=w, **kw, **jkw)]
    got = [a.numpy() for a in beam_search_batch(
        torch.from_numpy(mats), torch.from_numpy(LENGTHS), w, **kw, **tkw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    nolm = np.asarray(jbs.beam_search_batch(mats, LENGTHS, beam_width=w,
                                            lm_enabled=False)[0])
    return nolm, want[0]


def test_dense_lm_decoder_matches_jax():
    """ctx 1 and 3 (every context real) and ctx 11 (4,194,304 rows, all
    real), W 6 and 16, thresholds (0.5, 0.5) and (0.0, 10.0), float32 and
    bfloat16 tables, and one case with exact-zero probabilities."""
    rng = np.random.default_rng(11)
    probs11 = rng.dirichlet(np.full(4, 0.2), 4 ** 11)
    ent11 = jk._entropy_rows(probs11)
    changed = 0
    for ctx, w, thr, bf16, zero in ((1, 6, (0.5, 0.5), False, 0.0),
                                    (3, 16, (0.0, 10.0), True, 0.0),
                                    (3, 6, (0.5, 0.5), False, 0.05),
                                    (11, 6, (0.5, 0.5), False, 0.0),
                                    (11, 16, (0.0, 10.0), True, 0.0)):
        if ctx == 11:
            tables = (probs11.astype(np.float32), ent11)
        else:
            lm = jk.build_dense_tables(jk.random_kmer_model(
                np.random.default_rng(ctx), ctx, None, 0.2), ctx)
            tables = (lm.probs, lm.entropy)
        mats = _mats(100 * ctx + w, 4, 100, 0.3, zero_frac=zero)
        assert (mats == 0).any() == bool(zero)
        nolm, lm_labels = _decode_both(mats, w, ctx, thr, tables, False,
                                       bf16)
        changed += int((nolm != lm_labels).any(1).sum())
    assert changed > 0


def _packed(ctx_len, real_ctx, rows, default_row):
    """``KmerLM.compressed()``'s layout for sorted unique contexts
    ``real_ctx`` with rows ``rows [U, 5]``, without the dense tables."""
    n_words = 4 ** ctx_len // 32
    words = np.zeros(n_words, np.uint32)
    np.bitwise_or.at(words, real_ctx >> 5,
                     np.left_shift(1, real_ctx & 31).astype(np.uint32))
    rank = np.zeros(n_words, np.uint32)
    rank[1:] = np.cumsum(np.bincount(real_ctx >> 5, minlength=n_words))[:-1]
    l1 = np.stack([words, rank], axis=1).view(np.int32)
    return l1, np.concatenate([default_row[None], rows]).astype(np.float32)


def test_packed_lm_decoder_matches_jax():
    """Packed tables at ctx 12: real contexts are the 12-mers the no-LM
    decode visits plus 100,000 random ones, so presence bits both set and
    clear are read; W 6 and 16, both threshold pairs, float32 and
    bfloat16 values."""
    ctx = 12
    rng = np.random.default_rng(12)
    changed = 0
    for w, thr, bf16 in ((6, (0.5, 0.5), False), (16, (0.0, 10.0), True)):
        mats = _mats(1200 + w, 4, 100, 0.3)
        seqs = jbs.rows_to_seqs(np.asarray(jbs.beam_search_batch(
            mats, LENGTHS, beam_width=w, lm_enabled=False)[0]))
        seen = [jk.pack_context(s[i:i + ctx]) for s in seqs
                for i in range(len(s) - ctx + 1)]
        real = np.unique(np.concatenate([
            np.asarray(seen, np.int64),
            rng.choice(4 ** ctx, 100_000, replace=False)]))
        probs = rng.dirichlet(np.full(4, 0.2), len(real))
        rows = np.concatenate([probs, jk._entropy_rows(probs)[:, None]], 1)
        uniform = np.asarray([0.25] * 4 + [np.log(4.0)], np.float32)
        tables = _packed(ctx, real, rows, uniform)
        assert tables[0].nbytes == 4 * 2 ** 20
        nolm, lm_labels = _decode_both(mats, w, ctx, thr, tables, True, bf16)
        changed += int((nolm != lm_labels).any(1).sum())
    assert changed > 0
