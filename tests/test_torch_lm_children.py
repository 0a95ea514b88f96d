"""The layout the LM decode kernel's prefetch relies on, on the CPU.

Contexts are base 4 with the newest base lowest, so the rows a beam can
need after its next extension are those of its context's four children
``(ctx*4 + c) & mask``.  The kernel fetches them while the step runs
(``csrc/beam_search_lm.cu``): in a dense table they are one four-row
span; in a packed one they share one ``l1`` word and the present ones
are consecutive ``vals`` rows.  The LMs are the JAX package's own tables;
the rows are the port's ``LMFusion.rows``, float32 and bfloat16.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.lm import kmer as jk
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

N_PARENTS = 64


def _lm(ctx_len, n_contexts):
    return jk.build_dense_tables(jk.random_kmer_model(
        np.random.default_rng(ctx_len), ctx_len, n_contexts, 0.2), ctx_len)


def _children(lm):
    """Seeded parent contexts ``[P]``: the first and last context, half
    the rest parents of real contexts (so packed children are present),
    half uniform; and their children ``[4, P]``."""
    ctx_len = lm.context_len
    mask = 4 ** ctx_len - 1
    rng = np.random.default_rng(100 + ctx_len)
    parents = rng.integers(0, 4 ** ctx_len, N_PARENTS)
    real = np.flatnonzero(lm.real_mask)
    half = N_PARENTS // 2
    parents[half:] = rng.choice(real, N_PARENTS - half) >> 2
    parents[:2] = 0, mask
    return parents, (parents[None] * 4 + np.arange(4)[:, None]) & mask


def _rows(t1, t2, packed, ctx_len, bf16, children):
    """The port's ``LMFusion.rows`` of ``[4, P]`` contexts → ``[P, 4, 5]``."""
    import torch

    from radian_tpu_torch.ops.beam_search import LMFusion

    dtype = torch.bfloat16 if bf16 else torch.float32
    t2 = torch.from_numpy(t2).to(dtype)
    t1 = torch.from_numpy(t1) if packed else torch.from_numpy(t1).to(dtype)
    fusion = LMFusion(t1, t2, packed, ctx_len, 0.5, 0.5)
    return fusion.rows(torch.from_numpy(children)).permute(2, 1, 0).numpy()


def _stored(rows, bf16):
    """``rows`` as a table of that dtype holds them, widened to f32."""
    import torch

    dtype = torch.bfloat16 if bf16 else torch.float32
    return torch.from_numpy(rows).to(dtype).float().numpy()


def test_dense_children_are_one_four_row_span():
    """ctx 0 (one row: all four children are row 0), 1, 3 (every context
    real) and 11 (sparse, 4,194,304 rows): the children's rows are rows
    base..base+3 of the dense tables, base = (ctx*4) & mask, clamped to
    the table's one row at ctx 0."""
    for ctx_len, n_ctx in ((0, None), (1, None), (3, None), (11, 5000)):
        lm = _lm(ctx_len, n_ctx)
        table = np.concatenate([lm.probs, lm.entropy[:, None]], 1)
        parents, children = _children(lm)
        base = (parents * 4) & (4 ** ctx_len - 1)
        assert (base % 4 == 0).all()
        span = np.minimum(base[:, None] + np.arange(4), len(table) - 1)
        np.testing.assert_array_equal(children.T, span)
        for bf16 in (False, True):
            got = _rows(lm.probs, lm.entropy, False, ctx_len, bf16, children)
            np.testing.assert_array_equal(got, _stored(table[span], bf16))


def test_packed_children_share_one_l1_word():
    """ctx 3 and 12 (``compressed()``): the children's presence bits are
    a 4-aligned group of one l1 word, the present children's rows are
    consecutive vals rows from 1 + rank + the bits below the group, the
    absent ones row 0, and every row equals the dense table's."""
    for ctx_len, n_ctx in ((3, 20), (12, 3000)):
        lm = _lm(ctx_len, n_ctx)
        dense = np.concatenate([lm.probs, lm.entropy[:, None]], 1)
        l1, vals = lm.compressed()
        parents, children = _children(lm)
        first = children[0]
        assert (first % 4 == 0).all()
        assert (children >> 5 == first >> 5).all()  # one l1 word
        entry = l1[first >> 5].view(np.uint32).astype(np.int64)  # [P, 2]
        word, rank, bit = entry[:, 0], entry[:, 1], first & 31
        present = (word[None] >> (bit[None] + np.arange(4)[:, None])) & 1
        below = np.array([bin(w & ((1 << b) - 1)).count("1")
                          for w, b in zip(word.tolist(), bit.tolist())])
        idx = np.where(present == 1,
                       1 + rank + below + np.cumsum(present, 0) - present, 0)
        assert present.any() and not present.all()
        want = vals[idx.T]  # [P, 4, 5]
        np.testing.assert_array_equal(want, dense[children.T])
        del lm, dense
        for bf16 in (False, True):
            got = _rows(l1, vals, True, ctx_len, bf16, children)
            np.testing.assert_array_equal(got, _stored(want, bf16))
