"""The plain CRF Viterbi decode (``ops/crf_viterbi.py``, the function
``csrc/crf_viterbi.cu`` computes) on the CPU: against a brute force
over every path, and against the plain reference's
(``benchmark/core/reference_tx_crf.py``) on scores full of ties.  The
CUDA kernels are held to it bit for bit on the card by
``chip_smoke.py``.  ``torch`` and the port are imported inside the tests
(see ``tests/torch_one_cpu.py``).
"""

import itertools

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _brute_force(sc: np.ndarray, state_len: int):
    """The best score over every path of ``[T, S, 5]`` scores, and that
    path's emissions: from state ``p`` a step stays (column 0 of ``p``)
    or moves to ``s = (p mod 4^(L-1))·4 + b``, scored in column ``1+r``
    of ``s``, ``r`` the base ``p`` drops."""
    t_len, s_n, _ = sc.shape
    quarter = s_n // 4
    cols = np.array(list(itertools.product(range(5), repeat=t_len)))
    best, best_path = -np.inf, None
    for s0 in range(s_n):
        state = np.full(len(cols), s0)
        total = np.zeros(len(cols))
        for t in range(t_len):
            c = cols[:, t]
            move = c > 0
            nxt = np.where(move, (state % quarter) * 4 + (c - 1), state)
            col = np.where(move, 1 + state // quarter, 0)
            total += sc[t, nxt, col]
            state = nxt
        k = int(np.argmax(total))
        if total[k] > best:
            best = total[k]
            best_path = np.where(cols[k] > 0, cols[k] - 1, -1)
    return best, best_path


def test_plain_viterbi_matches_brute_force():
    """``state_len`` 2 (16 states), T 6, random scores without ties: the
    best path's emissions and its score."""
    import torch

    from radian_tpu_torch.ops import crf_viterbi as cv

    rng = np.random.default_rng(7)
    for _ in range(3):
        sc = rng.normal(size=(6, 16, 5)).astype(np.float32)
        best, want = _brute_force(sc.astype(np.float64), 2)
        scores = torch.from_numpy(sc.reshape(1, 6, 80))
        bp, final = cv.crf_viterbi(scores, 2)
        path = cv.crf_backtrace(bp, final)[0].numpy()
        np.testing.assert_array_equal(path, want)
        # the path's own score, walked back through the backpointers
        state, total = int(final[0]), 0.0
        for t in reversed(range(6)):
            c = int(bp[0, t, state])
            total += float(sc[t, state, c])
            if c:
                state = (c - 1) * 4 + state // 4
        assert abs(total - best) < 1e-5


def test_plain_viterbi_matches_reference_with_ties():
    """Scores on a grid of halves, so that most comparisons tie, in
    float32 and bfloat16, at ``state_len`` 3 and 5: the port's plain
    decode and the reference's give the same paths (ties to the lowest
    column, then to the lowest final state)."""
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.ops import crf_viterbi as cv

    rng = np.random.default_rng(8)
    for state_len, n, t_len in ((3, 4, 60), (5, 3, 40)):
        for dtype in (torch.float32, torch.bfloat16):
            sc = np.round(rng.normal(size=(n, t_len, 5 * 4 ** state_len))
                          * 2) / 2
            scores = torch.from_numpy(sc.astype(np.float32)).to(dtype)
            got = cv.viterbi_path(scores, state_len)
            want = ref.viterbi(scores, state_len)
            assert got.dtype == torch.int8
            assert torch.equal(got, want), (state_len, dtype)
            # the paths hold both stays and moves
            assert (got >= 0).any() and (got < 0).any()
