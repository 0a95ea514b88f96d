"""The port's greedy CTC decode and edit distance against the JAX
package's ``ops/greedy.py``: the same argmax labels and keep mask, the
same decoded label arrays with and without input lengths, and the same
edit distances and batch mean.  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from radian_tpu.ops import greedy as jgreedy
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_greedy_decode_and_edit_distance_equal_jax():
    import torch

    from radian_tpu_torch.ops import greedy as tgreedy

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 80, 5)).astype(np.float32)
    logits[:, :, 4] += 1.0  # blank-heavy, as a young model is
    logits[1, 10:20] = logits[1, 10]  # a run of one argmax: one label
    logits[2] = 0.0  # all ties: the first class, every step
    lp = np.array(jax.nn.log_softmax(logits, -1))
    am_j, keep_j = (np.asarray(x) for x in jgreedy.greedy_labels(lp))
    am_t, keep_t = tgreedy.greedy_labels(torch.from_numpy(lp))
    np.testing.assert_array_equal(am_t.numpy(), am_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)

    in_lens = np.asarray([80, 40, 80, 1, 79, 0], np.int32)
    labels = rng.integers(0, 4, size=(6, 30)).astype(np.int32)
    lab_lens = np.asarray([30, 12, 1, 5, 0, 7], np.int32)
    for lens in (None, in_lens):
        want = jgreedy.greedy_decode(jnp.asarray(lp), lens)
        got = tgreedy.greedy_decode(torch.from_numpy(lp), lens)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert (tgreedy.batch_mean_edit_distance(
                    torch.from_numpy(lp), labels, lab_lens, lens)
                == jgreedy.batch_mean_edit_distance(
                    jnp.asarray(lp), labels, lab_lens, lens))
    for a, b in (([], [1, 2]), ([3], []), ([0, 1, 2, 3], [0, 2, 3, 3]),
                 (labels[0], labels[1]), (labels[3, :5], labels[3, :5])):
        assert tgreedy.edit_distance(a, b) == jgreedy.edit_distance(a, b)
