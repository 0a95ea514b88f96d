"""The port's overlapped windowing against the JAX package, on the CPU.

``get_windows_np``, the batched ``window_signal`` / ``preprocess_read``
and ``max_windows_for`` must give the JAX functions' windows, counts
and padding, bit for bit, at lengths around every window boundary.
``torch`` and the port are imported inside the test (see
``tests/torch_one_cpu.py``).
"""

import jax.numpy as jnp
import numpy as np

from radian_tpu.ops import preprocess as jpp
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_windowing_matches_jax():
    import torch

    from radian_tpu_torch.ops import preprocess as tpp

    rng = np.random.default_rng(6)
    window, step, bucket = 256, 64, 1024
    lengths = np.asarray([1, 100, 255, 256, 257, 319, 320, 321, 700, 1024],
                         np.int32)
    sigs = rng.integers(300, 700, (len(lengths), bucket)).astype(np.int16)
    sigs[np.arange(bucket)[None, :] >= lengths[:, None]] = 0
    max_w = tpp.max_windows_for(bucket, window, step)
    assert max_w == jpp.max_windows_for(bucket, window, step)
    got = tpp.preprocess_read(torch.from_numpy(sigs),
                              torch.from_numpy(lengths), window, step, max_w,
                              4.0)
    for i, n in enumerate(lengths):
        want = jpp.preprocess_read(jnp.asarray(sigs[i], jnp.float32), n,
                                   window, step, max_w, 4.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
        win, pad = tpp.get_windows_np(sigs[i, :n], window, step)
        want_win, want_pad = jpp.get_windows_np(sigs[i, :n], window, step)
        np.testing.assert_array_equal(win, want_win)
        assert pad == want_pad == window - (n - (len(win) - 1) * step)
