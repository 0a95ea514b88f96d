"""The port's bfloat16 chunk mode at its two rounding points, against the
JAX package's.

With a bfloat16 forward, the JAX package's fused chunk program
(radian_tpu/pipeline.py:_chunk_fused) stores the full-read
probabilities in bfloat16 and casts each window head's probabilities
to that dtype before it joins them to the tail and widens the window to
float32 for the decode.  The test builds those window probabilities
from the flax model in bfloat16 on the port's normalised reads, and
holds the port's ``chunk_forward`` / ``chunk_window_probs`` to them:
every value of both is a bfloat16 value; they agree within the
bfloat16 forward's own tolerance (``test_torch_bf16.py``: 2e-2 max,
5e-5 mean) plus the one bfloat16 step (2^-8 below 1) that a rounding
can add; and most entries are equal, where the two frameworks' forwards
round to the same bfloat16 value.  Measured on these reads: max |Δp|
1.95e-2, mean 1.7e-5; equal on 97.6% of head and 90.4% of tail entries
(held at 90% and 85%).  ``torch`` and the port are imported inside the
tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from radian_tpu.models import sig2seq as jsig
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _jax_window_probs(norm, starts, head, window):
    """The JAX package's bfloat16 window probabilities, ``[N·D, window,
    5]`` float32: full-read pass stored in bfloat16, heads from a
    zero-history pass cast to bfloat16, joined, widened."""
    model = jsig.build_model(compute_dtype=jnp.bfloat16)
    params = {"params": jload(TRAINED)}
    n, length = norm.shape
    d = starts.shape[1]
    ext = np.pad(norm, ((0, 0), (0, window)))
    full = model.apply(params, jnp.asarray(ext[..., None]), probs=True)
    full = full.astype(jnp.bfloat16)
    tidx = (starts[..., None] + np.arange(head, window)).reshape(n, -1)
    tail = jnp.take_along_axis(full, jnp.asarray(tidx)[..., None], axis=1)
    hidx = np.minimum(starts[..., None] + np.arange(head), length - 1)
    strips = np.take_along_axis(norm, hidx.reshape(n, -1), axis=1)
    heads = model.apply(params, jnp.asarray(strips.reshape(n * d, head, 1)),
                        probs=True)
    probs = jnp.concatenate(
        [heads.reshape(n, d, head, 5).astype(tail.dtype),
         tail.reshape(n, d, window - head, 5)], axis=2)
    return np.asarray(probs.reshape(n * d, window, 5).astype(jnp.float32))


def test_bf16_chunk_window_probs_round_like_jax():
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(17)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n // 8 + 40, levels)[0][:n] * 60 + 500
             ).astype(np.int16) for n in (1500, 2000)]
    bc = tpipe.Basecaller(
        params_from_flax(load_params_npz(TRAINED)),
        options=tpipe.BasecallOptions(decode_type="chunk", read_batch=2,
                                      bucket_quantum=2048),
        compute_dtype=torch.bfloat16, device="cpu")
    assert bc.path.use_chunk_fused and bc.path.chunk_head == 256
    sig, ln = bc.pad_batch([0, 1], 2048, sigs)
    geom = bc.chunk_geometry(ln, 2048)
    norm, probs_full, _ = bc.chunk_forward(sig, ln)
    assert probs_full.dtype == torch.bfloat16
    got = bc.chunk_window_probs(norm, probs_full, geom)
    assert got.dtype == torch.float32
    got = got.numpy()
    want = _jax_window_probs(norm.numpy(), geom.starts.numpy(),
                             bc.path.chunk_head, 1024)
    assert got.shape == want.shape
    for a in (got, want):
        np.testing.assert_array_equal(
            a, torch.tensor(a).bfloat16().float().numpy())
    live = (np.arange(1024)[None, :] < geom.lens.reshape(-1, 1).numpy())
    dp = np.abs(got - want)[live]
    assert dp.max() <= 2e-2 + 2 ** -8 and dp.mean() <= 5e-5, (
        dp.max(), dp.mean())
    for part, share in ((slice(0, 256), 0.9), (slice(256, 1024), 0.85)):
        same = (got[:, part] == want[:, part])[live[:, part]]
        assert same.mean() >= share, (part, same.mean())
