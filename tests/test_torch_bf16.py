"""The port's bfloat16 forward against the flax model, and the LM tables
a bfloat16 Basecaller holds.

Both models run the trained weights on the same normalised read with
``compute_dtype=bfloat16`` on the CPU.  Measured on this input: max
|Δp| 1.1e-2 and mean 5.5e-6 (the float32 models differ by 2.9e-6 at
most); bfloat16 roundings of the two frameworks' convolutions differ in
a few places, and a rounding step moves a probability by up to 2^-8 of
its logit's scale.  The test holds 2e-2 max and 5e-5 mean.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from radian_tpu.models import sig2seq as jsig
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_bf16_model_matches_flax_bf16():
    import torch

    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.ops.preprocess import mad_normalise
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(1)
    sig, _ = synth_read(rng, 300, kmer_level_table(rng))
    sig = (sig * 60 + 500).astype(np.int16)[:2048]
    norm, _ = mad_normalise(torch.from_numpy(sig[None].copy()),
                            torch.tensor([len(sig)], dtype=torch.int32))
    x = norm[..., None].numpy()
    want = np.asarray(jsig.build_model(compute_dtype=jnp.bfloat16).apply(
        {"params": jload(TRAINED)}, jnp.asarray(x), probs=True))
    model = build_model(compute_dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(load_params_npz(TRAINED)))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), probs=True)
    assert got.dtype == torch.float32
    dp = np.abs(got.numpy() - want)
    assert dp.max() <= 2e-2 and dp.mean() <= 5e-5, (dp.max(), dp.mean())


def test_bf16_basecaller_holds_bf16_lm_tables():
    """``lm_table_dtype='auto'`` stores bfloat16 tables (dense and packed;
    packed l1 stays int32) under a bfloat16 forward and float32 under a
    float32 one; 'float32' overrides; the bfloat16 run basecalls."""
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.lm import kmer as tk
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    params = params_from_flax(load_params_npz(TRAINED))
    lm = tk.build_dense_tables(tk.random_kmer_model(
        np.random.default_rng(3), 5, 200, 0.2), 5)
    bf16, f32 = torch.bfloat16, torch.float32
    for compute, table_dtype, cut, t1, t2 in (
            (bf16, "auto", 1, bf16, bf16),
            (bf16, "auto", None, torch.int32, bf16),
            (f32, "auto", 1, f32, f32), (bf16, "float32", 1, f32, f32)):
        opts = tpipe.BasecallOptions(context_len=5, read_batch=2,
                                     bucket_quantum=1024,
                                     lm_table_dtype=table_dtype,
                                     packed_lm_max_bytes=cut)
        bc = tpipe.Basecaller(params, lm=lm, options=opts,
                              compute_dtype=compute, device="cpu")
        assert bc.lm_fusion.packed is (cut is None)
        assert (bc.lm_fusion.t1.dtype, bc.lm_fusion.t2.dtype) == (t1, t2)
        assert bc.model.compute_dtype == compute
    rng = np.random.default_rng(4)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n, levels)[0] * 60 + 500).astype(np.int16)
            for n in (90, 80)]
    seqs = bc.basecall_signals(sigs)
    assert all(seqs)
