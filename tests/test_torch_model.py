"""The port's SigToSeq and weight bridge against the flax model, on the CPU.

Both models get the same numpy input and the same weights (flax params
carried over by ``params_from_flax``).  Log-probs agree to 1e-5 absolute
(float32 convolutions summed in another order), plus 1e-5 relative at
full width.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict

from radian_tpu.models import sig2seq as jsig
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_narrow_model_matches_flax_and_is_causal():
    import torch

    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import SigToSeq

    kw = dict(nb_filters=16, dilations=(1, 2, 4))
    jmodel = jsig.SigToSeq(**kw)
    params = jsig.init_params(jmodel, jax.random.PRNGKey(3), window_size=64)
    x = np.random.default_rng(0).normal(size=(2, 300, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(params).items()}
    model = SigToSeq(**kw)
    model.load_state_dict(params_from_flax(flat))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        # causal: a change from sample 200 on leaves every earlier output
        y = torch.from_numpy(x).clone()
        y[:, 200:] += 1.0
        moved = model(y)
    torch.testing.assert_close(moved[:, :200], got[:, :200], rtol=0, atol=0)
    assert not torch.equal(moved[:, 200:], got[:, 200:])


def test_trained_model_full_width_matches_flax():
    import torch

    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model, param_count
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    flat = load_params_npz(TRAINED)
    jmodel = jsig.build_model()
    rng = np.random.default_rng(1)
    sig, _ = synth_read(rng, 120, kmer_level_table(rng))
    x = np.zeros((1, 1024, 1), np.float32)
    x[0, :, 0] = np.resize(sig, 1024)
    want = np.asarray(jmodel.apply({"params": jload(TRAINED)},
                                   jnp.asarray(x)))
    model = build_model()
    model.load_state_dict(params_from_flax(flat))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert param_count(model) == 2_200_581
    assert model.receptive_field == 253
    # trained log-probs reach -50, where float32 spacing is 4e-6 and the
    # 768-term conv sums differ in order: 1e-5 relative on top of 1e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
