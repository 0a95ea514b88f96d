"""The port's seeded init against the JAX package's ``init_params``.

``radian_tpu_torch.models.init`` rebuilds ``jax.random``'s Threefry
stream, flax's per-parameter keys and the truncated normal in numpy.
The test holds the weights exactly equal (bit for bit: XLA's CPU
``erfinv``, ``log1p`` and ``log`` are ported step for step) for seeds 0
and 1 at the default width, and the two packages' Basecallers built
from a seed alone give the same strings.  ``torch`` and the port are
imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

import jax
import numpy as np
from flax import traverse_util

from radian_tpu import pipeline as jpipe
from radian_tpu.models import sig2seq as jsig
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def test_init_params_equal_jax_bit_for_bit():
    import torch

    from radian_tpu_torch.models import init
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import build_model

    for seed in (0, 1):
        want = traverse_util.flatten_dict(jax.device_get(jsig.init_params(
            jsig.build_model(), jax.random.PRNGKey(seed))), sep="/")
        got = init.init_params(None, seed)
        assert list(got) == list(init.flax_param_shapes())
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        model = build_model()
        model.reset_parameters(seed)
        sd = params_from_flax(got)
        assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    # the pieces on their own: the PRNG key, fold_in and the bits
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(init.prng_key(7), np.asarray(key))
    np.testing.assert_array_equal(init.fold_in(init.prng_key(7), 123456789),
                                  np.asarray(jax.random.fold_in(key, 123456789)))
    np.testing.assert_array_equal(
        init.random_bits(init.prng_key(7), (5, 3)),
        np.asarray(jax.random.bits(key, (5, 3), np.uint32)))


def test_seeded_basecallers_give_jax_strings():
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(5)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n, levels)[0] * 60 + 500).astype(np.int16)
            for n in (60, 90, 75)]
    kw = dict(read_batch=3, bucket_quantum=1024)
    for seed in (0, 1):
        want = jpipe.load_basecaller(None, seed=seed, options=(
            jpipe.BasecallOptions(decode_backend="xla", **kw))
        ).basecall_signals(sigs)
        got = tpipe.load_basecaller(None, seed=seed, device="cpu",
                                    options=tpipe.BasecallOptions(**kw)
                                    ).basecall_signals(sigs)
        assert all(want) and got == want, seed
