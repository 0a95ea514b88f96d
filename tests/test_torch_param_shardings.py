"""The port's ``param_shardings`` against the JAX rule, and the sharded
model at every mix the rule gives, at the full width of the trained
model (``bench_data/trained/params.npz``: 256 filters, 128 relu units,
2,200,581 parameters), on the CPU.

The JAX ``param_shardings`` on a ``make_mesh(data=1, model=M)`` of the
conftest's virtual CPU devices only builds ``NamedSharding``s, so no
XLA program (and no collective) runs.  For M 2, 3, 4, 5 and 8 the port
splits, leaf for leaf, the torch dimension that the JAX
``PartitionSpec``'s ``'model'`` entry names in the flax layout.  At M 2
every conv and ``dense_relu`` split (2,199,936 parameters); at M 3
nothing; at M 5 only ``dense_out``'s kernel (its bias of 5 is under
8·M).  The sharded forward at each M equals the unsharded one within
``FORWARD_ATOL`` (measured on the CPU: 0 where every bias splits with
its kernel, 2.6e-5 at M 5, where ``dense_out``'s whole bias is added
after the split product).  ``torch`` and the port are imported inside
the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np
from flax import traverse_util

from radian_tpu.models.checkpoint import load_params_npz as jload
from radian_tpu.parallel.mesh import make_mesh as jmake_mesh
from radian_tpu.parallel.mesh import param_shardings as jparam_shardings
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / \
    "params.npz"
MODEL_SIZES = (2, 3, 4, 5, 8)
# trained log-probs reach -50 (f32 spacing 4e-6); a split product with
# its whole bias added after it rounds once more
FORWARD_ATOL = 1e-4


def test_param_shardings_equal_the_jax_rule_at_full_width():
    from radian_tpu_torch.models.checkpoint import load_params_npz
    from radian_tpu_torch.parallel import make_mesh, param_shardings

    flat = load_params_npz(TRAINED)
    assert sum(v.size for v in flat.values()) == 2_200_581
    jparams = jload(TRAINED)
    split_params = {}
    for m in MODEL_SIZES:
        jspecs = traverse_util.flatten_dict(
            jparam_shardings(jparams, jmake_mesh(data=1, model=m)), sep="/")
        got = param_shardings(flat, make_mesh(1, m, ["cpu"] * m))
        assert set(got) == set(jspecs) == set(flat)
        for k, sharding in jspecs.items():
            spec = tuple(sharding.spec)
            ndim = flat[k].ndim
            # the flax dimension on 'model', as the torch one (the conv
            # and dense kernels are stored reversed / transposed)
            want = next((ndim - 1 - i for i, ax in enumerate(spec)
                         if ax == "model"), None)
            assert got[k] == want, (m, k, spec)
        split_params[m] = sum(flat[k].size for k, d in got.items()
                              if d is not None)
        if m == 5:
            assert [k for k, d in got.items() if d is not None] == [
                "dense_out/kernel"]
    assert split_params == {2: 2_199_936, 3: 0, 4: 2_199_936, 5: 640,
                            8: 2_199_936}
    # a model axis of 1 replicates every leaf
    assert set(param_shardings(flat, make_mesh(1, 1, ["cpu"])).values()
               ) == {None}


def test_sharded_forward_at_every_mix():
    import torch

    from radian_tpu_torch.models.checkpoint import (
        leaf_name,
        load_params_npz,
        params_from_flax,
        params_to_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.models.tensor_parallel import shard_model
    from radian_tpu_torch.parallel import make_mesh, param_shardings

    flat = load_params_npz(TRAINED)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 600, 1)).astype(np.float32))
    whole = build_model()
    whole.load_state_dict(params_from_flax(flat))
    with torch.no_grad():
        want = whole(x)
    for m in MODEL_SIZES:
        mesh = make_mesh(1, m, ["cpu"] * m)
        model = build_model()
        model.load_state_dict(params_from_flax(flat))
        shard_model(model, mesh.model_row(0), param_shardings(flat, mesh))
        shards = [k for k, _ in model.named_parameters()
                  if leaf_name(k)[1] is not None]
        # 28 split leaves (each conv's and the shortcut's kernel and
        # bias, dense_relu's) or dense_out's kernel alone
        assert len(shards) == {2: 28 * 2, 3: 0, 4: 28 * 4, 5: 5,
                               8: 28 * 8}[m], m
        # the export is the whole model's, leaf for leaf
        exported = params_to_flax(model)
        assert set(exported) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(exported[k], v, err_msg=k)
        with torch.no_grad():
            got = model(x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=str(m))
