"""The port's single-process multi-device inference, on the CPU.

``Basecaller(mesh=make_mesh(data=2, devices=["cpu", "cpu"]))`` splits
each padded batch's rows over two model replicas, each slice run from
its own thread: the counterpart of the JAX package's ``shard_map`` over
its 8 virtual CPU devices (``tests/test_mesh_inference.py``, whose read
lengths and read_batch this test takes).  Global+LM and chunk mode give
strings equal to the port's unsharded ``Basecaller`` and to the JAX
package's unsharded one, read for read (a narrow model at the seeded
init, which both packages build bit for bit).  The JAX package's own
slow test holds its sharded run to its unsharded one.  The validation
``ValueError``s are the JAX ones, and the CLI's ``--mesh-data 2 --device
cpu`` writes the unsharded fasta.  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

import h5py
import jax
import numpy as np
import pytest

from radian_tpu import pipeline as jpipe
from radian_tpu.config import default_config
from radian_tpu.lm import build_dense_tables, random_kmer_model
from radian_tpu.models import sig2seq as jsig
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

LENS = [3000, 900, 2048, 1500, 4095, 1024, 2500, 700]


def _narrow(cfg):
    cfg.model.tcn.nb_filters = 16
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 16
    return cfg


def _signals():
    rng = np.random.default_rng(1234)
    return [(rng.normal(0, 30, size=n) + 400).astype(np.float32)
            for n in LENS], rng


def test_mesh_matches_unsharded_port_and_jax():
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.lm.kmer import KmerLM
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.init import init_params
    from radian_tpu_torch.parallel import make_mesh

    sigs, rng = _signals()
    jlm = build_dense_tables(
        random_kmer_model(rng, context_len=3, n_contexts=40), 3)
    tlm = KmerLM(context_len=jlm.context_len, probs=jlm.probs,
                 entropy=jlm.entropy)
    jcfg, tcfg = _narrow(default_config()), _narrow(tdefault())
    jparams = jsig.init_params(jsig.build_model(jcfg), jax.random.PRNGKey(0))
    params = params_from_flax(init_params(tcfg, 0))
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    for decode_type in ("global", "chunk"):
        kw = dict(read_batch=8, decode_type=decode_type, context_len=3)
        use_lm = decode_type == "global"
        want = jpipe.Basecaller(
            jparams, jcfg, lm=jlm if use_lm else None,
            options=jpipe.BasecallOptions(decode_backend="xla", **kw)
        ).basecall_signals(sigs)
        opts = tpipe.BasecallOptions(**kw)
        lm = tlm if use_lm else None
        single = tpipe.Basecaller(params, tcfg, lm, opts, device="cpu")
        sharded = tpipe.Basecaller(params, tcfg, lm, opts, mesh=mesh,
                                   device="cpu")
        assert len(sharded._replicas) == 2
        assert sharded.model is sharded._replicas[0].model
        # unsharded is a mesh of one replica, on its device
        assert single._replicas == [single]
        assert single.mesh.shape == {"data": 1, "model": 1}
        got = sharded.basecall_signals(sigs)
        assert single.basecall_signals(sigs) == got, decode_type
        assert got == want, decode_type
        # '' is legal (chunk mode's single-fragment quirk on short reads);
        # None would be a skipped read
        assert all(s is not None for s in got)
        assert sum(map(len, got)) > 1000


def test_mesh_validation_and_cli(tmp_path):
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.init import init_params
    import torch

    from radian_tpu_torch.parallel import (
        Mesh,
        data_sharding,
        make_mesh,
        param_shardings,
        replicated_sharding,
    )

    cfg = _narrow(tdefault())
    params = params_from_flax(init_params(cfg, 0))
    mesh8 = make_mesh(data=8, model=1, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.Basecaller(params, cfg, mesh=mesh8, device="cpu",
                         options=tpipe.BasecallOptions(read_batch=12))
    with pytest.raises(ValueError, match="'data' axis"):
        tpipe.Basecaller(params, cfg, mesh=Mesh(np.array(mesh8.devices[:, 0]),
                                                ("x",)),
                         device="cpu",
                         options=tpipe.BasecallOptions(read_batch=8))
    with pytest.raises(ValueError, match="not among the mesh"):
        tpipe.Basecaller(params, cfg, device="cpu",
                         mesh=make_mesh(data=2, devices=["cuda:0", "cuda:1"]))
    # a 2x2 mesh: each model row's first device runs its data slice,
    # once, and the strings are the unsharded ones
    sigs, _ = _signals()
    opts4 = tpipe.BasecallOptions(read_batch=4)
    mesh22 = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    bc22 = tpipe.Basecaller(params, cfg, options=opts4, mesh=mesh22,
                            device="cpu")
    assert len(bc22._replicas) == 2
    assert mesh22.data_devices() == [mesh22.model_row(i)[0]
                                     for i in range(2)]
    want = tpipe.Basecaller(params, cfg, options=opts4,
                            device="cpu").basecall_signals(sigs[:4])
    assert bc22.basecall_signals(sigs[:4]) == want and all(want)
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh(data=3, devices=["cpu", "cpu"])
    # the batch split and replication helpers
    x = torch.arange(12).reshape(6, 2)
    mesh3 = make_mesh(data=3, devices=["cpu"] * 3)
    assert mesh3.shape == {"data": 3, "model": 1}
    parts = data_sharding(mesh3).parts(x)
    assert [p.tolist() for p, _ in parts] == [
        [[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]]]
    assert [d for _, d in parts] == replicated_sharding(mesh3) == [
        torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="split evenly"):
        data_sharding(mesh8).parts(x)
    # a model axis of 1 replicates every leaf
    assert set(param_shardings({"dense_relu/kernel": np.zeros((16, 16))},
                               mesh3).values()) == {None}

    # the CLI: --mesh-data 2 on the CPU writes the unsharded fasta
    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for i, sig in enumerate(sigs[:4]):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}"
            raw.create_dataset("Signal", data=sig.astype(np.int16))
    out = {}
    for name, extra in (("one", []), ("mesh", ["--mesh-data", "2"])):
        main([str(f5), str(tmp_path / name), "--device", "cpu",
              "--read-batch", "4", *extra])
        out[name] = (tmp_path / name / "reads-0.fasta").read_text()
    assert out["mesh"] == out["one"] and out["one"].count(">") == 4
    with pytest.raises(ValueError, match="divisible"):
        main([str(f5), str(tmp_path / "x"), "--device", "cpu",
              "--read-batch", "3", "--mesh-data", "2"])
