"""The port's Keras ``.h5`` import and export against the JAX package's.

An ``.h5`` that the JAX exporter writes from the trained ``.npz`` loads
in the port to exactly ``params_from_flax(load_params_npz(npz))``; one
the port writes loads in JAX to the same tree as the ``.npz``; the two
packages' ``load_basecaller('x.h5')`` give the same strings, and the
port's CLI reaches that loader with ``--sig-model x.h5``.  ``torch`` and
the port are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import h5py
import jax
import numpy as np
from flax import traverse_util

from radian_tpu import pipeline as jpipe
from radian_tpu.models import keras_import as jkeras
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _jax_tree(flat):
    return traverse_util.unflatten_dict(flat, sep="/")


def test_h5_round_trips_between_the_packages(tmp_path):
    import torch

    from radian_tpu_torch.models import keras_import as tkeras
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )

    flat = load_params_npz(TRAINED)
    want = params_from_flax(flat)
    jh5 = tmp_path / "jax.h5"
    jkeras.export_keras_h5(_jax_tree(jload(TRAINED)), jh5)
    got = tkeras.load_keras_h5(jh5)
    assert set(got) == set(flat)
    sd = params_from_flax(got)
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)

    th5 = tmp_path / "port.h5"
    tkeras.export_keras_h5(flat, th5)
    with h5py.File(jh5) as a, h5py.File(th5) as b:  # the same file layout
        names_a, names_b = [], []
        a.visit(names_a.append)
        b.visit(names_b.append)
        assert len(names_a) > 40 and names_a == names_b
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        assert list(a["tcn"].attrs["weight_names"]) == list(
            b["tcn"].attrs["weight_names"])
    back = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, jkeras.load_keras_h5(th5)), sep="/")
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_load_basecaller_and_cli_take_h5(tmp_path):
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.io.fasta import read_fasta
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(13)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n, levels)[0] * 60 + 500).astype(np.int16)
            for n in (120, 100)]
    h5 = tmp_path / "model-01.h5"
    jkeras.export_keras_h5(_jax_tree(jload(TRAINED)), h5)
    kw = dict(read_batch=2, bucket_quantum=2048)
    want = jpipe.load_basecaller(h5, options=jpipe.BasecallOptions(
        decode_backend="xla", **kw)).basecall_signals(sigs)
    got = tpipe.load_basecaller(h5, options=tpipe.BasecallOptions(**kw),
                                device="cpu").basecall_signals(sigs)
    assert all(want) and got == want

    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for i, sig in enumerate(sigs):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}"
            raw.create_dataset("Signal", data=sig)
    main([str(f5), str(tmp_path / "out"), "--sig-model", str(h5),
          "--read-batch", "2", "--device", "cpu"])
    assert read_fasta(tmp_path / "out" / "reads-0.fasta") == {
        "r0": want[0], "r1": want[1]}
