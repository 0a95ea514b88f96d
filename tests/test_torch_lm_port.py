"""The port's global+LM basecall against the JAX package's, on the CPU.

Both stacks basecall the same synthetic reads with the trained weights
and the same k-mer LM, and must give identical strings: the Basecaller
with the bench's LM (auto-picked dense, and packed forced through
``packed_lm_max_bytes``), and the CLI from fast5 to fasta with
``--rna-model``.  ``torch`` and the port are imported inside the tests
(see ``tests/torch_one_cpu.py``).
"""

import json
from pathlib import Path

import h5py
import numpy as np

from radian_tpu import pipeline as jpipe
from radian_tpu.cli.basecall import main as jmain
from radian_tpu.lm import kmer as jk
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _reads():
    """Three synthetic reads of ~1,500 samples and one with MAD = 0."""
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(9)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n_bases, levels)[0] * 60 + 500).astype(np.int16)
            for n_bases in (170, 160, 175)]
    sigs.insert(2, np.full(1400, 480, np.int16))  # skipped
    return sigs


def test_basecaller_lm_matches_jax_dense_and_packed():
    """The bench's LM (rng 42, ctx 11, 200,000 contexts, concentration
    0.2): its packed bound is 5,048,596 B, over the 3,000,000 B cut, so
    both packages pick dense; a cut of 10 MB makes both pick packed."""
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.lm import kmer as tk
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )

    sigs = _reads()
    model = tk.random_kmer_model(np.random.default_rng(42), 11, 200_000, 0.2)
    tlm = tk.build_dense_tables(model, 11)
    jlm = jk.build_dense_tables(model, 11)
    assert tpipe._packed_lm_bound_bytes(tlm) == 5_048_596
    params = params_from_flax(load_params_npz(TRAINED))
    for cut, packed in ((None, False), (10_000_000, True)):
        kw = dict(read_batch=4, bucket_quantum=1024, packed_lm_max_bytes=cut)
        jbc = jpipe.Basecaller(jload(TRAINED), lm=jlm, options=(
            jpipe.BasecallOptions(decode_backend="xla", **kw)))
        tbc = tpipe.Basecaller(params, lm=tlm,
                               options=tpipe.BasecallOptions(**kw),
                               device="cpu")
        assert jbc._lm_packed is packed and tbc.lm_fusion.packed is packed
        want = jbc.basecall_signals(sigs)
        got = tbc.basecall_signals(sigs)
        assert got[2] is None and all(s for i, s in enumerate(got) if i != 2)
        assert got == want


def test_cli_rna_model_matches_jax(tmp_path):
    """``--rna-model lm.json`` (ctx 11, 20,000 contexts: packed in both)
    from fast5 to fasta, ``--device cpu``; the fasta equals the JAX
    CLI's."""
    from radian_tpu_torch.cli.basecall import main

    sigs = _reads()
    model = jk.random_kmer_model(np.random.default_rng(5), 11, 20_000, 0.2)
    lm_path = tmp_path / "lm.json"
    lm_path.write_text(json.dumps(
        {"".join("ACGT"[b] for b in k): v for k, v in model.items()}))
    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for i, sig in enumerate(sigs):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}"
            raw.create_dataset("Signal", data=sig)
    args = [str(f5), None, "--sig-model", str(TRAINED), "--read-batch", "4",
            "--rna-model", str(lm_path)]
    args[1] = str(tmp_path / "jax")
    jmain(args)
    args[1] = str(tmp_path / "torch")
    main(args + ["--device", "cpu"])
    want = (tmp_path / "jax" / "reads-0.fasta").read_text()
    got = (tmp_path / "torch" / "reads-0.fasta").read_text()
    assert want.count(">") == 3
    assert got == want
