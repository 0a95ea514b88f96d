"""The port's LM-fused tiled chunk decode (``chunk_lm``) and its chunk
CLI against the JAX package's, on the CPU.

``chunk_lm`` with a ctx-4 LM must give exactly the JAX strings with
dense tables and with packed ones; its geometry checks raise; and the
CLI from fast5 to fasta with ``--decode-type chunk`` writes the JAX
CLI's fasta.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from radian_tpu import pipeline as jpipe
from radian_tpu.cli.basecall import main as jmain
from radian_tpu.lm import kmer as jk
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.test_torch_chunk_port import chunk_reads
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_chunk_lm_matches_jax_and_checks_its_geometry():
    """Dense tables (a packed cut of 0) and packed ones (the default cut:
    256 contexts), then the ValueErrors: no ``lm=``, no crop, and a crop
    that leaves fewer warm-up bases than the LM's context (chunk_len 512,
    step 64: 320 samples, ~8 bases < 11)."""
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.lm import kmer as tk
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )

    sigs = chunk_reads()[1:4]  # 1,100, MAD 0, 2,500 samples
    model = tk.random_kmer_model(np.random.default_rng(3), 4,
                                 concentration=0.3)
    tlm, jlm = tk.build_dense_tables(model, 4), jk.build_dense_tables(model, 4)
    params = params_from_flax(load_params_npz(TRAINED))
    kw = dict(decode_type="chunk", chunk_prep="fullprobs", chunk_lm=True,
              context_len=4, read_batch=3, bucket_quantum=1024)
    strings = []
    for cut, packed in ((0, False), (None, True)):
        jbc = jpipe.Basecaller(jload(TRAINED), lm=jlm, options=(
            jpipe.BasecallOptions(decode_backend="xla",
                                  packed_lm_max_bytes=cut, **kw)))
        tbc = tpipe.Basecaller(params, lm=tlm, options=tpipe.BasecallOptions(
            packed_lm_max_bytes=cut, **kw), device="cpu")
        assert jbc._lm_packed is packed and tbc.lm_fusion.packed is packed
        got = tbc.basecall_signals(sigs)
        assert got[1] is None and got[0] and got[2]
        assert got == jbc.basecall_signals(sigs), cut
        strings.append(got)
    assert strings[0] == strings[1]

    def make(lm, **opts):
        tpipe.Basecaller(params, lm=lm, options=tpipe.BasecallOptions(
            decode_type="chunk", chunk_prep="fullprobs", chunk_lm=True,
            **opts), device="cpu")

    with pytest.raises(ValueError, match="chunk_lm"):
        make(None)
    with pytest.raises(ValueError, match="chunk_lm"):
        make(tlm, context_len=4, chunk_crop=False)
    lm11 = tk.build_dense_tables(tk.random_kmer_model(
        np.random.default_rng(4), 11, n_contexts=1000), 11)
    with pytest.raises(ValueError, match="chunk_lm.*320 samples"):
        make(lm11, chunk_len=512, step_size=64)
    make(lm11)  # 640 samples, ~16 bases: accepted


def _write_fast5(path: Path, sigs) -> list[str]:
    path.mkdir()
    ids = [f"r{i}" for i in range(len(sigs))]
    with h5py.File(path / "reads.fast5", "w") as f:
        for rid, sig in zip(ids, sigs):
            raw = f.create_group(f"read_{rid}/Raw")
            raw.attrs["read_id"] = rid
            raw.create_dataset("Signal", data=sig)
    return ids


def test_cli_chunk_matches_jax(tmp_path):
    """``--decode-type chunk`` (fused) and ``--decode-type chunk
    --chunk-prep fullprobs --chunk-lm --rna-model lm.json``, fast5 to
    fasta with ``--device cpu``: each fasta equals the JAX CLI's."""
    from radian_tpu_torch.cli.basecall import main

    sigs = chunk_reads()[1:4]
    _write_fast5(tmp_path / "f5", sigs)
    model = jk.random_kmer_model(np.random.default_rng(5), 4,
                                 concentration=0.3)
    lm_path = tmp_path / "lm.json"
    lm_path.write_text(json.dumps(
        {"".join("ACGT"[b] for b in k): v for k, v in model.items()}))
    base = [str(tmp_path / "f5"), None, "--sig-model", str(TRAINED),
            "--read-batch", "3", "--decode-type", "chunk"]
    lm_flags = ["--chunk-prep", "fullprobs", "--chunk-lm", "--rna-model",
                str(lm_path), "--context-len", "4"]
    for name, extra in (("fused", []), ("lm", lm_flags)):
        args = list(base)
        args[1] = str(tmp_path / f"jax-{name}")
        jmain(args + extra)
        args[1] = str(tmp_path / f"torch-{name}")
        main(args + extra + ["--device", "cpu"])
        want = (tmp_path / f"jax-{name}" / "reads-0.fasta").read_text()
        got = (tmp_path / f"torch-{name}" / "reads-0.fasta").read_text()
        assert want.count(">") == 2
        assert got == want, name
