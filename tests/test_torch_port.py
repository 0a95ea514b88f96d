"""The PyTorch port's slice (radian_tpu_torch) against the JAX package.

Both stacks basecall the same synthetic reads with the same trained
weights, on the CPU, and must give identical strings.  ``torch`` and the
port are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np
import pytest

from radian_tpu import pipeline as jpipe
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _reads(seed):
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(seed)
    levels = kmer_level_table(rng)
    sigs = []
    for n_bases in (330, 320, 345):
        sig, _ = synth_read(rng, n_bases, levels)
        sigs.append((sig * 60 + 500).astype(np.int16))
    sigs.insert(2, np.full(2900, 480, np.int16))  # MAD = 0: skipped
    return sigs


@pytest.fixture(scope="module")
def jax_calls(one_cpu):  # noqa: F811  (runs after the wait)
    """Four reads (one with MAD = 0) and the JAX Basecaller's strings."""
    sigs = _reads(9)
    jbc = jpipe.Basecaller(jload(TRAINED), options=jpipe.BasecallOptions(
        decode_backend="xla", read_batch=4, bucket_quantum=1024))
    return sigs, jbc.basecall_signals(sigs)


def test_basecaller_matches_jax_on_trained_weights(jax_calls):
    from radian_tpu_torch import pipeline as tpipe

    sigs, want = jax_calls
    tbc = tpipe.load_basecaller(TRAINED, options=tpipe.BasecallOptions(
        read_batch=4, bucket_quantum=1024), device="cpu")
    got = tbc.basecall_signals(sigs)
    assert got[2] is None and want[2] is None
    assert all(s for i, s in enumerate(want) if i != 2)
    assert got == want


def test_cli_fast5_to_fasta_matches_jax(jax_calls, tmp_path):
    import h5py

    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.io.fasta import read_fasta

    sigs, want = jax_calls
    f5 = tmp_path / "f5"
    f5.mkdir()
    ids = [f"r{i}" for i in range(len(sigs))]
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for rid, sig in zip(ids, sigs):
            raw = f.create_group(f"read_{rid}/Raw")
            raw.attrs["read_id"] = rid
            raw.create_dataset("Signal", data=sig)
    main([str(f5), str(tmp_path / "out"), "--sig-model", str(TRAINED),
          "--read-batch", "4", "--device", "cpu"])
    got = read_fasta(tmp_path / "out" / "reads-0.fasta")
    assert got == {rid: s for rid, s in zip(ids, want) if s is not None}
