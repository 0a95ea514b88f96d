"""The port's streaming basecall against the JAX package's, on the CPU.

``basecall_directory(streaming=True)`` must write the JAX package's
streaming fasta, in read order, with a skipped (MAD = 0) read in the
middle, in global and in chunk mode.  ``torch`` and the port are
imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

from radian_tpu import pipeline as jpipe
from radian_tpu.io.fast5 import Fast5Read as JRead
from radian_tpu.models.checkpoint import load_params_npz as jload
from tests.test_torch_chunk_port import chunk_reads
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _stream_both(tmp_path, capsys, **kw):
    """Five reads of two buckets, two a batch, the skipped read third."""
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.io.fast5 import Fast5Read

    sigs = chunk_reads()
    sigs = [sigs[1], sigs[3], sigs[2], sigs[1][:1000], sigs[3][:2100]]
    ids = [f"s{i}" for i in range(len(sigs))]
    kw = dict(read_batch=2, bucket_quantum=2048, **kw)
    jbc = jpipe.Basecaller(jload(TRAINED), options=jpipe.BasecallOptions(
        decode_backend="xla", **kw))
    jbc.basecall_directory(None, tmp_path / "jax", reads=iter(
        [JRead(i, s) for i, s in zip(ids, sigs)]), streaming=True)
    want_out = capsys.readouterr().out
    tbc = tpipe.load_basecaller(TRAINED, options=tpipe.BasecallOptions(**kw),
                                device="cpu")
    tbc.basecall_directory(None, tmp_path / "torch", reads=iter(
        [Fast5Read(i, s) for i, s in zip(ids, sigs)]), streaming=True)
    got_out = capsys.readouterr().out
    assert "s2 signal issue, skipping this read." in got_out
    assert got_out.splitlines()[0] == want_out.splitlines()[0]
    want = (tmp_path / "jax" / "reads-0.fasta").read_text()
    got = (tmp_path / "torch" / "reads-0.fasta").read_text()
    assert [ln for ln in got.splitlines() if ln.startswith(">")] == [
        ">s0", ">s1", ">s3", ">s4"]
    return got, want


def test_streaming_global_matches_jax(tmp_path, capsys):
    got, want = _stream_both(tmp_path, capsys)
    assert got == want


def test_streaming_chunk_matches_jax(tmp_path, capsys):
    got, want = _stream_both(tmp_path, capsys, decode_type="chunk")
    assert got == want
