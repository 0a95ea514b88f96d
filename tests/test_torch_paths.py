"""The ``Basecaller``'s decode paths through its one dispatch loop, on
the CPU.

Each radian path gives on a two-replica mesh the strings of one
replica: every render takes the record's arrays joined by rows over the
mesh slices, and ``basecall_stream`` writes the same strings through the
same loop.  The transformer-CRF path refuses what it cannot run, with
its messages.  ``torch`` and the port are imported inside the tests
(see ``tests/torch_one_cpu.py``).
"""

import re

import numpy as np
import pytest

from tests.test_torch_mesh_inference import _narrow, _signals
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import MODEL, config


def test_radian_paths_on_a_mesh_match_one_replica_and_stream(tmp_path):
    """Global with an LM; chunk 'fused', 'windows', 'fullprobs' tiled
    with ``chunk_lm`` and 'fused' with the device consensus: the first
    eighth of seven of the mesh test's reads and a read skipped (MAD =
    0), in two batches of four rows, two a replica, 256-sample windows
    (the plain decoders step in Python)."""
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.io.fast5 import Fast5Read
    from radian_tpu_torch.io.fasta import read_fasta
    from radian_tpu_torch.lm import kmer
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.init import init_params
    from radian_tpu_torch.parallel import make_mesh

    sigs, rng = _signals()
    sigs = [s[:len(s) // 8] for s in sigs[:-1]]
    sigs.append(np.full(400, 400, np.float32))
    real = len(sigs) - 1
    ids = [f"r{i}" for i in range(len(sigs))]
    lm = kmer.build_dense_tables(
        kmer.random_kmer_model(rng, context_len=3, n_contexts=40), 3)
    cfg = _narrow(default_config())
    params = params_from_flax(init_params(cfg, 0))
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    cases = {
        "global-lm": (tpipe.GlobalPath, dict(), lm),
        "fused": (tpipe.ChunkPath, dict(decode_type="chunk"), None),
        "windows": (tpipe.ChunkPath, dict(decode_type="chunk",
                                          chunk_prep="windows"), None),
        "tiled-lm": (tpipe.ChunkPath, dict(
            decode_type="chunk", chunk_prep="fullprobs", chunk_lm=True),
            lm),
        "device": (tpipe.ChunkPath, dict(decode_type="chunk",
                                         consensus="device"), None),
    }
    for name, (path, kw, case_lm) in cases.items():
        opts = tpipe.BasecallOptions(
            chunk_len=256, step_size=32, read_batch=4, bucket_quantum=256,
            context_len=3, **kw)
        single = tpipe.Basecaller(params, cfg, case_lm, opts, device="cpu")
        sharded = tpipe.Basecaller(params, cfg, case_lm, opts, mesh=mesh,
                                   device="cpu")
        assert type(sharded.path) is path and len(sharded._replicas) == 2
        assert len(sharded.batches(sigs)) == 2
        want = single.basecall_signals(sigs)
        assert sharded.basecall_signals(sigs) == want, name
        assert want[real] is None
        assert all(s is not None for s in want[:real]), name
        assert sum(len(s) for s in want[:real]) > 100, name
        written = sharded.basecall_directory(
            None, tmp_path / name, verbose=False, streaming=True,
            reads=iter([Fast5Read(i, s) for i, s in zip(ids, sigs)]))
        assert written == real
        got = read_fasta(tmp_path / name / "reads-0.fasta")
        assert got == {i: s for i, s in zip(ids, want) if s is not None}
        assert list(got) == ids[:real], name


def test_crf_path_refusals_keep_their_messages(tmp_path):
    """A ``bonito_tx_crf`` model refuses radian's chunk mode, an empty
    chunk batch, a config without its ``basecaller`` section and
    streaming."""
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.io.fast5 import Fast5Read
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.pipeline import (
        Basecaller,
        BasecallOptions,
        CrfPath,
    )

    tx = DotDict(config())
    params = build_model(tx).state_dict()

    def make(cfg=tx, **kw):
        return Basecaller(params, cfg, None, BasecallOptions(**kw),
                          device="cpu")

    for kw, cfg, err, msg in (
            (dict(decode_type="chunk"), tx, ValueError,
             "decode_type='chunk' is radian's; a bonito_tx_crf model "
             "chunks by its config's basecaller section"),
            (dict(chunk_batch=0), tx, ValueError, "chunk_batch 0 < 1"),
            ({}, DotDict({"model": MODEL}), ValueError,
             "a bonito_tx_crf config needs a basecaller section "
             "(chunksize, overlap)")):
        with pytest.raises(err, match=f"^{re.escape(msg)}$"):
            make(cfg, **kw)
    bc = make(chunk_batch=2)
    assert type(bc.path) is CrfPath
    read = Fast5Read("t0", np.zeros(2000, np.int16))
    with pytest.raises(NotImplementedError, match=re.escape(
            "streaming a bonito_tx_crf model: use basecall_signals")):
        bc.basecall_directory(None, tmp_path, reads=iter([read]),
                              streaming=True)
