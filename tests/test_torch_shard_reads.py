"""The port's multi-process inference helpers
(``parallel/distributed.py``) against the JAX package's, on the CPU.

``host_read_indices`` partitions the reads round-robin as JAX's does;
``merge_fasta_shards`` writes JAX's merged file from the same shards;
the CLI's ``--shard-reads`` in two processes, each given torchrun's
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; a gloo group over localhost), runs ``basecall_sharded``
as rank 0 of 2 and 1 of 2 and writes ``reads-h0-*``/``reads-h1-*``
shards whose merge is the unsharded fasta, whose strings are the JAX
``Basecaller``'s; without a group the CLI is process 0 of 1.  Each
process has a timeout.  ``torch`` and the port are imported inside the
tests (see ``tests/torch_one_cpu.py``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import yaml

from radian_tpu import pipeline as jpipe
from radian_tpu.config import default_config
from radian_tpu.models import sig2seq as jsig
from radian_tpu.parallel import distributed as jdist
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

# one rank of the CLI: its group, its shard, the group gone on return
_WORKER = r"""
def run():
    import json, sys

    import torch

    torch.set_num_threads(1)
    from radian_tpu_torch.cli.basecall import main

    main(sys.argv[1:])
    print(json.dumps({"group_left": torch.distributed.is_initialized()}))


run()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_read_indices_and_merge_equal_jax(tmp_path):
    from radian_tpu_torch.parallel import distributed as tdist

    for n, pc in ((10, 4), (7, 2), (3, 5), (0, 2), (9, 1)):
        parts = [tdist.host_read_indices(n, p, pc) for p in range(pc)]
        assert sorted(i for part in parts for i in part) == list(range(n))
        assert parts == [jdist.host_read_indices(n, p, pc)
                         for p in range(pc)]
    assert tdist.host_read_indices(5) == [0, 1, 2, 3, 4]  # no group: 0 of 1
    assert (tdist.rank(), tdist.world_size()) == (0, 1)

    shards = tmp_path / "shards"
    shards.mkdir()
    (shards / "reads-h0-0.fasta").write_text(">a\nAAAA\n>c\nCCCC\n")
    (shards / "reads-h0-1.fasta").write_text(">e\nGA\n")
    (shards / "reads-h1-0.fasta").write_text(">b\nGGGG\n>d\n\n")
    (shards / "reads-0.fasta").write_text(">z\nTT\n")  # not a shard
    for order in (None, ["e", "b", "a", "x", "d", "c"]):
        n_t = tdist.merge_fasta_shards(shards, tmp_path / "t.fasta", order)
        n_j = jdist.merge_fasta_shards(shards, tmp_path / "j.fasta", order)
        assert n_t == n_j == 5
        assert (tmp_path / "t.fasta").read_text() == \
            (tmp_path / "j.fasta").read_text()


def test_basecall_sharded_merges_to_the_unsharded_fasta(tmp_path, capsys):
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.cli.basecall import main
    from radian_tpu_torch.config import default_config as tdefault
    from radian_tpu_torch.io.fasta import read_fasta
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.init import init_params
    from radian_tpu_torch.parallel.distributed import merge_fasta_shards

    rng = np.random.default_rng(21)
    sigs = [(rng.normal(0, 30, size=n) + 400).astype(np.int16)
            for n in (2000, 900, 3100, 1500, 2600, 700, 1200)]
    sigs[3][:] = 400  # MAD 0: skipped
    ids = [f"read{i}" for i in range(len(sigs))]
    f5 = tmp_path / "f5"
    f5.mkdir()
    with h5py.File(f5 / "reads.fast5", "w") as f:
        for rid, sig in zip(ids, sigs):
            raw = f.create_group(f"read_{rid}/Raw")
            raw.attrs["read_id"] = rid
            raw.create_dataset("Signal", data=sig)

    cfg = tdefault()
    cfg.model.tcn.nb_filters = 16
    cfg.model.tcn.dilations = [1, 2, 4]
    cfg.model.relu_units = 16
    (tmp_path / "narrow.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    ladder = (1024, 2048, 4096)
    argv = ["--device", "cpu", "--shard-reads", "--read-batch", "2",
            "--sig-config", str(tmp_path / "narrow.yaml"),
            "--bucket-lengths", ",".join(map(str, ladder))]

    # two ranks of the CLI, as torchrun starts them
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(f5), str(tmp_path / "sh"),
         *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(
            os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=port)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    # read3 (rank 1's) is skipped
    assert "[host 0/2] 4/4 reads" in outs[0]
    assert "[host 1/2] 2/3 reads" in outs[1]
    assert all(o.strip().endswith('{"group_left": false}') for o in outs)
    assert sorted(p.name for p in (tmp_path / "sh").iterdir()) == [
        "reads-h0-0.fasta", "reads-h1-0.fasta"]
    assert list(read_fasta(tmp_path / "sh" / "reads-h1-0.fasta")) == [
        "read1", "read5"]
    n = merge_fasta_shards(tmp_path / "sh", tmp_path / "merged.fasta", ids)
    bc = tpipe.Basecaller(params_from_flax(init_params(cfg, 0)), cfg,
                          options=tpipe.BasecallOptions(
                              read_batch=2, bucket_lengths=ladder),
                          device="cpu")
    bc.basecall_directory(f5, tmp_path / "one", verbose=False)
    merged = (tmp_path / "merged.fasta").read_text()
    assert n == 6 and merged == (tmp_path / "one" / "reads-0.fasta"
                                 ).read_text()

    # the JAX Basecaller's strings, the same seeded narrow model
    jcfg = default_config()
    jcfg.model.tcn.nb_filters = 16
    jcfg.model.tcn.dilations = [1, 2, 4]
    jcfg.model.relu_units = 16
    want = jpipe.Basecaller(
        jsig.init_params(jsig.build_model(jcfg), jax.random.PRNGKey(0)),
        jcfg, options=jpipe.BasecallOptions(
            read_batch=2, bucket_lengths=ladder, decode_backend="xla")
    ).basecall_signals(sigs)
    got = read_fasta(tmp_path / "merged.fasta")
    assert [got.get(rid) for rid in ids] == want

    # without a process group, --shard-reads is process 0 of 1
    main([str(f5), str(tmp_path / "cli"), *argv])
    assert "[host 0/1] 6/7 reads" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "cli").iterdir()] == [
        "reads-h0-0.fasta"]
    assert (tmp_path / "cli" / "reads-h0-0.fasta").read_text() == merged
