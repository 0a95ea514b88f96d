"""Multi-process orchestration (counterpart of
radian_tpu/parallel/distributed.py).

Training: ``initialize()`` forms a ``torch.distributed`` process group,
one process per GPU (NCCL; gloo on the CPU), in place of
``jax.distributed`` and the reference's TF_CONFIG cluster bootstrap
(reference radian/train.py:123-133).  ``train/trainer.py`` then
all-reduces the loss weights and the gradients over it.

Inference: reads are sharded round-robin over the processes by read
index; each process basecalls its share with its own ``Basecaller`` and
writes its own fasta shard (``reads-h<rank>-<n>.fasta``), merged
deterministically afterwards by ``merge_fasta_shards``.  No collective
runs.
"""

from __future__ import annotations

import datetime
import os
import time
from pathlib import Path
from typing import Iterable

import torch
import torch.distributed as dist

# how long a collective, or forming the group, waits for a missing peer
# before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _init_method(coordinator_address: str | None) -> str:
    """``tcp://host:port`` from the JAX package's ``host:port``; a URL
    (``tcp://``, ``file://``, ``env://``) passes as it is."""
    if coordinator_address is None:
        raise ValueError("multi-process runs need a coordinator address "
                         "(host:port), or torchrun's environment")
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: str | torch.device = "cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Form the process group: a no-op for one process, as in JAX.

    With ``num_processes`` > 1 the group is formed at
    ``coordinator_address`` (``host:port`` or a ``tcp://``/``file://``
    URL) as rank ``process_id``; with no arguments and torchrun's
    variables set (``RANK``, ``WORLD_SIZE``, ...), from those
    (``env://``).  The backend is NCCL for a CUDA ``device``, whose
    process then drives ``cuda:<LOCAL_RANK>`` (torchrun) or
    ``cuda:<rank mod device count>`` (so call this before building a
    model on a bare ``cuda``), and gloo on the CPU.  Every
    collective of the group, and forming it, raises after ``timeout``
    rather than waiting for a missing peer forever.
    """
    if num_processes is None and all(v in os.environ for v in _TORCHRUN_VARS):
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init_method = "env://"
    elif num_processes is not None and num_processes > 1:
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} must be in "
                             f"[0, {num_processes})")
        init_method = _init_method(coordinator_address)
    else:
        return
    if num_processes <= 1:
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to train "
                "on the CPU over gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_read_indices(n_reads: int, process_index: int | None = None,
                      process_count: int | None = None) -> list[int]:
    """The read indices this process basecalls: every ``process_count``-th
    from ``process_index`` (by default the group's rank and size)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return list(range(pi, n_reads, pc))


def basecall_sharded(basecaller, fast5_dir, fasta_dir, verbose: bool = True,
                     *, reads: Iterable | None = None) -> int:
    """Basecall this process's round-robin share of the reads under
    ``fast5_dir`` into ``fasta_dir/reads-h<rank>-<n>.fasta``, by the
    process group's rank and size; returns the reads written.
    ``reads`` (``Fast5Read``s) stands in for the directory where there
    is no h5py to read it, as on the card in ``chip_smoke.py``."""
    from radian_tpu_torch.io.fast5 import iter_fast5_dir
    from radian_tpu_torch.io.fasta import FastaWriter

    pi, pc = rank(), world_size()
    reads = list(iter_fast5_dir(fast5_dir) if reads is None else reads)
    mine = host_read_indices(len(reads), pi, pc)
    t0 = time.time()
    seqs = basecaller.basecall_signals([reads[i].signal for i in mine])
    n_written = 0
    with FastaWriter(fasta_dir, basecaller.options.reads_per_fasta,
                     prefix=f"reads-h{pi}") as w:
        for idx, seq in zip(mine, seqs):
            if seq is None:
                continue
            w.write(reads[idx].read_id, seq)
            n_written += 1
    if verbose:
        dt = time.time() - t0
        print(f"[host {pi}/{pc}] {n_written}/{len(mine)} reads in "
              f"{dt:.2f}s ({n_written / dt:.2f} reads/s)")
    return n_written


def merge_fasta_shards(fasta_dir: str | Path, out_path: str | Path,
                       read_order: list[str] | None = None) -> int:
    """Deterministic merge of the per-process fasta shards, by
    ``read_order`` or else by read id; returns the reads found."""
    from radian_tpu_torch.io.fasta import read_fasta

    merged: dict[str, str] = {}
    for p in sorted(Path(fasta_dir).glob("reads-h*.fasta")):
        merged.update(read_fasta(p))
    order = read_order if read_order is not None else sorted(merged)
    with open(out_path, "w") as f:
        for rid in order:
            if rid in merged:
                f.write(f">{rid}\n{merged[rid]}\n")
    return len(merged)
