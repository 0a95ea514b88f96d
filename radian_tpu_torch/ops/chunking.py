"""Chunks batched by samples, for the transformer-CRF model: Bonito's
``chunk`` and ``stitch`` geometry (the benchmark's plain reference,
``benchmark/core/reference_tx_crf.py``, states it).

A read of ``length`` samples becomes chunks of ``size`` samples that
overlap by ``overlap``: a read shorter than a chunk is one chunk, the
read repeated up to ``size``; else the chunks step by ``size −
overlap`` from ``stub = (length − overlap) mod (size − overlap)``, with
``[0, size)`` in front when ``stub > 0``.  Its path keeps, in decoded
steps of ``step`` samples: a short read its first ``length // step``; a
read of one chunk all of it; else ``[0, first_end)`` of the first chunk,
``[semi, size − semi)`` of the middle ones and ``[semi, size)`` of the
last, ``semi = overlap // 2`` in steps.

``plan`` deals the chunks of a call's reads, the reads in length order,
into batches of ``rows`` chunks (a read's chunks may span two batches);
``ChunkBatch.host_arrays`` gives a batch's device inputs and
``ChunkBatch.stitch`` turns its paths into the finished reads' strings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from radian_tpu_torch.ops.preprocess import bucket_length
from radian_tpu_torch.utils import profiling

_BASES = np.frombuffer(b"ACGT", np.uint8)


def chunk_starts(length: int, size: int, overlap: int) -> list[int]:
    """The start of each chunk of a read (module docstring)."""
    if length < size:
        return [0]
    stub = (length - overlap) % (size - overlap)
    n = (length - stub - overlap) // (size - overlap)
    starts = [stub + i * (size - overlap) for i in range(n)]
    return ([0] + starts) if stub > 0 else starts


def kept_steps(length: int, size: int, overlap: int,
               step: int) -> list[tuple[int, int]]:
    """The decoded steps ``[lo, hi)`` each chunk of a read keeps."""
    steps = size // step
    if length < size:
        return [(0, length // step)]
    n = len(chunk_starts(length, size, overlap))
    if n == 1:
        return [(0, steps)]
    semi = overlap // 2
    start, end = semi // step, (size - semi) // step
    stub = (length - overlap) % (size - overlap)
    first_end = (stub + semi) // step if stub > 0 else end
    return [(0, first_end)] + [(start, end)] * (n - 2) + [(start, steps)]


@dataclasses.dataclass
class ChunkBatch:
    """One batch of chunks, ``rows`` rows once filled; per real row
    ``r``: its read ``reads[row_read[r]]`` (an index into the call's
    signals), its first sample ``row_start[r]``, the steps ``[lo[r],
    hi[r])`` its read's path keeps, and whether it is its read's last
    chunk.  ``pieces`` is the call's: each unfinished read's kept bases
    so far, in chunk order."""

    reads: list[int]
    row_read: np.ndarray
    row_start: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    last: np.ndarray
    rows: int
    size: int
    pieces: dict

    @property
    def n_chunks(self) -> int:
        return len(self.row_read)

    def host_arrays(self, signals, quantum: int):
        """``(reads [R, L], lengths [R] int32, table [rows, 2] int64)``:
        the batch's whole reads padded to a multiple of ``quantum``
        samples, and each row's (read row, first sample); filler rows
        repeat row 0.  int16 signals stay int16."""
        sigs = [signals[i] for i in self.reads]
        dtypes = {np.asarray(s).dtype for s in sigs}
        host_dtype = (np.int16 if dtypes == {np.dtype(np.int16)}
                      else np.float32)
        width = bucket_length(max(len(s) for s in sigs), quantum)
        padded = np.zeros((len(sigs), width), host_dtype)
        lengths = np.zeros(len(sigs), np.int32)
        for j, s in enumerate(sigs):
            padded[j, :len(s)] = s
            lengths[j] = len(s)
        table = np.zeros((self.rows, 2), np.int64)
        table[:, 0] = self.row_read[0]
        table[:, 1] = self.row_start[0]
        table[:self.n_chunks, 0] = self.row_read
        table[:self.n_chunks, 1] = self.row_start
        return padded, lengths, table

    def count(self, signals) -> None:
        """The batch's counters while tracing: its reads that start here
        (``reads``, ``real_samples``), its chunks and its rows' samples,
        filler rows included (``chunks``, ``chunk_samples``)."""
        # a read's first chunk, and no other, starts at its sample 0
        starting = [self.reads[k] for k in self.row_read[self.row_start == 0]]
        profiling.count("reads", len(starting))
        profiling.count("real_samples", sum(len(signals[i])
                                            for i in starting))
        profiling.count("chunks", self.n_chunks)
        profiling.count("chunk_samples", self.rows * self.size)

    def stitch(self, path: np.ndarray, bad: np.ndarray, results) -> None:
        """Add the rows' kept bases (``path`` ``[n_chunks, T]`` int8, -1
        for a stay) to their reads, and write each read whose last chunk
        this is into ``results`` (a read whose ``bad`` MAD marks it is
        skipped, left None)."""
        t = np.arange(path.shape[1])[None, :]
        keep = ((t >= self.lo[:, None]) & (t < self.hi[:, None])
                & (path >= 0))
        cuts = np.cumsum(keep.sum(1))[:-1]
        for r, bases in enumerate(np.split(path[keep], cuts)):
            k = self.row_read[r]
            i = self.reads[k]
            if bad[k]:
                continue
            self.pieces.setdefault(i, []).append(bases)
            if self.last[r]:
                seq = _BASES[np.concatenate(self.pieces.pop(i))]
                results[i] = seq.tobytes().decode()


def plan(lengths, *, size: int, overlap: int, step: int,
         rows: int) -> list[ChunkBatch]:
    """The batches of ``rows`` chunks of a call's reads (lengths in the
    call's order): the reads in length order, each read's chunks in
    order.  A read of no samples has no chunk (it stays None)."""
    order = sorted((i for i in range(len(lengths)) if lengths[i] > 0),
                   key=lambda i: lengths[i])
    read_of, start, lo, hi, last = [], [], [], [], []
    for i in order:
        n = int(lengths[i])
        kept = kept_steps(n, size, overlap, step)
        for j, (s, (a, b)) in enumerate(zip(chunk_starts(n, size, overlap),
                                            kept)):
            read_of.append(i)
            start.append(s)
            lo.append(a)
            hi.append(b)
            last.append(j == len(kept) - 1)
    pieces: dict = {}
    out = []
    for b0 in range(0, len(read_of), rows):
        ids = read_of[b0:b0 + rows]
        reads = list(dict.fromkeys(ids))
        pos = {i: k for k, i in enumerate(reads)}
        out.append(ChunkBatch(
            reads=reads,
            row_read=np.array([pos[i] for i in ids], np.int64),
            row_start=np.array(start[b0:b0 + rows], np.int64),
            lo=np.array(lo[b0:b0 + rows], np.int64),
            hi=np.array(hi[b0:b0 + rows], np.int64),
            last=np.array(last[b0:b0 + rows], bool),
            rows=rows, size=size, pieces=pieces))
    return out
