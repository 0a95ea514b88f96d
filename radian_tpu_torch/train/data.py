"""Training data pipeline: TFRecord shards → host batches (copy of
radian_tpu/train/data.py).

tf.data-free equivalent of the reference pipeline (reference
radian/data.py:34-76): interleaved shard reads, shuffle + infinite repeat
for training, deterministic order for validation, prefetch overlap — all
on host threads feeding numpy batches.  Multi-host data parallelism
shards the *file list* per process (each host owns every len(hosts)-th
shard), which replaces the reference's implicit per-worker tf.data
sharding under MultiWorkerMirroredStrategy.
"""

from __future__ import annotations

import glob as globlib
import queue
import threading
from collections import deque
from pathlib import Path
from typing import Iterator

import numpy as np

from radian_tpu_torch.io.tfrecord import iter_shard, read_shard


def list_shards(shards_dir: str | Path, split: str) -> list[str]:
    """Reference layout: ``{shards_dir}/{train|val}/*.tfrecords``
    (reference train.py:51-56)."""
    return sorted(globlib.glob(str(Path(shards_dir) / split / "*.tfrecords")))


class ShardDataset:
    """Iterates batches from TFRecord shards.

    Args:
      shard_files: shard paths (already restricted to this host's share).
      batch_size: examples per batch.
      train: shuffle shards + examples and repeat forever; False = one
        deterministic epoch.
      window/max_label: dense buffer sizes.
      seed: shuffle seed (per-host offset applied by the caller).
      drop_remainder: drop the final short batch (train default).
      interleave_cycle: shards held open concurrently; examples are
        drawn round-robin across them (reference radian/data.py:57-63,
        tf.data interleave cycle_length=32, block_length=1).
      shuffle_buffer: streaming shuffle-buffer size in examples
        (reference radian/data.py:7,64: WINDOWS_PER_SHARD+1 = 50_001),
        so consecutive batches mix examples from many shards instead of
        draining one shard at a time.  Train mode only.
      read_block: examples parsed per IO chunk per open shard (bounds
        memory to ~cycle·block examples instead of whole shards).
    """

    def __init__(
        self,
        shard_files: list[str],
        batch_size: int = 32,
        train: bool = True,
        window: int = 1024,
        max_label: int = 64,
        seed: int = 0,
        drop_remainder: bool | None = None,
        prefetch: int = 4,
        interleave_cycle: int = 32,
        shuffle_buffer: int = 50_001,
        read_block: int = 256,
    ):
        if not shard_files:
            raise ValueError("no shard files given")
        self.shard_files = list(shard_files)
        self.batch_size = batch_size
        self.train = train
        self.window = window
        self.max_label = max_label
        self.seed = seed
        self.drop_remainder = train if drop_remainder is None else drop_remainder
        self.prefetch = prefetch
        self.interleave_cycle = max(1, interleave_cycle)
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.read_block = read_block

    def count_examples(self) -> int:
        n = 0
        for f in self.shard_files:
            s, *_ = read_shard(f, self.window, self.max_label)
            n += s.shape[0]
        return n

    def _shard_examples(self, path: str) -> Iterator[tuple]:
        """Stream one shard example-at-a-time (block-buffered IO)."""
        for sig, lab, slen, llen in iter_shard(
            path, self.window, self.max_label, block=self.read_block
        ):
            for i in range(sig.shape[0]):
                yield sig[i], lab[i], slen[i], llen[i]

    def _interleaved(self, rng) -> Iterator[tuple]:
        """One epoch, drawn round-robin from ``interleave_cycle`` open
        shards; an exhausted shard's slot is refilled from the pending
        file list (tf.data interleave semantics, reference
        radian/data.py:57-63).  Validation reads shards one at a time in
        order (reference uses cycle_length=1 for val)."""
        files = list(self.shard_files)
        if self.train:
            rng.shuffle(files)
        cycle = self.interleave_cycle if self.train else 1
        pending = iter(files)
        active: deque = deque()

        def refill():
            while len(active) < cycle:
                f = next(pending, None)
                if f is None:
                    return
                active.append(self._shard_examples(f))

        refill()
        while active:
            it = active.popleft()
            try:
                ex = next(it)
            except StopIteration:
                refill()
                continue
            yield ex
            active.append(it)

    def _shuffled(self, src: Iterator[tuple], rng) -> Iterator[tuple]:
        """Streaming shuffle buffer: emit a uniformly-random held example
        per input, then drain in random order (tf.data shuffle)."""
        buf: list = []
        for ex in src:
            if len(buf) < self.shuffle_buffer:
                buf.append(ex)
                continue
            j = int(rng.integers(len(buf)))
            out = buf[j]
            buf[j] = ex
            yield out
        while buf:
            j = int(rng.integers(len(buf)))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()

    def _example_stream(self) -> Iterator[tuple]:
        rng = np.random.default_rng(self.seed)
        while True:
            src = self._interleaved(rng)
            if self.train:
                src = self._shuffled(src, rng)
            yield from src
            if not self.train:
                return

    def _batch_stream(self) -> Iterator[dict]:
        buf_s, buf_l, buf_sl, buf_ll = [], [], [], []
        for s, l, sl, ll in self._example_stream():
            buf_s.append(s)
            buf_l.append(l)
            buf_sl.append(sl)
            buf_ll.append(ll)
            if len(buf_s) == self.batch_size:
                yield self._make_batch(buf_s, buf_l, buf_sl, buf_ll)
                buf_s, buf_l, buf_sl, buf_ll = [], [], [], []
        if buf_s and not self.drop_remainder:
            yield self._make_batch(buf_s, buf_l, buf_sl, buf_ll)

    @staticmethod
    def _make_batch(s, l, sl, ll) -> dict:
        return {
            "signal": np.stack(s),
            "labels": np.stack(l).astype(np.int32),
            "input_length": np.asarray(sl, np.int32),
            "label_length": np.asarray(ll, np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        """Prefetching iterator: shard IO overlaps device compute."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        errors: list[BaseException] = []

        def producer():
            try:
                for batch in self._batch_stream():
                    q.put(batch)
            except BaseException as e:  # handed to the consumer below
                errors.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                # a failed read (or shard-parser build) ends the stream
                # with its error, not as a short epoch
                if errors:
                    raise errors[0]
                return
            yield item


def host_shard_files(files: list[str], process_index: int,
                     process_count: int) -> list[str]:
    """Round-robin file assignment for multi-host data parallelism."""
    mine = files[process_index::process_count]
    return mine if mine else files  # degenerate case: fewer shards than hosts
