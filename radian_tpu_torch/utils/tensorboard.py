"""Minimal TensorBoard scalar event writer, no TF dependency (copy of
radian_tpu/utils/tensorboard.py).

The reference logs training scalars through tf.summary / the TensorBoard
callback (reference radian/train.py:62-68).  This writer emits the same
on-disk format — TFRecord-framed ``Event`` protos with ``simple_value``
summaries — hand-encoded with the protobuf wire helpers shared with our
TFRecord codec, so standard TensorBoard can read our training runs.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

from radian_tpu_torch.io.tfrecord import _masked_crc, _varint


def _tag_bytes(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    out = _tag_bytes(1, 1) + struct.pack("<d", wall_time)
    out += _tag_bytes(2, 0) + _varint(step)
    return out + body


def _scalar_summary(tag: str, value: float) -> bytes:
    val = (
        _tag_bytes(1, 2) + _varint(len(tag.encode())) + tag.encode()
        + _tag_bytes(2, 5) + struct.pack("<f", value)
    )
    summary = _tag_bytes(1, 2) + _varint(len(val)) + val
    return _tag_bytes(5, 2) + _varint(len(summary)) + summary


class EventWriter:
    def __init__(self, log_dir: str | Path):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self._f = open(Path(log_dir) / fname, "ab")
        version = _tag_bytes(3, 2) + _varint(len(b"brain.Event:2")) + b"brain.Event:2"
        self._write(_event(time.time(), 0, version))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, _scalar_summary(tag, value)))

    def close(self) -> None:
        self._f.close()
