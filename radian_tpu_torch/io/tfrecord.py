"""TFRecord shard reader/writer for the training pipeline (copy of
radian_tpu/io/tfrecord.py).

Replaces the reference's tf.data + tf.io TFRecord stack (reference
radian/data.py:9-76) without a TensorFlow dependency.  The path is the
native C++ codec (``csrc/tfrecord.cc``, built by ``g++`` at first use
and loaded with ctypes); a failed build or load raises.  The pure
Python/numpy codec (``use_native=False``) is the plain version the tests
hold the native one against.

Schema (reference data.py:10-15): per example, ``signal`` float[window],
``label`` varlen float, ``signal_length`` int64, ``label_length`` int64.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from radian_tpu_torch import _build

_WINDOW = 1024
_MAX_LABEL = 64  # generous bound; reference MAX_LABEL_LEN=25 (model.py:10)

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_longlong)


# ---------------------------------------------------------------------------
# crc32c (plain version)
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = np.uint32(0x82F63B78) ^ (c >> np.uint32(1)) if c & 1 else c >> np.uint32(1)
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def _masked_crc(data: bytes) -> int:
    table = _crc_table()
    c = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    for b in arr:
        c = table[(c ^ b) & np.uint32(0xFF)] ^ (c >> np.uint32(8))
    crc = int(c ^ np.uint32(0xFFFFFFFF))
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Python protobuf codec (plain version)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while v >= 0x80:
        out += bytes([(v & 0x7F) | 0x80])
        v >>= 7
    return out + bytes([v])


def _read_varint(buf, pos):
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _encode_example(signal, label, signal_length, label_length) -> bytes:
    def float_feature(key, values):
        packed = np.asarray(values, "<f4").tobytes()
        flist = b"\x0a" + _varint(len(packed)) + packed  # field1 packed
        feature = b"\x12" + _varint(len(flist)) + flist  # float_list=2
        entry = (
            b"\x0a" + _varint(len(key)) + key.encode()
            + b"\x12" + _varint(len(feature)) + feature
        )
        return b"\x0a" + _varint(len(entry)) + entry

    def int_feature(key, value):
        ilist = b"\x08" + _varint(int(value))
        feature = b"\x1a" + _varint(len(ilist)) + ilist  # int64_list=3
        entry = (
            b"\x0a" + _varint(len(key)) + key.encode()
            + b"\x12" + _varint(len(feature)) + feature
        )
        return b"\x0a" + _varint(len(entry)) + entry

    feats = (
        float_feature("signal", signal)
        + float_feature("label", label)
        + int_feature("signal_length", signal_length)
        + int_feature("label_length", label_length)
    )
    return b"\x0a" + _varint(len(feats)) + feats


def _decode_example(payload: bytes) -> dict:
    out = {}
    tag, pos = _read_varint(payload, 0)
    flen, pos = _read_varint(payload, pos)
    fend = pos + flen
    while pos < fend:
        _, pos = _read_varint(payload, pos)  # map entry tag
        elen, pos = _read_varint(payload, pos)
        eend = pos + elen
        key = None
        feature = None
        while pos < eend:
            ktag, pos = _read_varint(payload, pos)
            klen, pos = _read_varint(payload, pos)
            if (ktag >> 3) == 1:
                key = payload[pos : pos + klen].decode()
            else:
                feature = payload[pos : pos + klen]
            pos += klen
        if key and feature:
            vtag, vpos = _read_varint(feature, 0)
            vlen, vpos = _read_varint(feature, vpos)
            body = feature[vpos : vpos + vlen]
            if (vtag >> 3) == 2:  # float_list
                ltag, lpos = _read_varint(body, 0)
                if (ltag & 7) == 2:
                    plen, lpos = _read_varint(body, lpos)
                    out[key] = np.frombuffer(
                        body[lpos : lpos + plen], "<f4"
                    ).copy()
                else:
                    vals = []
                    lpos = 0
                    while lpos < len(body):
                        _, lpos = _read_varint(body, lpos)
                        vals.append(struct.unpack("<f", body[lpos : lpos + 4])[0])
                        lpos += 4
                    out[key] = np.asarray(vals, np.float32)
            elif (vtag >> 3) == 3:  # int64_list
                ltag, lpos = _read_varint(body, 0)
                if (ltag & 7) == 2:  # packed repeated int64
                    plen, lpos = _read_varint(body, lpos)
                    stop = lpos + plen
                    v = 0
                    while lpos < stop:
                        v, lpos = _read_varint(body, lpos)
                else:
                    v, lpos = _read_varint(body, lpos)
                out[key] = int(v)
        pos = eend
    return out


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def _native_record(lib, ex: dict) -> bytes:
    """One framed record from ``csrc/tfrecord.cc``'s ``WriteExample``."""
    sig = np.ascontiguousarray(ex["signal"], np.float32)
    lab = np.ascontiguousarray(ex["label"], np.float32)
    cap = 64 + 4 * (sig.size + lab.size) + 64
    out = np.empty(cap, np.uint8)
    n = lib.WriteExample(
        sig.ctypes.data_as(_F32P), sig.size, lab.ctypes.data_as(_F32P),
        lab.size, int(ex["signal_length"]), int(ex["label_length"]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), cap)
    if n < 0:
        raise ValueError(f"record buffer of {cap} bytes too small")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def write_shard(path: str | Path, examples: list[dict],
                use_native: bool = True) -> None:
    """Write examples ``{'signal', 'label', 'signal_length',
    'label_length'}``; the native and the plain codec write the same
    bytes."""
    lib = _build.load("tfrecord") if use_native else None
    with open(path, "wb") as f:
        for ex in examples:
            if lib is not None:
                f.write(_native_record(lib, ex))
            else:
                f.write(_frame(_encode_example(
                    ex["signal"], ex["label"], ex["signal_length"],
                    ex["label_length"])))


def read_shard(
    path: str | Path,
    window: int = _WINDOW,
    max_label: int = _MAX_LABEL,
    verify_crc: bool = False,
    use_native: bool = True,
):
    """Read a shard into dense arrays.

    Returns ``(signals [N, window] f32, labels [N, max_label] f32,
    signal_lengths [N] i64, label_lengths [N] i64)``.
    """
    data = Path(path).read_bytes()
    lib = _build.load("tfrecord") if use_native else None
    return _parse_buffer(data, window, max_label, verify_crc, lib, path)


def iter_shard(
    path: str | Path,
    window: int = _WINDOW,
    max_label: int = _MAX_LABEL,
    block: int = 256,
    verify_crc: bool = False,
    use_native: bool = True,
):
    """Stream a shard as dense array blocks of up to ``block`` examples:
    reads ``block`` framed records at a time, so an open shard holds ~
    ``block`` examples in memory (the reference holds 32 shards open at
    once, reference radian/data.py:57-63).

    Yields tuples shaped like :func:`read_shard`'s return value.
    """
    lib = _build.load("tfrecord") if use_native else None
    with open(path, "rb") as fh:
        while True:
            chunk = bytearray()
            count = 0
            while count < block:
                header = fh.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack("<Q", header)
                rest = fh.read(4 + length + 4)
                if len(rest) < 4 + length + 4:
                    raise ValueError(f"truncated record in {path}")
                chunk += header
                chunk += rest
                count += 1
            if not count:
                return
            yield _parse_buffer(
                bytes(chunk), window, max_label, verify_crc, lib, path
            )


def _parse_buffer(data, window, max_label, verify_crc, lib, path):
    if lib is not None:
        cap = max(len(data) // 64, 16)  # examples are >= ~4KB each
        while True:
            signals = np.zeros((cap, window), np.float32)
            labels = np.zeros((cap, max_label), np.float32)
            slen = np.zeros(cap, np.int64)
            llen = np.zeros(cap, np.int64)
            n = lib.ParseShard(
                data, len(data), window, max_label, cap,
                signals.ctypes.data_as(_F32P), labels.ctypes.data_as(_F32P),
                slen.ctypes.data_as(_I64P), llen.ctypes.data_as(_I64P),
                1 if verify_crc else 0,
            )
            if n < 0:
                raise ValueError(f"corrupt TFRecord shard: {path}")
            if n <= cap:
                return signals[:n], labels[:n], slen[:n], llen[:n]
            cap = n
    # the plain version
    sig_rows, lab_rows, slens, llens = [], [], [], []
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        if verify_crc:
            (crc,) = struct.unpack_from("<I", data, pos + 8)
            if _masked_crc(data[pos : pos + 8]) != crc:
                raise ValueError(f"corrupt length crc at {pos} in {path}")
        payload = data[pos + 12 : pos + 12 + length]
        if verify_crc:
            (crc,) = struct.unpack_from("<I", data, pos + 12 + length)
            if _masked_crc(payload) != crc:
                raise ValueError(f"corrupt data crc at {pos} in {path}")
        ex = _decode_example(payload)
        sig = np.zeros(window, np.float32)
        s = ex.get("signal", np.zeros(0, np.float32))
        sig[: min(len(s), window)] = s[:window]
        lab = np.zeros(max_label, np.float32)
        l = ex.get("label", np.zeros(0, np.float32))
        lab[: min(len(l), max_label)] = l[:max_label]
        sig_rows.append(sig)
        lab_rows.append(lab)
        slens.append(ex.get("signal_length", len(s)))
        llens.append(ex.get("label_length", len(l)))
        pos += 12 + length + 4
    n = len(sig_rows)
    return (
        np.stack(sig_rows) if n else np.zeros((0, window), np.float32),
        np.stack(lab_rows) if n else np.zeros((0, max_label), np.float32),
        np.asarray(slens, np.int64),
        np.asarray(llens, np.int64),
    )
