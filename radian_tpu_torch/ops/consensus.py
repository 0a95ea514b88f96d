"""Chunk-mode sequence consensus (counterpart of radian_tpu/ops/consensus.py).

Reference behaviour (reference radian/sequence_assembly.py:19-48): align
each window's fragment against its predecessor by difflib's longest
matching block, add its bases to a 4×L vote matrix at the running
displacement, and call each column's argmax (ties to A<C<G<T, reference
sequence_assembly.py:90-97).

The stitch runs on the host, in C++ (``csrc/seqmatch.cc``, built by
``_build.py`` with g++ at first use): a failed build or load raises.
The plain version is python's difflib with a python vote loop
(``native=False``), the reference the C++ is tested against.
"""

from __future__ import annotations

import ctypes
import difflib

import numpy as np

from radian_tpu_torch import _build

BASES = "ACGT"
_IDX = {b: i for i, b in enumerate(BASES)}
_B2I = np.full(256, 255, np.uint8)
for _i, _b in enumerate(BASES.encode()):
    _B2I[_b] = _i
    _B2I[_b + 32] = _i  # lowercase, like _IDX via .upper()
_I2B = np.frombuffer(BASES.encode(), np.uint8)


def _lib() -> ctypes.CDLL:
    return _build.load("seqmatch")


def _decode(out, n: int) -> str:
    return _I2B[np.frombuffer(out.raw[:n], np.uint8)].tobytes().decode()


def longest_block(a: str, b: str, native: bool = True):
    """``(a_start, b_start, size)`` of difflib's longest matching block:
    the first maximal block of ``SequenceMatcher(None, a, b)``."""
    if not native:
        sm = difflib.SequenceMatcher(None, a, b)
        blk = max(sm.get_matching_blocks(), key=lambda m: m.size)
        return blk.a, blk.b, blk.size
    out = (ctypes.c_long * 3)()
    ab, bb = a.encode(), b.encode()
    _lib().LongestBlock(ab, len(ab), bb, len(bb), out)
    return out[0], out[1], out[2]


def _vote(counts: np.ndarray, start: int, fragment: str) -> None:
    if start < 0:
        fragment = fragment[-start:]
        start = 0
    for i, base in enumerate(fragment):
        counts[_IDX[base.upper()], start + i] += 1


def simple_assembly(fragments: list[str]) -> np.ndarray:
    """Vote-matrix consensus of decoded fragments (difflib alignment);
    returns ``[4, L]`` counts."""
    if not fragments:
        return np.zeros((4, 0))
    cap = 1000
    counts = np.zeros((4, cap))
    pos = 0
    length = 0
    for i, frag in enumerate(fragments):
        if i == 0:
            # reference quirk: the first fragment never counts toward
            # ``length`` (reference sequence_assembly.py:25-27), so a
            # one-fragment read assembles to an empty consensus
            _vote(counts, 0, frag)
            continue
        blk_a, blk_b, _ = longest_block(fragments[i - 1], frag, native=False)
        disp = blk_a - blk_b
        while disp + pos + len(frag) > cap:
            counts = np.pad(counts, ((0, 0), (0, 1000)))
            cap += 1000
        _vote(counts, pos + disp, frag)
        pos += disp
        length = max(length, pos + len(frag))
    return counts[:, :length]


def consensus_sequence(counts: np.ndarray) -> str:
    """argmax over the vote matrix → base string (reference index2base)."""
    return "".join(BASES[i] for i in np.argmax(counts, axis=0))


def assemble_fragments(fragments: list[str], native: bool = True) -> str:
    """Consensus of a read's window fragments: one C++ call
    (``AssembleFragments``), or with ``native=False`` the plain
    ``consensus_sequence(simple_assembly(fragments))``."""
    if not fragments:
        return ""
    if not native:
        return consensus_sequence(simple_assembly(fragments))
    data = _B2I[np.frombuffer("".join(fragments).encode(), np.uint8)]
    if data.size and data.max() > 3:
        raise ValueError("fragments must hold only the bases ACGT")
    offsets = np.zeros(len(fragments) + 1, np.int64)
    np.cumsum([len(f) for f in fragments], out=offsets[1:])
    max_len = max(len(f) for f in fragments)
    out = ctypes.create_string_buffer(int(offsets[-1]) + max_len + 1)
    n = _lib().AssembleFragments(data.tobytes(), offsets.ctypes.data,
                                 len(fragments), out)
    return _decode(out, n)


def assemble_read_packed(packed_rows: np.ndarray) -> str:
    """Consensus straight from a read's nibble-packed label rows
    (``pack_labels`` of front-compacted emissions, ``[n_wins,
    bytes_per_win]`` uint8; a 0 nibble ends a row): the fragments are
    rendered and stitched in one C++ call (``AssembleRead``).  Equal to
    ``assemble_fragments(rows_to_seqs(unpack_labels(rows)))``."""
    rows = np.ascontiguousarray(packed_rows, np.uint8)
    n_wins, bpw = rows.shape
    out = ctypes.create_string_buffer(n_wins * bpw * 2 + bpw * 2 + 1)
    n = _lib().AssembleRead(rows.ctypes.data, n_wins, bpw, out)
    return _decode(out, n)


def assemble_read_packed2(packed_rows: np.ndarray, n_lab: np.ndarray) -> str:
    """Consensus straight from a read's 2-bit-packed label rows
    (``pack_labels2``, ``[n_wins, bytes_per_win]`` uint8) and their
    emission counts ``[n_wins]``: the fragments are rendered and
    stitched in one C++ call (``AssembleRead2``).  Equal to
    ``assemble_fragments(rows_to_seqs(unpack_labels2(rows, n_lab)))``."""
    rows = np.ascontiguousarray(packed_rows, np.uint8)
    counts = np.ascontiguousarray(n_lab, np.int32)
    n_wins, bpw = rows.shape
    if counts.shape != (n_wins,):
        raise ValueError(f"n_lab must be [{n_wins}], got {counts.shape}")
    out = ctypes.create_string_buffer(
        int(counts.clip(0, bpw * 4).sum()) + bpw * 4 + 1)
    n = _lib().AssembleRead2(rows.ctypes.data, counts.ctypes.data, n_wins,
                             bpw, out)
    return _decode(out, n)
