"""The port's ``assemble_read_packed`` (consensus straight from a read's
nibble-packed label rows, one C++ call: ``AssembleRead`` in
``csrc/seqmatch.cc``) against the JAX package's, and against rendering
the rows to fragments and stitching them, on the CPU.

The fuzz of ``tests/test_native_seqmatch.py::test_assemble_read_packed_
fuzz`` (random compacted label rows, 60 reads from a seed), then rows
cut from one noisy sequence, so that the windows overlap as a read's do.
Where the JAX function would return ``None`` (no native library, or
``RADIAN_NATIVE_CONSENSUS=0``), the port builds its library through
``_build.py`` and raises on a failed build: it has no fallback.
``torch`` and the port are imported inside the test (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.ops.consensus import assemble_read_packed as jassemble
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _pack(rows: np.ndarray) -> np.ndarray:
    return ((rows[:, 0::2] + 1).astype(np.uint8)
            | ((rows[:, 1::2] + 1).astype(np.uint8) << 4))


def _reads(rng):
    """Compacted ``[n_wins, max_lab]`` int8 label rows, -1 after each
    row's emissions."""
    for _ in range(60):  # tests/test_native_seqmatch.py's fuzz
        n_wins = int(rng.integers(1, 12))
        max_lab = 2 * int(rng.integers(2, 40))
        rows = np.full((n_wins, max_lab), -1, np.int8)
        for w in range(n_wins):
            m = int(rng.integers(0, max_lab + 1))
            rows[w, :m] = rng.integers(0, 4, m)
        yield rows
    for _ in range(20):  # overlapping windows of one noisy sequence
        seq = rng.integers(0, 4, 600).astype(np.int8)
        n_wins, max_lab = int(rng.integers(2, 14)), 120
        rows = np.full((n_wins, max_lab), -1, np.int8)
        for w in range(n_wins):
            start = 40 * w + int(rng.integers(0, 10))
            frag = seq[start:start + int(rng.integers(60, max_lab + 1))].copy()
            flips = rng.integers(0, len(frag), 3)
            frag[flips] = rng.integers(0, 4, 3)
            rows[w, :len(frag)] = frag[::-1]  # emissions are reversed
        yield rows


def test_assemble_read_packed_equals_jax_and_the_fragments():
    from radian_tpu_torch.ops.beam_search import rows_to_seqs, unpack_labels
    from radian_tpu_torch.ops.consensus import (
        assemble_fragments,
        assemble_read_packed,
    )

    rng = np.random.default_rng(1234)
    n_bases = 0
    for i, rows in enumerate(_reads(rng)):
        packed = _pack(rows)
        got = assemble_read_packed(packed)
        want = jassemble(packed)
        assert want is not None  # the JAX package's native library built
        assert got == want, (i, rows)
        frags = rows_to_seqs(unpack_labels(packed))
        assert got == assemble_fragments(frags, native=False), i
        assert got == assemble_fragments(frags), i
        n_bases += len(got)
    assert n_bases > 8_000
    assert assemble_read_packed(np.zeros((0, 4), np.uint8)) == ""
