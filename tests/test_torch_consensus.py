"""The port's chunk stitch and label packing against the JAX package's.

The port's C++ stitcher (``csrc/seqmatch.cc``) and its plain difflib
path must give the JAX ``radian_tpu.ops.consensus`` results on seeded
fragment sets; ``_compact_pack2``, ``pack_labels2`` and
``unpack_labels2`` the JAX bytes; and the tiled crop's kept spans must
partition each read exactly.  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu import pipeline as jpipe
from radian_tpu.ops import beam_search as jbs
from radian_tpu.ops import consensus as jcons
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _seq(idx) -> str:
    return "".join("ACGT"[int(i)] for i in idx)


def _fragment_sets(rng):
    """Overlapping noisy windows of one sequence (lengths crossing
    difflib's autojunk threshold of 200), the same with a skewed base
    composition (a rare base that stays non-popular), and edge cases."""
    sets = []
    for _ in range(40):
        seq = rng.integers(0, 4, 700)
        frags, start = [], 0
        for _ in range(int(rng.integers(1, 12))):
            frag = list(seq[start:start + int(rng.integers(0, 300))])
            for _ in range(int(rng.integers(0, 5))):
                if frag:
                    frag[int(rng.integers(0, len(frag)))] = int(
                        rng.integers(0, 4))
            frags.append(_seq(frag))
            start += int(rng.integers(0, 60))
        sets.append(frags)
    for _ in range(20):
        rare = int(rng.integers(0, 4))
        common = [i for i in range(4) if i != rare]
        seq = np.array([common[int(i)] for i in rng.integers(0, 3, 600)])
        seq[rng.choice(len(seq), size=4, replace=False)] = rare
        sets.append([_seq(seq[s:s + int(rng.integers(200, 350))])
                     for s in range(0, 250, int(rng.integers(20, 60)))])
    sets += [[], ["ACGT"], ["", ""], ["ACGTACGT", ""], ["", "ACGT"],
             ["ACGTAC", "", "GTACGT"], ["acgtAC", "GTacgt"]]
    return sets


def test_stitcher_matches_jax(rng):
    """Longest blocks and consensus, C++ and difflib, against the JAX
    module; ``assemble_read_packed2`` on 2-bit-packed rows against the
    JAX module's on the same rows."""
    import torch

    from radian_tpu_torch.ops import beam_search as tbs
    from radian_tpu_torch.ops import consensus as tcons

    for frags in _fragment_sets(rng):
        for a, b in zip(frags, frags[1:]):
            want = jcons.longest_block(a, b)
            assert tcons.longest_block(a, b) == want, (a, b)
            assert tcons.longest_block(a, b, native=False) == want
        want = jcons.assemble_fragments(frags)
        assert tcons.assemble_fragments(frags) == want, frags
        assert tcons.assemble_fragments(frags, native=False) == want
    assert tcons.assemble_fragments(["ACGT"]) == ""  # the first-fragment quirk
    for trial in range(40):
        n_wins = int(rng.integers(1, 12))
        cap = 4 * int(rng.integers(1, 24))
        rows = np.full((n_wins, cap), -1, np.int8)
        counts = rng.integers(0, cap + 1, n_wins).astype(np.int32)
        for w, m in enumerate(counts):
            rows[w, :m] = rng.integers(0, 4, m)
        packed = tbs.pack_labels2(torch.from_numpy(rows)).numpy()
        got = tcons.assemble_read_packed2(packed, counts)
        assert got == jcons.assemble_read_packed2(packed, counts), trial
        assert got == tcons.assemble_fragments(
            tbs.rows_to_seqs(tbs.unpack_labels2(packed, counts)),
            native=False)


def test_packing_and_crop_spans_match_jax(rng):
    """Compaction and 2-bit packing give the JAX bytes; the crop's kept
    spans, computed by the port, partition ``[0, len)`` exactly for the
    lengths and geometries of the JAX package's own partition test."""
    import jax.numpy as jnp
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.ops import beam_search as tbs

    for cap, width in ((0, 64), (4, 64), (32, 64), (64, 64), (128, 256)):
        rev = rng.integers(0, 4, (9, width)).astype(np.int32)
        rev[rng.random(rev.shape) < rng.random((9, 1))] = -1
        got = tpipe._compact_pack2(torch.from_numpy(rev), cap).numpy()
        assert np.array_equal(got, np.asarray(
            jpipe._compact_pack2(jnp.asarray(rev), cap))), cap
        counts = np.minimum((rev >= 0).sum(1), cap)
        assert np.array_equal(tbs.unpack_labels2(got, counts),
                              jbs.unpack_labels2(got, counts))
        comp = tbs.unpack_labels2(got, counts)
        assert np.array_equal(
            tbs.pack_labels2(torch.from_numpy(comp)).numpy(),
            np.asarray(jbs.pack_labels2(jnp.asarray(comp))))

    rf = 253
    lengths = (200, 900, 1023, 1024, 1025, 1151, 1152, 1153, 2047, 2048,
               2049, 4001, 5120, 13327)
    for window, step in ((1024, 128), (512, 64), (2048, 256), (1024, 256)):
        for stride in (1, 2, 4):
            off = window - (stride + 1) * step
            if off < rf - 1:
                continue  # the constructor would take a smaller stride
            geom = tpipe._chunk_geometry(
                torch.tensor(lengths), window=window, step=step,
                stride=stride,
                max_windows=max((n - window) // step + 2 for n in lengths))
            lo, hi = tpipe._crop_spans(geom, step=step, crop_off=off,
                                       stride=stride)
            for r, n in enumerate(lengths):
                covered = []
                for d in range(int(geom.n_dec[r])):
                    s = int(geom.starts[r, d])
                    covered.extend(range(s + int(lo[r, d]),
                                         s + int(hi[r, d])))
                assert covered == list(range(n)), (window, step, stride, n)
