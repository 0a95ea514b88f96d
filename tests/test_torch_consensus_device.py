"""The port's device consensus against the JAX package's, on the CPU.

``consensus_votes`` and ``assemble_fragments_device`` on seeded
overlapping fragments (mutated copies of windows of one sequence), on a
case whose running position goes negative (JAX's scatter wraps such a
vote to the end of the matrix, and the port does too), all of those
reads in one padded ``assemble_fragments_device_batch`` call (and in
calls of one read each), and chunk mode
end to end with ``consensus='device'`` on the 'fused' and 'windows'
paths: the votes, the totals and the strings are exactly the JAX
package's.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from radian_tpu import pipeline as jpipe
from radian_tpu.models.checkpoint import load_params_npz as jload
from radian_tpu.ops import consensus_device as jcd
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def _fragments(rng, n_frags, length, stride):
    """Overlapping windows of one random sequence, each with a few
    substitutions and indels, some cut short."""
    seq = rng.choice(list("ACGT"), n_frags * stride + length)
    frags = []
    for i in range(n_frags):
        f = list(seq[i * stride:i * stride + length])
        for _ in range(3):
            j = int(rng.integers(len(f)))
            op = rng.integers(3)
            if op == 0:
                f[j] = "ACGT"[int(rng.integers(4))]
            elif op == 1:
                del f[j]
            else:
                f.insert(j, "ACGT"[int(rng.integers(4))])
        frags.append("".join(f[:int(rng.integers(length // 2, len(f) + 1))]))
    return frags


def _codes(frags):
    l = max(len(f) for f in frags)
    arr = np.full((len(frags), l), -1, np.int32)
    for i, f in enumerate(frags):
        arr[i, :len(f)] = ["ACGT".index(b) for b in f]
    return arr, np.array([len(f) for f in frags], np.int32)


def test_votes_and_strings_match_jax_with_the_wrap(monkeypatch):
    import torch

    from radian_tpu_torch.ops import consensus_device as tcd
    from radian_tpu_torch.ops.consensus_device import (
        assemble_fragments_device,
        assemble_fragments_device_batch,
        consensus_votes,
    )

    rng = np.random.default_rng(0)
    cases = [_fragments(rng, n, 40, s) for n, s in ((6, 13), (9, 7), (2, 30))]
    cases += [["ACGTTGCA"], ["", "ACG", "ACGTAC"], []]
    # fragment 1 starts 6 bases before fragment 0: its first votes land at
    # positions -6..-1, which JAX's scatter wraps to the last columns
    wrap = ["TTGCATGCAAGT", "CCGATCTTGCATGCAAGT"]
    cases.append(wrap)
    wants = []
    for frags in cases:
        want = jcd.assemble_fragments_device(frags)
        got = assemble_fragments_device(frags, device="cpu")
        assert got == want, frags
        wants.append(want)
    # one padded call over reads of different fragment counts, lengths
    # and displacement ranges, the wrap case among them
    assert assemble_fragments_device_batch(cases, device="cpu") == wants
    monkeypatch.setattr(tcd, "MATCH_ELEMENTS", 1)  # one read a call
    assert assemble_fragments_device_batch(cases, device="cpu") == wants
    arr, lens = _codes(wrap)
    kw = dict(max_disp=19, out_len=2 * 18 + 1, min_disp=-8)
    want_v, want_t = jcd.consensus_votes(jnp.asarray(arr), jnp.asarray(lens),
                                         **kw)
    got_v, got_t = consensus_votes(torch.from_numpy(arr),
                                   torch.from_numpy(lens), **kw)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert int(got_t) == int(want_t) == 12
    assert got_v[:, -6:].sum() == 6  # the wrapped votes
    for frags in cases[:3]:
        arr, lens = _codes(frags)
        kw = dict(max_disp=41, out_len=len(frags) * arr.shape[1] + 1,
                  min_disp=-10)
        want_v, want_t = jcd.consensus_votes(
            jnp.asarray(arr), jnp.asarray(lens), **kw)
        got_v, got_t = consensus_votes(torch.from_numpy(arr),
                                       torch.from_numpy(lens), **kw)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert int(got_t) == int(want_t)
    # a batch's votes, read by read, are each read's JAX votes: the wrap
    # read's negative positions wrap by its own width, not the batch's
    reads = [wrap, cases[0], cases[4]]
    codes = [_codes(frags) for frags in reads]
    f = max(len(x) for x, _ in codes)
    l = max(x.shape[1] for x, _ in codes)
    arr = np.full((len(reads), f, l), -1, np.int32)
    lens = np.zeros((len(reads), f), np.int32)
    for r, (x, n) in enumerate(codes):
        arr[r, :len(x), :x.shape[1]] = x
        lens[r, :len(n)] = n
    lo, hi = [-8, -10, -9], [19, 41, 7]
    out = [len(frags) * x.shape[1] + 1 for frags, (x, _) in zip(reads, codes)]
    got_v, got_t = tcd.consensus_votes_batch(
        torch.from_numpy(arr), torch.from_numpy(lens), min_disp=lo,
        max_disp=hi, out_len=out)
    for r, (x, n) in enumerate(codes):
        want_v, want_t = jcd.consensus_votes(
            jnp.asarray(x), jnp.asarray(n), max_disp=hi[r], out_len=out[r],
            min_disp=lo[r])
        np.testing.assert_array_equal(got_v[r, :, :out[r]].numpy(),
                                      np.asarray(want_v))
        assert got_v[r, :, out[r]:].sum() == 0
        assert int(got_t[r]) == int(want_t)


def test_chunk_device_consensus_matches_jax():
    """Chunk mode with ``consensus='device'``: the 'fused' and 'windows'
    paths give the JAX strings (reads of 900 to 4,000 samples, one with
    MAD = 0; four good reads in one batch, so the stitch runs in the
    thread pool), and differ from the reference stitch's."""
    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(11)
    levels = kmer_level_table(rng)
    sigs = [(synth_read(rng, n // 8 + 40, levels)[0][:n] * 60 + 500
             ).astype(np.int16) for n in (900, 2500, 4000, 1200)]
    sigs.insert(1, np.full(1500, 480, np.int16))
    params = params_from_flax(load_params_npz(TRAINED))
    kw = dict(decode_type="chunk", read_batch=5, bucket_quantum=4096)
    got = {}
    for prep in ("fused", "windows"):
        want = jpipe.Basecaller(jload(TRAINED), options=jpipe.BasecallOptions(
            decode_backend="xla", chunk_prep=prep, consensus="device", **kw)
        ).basecall_signals(sigs)
        tbc = tpipe.Basecaller(params, options=tpipe.BasecallOptions(
            chunk_prep=prep, consensus="device", **kw), device="cpu")
        got[prep] = tbc.basecall_signals(sigs)
        assert got[prep] == want, prep
        assert got[prep][1] is None and all(got[prep][i] for i in (0, 2, 3, 4))
    assert got["fused"] == got["windows"]
    ref = tpipe.Basecaller(params, options=tpipe.BasecallOptions(
        chunk_prep="fused", **kw), device="cpu").basecall_signals(sigs)
    assert ref != got["fused"]
