"""The port's training-data generators and TFRecord codec against the
JAX package's.

From the same ``default_rng`` seed, ``markov_labels``, ``markov_kmer_lm``,
``synth_windows`` and ``synth_norm_windows`` give the same arrays bit for
bit; a shard the JAX package writes reads back equal in the port (whole
and streamed), the port writes the JAX package's bytes, and the port's
native codec (``csrc/tfrecord.cc``) and its plain Python one agree both
ways.  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import numpy as np

from radian_tpu.io import tfrecord as jtf
from radian_tpu.utils import synthetic as jsyn
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRANS = np.asarray([[0.7, 0.1, 0.1, 0.1], [0.1, 0.1, 0.7, 0.1],
                    [0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_generators_equal_jax():
    from radian_tpu_torch.utils import synthetic as tsyn

    def both(fn, *args, **kw):
        return (getattr(jsyn, fn)(np.random.default_rng(7), *args, **kw),
                getattr(tsyn, fn)(np.random.default_rng(7), *args, **kw))

    want, got = both("markov_labels", 200, TRANS)
    np.testing.assert_array_equal(got, want)
    jlm, tlm = jsyn.markov_kmer_lm(TRANS, 5), tsyn.markov_kmer_lm(TRANS, 5)
    np.testing.assert_array_equal(tlm.probs, jlm.probs)
    np.testing.assert_array_equal(tlm.entropy, jlm.entropy)
    assert tlm.context_len == jlm.context_len == 5
    want, got = both("synth_read", 50, jsyn.kmer_level_table(
        np.random.default_rng(1)), trans=TRANS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the bench's traffic (dwell 40 +- 8 a base) and the tests' (dwell 9)
    _equal(*both("synth_windows", 6, window=1024, dwell_mean=40.0,
                 dwell_std=8.0))
    _equal(*both("synth_windows", 5, window=256, max_label=64))
    _equal(*both("synth_norm_windows", 4, window=256))
    _equal(*both("synth_norm_windows", 3, window=512, trans=TRANS,
                 dwell_mean=12.0))


def test_shards_equal_jax(tmp_path):
    from radian_tpu_torch.io import tfrecord as ttf
    from radian_tpu_torch.utils.synthetic import synth_windows

    b = synth_windows(np.random.default_rng(3), 37, window=256)
    exs = [{"signal": b["signal"][i],
            "label": b["labels"][i][: b["label_length"][i]].astype(np.float32),
            "signal_length": 256, "label_length": int(b["label_length"][i])}
           for i in range(37)]
    jtf.write_shard(tmp_path / "jax.tfrecords", exs)
    ttf.write_shard(tmp_path / "native.tfrecords", exs)
    ttf.write_shard(tmp_path / "plain.tfrecords", exs, use_native=False)
    raw = (tmp_path / "jax.tfrecords").read_bytes()
    assert (tmp_path / "native.tfrecords").read_bytes() == raw
    assert (tmp_path / "plain.tfrecords").read_bytes() == raw

    path = tmp_path / "jax.tfrecords"
    want = jtf.read_shard(path, 256, 64, use_native=False)
    np.testing.assert_array_equal(want[0], b["signal"])
    np.testing.assert_array_equal(want[3], b["label_length"])
    for native in (True, False):
        for crc in (True, False):
            got = ttf.read_shard(path, 256, 64, verify_crc=crc,
                                 use_native=native)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        blocks = list(ttf.iter_shard(path, 256, 64, block=10,
                                     use_native=native))
        assert [len(x[0]) for x in blocks] == [10, 10, 10, 7]
        jblocks = list(jtf.iter_shard(path, 256, 64, block=10))
        for g, w in zip(blocks, jblocks):
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi, wi)
    # a corrupt record raises in both codecs
    bad = bytearray(raw)
    bad[100] ^= 0xFF
    (tmp_path / "bad.tfrecords").write_bytes(bytes(bad))
    for native in (True, False):
        try:
            ttf.read_shard(tmp_path / "bad.tfrecords", 256, 64,
                           verify_crc=True, use_native=native)
        except ValueError:
            continue
        raise AssertionError(f"corrupt shard read (native={native})")
