"""The port's ``ShardDataset`` against the JAX package's: over the same
shard files and seed, the same batch sequence, in train mode (shard
shuffle, 3-way interleave, a streaming shuffle buffer smaller than the
data, repeat) and in val mode (one ordered pass, the short final batch
kept).  ``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import itertools

import numpy as np
import pytest

from radian_tpu.io.tfrecord import write_shard
from radian_tpu.train import data as jdata
from radian_tpu.utils.synthetic import kmer_level_table, synth_windows
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _shards(root, n_shards=5, per_shard=13, window=128):
    rng = np.random.default_rng(11)
    levels = kmer_level_table(rng)
    (root / "train").mkdir()
    for s in range(n_shards):
        b = synth_windows(rng, per_shard, window=window, levels=levels,
                          max_label=32)
        write_shard(root / "train" / f"shard-{s}.tfrecords", [
            {"signal": b["signal"][i],
             "label": b["labels"][i][: b["label_length"][i]].astype(
                 np.float32),
             "signal_length": window,
             "label_length": int(b["label_length"][i])}
            for i in range(per_shard)])
    return root


@pytest.mark.parametrize("train", [True, False])
def test_shard_dataset_batches_equal_jax(tmp_path, train):
    from radian_tpu_torch.train import data as tdata

    root = _shards(tmp_path)
    files = tdata.list_shards(root, "train")
    assert files == jdata.list_shards(root, "train") and len(files) == 5
    for idx, count in ((0, 2), (1, 2), (0, 1)):
        assert (tdata.host_shard_files(files, idx, count)
                == jdata.host_shard_files(files, idx, count))
    kw = dict(batch_size=6, train=train, window=128, max_label=32, seed=3,
              interleave_cycle=3, shuffle_buffer=20, read_block=4)
    want = jdata.ShardDataset(files, **kw)
    got = tdata.ShardDataset(files, **kw)
    assert got.count_examples() == want.count_examples() == 65
    # train mode repeats forever: 25 batches span ~2.3 passes
    n = 25 if train else None
    wb = list(itertools.islice(iter(want), n))
    gb = list(itertools.islice(iter(got), n))
    assert len(gb) == len(wb) == (25 if train else 11)
    if not train:
        assert gb[-1]["signal"].shape[0] == 5  # 65 = 10·6 + 5, kept
    for g, w in zip(gb, wb):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
