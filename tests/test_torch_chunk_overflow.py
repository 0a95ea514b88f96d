"""The fused chunk paths refuse a window whose labels overflow the
compaction cap, as the JAX package does, instead of cutting it short.
``torch`` and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import pytest

from tests.test_torch_chunk_port import chunk_reads
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"


def test_chunk_max_lab_overflow_raises():
    """``chunk_max_lab=2`` rounds down to a cap of 0 labels a window: the
    first window with a label raises, naming the option."""
    from radian_tpu_torch import pipeline as tpipe

    bc = tpipe.load_basecaller(TRAINED, options=tpipe.BasecallOptions(
        decode_type="chunk", chunk_prep="fused", read_batch=1,
        bucket_quantum=1024, chunk_max_lab=2), device="cpu")
    assert bc.path.use_chunk_fused and bc.path.chunk_cap == 0
    with pytest.raises(RuntimeError, match="chunk_max_lab"):
        bc.basecall_signals([chunk_reads()[1]])


def test_chunk_overflow_uses_effective_cap():
    """``chunk_max_lab=6`` packs to an effective 4-slot cap (a multiple of
    4): a window of 5 labels was cut on the device, so the check compares
    against the effective cap, not the option; windows past a read's
    count and skipped rows are not checked."""
    import numpy as np

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.models.sig2seq import build_model

    bc = tpipe.Basecaller(build_model().state_dict(),
                          options=tpipe.BasecallOptions(
                              decode_type="chunk", chunk_prep="fused",
                              chunk_max_lab=6), device="cpu")
    assert bc.path.chunk_cap == 4

    def render(n_lab, results, mads=(1.0,), n_dec=(2,)):
        record = [np.array(mads, np.float32),
                  np.zeros((len(mads), 2, 1), np.uint8),
                  np.array(n_dec), np.array(n_lab, np.int32)]
        bc.path.render(bc, tpipe.ReadBatch([0], 1024, 1), record, results)

    with pytest.raises(RuntimeError, match="effective compaction cap 4"):
        render([[5, 3]], {})
    results = {}
    render([[4, 9]], results, n_dec=(1,))
    assert results == {0: ""}
    skipped = {}
    render([[9, 9]], skipped, mads=(0.0,))
    assert skipped == {}
