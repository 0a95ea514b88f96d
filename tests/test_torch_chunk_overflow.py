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
    assert bc.use_chunk_fused and bc.chunk_cap == 0
    with pytest.raises(RuntimeError, match="chunk_max_lab"):
        bc.basecall_signals([chunk_reads()[1]])


def test_chunk_overflow_uses_effective_cap():
    """``chunk_max_lab=6`` packs to an effective 4-slot cap (a multiple of
    4): a window of 5 labels was cut on the device, so the check compares
    against the effective cap, not the option; windows past a read's
    count and skipped rows are not checked."""
    import torch

    from radian_tpu_torch import pipeline as tpipe
    from radian_tpu_torch.models.sig2seq import build_model

    bc = tpipe.Basecaller(build_model().state_dict(),
                          options=tpipe.BasecallOptions(
                              decode_type="chunk", chunk_prep="fused",
                              chunk_max_lab=6), device="cpu")
    assert bc.chunk_cap == 4

    def pending(n_lab, mads=(1.0,), n_dec=(2,)):
        return ("chunk", [0], torch.tensor(mads),
                torch.zeros((len(mads), 2, 1), dtype=torch.uint8),
                torch.tensor(n_dec), torch.tensor(n_lab, dtype=torch.int32))

    with pytest.raises(RuntimeError, match="effective compaction cap 4"):
        bc._collect_batch(pending([[5, 3]]), {})
    results = {}
    bc._collect_batch(pending([[4, 9]], n_dec=(1,)), results)
    assert results == {0: ""}
    skipped = {}
    bc._collect_batch(pending([[9, 9]], mads=(0.0,)), skipped)
    assert skipped == {}
