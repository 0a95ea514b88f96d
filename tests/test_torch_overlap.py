"""The ``Basecaller``'s two-deep dispatch loop on the CPU: the order of
its launches and renders, and the strings of a call over several
batches.

A card's record comes back behind batch k+1's work, so the render of
batch k must come after batch k+1 is launched, and the streaming flush
(``collected``) must still follow each render in order.  The strings of
a call over several batches are those of the same reads sent one batch
a call, where nothing overlaps.  ``torch`` and the port are imported
inside the tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

LENGTHS = (300, 350, 400, 450, 520, 600, 700, 650)
OPTS = dict(read_batch=2, chunk_len=256, step_size=32, bucket_quantum=256,
            context_len=3)


def _tiny_config():
    from radian_tpu_torch.config import default_config

    cfg = default_config()
    cfg.model.tcn.nb_filters = 8
    cfg.model.tcn.dilations = [1, 2]
    cfg.model.relu_units = 8
    return cfg


def _reads():
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_read

    rng = np.random.default_rng(21)
    levels = kmer_level_table(rng)
    out = []
    for n in LENGTHS:
        sig, _ = synth_read(rng, n // 8 + 40, levels)
        out.append((sig[:n] * 60 + 500).astype(np.int16))
    return out


def _basecaller(decode_type: str, lm=None):
    import torch

    from radian_tpu_torch import pipeline as tp
    from radian_tpu_torch.models.sig2seq import build_model

    cfg = _tiny_config()
    torch.manual_seed(0)
    params = build_model(cfg).state_dict()
    return tp.Basecaller(params, cfg, lm, tp.BasecallOptions(
        decode_type=decode_type, **OPTS), device="cpu")


def test_render_follows_the_next_launch_and_precedes_its_flush():
    """A recording stand-in for the path's ``run`` and ``render``: batch
    k is rendered only after batch k+1 is launched, the last batch once
    no batch is left, and ``collected`` follows each render, in order;
    each render gets its own batch's record."""
    import torch

    bc = _basecaller("global")
    real = bc.path
    reads = _reads()
    plan = real.plan(bc, reads)
    assert len(plan) >= 4
    batch_of = {b.reads[0]: k for k, (_, b) in enumerate(plan)}
    log = []

    class Recording:
        render_span, render_on_device = real.render_span, False

        def run(self, _bc, batch, padded, lengths):
            k = batch_of[batch.reads[0]]
            log.append(("run", k))
            return (torch.full((1,), k),)

        def render(self, _bc, batch, record, results):
            k = batch_of[batch.reads[0]]
            assert record[0].tolist() == [k]
            log.append(("render", k))
            for i in batch.reads:
                results[i] = str(k)

    bc.path = Recording()
    results = [None] * len(reads)
    bc._run_batches(((reads, b) for _, b in plan), results,
                    lambda batch: log.append(
                        ("collected", batch_of[batch.reads[0]])))
    n = len(plan)
    want = [("run", 0)]
    for k in range(n):
        if k + 1 < n:
            want.append(("run", k + 1))
        want += [("render", k), ("collected", k)]
    assert log == want
    assert all(results[i] == str(k) for k, (idxs, _) in enumerate(plan)
               for i in idxs)


@pytest.mark.parametrize("decode_type", ["global", "chunk"])
def test_call_over_batches_matches_one_batch_a_call(decode_type):
    """A tiny seeded radian model (global with a 3-mer LM; chunk
    'fused'): one call over every batch gives exactly the strings of the
    same reads sent one batch a call."""
    from radian_tpu_torch.lm import kmer

    lm = None
    if decode_type == "global":
        lm = kmer.build_dense_tables(kmer.random_kmer_model(
            np.random.default_rng(5), context_len=3, n_contexts=40), 3)
    bc = _basecaller(decode_type, lm)
    reads = _reads()
    batches = bc.batches(reads)
    assert len(batches) >= 4
    got = bc.basecall_signals(reads)
    want = [None] * len(reads)
    for idxs, _ in batches:
        for i, seq in zip(idxs, bc.basecall_signals([reads[i]
                                                     for i in idxs])):
            want[i] = seq
    assert got == want
    assert all(s for s in got)
