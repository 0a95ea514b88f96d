"""The transformer-CRF model through the ``Basecaller`` on the CPU, at
Bonito's chunk geometry (12,288 samples overlapping by 600) on a narrow
model (``tests/torch_tx_tiny.py``): its strings against the plain
reference's chunk, Viterbi and stitch; and radian's path as before
without ``model.type``.  ``torch`` and the port are imported inside the
tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)
from tests.torch_tx_tiny import config

# 1 sample (MAD 0: skipped); one short of a chunk (tiled); one chunk;
# one over (stub 1: two chunks); stub > 0 over three chunks; 13 chunks
LENGTHS = (1, 12287, 12288, 12289, 26000, 3000, 140900)
# the port's float32 scores against the reference's from the raw reads:
# the same arithmetic in another sum order (tests/test_torch_tx_forward.py)
SCORE_ATOL = 1e-4


def test_basecaller_strings_match_reference():
    """Batches of 4 chunks, so reads span batches and a call ends on a
    partial batch: each string is the reference's Viterbi and stitch of
    the port's own scores, and those scores are the reference's from the
    raw read."""
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.ops import chunking
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

    cfg = config()
    weights = ref.bonito_init(cfg["model"], 5)
    bc = Basecaller({k: torch.from_numpy(v) for k, v in weights.items()},
                    DotDict(cfg), None, BasecallOptions(chunk_batch=4),
                    torch.float32, device="cpu")
    p = bc.path
    assert (p.size, p.overlap, p.step, p.state_len) == (12288, 600, 6, 5)
    rng = np.random.default_rng(1)
    reads = [(rng.normal(size=n) * 80 + 500).astype(np.int16)
             for n in LENGTHS]
    got = bc.basecall_signals(reads)
    plan = bc.chunk_batches(reads)
    assert [b.n_chunks for _, b in plan][:-1] == [4] * (len(plan) - 1)
    assert plan[-1][1].n_chunks < 4
    scores: dict[int, list] = {}
    for idxs, b in plan:
        s, _ = bc.crf_scores(*bc.pad_batch(idxs, b, reads))
        assert s.shape == (4, 2048, 5120)
        for r in range(b.n_chunks):
            scores.setdefault(b.reads[b.row_read[r]], []).append(s[r])
    p = ref.params(weights, "cpu")
    for i, read in enumerate(reads):
        n = len(read)
        assert len(scores[i]) == len(ref.chunk_starts(n, 12288, 600))
        assert chunking.kept_steps(n, 12288, 600, 6) == ref.kept_steps(
            n, 12288, 600, 6)
        if ref.mad_normalise(read, 4.0) is None:
            assert got[i] is None
            continue
        mine = torch.stack(scores[i])
        want = ref.stitch(ref.viterbi(mine, 5).numpy(), n, 12288, 600, 6)
        assert got[i] == want, i
        theirs = ref.read_scores(p, cfg["model"], read, 12288, 600, 4.0,
                                 "cpu")
        assert float((theirs - mine).abs().max()) <= SCORE_ATOL
    # a short read keeps its first length // 6 steps
    assert 0 < len(got[1]) <= 12287 // 6 and len(got[5]) <= 3000 // 6


def test_radian_path_unchanged_without_model_type():
    """No ``model.type``: radian's SigToSeq, its Basecaller and its
    strings, as its own forward and decode give them; an unknown type
    and an LM or a mesh with the CRF model are refused."""
    import torch

    from radian_tpu_torch.config import DotDict, default_config
    from radian_tpu_torch.lm.kmer import KmerLM
    from radian_tpu_torch.models.sig2seq import SigToSeq, build_model
    from radian_tpu_torch.ops.beam_search import labels_to_seq, unpack_labels
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.pipeline import (
        Basecaller,
        BasecallOptions,
        GlobalPath,
    )

    cfg = default_config()
    cfg.model.tcn.nb_filters = 16
    cfg.model.tcn.dilations = [1, 2]
    cfg.model.relu_units = 16
    model = build_model(cfg)
    assert type(model) is SigToSeq
    params = model.state_dict()
    bc = Basecaller(params, cfg, None, BasecallOptions(read_batch=2),
                    device="cpu")
    assert type(bc.path) is GlobalPath and bc.path.use_fullread
    rng = np.random.default_rng(2)
    reads = [(rng.normal(size=n) * 80 + 500).astype(np.int16)
             for n in (700, 1500, 900)]
    got = bc.basecall_signals(reads)
    for idxs, b in bc.batches(reads):
        mats, t_reads, _ = bc.forward(*bc.pad_batch(idxs, b, reads))
        packed, _ = bc.decode(mats, t_reads)
        rev = unpack_labels(packed.numpy())
        for j, i in enumerate(idxs):
            assert got[i] == labels_to_seq(rev[j])
    bad = DotDict(cfg.to_dict())
    bad.model.type = "other"
    with pytest.raises(ValueError, match="model.type"):
        build_model(bad)
    tx = DotDict(config())
    tx_params = build_model(tx).state_dict()
    with pytest.raises(ValueError, match="without an LM"):
        lm = KmerLM(3, np.full((64, 4), 0.25, np.float32),
                    np.full(64, np.log(4), np.float32))
        Basecaller(tx_params, tx, lm, BasecallOptions(context_len=3),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        Basecaller(tx_params, tx, None, BasecallOptions(read_batch=2),
                   mesh=make_mesh(data=2, devices=["cpu", "cpu"]),
                   device="cpu")
