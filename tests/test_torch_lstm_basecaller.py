"""The LSTM-CRF model through the ``Basecaller`` on the CPU, at Bonito's
v4 chunk geometry (9,996 samples overlapping by 498) on a narrow model
(``tests/torch_lstm_tiny.py``): its strings against the plain
reference's chunk, Viterbi and stitch; and the transformer-CRF model's
path and messages as before.  ``torch`` and the port are imported inside
the tests (see ``tests/torch_one_cpu.py``).
"""

import numpy as np
import pytest

from tests.torch_lstm_tiny import config
from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

# 1 sample (MAD 0: skipped); one short of a chunk (tiled); one chunk;
# one over (a stub of 1: two chunks); a stub over three chunks; a short
# read; 12 chunks
LENGTHS = (1, 9995, 9996, 9997, 21000, 3000, 105000)
SIZE, OVERLAP, STEP = 9996, 498, 6
# the port's float32 scores against the reference's from the raw reads:
# the same arithmetic in another sum order (tests/test_torch_lstm_forward
# .py: within 5e-7 of the largest score there)
SCORE_ATOL = 1e-5


def test_basecaller_strings_match_reference():
    """Batches of 4 chunks, so reads span batches and a call ends on a
    partial batch: each string is the reference's Viterbi and stitch of
    the port's own scores, and those scores are the reference's from the
    raw read."""
    import torch

    from benchmark.core import reference_lstm_crf as ref
    from benchmark.core import reference_tx_crf as tx
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.ops import chunking
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions, CrfPath

    cfg = config()
    weights = ref.bonito_lstm_init(cfg["model"], 5)
    bc = Basecaller({k: torch.from_numpy(v) for k, v in weights.items()},
                    DotDict(cfg), None, BasecallOptions(chunk_batch=4),
                    torch.float32, device="cpu")
    p = bc.path
    assert type(p) is CrfPath and p.kind == "bonito_lstm_crf"
    assert (p.size, p.overlap, p.step, p.state_len) == (SIZE, OVERLAP,
                                                        STEP, 5)
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
        assert s.shape == (4, SIZE // STEP, 5120)
        for r in range(b.n_chunks):
            scores.setdefault(b.reads[b.row_read[r]], []).append(s[r])
    p = tx.params(weights, "cpu")
    for i, read in enumerate(reads):
        n = len(read)
        assert len(scores[i]) == len(tx.chunk_starts(n, SIZE, OVERLAP))
        assert chunking.kept_steps(n, SIZE, OVERLAP, STEP) == tx.kept_steps(
            n, SIZE, OVERLAP, STEP)
        if tx.mad_normalise(read, 4.0) is None:
            assert got[i] is None
            continue
        mine = torch.stack(scores[i])
        want = tx.stitch(tx.viterbi(mine, 5).numpy(), n, SIZE, OVERLAP, STEP)
        assert got[i] == want, i
        theirs = ref.read_scores(p, cfg["model"], read, SIZE, OVERLAP, 4.0,
                                 "cpu")
        assert float((theirs - mine).abs().max()) <= SCORE_ATOL
    # a short read keeps its first length // 6 steps
    assert 0 < len(got[1]) <= 9995 // 6 and len(got[5]) <= 3000 // 6
    # the reference's own basecall of a read of two chunks, end to end
    assert ref.basecall(p, cfg["model"], reads[3], SIZE, OVERLAP, 4.0,
                        "cpu") == got[3]


def test_both_families_take_the_crf_path_with_their_own_messages():
    """Each CRF family's config takes ``CrfPath``, and every refusal
    names its own ``model.type``: for ``bonito_tx_crf`` the messages it
    has always had, word for word.  An unknown type names the families."""
    for kind in ("bonito_tx_crf", "bonito_lstm_crf"):
        _family_takes_the_crf_path(kind)


def _family_takes_the_crf_path(kind):
    import torch

    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.lm.kmer import KmerLM
    from radian_tpu_torch.models.sig2seq import CRF_FAMILIES, build_model
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions, CrfPath
    from tests import torch_lstm_tiny, torch_tx_tiny

    tiny = {"bonito_tx_crf": torch_tx_tiny, "bonito_lstm_crf":
            torch_lstm_tiny}[kind]
    cfg = DotDict(tiny.config())
    model = build_model(cfg)
    assert isinstance(model, CRF_FAMILIES[kind].model)
    params = model.state_dict()
    weights = CRF_FAMILIES[kind].init(cfg.model, 3)
    assert list(weights) == list(params)
    bc = Basecaller(params, cfg, None, BasecallOptions(chunk_batch=2),
                    device="cpu")
    assert type(bc.path) is CrfPath and bc.path.kind == kind

    def refused(exc, message, **kw):
        with pytest.raises(exc) as e:
            Basecaller(params, kw.pop("config", cfg), kw.pop("lm", None),
                       device="cpu", **kw)
        assert str(e.value) == message

    lm = KmerLM(3, np.full((64, 4), 0.25, np.float32),
                np.full(64, np.log(4), np.float32))
    refused(ValueError, f"a {kind} model decodes without an LM", lm=lm,
            options=BasecallOptions(context_len=3))
    refused(NotImplementedError,
            f"a {kind} model runs on one device, not a mesh",
            options=BasecallOptions(read_batch=2),
            mesh=make_mesh(data=2, devices=["cpu", "cpu"]))
    refused(ValueError, "decode_type='chunk' is radian's; a "
            f"{kind} model chunks by its config's basecaller section",
            options=BasecallOptions(decode_type="chunk"))
    bare = DotDict({"model": cfg.model.to_dict()})
    refused(ValueError, f"a {kind} config needs a basecaller section "
            "(chunksize, overlap)", config=bare)
    with pytest.raises(NotImplementedError) as e:
        bc.basecall_stream([], None)
    assert str(e.value) == f"streaming a {kind} model: use basecall_signals"
    bad = DotDict({"model": {**cfg.model.to_dict(), "type": "other"}})
    with pytest.raises(ValueError, match="bonito_tx_crf.*bonito_lstm_crf"):
        build_model(bad, torch.float32)
