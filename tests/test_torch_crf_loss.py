"""The CTC-CRF loss's CPU path (``radian_tpu_torch/ops/crf_loss.py``)
against the benchmark's plain reference (``benchmark/core/
reference_crf_loss.py``) and against every path of a tiny lattice; and
the CRF head's differentiable form against its in-place one.  ``torch``
and the port are imported inside the tests (see
``tests/torch_one_cpu.py``).
"""

import itertools

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)


def _brute_force(sc: np.ndarray, bases: np.ndarray, state_len: int):
    """``(logZ, logZ_target)`` of one row ``[T, 4^L·5]`` by summing over
    every path: a start state, then each step a stay or a move into a
    new state whose bases shift the oldest out."""
    t_len = sc.shape[0]
    s_n = 4 ** state_len
    q = s_n // 4
    want = [int("".join(map(str, bases[j:j + state_len])), 4)
            for j in range(len(bases) - state_len + 1)]
    full, target = [], []
    for start in range(s_n):
        for choice in itertools.product(range(5), repeat=t_len):
            s, total, seq = start, 0.0, [start]
            for t, c in enumerate(choice):
                if c:  # the move emitting base c - 1 into (s % q)·4 + c - 1
                    prev = s
                    s = (s % q) * 4 + c - 1
                    total += sc[t, s * 5 + 1 + prev // q]
                    seq.append(s)
                else:
                    total += sc[t, s * 5]
            full.append(total)
            if seq == want:
                target.append(total)
    lse = lambda v: float(np.logaddexp.reduce(np.asarray(v, np.float64)))
    return lse(full), lse(target)


def test_loss_and_gradient_equal_the_reference():
    """Rows of 3 to 40 bases (one of exactly ``state_len``, the shortest
    allowed) on seeded scores in the head's range, two of them filler
    rows of weight 0: the loss and its gradient equal the reference's
    (autograd through its own step loops).  Both sum in float32 over
    60 steps from per-step normalised values, so the losses (~1-40)
    agree to 1e-5 relative and the gradient's entries (at most 1/3) to
    1e-6.  Every path of a 4-step, 16-state lattice gives the same
    ``(logZ − logZ_target) / n`` (float64 sums; 1e-5).  A filler row's
    gradient is exactly 0; a target shorter than ``state_len``, or one
    that the steps cannot reach, is refused."""
    import pytest
    import torch

    from benchmark.core import reference_crf_loss as ref
    from radian_tpu_torch.ops.crf_loss import crf_loss

    gen = torch.Generator().manual_seed(5)
    for state_len, t_len, lengths in ((3, 60, [3, 12, 40, 25, 7, 30]),
                                      (2, 60, [2, 31, 9, 17, 5, 60])):
        s_n = 4 ** state_len
        moves = 5.0 * torch.tanh(1.5 * torch.randn(len(lengths), t_len, s_n,
                                                   4, generator=gen))
        scores = torch.cat([torch.full_like(moves[..., :1], 2.0), moves],
                           -1).reshape(len(lengths), t_len, -1)
        targets = torch.randint(0, 4, (len(lengths), max(lengths)),
                                generator=gen)
        lens = torch.tensor(lengths)
        weight = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
        got_sc = scores.clone().requires_grad_(True)
        got = crf_loss(got_sc, targets, lens, state_len)
        (got_g,) = torch.autograd.grad((got * weight).sum(), got_sc)
        want_sc = scores.clone().requires_grad_(True)
        want = ref.crf_loss(want_sc, targets, lens, state_len)
        (want_g,) = torch.autograd.grad((want * weight).sum(), want_sc)
        assert got.dtype == torch.float32 and got.shape == (len(lengths),)
        assert torch.allclose(got.detach(), want.detach(), rtol=1e-5,
                              atol=0)
        assert float((got_g - want_g).abs().max()) <= 1e-6
        assert float(want_g.abs().max()) > 1e-2
        assert not got_g[weight == 0].any()

    sc = 5.0 * torch.tanh(torch.randn(1, 4, 16 * 5, generator=gen))
    bases = np.array([1, 3, 0, 2])
    logz, logz_t = _brute_force(sc[0].double().numpy(), bases, 2)
    got = crf_loss(sc, torch.from_numpy(bases)[None], torch.tensor([4]), 2)
    assert abs(float(got[0]) - (logz - logz_t) / 4) <= 1e-5

    short = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="at least 3"):
        crf_loss(torch.zeros(2, 10, 64 * 5), short, torch.tensor([3, 2]), 3)
    with pytest.raises(ValueError, match="steps"):
        crf_loss(torch.zeros(2, 4, 64 * 5), short, torch.tensor([8, 3]), 3)


def test_crf_head_differentiable_form_equals_in_place():
    """With grad enabled the head concatenates its blank column before
    ``scale·tanh`` (autograd cannot go through ``out=``); under
    ``no_grad`` it writes the scores in place.  Both are the same
    operations in the same order, so they agree bit for bit in float32
    and in bf16, and the differentiable form carries a gradient to the
    head's weight."""
    import torch

    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.crf_head import CrfHead

    torch.manual_seed(3)
    head = CrfHead(32, DotDict({"n_base": 4, "state_len": 3, "scale": 5.0,
                                "blank_score": 2.0, "bias": True}))
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.randn(2, 7, 32).to(dtype)
        head = head.to(dtype)
        with torch.no_grad():
            inplace = head(h)
        grad_form = head(h)
        assert grad_form.requires_grad and not inplace.requires_grad
        assert grad_form.shape == (2, 7, 64 * 5) and grad_form.dtype == dtype
        assert torch.equal(grad_form.detach(), inplace)
        assert torch.equal(inplace.view(2, 7, 64, 5)[..., 0],
                           torch.full((2, 7, 64), 2.0, dtype=dtype))
    (g,) = torch.autograd.grad(head(h).float().sum(), head.weight)
    assert g.abs().sum() > 0
