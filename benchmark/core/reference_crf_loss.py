"""Plain float32 reference of a training step of Bonito's v4 LSTM-CRF:
the CTC-CRF loss, the global-norm clip and AdamW.

Written from Bonito's published sources (https://github.com/nanoporetech/
bonito: ``bonito/crf/model.py``'s ``CTC_CRF.ctc_loss``, ``normalise`` and
``logZ``; ``bonito/training.py``'s step: ``torch.optim.AdamW`` after
``clip_grad_norm_``).  It imports only ``torch``, ``numpy`` and the
LSTM-CRF model's reference (``core/reference_lstm_crf.py``): nothing of
the port, no kernel, no table.  The benchmark holds the port's
``Trainer`` to it, and so do the port's CPU tests.

The loss of a row of scores ``[T, 4^L·5]`` (``L = state_len``; a
state's stay score, then the 4 move scores, the move in column ``1+r``
coming from the state with ``r`` as its oldest base and the new state's
other bases after it) and its bases ``b_0..b_{n−1}``, in float32 with
autograd through the step loop:

- ``logZ``: the forward algorithm over all ``4^L`` states from 0 each;
- ``logZ_target``: the same over the target's k-mers in order, starting
  in the first, each step staying in place or moving on by one base;
- ``loss = (logZ − logZ_target) / n``: Bonito's normalised scores take
  ``logZ/T`` off each of a path's T steps.

Each step's values have their largest (detached) taken off and added
to the row's offset, so that they stay near 0 whatever T; a state
unreachable so far holds ``NEG``, a finite log-zero, so that its
gradient is 0 and never NaN.

A step trains every parameter but the LSTM layers' ``bias_hh``, which
Bonito's ``RNNWrapper`` keeps at zero (``disable_state_bias``).  The
batch's loss is ``Σ(w·loss) / max(Σw, 1)``, worked out in
blocks of rows whose gradients are summed (memory); the gradients are
clipped to a global norm (``g·clip/‖g‖`` where ``‖g‖ ≥ clip``), then
AdamW: ``p ← p − lr·(m̂ / (sqrt(v̂) + eps) + wd·p)``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import reference_lstm_crf as lstm

NEG = -1.0e30


def trainable(name: str) -> bool:
    """Whether a step trains the parameter: all but ``bias_hh``."""
    return ".bias_hh_" not in name


def crf_loss(scores: torch.Tensor, targets: torch.Tensor,
             lengths: torch.Tensor, state_len: int) -> torch.Tensor:
    """``[N]`` float32 losses of ``scores [N, T, 4^L·5]`` against
    ``targets [N, n_max]`` (bases 0–3, ``lengths [N]`` of them)."""
    n, t_len, _ = scores.shape
    s_n = 4 ** state_len
    sc = scores.float().reshape(n, t_len, s_n, 5)
    lengths = lengths.long()
    targets = targets.long().clamp(0, 3)

    # all states: the move into s in column 1+r comes from r·4^(L−1) +
    # s // 4, that is row r of the states laid out [4, 4^(L−1)], each
    # entry repeated for the 4 bases the move may emit
    a = torch.zeros(n, s_n, device=scores.device)
    z = torch.zeros(n, device=scores.device)
    for t in range(t_len):
        x = sc[:, t]
        moves = a.view(n, 4, s_n // 4).repeat_interleave(4, dim=2)
        cand = torch.cat([(a + x[..., 0])[:, None],
                          moves + x[..., 1:].transpose(1, 2)], 1)
        a = torch.logsumexp(cand, 1)
        top = a.detach().amax(1, keepdim=True)
        a = a - top
        z = z + top[:, 0]
    logz = z + torch.logsumexp(a, 1)

    # the target's k-mers: position j holds bases j..j+L−1, the oldest
    # in the highest digit; the move into j > 0 is scored in column
    # 1 + b_{j−1} of k-mer j
    p_max = targets.shape[1] - state_len + 1
    digits = 4 ** torch.arange(state_len - 1, -1, -1, device=scores.device)
    kmer = (targets.unfold(1, state_len, 1) * digits).sum(-1)
    stay_at = kmer * 5
    move_at = kmer[:, 1:] * 5 + 1 + targets[:, :p_max - 1]
    b = torch.full((n, p_max), NEG, device=scores.device)
    b[:, 0] = 0.0
    zt = torch.zeros(n, device=scores.device)
    neg = torch.full((n, 1), NEG, device=scores.device)
    for t in range(t_len):
        x = sc[:, t].reshape(n, -1)
        stay = b + x.gather(1, stay_at)
        move = torch.cat([neg, b[:, :-1] + x.gather(1, move_at)], 1)
        b = torch.logaddexp(stay, move)
        top = b.detach().amax(1, keepdim=True)
        b = b - top
        zt = zt + top[:, 0]
    logz_t = zt + b.gather(1, (lengths - state_len)[:, None])[:, 0]
    return (logz - logz_t) / lengths


def row_losses(p, model: dict, batch: dict, rows: slice,
               rounding=None) -> torch.Tensor:
    """Rows ``rows`` of the batch, each row's ``w·loss``: the LSTM-CRF
    reference's scores of their chunks, then their loss."""
    scores = lstm.forward(p, model, batch["signal"][rows], rounding)
    losses = crf_loss(scores, batch["targets"][rows],
                      batch["target_length"][rows], model["crf"]["state_len"])
    return losses * batch["weight"][rows]


def adamw_steps(p: dict[str, torch.Tensor], model: dict, batches: list[dict],
                opt: dict, rows_per_block: int, rounding=None):
    """``len(batches)`` clipped AdamW steps from ``p`` (float32 leaves
    that require grad) in place.  ``opt``: the configuration's ``adamw``
    section (``lr``, ``beta_1``, ``beta_2``, ``epsilon``,
    ``weight_decay``, ``clipnorm``); the leaves ``trainable`` names.
    Returns ``(losses, the first step's clipped gradients {name:
    tensor}, the first step's row losses [N] (w·loss))``."""
    lr, b1, b2 = opt["lr"], opt["beta_1"], opt["beta_2"]
    eps, wd, clip = opt["epsilon"], opt["weight_decay"], opt["clipnorm"]
    names = [k for k in p if trainable(k)]
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    losses, first, first_rows = [], None, []
    for t, batch in enumerate(batches, start=1):
        rows = len(batch["weight"])
        total = batch["weight"].sum().clamp_min(1.0)
        grads = {k: torch.zeros_like(p[k]) for k in names}
        loss = 0.0
        for r0 in range(0, rows, rows_per_block):
            part = row_losses(p, model, batch,
                              slice(r0, r0 + rows_per_block), rounding)
            share = part.sum() / total
            parts = torch.autograd.grad(share, [p[k] for k in names])
            for k, g in zip(names, parts):
                grads[k] += g
            loss += float(share.detach())
            if t == 1:
                first_rows.append(part.detach())
        losses.append(loss)
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))
        if norm >= clip:
            grads = {k: g * np.float32(clip / norm) for k, g in grads.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                g = grads[k]
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                m_hat = mu[k] / (1 - b1 ** t)
                v_hat = nu[k] / (1 - b2 ** t)
                p[k] -= lr * (m_hat / (v_hat.sqrt() + eps) + wd * p[k])
    return losses, first, torch.cat(first_rows)
