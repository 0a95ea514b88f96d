"""CTC loss (counterpart of radian_tpu/ops/ctc.py).

The JAX package runs the CTC forward recursion as an XLA ``lax.scan``
and differentiates it with ``jax.grad``; it is not a Pallas kernel, so
its port is a library call: :func:`ctc_loss` is ``F.ctc_loss`` (torch's
native CUDA kernel on the card: cuDNN's takes only blank 0).
:func:`ctc_loss_reference` is the JAX recursion itself in torch ops, the
plain version the tests hold the library call against.

Infeasible rows (a label needing more frames than the input has) cost
``-NEG_INF = 1e30`` with a zero gradient.  The JAX recursion gives ~1e30
there too, finite, because its log-zero is the finite ``NEG_INF``;
``F.ctc_loss`` would give ``inf``, and the trainer's zero-weight filler
rows would turn ``inf * 0`` into NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite -inf proxy keeps grads NaN-free


def min_frames(labels: torch.Tensor, label_lengths: torch.Tensor):
    """``[B]`` fewest frames a CTC path needs for each row's labels: one a
    label, plus a blank between equal neighbours."""
    pos = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos[None, :] < label_lengths[:, None]))
    return label_lengths + repeats.sum(1)


def ctc_loss(log_probs, input_lengths, labels, label_lengths,
             blank_id: int = 4):
    """Per-example negative log-likelihood of ``labels`` under CTC.

    Args:
      log_probs: ``[B, T, C]`` log-softmax outputs (any float dtype; the
        loss runs in float32).
      input_lengths: ``[B]`` valid timestep counts.
      labels: ``[B, U]`` int labels, padded arbitrarily past length.
      label_lengths: ``[B]`` valid label counts.
      blank_id: index of the CTC blank (the last class here).

    Returns ``[B]`` float32 losses.  ``F.ctc_loss``'s backward gives the
    gradient with respect to the logits of a log-softmax, which is what
    this model's head feeds it.
    """
    input_lengths = input_lengths.long()
    label_lengths = label_lengths.long()
    labels = labels.long()
    raw = F.ctc_loss(log_probs.float().transpose(0, 1), labels,
                     input_lengths, label_lengths, blank=blank_id,
                     reduction="none", zero_infinity=True)
    infeasible = min_frames(labels, label_lengths) > input_lengths
    return torch.where(infeasible, raw.new_tensor(-NEG_INF), raw)


def ctc_loss_mean(log_probs, input_lengths, labels, label_lengths,
                  blank_id: int = 4):
    """Batch-mean CTC loss."""
    return ctc_loss(log_probs, input_lengths, labels, label_lengths,
                    blank_id).mean()


def ctc_loss_reference(log_probs, input_lengths, labels, label_lengths,
                       blank_id: int = 4):
    """The JAX package's recursion, step for step: the extended labels
    ``blank, y1, blank, ..., yU, blank`` (S = 2U+1 states), log-zero
    ``NEG_INF``, the emission as a one-hot masked sum, and the loss read
    at each row's ``input_length - 1``.  Differentiable by autograd."""
    lp = log_probs.float()
    b, t, c = lp.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = lp.device
    labels = labels.long()
    ext = torch.full((b, s), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    s_len = 2 * label_lengths.long() + 1
    state_idx = torch.arange(s, device=dev)[None, :]
    state_valid = state_idx < s_len[:, None]
    ext_prev2 = F.pad(ext, (2, 0), value=-1)[:, :s]
    can_skip = (ext != blank_id) & (ext != ext_prev2) & (state_idx >= 2)
    onehot = (ext[:, :, None]
              == torch.arange(c, device=dev)[None, None, :]).to(lp.dtype)
    neg = torch.full((), NEG_INF, device=dev)

    def emit(step):
        return (lp[:, step, None, :] * onehot).sum(-1)  # [B, S]

    e0 = emit(0)
    init = torch.full((b, s), NEG_INF, device=dev)
    init[:, 0] = e0[:, 0]
    init[:, 1] = torch.where(s_len > 1, e0[:, min(1, s - 1)], neg)
    alpha = torch.where(state_valid, init, neg)
    alphas = [alpha]
    for step in range(1, t):
        prev1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :s]
        prev2 = torch.where(can_skip,
                            F.pad(alpha, (2, 0), value=NEG_INF)[:, :s], neg)
        combined = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha = torch.where(state_valid, combined + emit(step), neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # [T, B, S]
    rows = torch.arange(b, device=dev)
    final = alphas[input_lengths.long() - 1, rows]  # [B, S]
    end1 = final[rows, s_len - 1]
    end2 = torch.where(s_len >= 2, final[rows, (s_len - 2).clamp_min(0)],
                       neg)
    return -torch.logaddexp(end1, end2)
