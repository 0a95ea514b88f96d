"""The yardstick's arithmetic for the CTC-CRF loss (``core/
reference_crf_loss.py`` states it): its operations and bytes, counted
from the shapes of the rows it ran on, whatever implements it.

Operations, a state (or target position) a step, each add, subtract,
multiply, max, ``exp`` and ``log`` one: a ``k``-way logsumexp is ``4k``
(``k−1`` maxima, ``k`` subtractions and ``exp``s, ``k−1`` sums, a
``log`` and an add).

- full lattice, forward: 5 additions of the scores, a 5-way logsumexp
  and the step's normaliser: 26; backward: the same for β (26), the 5
  edge posteriors (two additions, a subtraction and an ``exp`` each:
  20) and the gradient (a subtraction and a multiplication each: 10):
  56;
- target lattice, forward: 2 additions, a 2-way logsumexp and the
  normaliser: 11; backward: the same for β (11) and 2 posteriors
  (three additions and an ``exp``, then their sum into the row: 5
  each): 21.

Bytes: the scores read by each pass (2 or 4 bytes each), every state's
and position's α written by the forward and read by the backward (4
bytes each way), the offsets (two float64 a step each way), and the
gradient written once in the scores' dtype.
"""

from __future__ import annotations

PEAK_OPS_F32 = 67e12  # the loss's scalar float32 operations
PEAK_BYTES = 3.35e12

FULL_OPS = 26 + 56  # a state-step, forward and backward
TARGET_OPS = 11 + 21  # a target position-step, forward and backward


def positions(target_lengths, state_len: int) -> int:
    """Target positions (k-mers) of rows of these lengths."""
    return sum(int(n) - state_len + 1 for n in target_lengths)


def loss_ops(rows: int, steps: int, state_len: int, target_positions: int
             ) -> int:
    """Operations of the forward and backward passes over ``rows`` rows
    of ``steps`` steps whose targets hold ``target_positions``
    positions in all."""
    return steps * (rows * 4 ** state_len * FULL_OPS
                    + target_positions * TARGET_OPS)


def loss_bytes(rows: int, steps: int, state_len: int, target_positions: int,
               score_bytes: int) -> int:
    """Bytes both passes move (module docstring)."""
    scores = rows * steps * 4 ** state_len * 5 * score_bytes
    alpha = 4 * steps * (rows * 4 ** state_len + target_positions)
    offsets = 2 * 8 * rows * steps
    return 3 * scores + 2 * alpha + 2 * offsets


def loss_bound_s(rows: int, steps: int, state_len: int, target_positions: int,
                 score_bytes: int) -> float:
    """The least time both passes could take on the card: operations
    over 67 TOP/s or bytes over 3.35 TB/s, whichever is longer."""
    return max(loss_ops(rows, steps, state_len, target_positions)
               / PEAK_OPS_F32,
               loss_bytes(rows, steps, state_len, target_positions,
                          score_bytes) / PEAK_BYTES)
