"""The yardstick's arithmetic for the transformer-CRF configuration: the
model's useful FLOPs a sample and the CRF Viterbi decode's operations
and bytes, counted from the configuration's shapes and the inputs, never
from what a kernel happens to do."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_F32 = 67e12  # the decode's scalar float32 / int32 operations
PEAK_BYTES = 3.35e12


def flops_per_sample(model: dict, chunksize: int) -> float:
    """Useful forward FLOPs for one input sample, over a chunk of
    ``chunksize`` samples: ``2·k·C_in·C_out`` an output position of each
    stem convolution; a token's ``Wqkv``, ``out_proj``, ``fc1`` and
    ``fc2`` products and its attention over the window's ``left + right
    + 1`` keys (``q·k`` and ``p·v``); the upsampling a token and the CRF
    head a step (``2·in·out``).  Biases, norms and activations not
    counted."""
    total, t = 0, chunksize
    for s in model["stem"]:
        t = (t + 2 * s["padding"] - s["winlen"]) // s["stride"] + 1
        total += t * 2 * s["winlen"] * s["insize"] * s["size"]
    enc = model["encoder"]
    d, ff = enc["d_model"], enc["dim_feedforward"]
    keys = enc["attn_window"][0] + enc["attn_window"][1] + 1
    layer = 2 * d * 3 * d + 2 * d * d + 2 * d * 2 * ff + 2 * ff * d \
        + 2 * 2 * keys * d
    up = model["upsample"]["scale_factor"]
    total += t * (enc["num_layers"] * layer + 2 * d * up * d)
    total += t * up * 2 * d * 4 ** model["crf"]["state_len"] * 4
    return total / chunksize


def viterbi_ops(chunks: int, steps: int, state_len: int) -> int:
    """Operations the decode needs: a state-step's 5 additions and 4
    comparisons, a chunk's final argmax (a comparison a state) and its
    walk back (a step's index arithmetic, 3)."""
    states = 4 ** state_len
    return chunks * (9 * steps * states + states + 3 * steps)


def viterbi_bytes(chunks: int, steps: int, state_len: int,
                  score_bytes: int) -> int:
    """Bytes the decode must move: each chunk's 4 move scores a
    state-step read once, and its blank score once (column 0 holds the
    same constant everywhere), its one-byte backpointers written once,
    the step's one backpointer the walk reads, the path's byte a step
    written, the final state."""
    states = 4 ** state_len
    return chunks * (steps * states * 4 * score_bytes + score_bytes
                     + steps * states + 2 * steps + 4)


def viterbi_bound_s(chunks: int, steps: int, state_len: int,
                    score_bytes: int) -> tuple[float, str]:
    """The least time the decode could take, and what bounds it."""
    t_ops = viterbi_ops(chunks, steps, state_len) / PEAK_OPS_F32
    t_bytes = viterbi_bytes(chunks, steps, state_len,
                            score_bytes) / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def score_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype]

