"""The yardstick's arithmetic for the LSTM-CRF configuration: the model's
useful FLOPs a sample, and the recurrence's, counted from the
configuration's shapes, never from what implements a layer."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS_BF16 = 989e12


def steps(model: dict, chunksize: int) -> int:
    """Steps a chunk of ``chunksize`` samples leaves the stem with."""
    t = chunksize
    for s in model["stem"]:
        t = (t + 2 * s["padding"] - s["winlen"]) // s["stride"] + 1
    return t


def lstm_flops_per_step(model: dict) -> int:
    """One row's FLOPs a step over every LSTM layer: ``2·4H·(H_in + H)``
    a layer (the four gates' input and recurrent products); the gates'
    elementwise work is not counted."""
    h, insize = model["lstm"]["size"], model["stem"][-1]["size"]
    total = 0
    for _ in range(model["lstm"]["num_layers"]):
        total += 2 * 4 * h * (insize + h)
        insize = h
    return total


def flops_per_sample(model: dict, chunksize: int) -> float:
    """Useful forward FLOPs for one input sample, over a chunk of
    ``chunksize`` samples: ``2·k·C_in·C_out`` an output position of each
    stem convolution, the LSTM layers a step, and the CRF head's
    ``2·in·out`` a step.  Biases and activations not counted."""
    total, t = 0, chunksize
    for s in model["stem"]:
        t = (t + 2 * s["padding"] - s["winlen"]) // s["stride"] + 1
        total += t * 2 * s["winlen"] * s["insize"] * s["size"]
    head = 2 * model["lstm"]["size"] * 4 ** model["crf"]["state_len"] * 4
    total += t * (lstm_flops_per_step(model) + head)
    return total / chunksize


def lstm_flops(model: dict, chunks: int, chunksize: int) -> int:
    """The recurrence's useful FLOPs over ``chunks`` real chunks."""
    return chunks * steps(model, chunksize) * lstm_flops_per_step(model)
