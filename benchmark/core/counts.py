"""The yardstick's arithmetic: model FLOPs, the decode's operations and
bytes, and the card's published peaks.  Counted from the configuration's
shapes and the inputs, never from what a kernel happens to do."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: no tensor cores
PEAK_OPS_F32 = 67e12  # the decode's scalar f32 / int32 operations
PEAK_BYTES = 3.35e12


def model_flops_per_sample(model: dict) -> int:
    """Useful forward FLOPs for one input sample: ``2·k·C_in·C_out`` a
    convolution (the 1×1 shortcut where the channels change) and
    ``2·in·out`` a dense layer; biases and activations not counted."""
    tcn = model["tcn"]
    f, k = tcn["nb_filters"], tcn["kernel_size"]
    total, c = 0, 1
    for _ in range(tcn["nb_stacks"] * len(tcn["dilations"])):
        total += 2 * k * c * f + 2 * k * f * f
        if c != f:
            total += 2 * c * f
        c = f
    total += 2 * f * model["relu_units"]
    total += 2 * model["relu_units"] * model["softmax_units"]
    return total


def train_flops_per_window(model: dict, window: int) -> int:
    """Forward, data-gradient and filter-gradient products: three times
    the forward's FLOPs."""
    return 3 * window * model_flops_per_sample(model)


def decode_ops_per_step(beam: int, lm: bool) -> int:
    """Operations one active read-step of the CTC prefix beam search
    needs: ``29·W² + 83·W``, plus ``47·W + 35`` with the LM fused in
    (the count ``chip_smoke.py`` phase 6 bounds its kernels by)."""
    ops = 29 * beam * beam + 83 * beam
    if lm:
        ops += 47 * beam + 35
    return ops


def decode_bytes(active_steps: int, beam: int, emitted: int,
                 lm_row_bytes: int) -> int:
    """Bytes the decode must move: each active step's 5 float32 inputs
    read once, its ``W`` one-byte backpointers written once and read
    once by the backtrace, and one LM row for each base the calls
    emitted (0 without the LM)."""
    return active_steps * (5 * 4 + 2 * beam) + emitted * lm_row_bytes


def decode_bound_s(active_steps: int, beam: int, lm: bool, emitted: int,
                   lm_row_bytes: int) -> tuple[float, str]:
    """The least time the decode could take, and what bounds it."""
    t_ops = active_steps * decode_ops_per_step(beam, lm) / PEAK_OPS_F32
    t_bytes = decode_bytes(active_steps, beam, emitted,
                           lm_row_bytes) / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
