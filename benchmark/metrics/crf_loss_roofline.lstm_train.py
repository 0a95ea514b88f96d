"""The CTC-CRF loss kernels' (forward and backward pass) share of their
roofline: the least time the loss could take (operations over 67 TOP/s
or bytes over 3.35 TB/s, whichever is longer; both counted from the
window's rows, steps and target positions, ``core/counts_crf_loss.py``)
over the kernels' device time in the trace."""

from benchmark.core import counts_crf_loss as cnt

SCORE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    c = run.counts
    if run.trace is None or "target_positions" not in c:
        return None
    kernel_s = run.trace.device_seconds("crf_loss_forward_kernel",
                                        "crf_loss_backward_kernel")
    if kernel_s <= 0:
        return None
    bound_s = cnt.loss_bound_s(c["windows"], c["chunk_steps"],
                               c["state_len"], c["target_positions"],
                               SCORE_BYTES[c["dtype"]])
    return 100.0 * bound_s / kernel_s
