"""The CRF Viterbi kernels' (forward scan and backtrace) share of their
roofline: the least time the decode could take (bytes over 3.35 TB/s,
or operations over 67 TOP/s, whichever is longer; both counted from the
window's chunks, ``core/counts_tx_crf.py``) over their device time."""

from benchmark.core import counts_tx_crf as cnt


def read(run):
    c = run.counts
    if run.trace is None or "state_len" not in c:
        return None
    kernel_s = run.trace.device_seconds("crf_viterbi")
    if kernel_s <= 0:
        return None
    bound_s, _ = cnt.viterbi_bound_s(c["chunks"], c["steps"], c["state_len"],
                                     cnt.score_bytes(c["dtype"]))
    return 100.0 * bound_s / kernel_s
