"""Host C++ beam search, OpenMP across reads (counterpart of
radian_tpu/ops/beam_native.py).

``csrc/beamsearch.cc`` decodes ``[N, T, 5]`` probability matrices on the
CPU in double precision, with the reference decoder's semantics, with or
without the k-mer LM fused in.  It is built by ``_build.py`` with
``-fopenmp`` at first use; a failed build or load raises.  No pipeline
path uses it: it is a host decoder for CPU serving and a fast oracle.
"""

from __future__ import annotations

import numpy as np

from radian_tpu_torch import _build


def beam_search_native(
    mats: np.ndarray,
    lengths: np.ndarray,
    beam_width: int = 6,
    lm=None,
    s_threshold: float = 0.5,
    r_threshold: float = 0.5,
    ctx_len: int = 11,
):
    """Decode ``[N, T, 5]`` probability matrices on the CPU.

    Returns ``(rev_labels [N, T] int8 -- the labels last emission first,
    -1 padded, n_labels [N] int64, scores [N] float64)``.  ``lm`` is a
    ``KmerLM`` (dense tables) or None.
    """
    lib = _build.load("beamsearch")
    mats = np.ascontiguousarray(mats, np.float32)
    n, t, c5 = mats.shape
    if c5 != 5:
        raise ValueError(f"mats must be [N, T, 5], got {mats.shape}")
    lengths = np.ascontiguousarray(lengths, np.int32)
    if lengths.shape != (n,) or (lengths < 0).any() or (lengths > t).any():
        raise ValueError(f"lengths must be [{n}] in [0, {t}]")
    out_rev = np.full((n, t), -1, np.int8)
    out_lens = np.zeros(n, np.int64)
    out_scores = np.zeros(n, np.float64)
    lm_probs = lm_ent = None
    if lm is not None:
        if lm.context_len != ctx_len:
            raise ValueError(f"LM context_len {lm.context_len} != ctx_len "
                             f"{ctx_len}")
        lm_probs = np.ascontiguousarray(lm.probs, np.float32)
        lm_ent = np.ascontiguousarray(lm.entropy, np.float32)
    lib.BeamSearchBatch(
        mats.ctypes.data, n, t, lengths.ctypes.data, beam_width,
        None if lm_probs is None else lm_probs.ctypes.data,
        None if lm_ent is None else lm_ent.ctypes.data,
        ctx_len, float(s_threshold), float(r_threshold),
        out_rev.ctypes.data, out_lens.ctypes.data, out_scores.ctypes.data)
    return out_rev, out_lens, out_scores


def native_seq(rev_row: np.ndarray, n: int, reverse: bool = False,
               bases: str = "ACGT") -> str:
    """One row of ``beam_search_native``'s labels as bases: as stored
    (5'→3'), or in emission order with ``reverse=True``."""
    labs = rev_row[:n]
    if reverse:
        labs = labs[::-1]
    lut = np.frombuffer(bases.encode(), np.uint8)
    return lut[labs].tobytes().decode()
