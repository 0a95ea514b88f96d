"""End-to-end basecalling (counterpart of radian_tpu/pipeline.py).

Reads are sorted by length, grouped into length buckets and fixed-size
padded batches, and each batch runs on the device.  Global mode:

  MAD-normalise → one causal full-read TCN forward (float32 or
  bfloat16) → "first"-assembly renormalise/trim → CTC beam search (a
  CUDA kernel, with the k-mer LM fused in when one is given) →
  nibble-packed labels

with, in place of the full-read forward, the forward over strips (each
window's kept rows and their context) or over every window, assembled
'first' or 'mean' (``ops/assembly.py``); the windowed forward serves
any window/step geometry.

Chunk mode (reference basecall.py:111-123) decodes each overlapped
window on its own and stitches the fragments on the host:

- 'fused' (the default): one full-read forward, a zero-history forward
  over each window's first ``head`` samples, every window of the batch
  decoded in one launch, labels compacted and 2-bit packed, then the
  C++ consensus stitch (``ops/consensus.py``);
- 'windows': the forward over every whole window, the same decode and
  stitch (nibble-packed labels);
- with ``consensus='device'`` the untiled paths stitch by offset
  correlation on the device (``ops/consensus_device.py``);
- 'fullprobs': windows sliced straight from the full-read forward (no
  head fix-up); with the tiled centre crop every ``crop_stride``-th
  window keeps a span of labels that partition the read, so the stitch
  is a concatenation, and ``chunk_lm`` fuses the LM into that decode.

A Bonito CRF model, ``bonito_tx_crf`` (``models/tx_crf.py``, the
transformer-CRF basecaller) or ``bonito_lstm_crf``
(``models/lstm_crf.py``, the LSTM-CRF basecaller), takes its own path
through the same calls: each read is cut into the overlapping chunks of
its config's ``basecaller`` section (``ops/chunking.py``), the chunks of
many reads fill batches of ``chunk_batch`` chunks, and each batch runs

  MAD-normalise its whole reads → gather the chunks → the model's CRF
  scores (float32 or bfloat16) → the Viterbi path (two CUDA kernels,
  ``ops/crf_viterbi.py``)

before the host stitches each read's kept steps into its string.

Each of the three is one path object (``GlobalPath``, ``ChunkPath``,
``CrfPath``) that a ``Basecaller`` chooses once; the host does fast5
ingest, padding, label rendering, the stitch and fasta output, in
batches or streaming, for any of them.  On a mesh (``mesh=``, from
``parallel.make_mesh``) each padded batch's rows are split over the
``data`` axis, one model replica on each device, each slice run from
its own host thread, and the strings joined in row order: the
unsharded strings, read for read.

Two batches are in flight: batch k+1 is launched before batch k is
rendered.  A CUDA replica uploads from pinned host memory and queues
its record's copy back into pinned host tensors behind the batch's
work, with an event after it; the render of batch k waits on that
event alone, so it runs while the device works on batch k+1.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import itertools
import os
import time
from pathlib import Path
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from radian_tpu_torch.config import DotDict, default_config
from radian_tpu_torch.io.fast5 import Fast5Read, iter_fast5_dir
from radian_tpu_torch.io.fasta import FastaWriter
from radian_tpu_torch.lm.kmer import KmerLM, load_kmer_json
from radian_tpu_torch.models.checkpoint import load_params_npz, params_from_flax
from radian_tpu_torch.models.init import init_params
from radian_tpu_torch.models.keras_import import load_keras_h5
from radian_tpu_torch.models.sig2seq import (
    CRF_FAMILIES,
    SigToSeq,
    build_model,
)
from radian_tpu_torch.ops import chunking
from radian_tpu_torch.ops.assembly import assemble_matrices, row_sum
from radian_tpu_torch.ops.beam_cuda import (
    MAX_BEAM,
    beam_search_cuda,
    beam_search_lm_cuda,
)
from radian_tpu_torch.ops.beam_search import (
    LMFusion,
    labels_to_seq,
    pack_labels,
    pack_labels2,
    rows_to_seqs,
    unpack_labels,
    unpack_labels2,
)
from radian_tpu_torch.ops.consensus import (
    assemble_fragments,
    assemble_read_packed2,
)
from radian_tpu_torch.ops.consensus_device import (
    assemble_fragments_device_batch,
)
from radian_tpu_torch.ops.crf_viterbi import viterbi_path
from radian_tpu_torch.ops.preprocess import (
    bucket_length,
    mad_normalise,
    max_windows_for,
    preprocess_read,
    preprocess_read_strips,
)
from radian_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicated_sharding,
)
from radian_tpu_torch.utils import profiling


# Packed-vs-dense LM layout cut, in bytes of the packed tables: the JAX
# package's cut (radian_tpu/pipeline.py PACKED_LM_MAX_BYTES), chosen from
# its TPU measurements and kept here because the two layouts give
# bit-identical rows, so the cut changes no output.  It is not measured
# on this card.  Override per run with BasecallOptions.packed_lm_max_bytes.
PACKED_LM_MAX_BYTES = 3_000_000


def _packed_lm_bound_bytes(lm: KmerLM) -> int:
    """Upper bound on ``lm.compressed()``'s size without building it: l1
    is ``ceil(R/32) × 8`` bytes, vals ``(n_real + 1) × 20``; exact with a
    ``real_mask``, else every row is assumed distinct."""
    r = lm.n_contexts
    l1_bytes = -(-r // 32) * 8
    n_real = int(lm.real_mask.sum()) if lm.real_mask is not None else r
    return l1_bytes + (n_real + 1) * 20


_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Samples a chunk-mode head or window forward takes at once: the global
# path's largest batch (256 reads of 16,384 samples), so those forwards
# peak near the global forward's memory instead of holding every
# window's activations at once.
FORWARD_GROUP_SAMPLES = 256 * 16384

# Samples a base dwells, for chunk_lm's warm-up guard: the JAX package's
# comments count the crop's 640 samples of decode warm-up as ~16 bases
# (radian_tpu/pipeline.py:190, :521-523).
SAMPLES_PER_BASE = 40

# Host threads of the chunk consensus stitch (ctypes releases the GIL
# for the C++ call), made at first use
_STITCH_POOL = None


def _stitch_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _STITCH_POOL
    if _STITCH_POOL is None:
        _STITCH_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="radian-stitch")
    return _STITCH_POOL


@dataclasses.dataclass(frozen=True)
class BasecallOptions:
    """Decode options; the fields and defaults of the JAX package's
    ``BasecallOptions`` (reference basecall.py:19-37 CLI defaults) but
    its ``decode_backend`` and ``chunk_slab``: the port decodes with its
    CUDA kernel, all of a batch's windows in one launch.

    Chunk mode (``decode_type='chunk'``): ``chunk_prep`` picks the path
    ('auto' = 'fused' when the geometry allows, else 'windows'; see the
    module docstring); ``chunk_max_lab`` caps a window's emissions in
    the fused paths' compaction (rounded down to a multiple of 4; a
    window over it raises on the host); ``chunk_crop`` and
    ``chunk_crop_stride`` set 'fullprobs'' tiled centre crop, and
    ``chunk_lm`` fuses the LM into it.  ``consensus='device'`` stitches
    the untiled chunk paths' fragments with ``ops/consensus_device.py``
    on the Basecaller's device.

    Global mode: ``prep_mode`` 'auto' takes the full-read forward where
    the geometry allows it (step | window, window - step >= the strips'
    context), else the windowed forward; 'strips' forwards each
    window's kept ``step`` rows with their context; 'windows' forwards
    every window and assembles them by ``assembly_mode`` ('first', the
    reference's, or 'mean').  'mean' and a geometry the fast forwards
    cannot take always run the windowed forward.

    A CRF model (``bonito_tx_crf``, ``bonito_lstm_crf``) takes
    ``chunk_batch``, ``outlier_clip`` and ``bucket_quantum`` (its reads'
    padding) alone.
    """

    chunk_len: int = 1024
    step_size: int = 128
    outlier_clip: float = 4.0
    beam_width: int = 6
    decode_type: str = "global"  # 'global' | 'chunk'
    sig_threshold: float = 0.5
    rna_threshold: float = 0.5
    context_len: int = 11
    assembly_mode: str = "first"  # reference parity; 'mean' = corrected
    read_batch: int = 8  # reads a batch (padded to this many rows)
    bucket_quantum: int = 4096
    # optional fixed bucket ladder: lengths round up to the smallest entry
    # (quantum rounding above the top entry)
    bucket_lengths: tuple[int, ...] | None = None
    reads_per_fasta: int = 1000
    consensus: str = "reference"
    prep_mode: str = "auto"  # 'auto' | 'fullread' | 'strips' | 'windows'
    chunk_prep: str = "auto"
    chunk_max_lab: int = 512
    chunk_crop: bool = True
    chunk_crop_stride: int = 2
    chunk_lm: bool = False
    # packed-LM layout cut in bytes (None = PACKED_LM_MAX_BYTES)
    packed_lm_max_bytes: int | None = None
    # LM table storage: 'auto' = bfloat16 when the forward runs in
    # bfloat16, float32 otherwise; the fusion runs in float32 on the rows
    lm_table_dtype: str = "auto"  # 'auto' | 'float32' | 'bfloat16'
    # chunks a batch of a CRF model (its config's basecaller section
    # sets the chunk's samples and overlap)
    chunk_batch: int = 64


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on, a bare ``cuda`` fixed to the
    current device (``cuda:<LOCAL_RANK>`` once a process group has set
    it); a CUDA device without a card raises instead of quietly falling
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _run_here(fn, *args) -> concurrent.futures.Future:
    """``fn(*args)`` on the calling thread, as a finished future."""
    done = concurrent.futures.Future()
    done.set_result(fn(*args))
    return done


def _on(device: torch.device):
    """Make ``device`` the calling thread's current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Pending(NamedTuple):
    """A slice's record on its way to the host: its host tensors, pinned
    on a CUDA replica, and the event recorded on the replica's stream
    after their copies (None where the record was made on the host)."""

    tensors: list
    event: torch.cuda.Event | None

    def ready(self) -> bool:
        """Whether the copies are done; never blocks."""
        return self.event is None or self.event.query()


class ReadBatch(NamedTuple):
    """One batch of radian's reads: ``reads`` (indices into the call's
    signals) padded to ``bucket`` samples, in ``rows`` rows."""

    reads: list
    bucket: int
    rows: int

    def host_arrays(self, signals, quantum: int | None = None):
        """``(signals [rows, bucket], lengths [rows] int32)``: filler rows
        repeat the first read and are discarded; int16 signals stay
        int16.  ``quantum``, a ``ChunkBatch``'s padding, is unused: the
        bucket is set."""
        real = len(self.reads)
        dtypes = {np.asarray(signals[i]).dtype for i in self.reads}
        host_dtype = (np.int16 if dtypes == {np.dtype(np.int16)}
                      else np.float32)
        padded = np.zeros((self.rows, self.bucket), host_dtype)
        lengths = np.zeros(self.rows, np.int32)
        for j in range(self.rows):
            sig = signals[self.reads[j] if j < real else self.reads[0]]
            padded[j, : len(sig)] = sig
            lengths[j] = len(sig)
        return padded, lengths

    def count(self, signals) -> None:
        """The batch's counters while tracing: its reads (``reads``) and
        their samples (``real_samples``)."""
        profiling.count("reads", len(self.reads))
        profiling.count("real_samples",
                        sum(len(signals[i]) for i in self.reads))


def _write_read(writer: FastaWriter, read_id: str, seq: str | None,
                verbose: bool) -> int:
    """Write one read's record, or say that it is skipped (``seq``
    None); returns the records written."""
    if seq is None:
        if verbose:
            print(f"{read_id} signal issue, skipping this read.")
        return 0
    writer.write(read_id, seq)
    return 1


def _skipped(mads: np.ndarray) -> np.ndarray:
    """The rows whose read is skipped: no finite, non-zero MAD."""
    return ~np.isfinite(mads) | (mads == 0)


def _first_renorm_trim(mats, n_wins, pad_ends, *, window: int, step: int):
    """Reference "first"-assembly post-pass on an ``[N, T, 5]`` matrix.

    Rows covered by >1 window are L1-renormalised (reference
    radian/matrix_assembly.py:46-53) and rows past the read end are zeroed
    (reference basecall.py:96).  Returns ``(mats, t_reads)``.
    """
    out_len = mats.shape[1]
    t = torch.arange(out_len, device=mats.device)[None, :]
    nw = n_wins[:, None]
    t_reads = (n_wins - 1) * step + window - pad_ends
    i0 = torch.minimum(torch.clamp((t - window) // step + 1, min=0), nw - 1)
    i_hi = torch.minimum(t // step, nw - 1)
    count = i_hi - i0 + 1
    ssum = row_sum(mats)
    mats = torch.where((count[..., None] > 1) & (ssum > 0), mats / ssum, mats)
    mats = torch.where((t < t_reads[:, None])[..., None], mats,
                       torch.zeros((), device=mats.device))
    return mats, t_reads


def _prep_model_assemble_fullread(model: SigToSeq, signals, lengths, *,
                                  opts: BasecallOptions):
    """``[N, L]`` padded signals → "first"-assembled matrices ``[N, L, 5]``.

    One causal TCN pass over each whole normalised read: every row the
    "first" assembly keeps is the model's causal output at its absolute
    position with at least RF-1 samples of history (or the read's own
    zero history), so the full-read pass gives the windowed values
    without windowing.  Returns ``(mats, t_reads, mads)``.
    """
    window, step = opts.chunk_len, opts.step_size
    norm, mads = mad_normalise(signals, lengths, opts.outlier_clip)
    profiling.count("forward_samples", norm.numel())
    probs = model(norm[..., None], probs=True)
    lengths = lengths.to(torch.int64)
    # reference window accounting (preprocess.py:4-22) for trim/renorm
    n_full = torch.clamp((lengths - window) // step + 1, min=0)
    n_wins = n_full + 1
    pad_ends = window - (lengths - n_full * step)
    mats, t_reads = _first_renorm_trim(probs, n_wins, pad_ends,
                                       window=window, step=step)
    return mats, t_reads, mads


def _prep_model_assemble_strips(model: SigToSeq, signals, lengths, *,
                                opts: BasecallOptions, ctx: int,
                                n_strips: int):
    """``[N, L]`` padded signals → "first"-assembled matrices ``[N,
    n_strips·step, 5]``: the model over uniform ``ctx + step`` strips
    (``strip_signal``), each strip's last ``step`` outputs kept, in
    groups of FORWARD_GROUP_SAMPLES.  ``n_strips`` is ``L // step``, so a
    bucket that is not a multiple of ``step`` loses its last ``L % step``
    rows, as in the JAX package.  Returns ``(mats, t_reads, mads)``."""
    window, step = opts.chunk_len, opts.step_size
    strips, n_wins, pad_ends, mads = preprocess_read_strips(
        signals, lengths, window, step, ctx, n_strips, opts.outlier_clip)
    n, s, l = strips.shape
    probs = _model_in_groups(model, strips.reshape(n * s, l))[:, ctx:, :]
    mats, t_reads = _first_renorm_trim(probs.reshape(n, s * step, -1),
                                       n_wins, pad_ends, window=window,
                                       step=step)
    return mats, t_reads, mads


def _prep_model_assemble_windows(model: SigToSeq, signals, lengths, *,
                                 opts: BasecallOptions):
    """``[N, L]`` padded signals → matrices ``[N, L, 5]`` assembled by
    ``opts.assembly_mode`` from the forward over every window (any
    window/step geometry).  Returns ``(mats, t_reads, mads)``."""
    bucket = signals.shape[1]
    probs, n_wins, pad_ends, mads = _prep_and_model(
        model, signals, lengths, opts=opts,
        max_windows=max_windows_for(bucket, opts.chunk_len, opts.step_size))
    mats, t_reads = assemble_matrices(
        probs, n_wins, pad_ends, step=opts.step_size, window=opts.chunk_len,
        out_len=bucket, mode=opts.assembly_mode)
    return mats, t_reads, mads


# -- chunk mode ------------------------------------------------------------

def _model_in_groups(model: SigToSeq, x: torch.Tensor) -> torch.Tensor:
    """``[R, T]`` signal rows → ``[R, T, 5]`` probabilities, the model run
    on at most FORWARD_GROUP_SAMPLES samples at a time."""
    rows = max(1, FORWARD_GROUP_SAMPLES // max(1, x.shape[1]))
    profiling.count("forward_samples", x.numel())
    return torch.cat([model(x[i:i + rows, :, None], probs=True)
                      for i in range(0, x.shape[0], rows)])


def _window_lengths(n_wins, pad_ends, n_rows: int, window: int):
    """``[N, n_rows]`` decode lengths: full windows, the last one trimmed
    of its padding (reference basecall.py:96), 0 from ``n_wins`` on."""
    w_idx = torch.arange(n_rows, device=n_wins.device)[None, :]
    lens = torch.where(w_idx == n_wins[:, None] - 1,
                       window - pad_ends[:, None], window)
    return torch.where(w_idx < n_wins[:, None], lens, 0)


def _prep_and_model(model: SigToSeq, signals, lengths, *,
                    opts: BasecallOptions, max_windows: int):
    """``[N, L]`` padded signals → per-window probabilities ``[N,
    max_windows, chunk_len, 5]`` (the 'windows' path's forward), with
    ``(n_wins, pad_ends, mads)``."""
    windows, n_wins, pad_ends, mads = preprocess_read(
        signals, lengths, opts.chunk_len, opts.step_size, max_windows,
        opts.outlier_clip)
    n, w, t = windows.shape
    probs = _model_in_groups(model, windows.reshape(n * w, t))
    return probs.reshape(n, w, t, -1), n_wins, pad_ends, mads


def _decode_windows(probs, n_wins, pad_ends, *, opts: BasecallOptions):
    """Every window decoded on its own, no LM (reference
    basecall.py:111-121) → ``(nibble-packed labels [N, W, T/2], n_labels
    [N, W])``."""
    n, w, t, c = probs.shape
    lens = _window_lengths(n_wins, pad_ends, w, opts.chunk_len)
    rev, n_lab, _ = beam_search_cuda(probs.reshape(n * w, t, c),
                                     lens.reshape(-1), opts.beam_width)
    return pack_labels(rev).reshape(n, w, t // 2), n_lab.reshape(n, w)


class ChunkGeometry(NamedTuple):
    """Window accounting of the fused chunk paths, int64 tensors."""

    n_dec: torch.Tensor  # [N] windows decoded
    tail_start: torch.Tensor  # [N] absolute start of the tail window
    starts: torch.Tensor  # [N, D] absolute start of each decoded window
    lens: torch.Tensor  # [N, D] its decode length, 0 from n_dec on


def _chunk_geometry(lengths, *, window: int, step: int, stride: int,
                    max_windows: int) -> ChunkGeometry:
    """Decoded window ``d`` of a read starts at ``d·stride·step``, clipped
    to the tail window's start; ``stride`` is 1 but in the tiled crop.
    ``D`` covers a bucket's most windows."""
    ln = lengths.long()
    n_full = torch.clamp((ln - window) // step + 1, min=0)
    tail_start = n_full * step
    pad_ends = window - (ln - tail_start)
    n_dec = (n_full + stride - 1) // stride + 1
    n_rows = -((max_windows - 1) // -stride) + 1
    w_idx = torch.arange(n_rows, device=ln.device)
    starts = torch.minimum(w_idx[None, :] * (stride * step),
                           tail_start[:, None])
    return ChunkGeometry(n_dec, tail_start, starts,
                         _window_lengths(n_dec, pad_ends, n_rows, window))


def _crop_spans(geom: ChunkGeometry, *, step: int, crop_off: int,
                stride: int):
    """``(lo, hi)`` ``[N, D]``: the time steps ``[lo, hi)`` of its window
    that each decoded window keeps in the tiled centre crop.

    Window ``d`` keeps ``[crop_off, crop_off + stride·step)``: consecutive
    spans are contiguous in absolute time, so they partition the read.
    The first window keeps its left edge and the last (the tail) its
    right edge, the read's own edges; the window before the tail stops
    where the tail's span starts (``tail_start + crop_off``).
    """
    d = torch.arange(geom.starts.shape[1], device=geom.starts.device)
    is_last = d[None, :] == geom.n_dec[:, None] - 1
    lo = torch.where(d == 0, 0, crop_off)[None, :].expand_as(geom.starts)
    hi = torch.where(is_last, geom.lens, torch.minimum(
        torch.full_like(geom.starts, crop_off + stride * step),
        geom.tail_start[:, None] + crop_off - geom.starts))
    return lo, hi


def _compact_pack2(rev: torch.Tensor, cap: int) -> torch.Tensor:
    """Each row's emissions (labels >= 0) moved to its front, keeping
    their order, the first ``cap`` kept, 2-bit packed → ``[R, cap/4]`` uint8:
    the bytes of the JAX package's sort on ``t·8 + label`` keys (the
    caller checks the counts against ``cap``)."""
    emit = rev >= 0
    slot = torch.where(emit, emit.cumsum(1) - 1, cap).clamp_(max=cap)
    comp = torch.full((rev.shape[0], cap + 1), -1, dtype=rev.dtype,
                      device=rev.device)
    # slot ``cap`` takes the copy steps and any overflow, and is dropped
    comp.scatter_(1, slot, rev)
    return pack_labels2(comp[:, :cap])


# -- decode paths ------------------------------------------------------------
#
# A Basecaller runs one of three paths, chosen once by its constructor.
# Each gives the orchestration its plan of batches, a batch's device run
# on a replica (``run`` → the record's tensors) and the render of the
# record's host arrays into strings (under ``render_span``, which takes
# CUDA events where ``render_on_device``).  A path holds plain values
# only, so mesh replicas share it.

class _RadianPath:
    """What radian's two paths share: the global forward's and the chunk
    windows' geometry, checked (radian_tpu/pipeline.py:705-812), and
    batches of reads bucketed by length."""

    chunked = False  # each window decoded alone (ChunkPath)
    plan_span = "radian.batches"
    render_on_device = False

    def __init__(self, model: SigToSeq, options: BasecallOptions,
                 has_lm: bool):
        o = self.options = options
        rf = model.receptive_field
        # global forward (radian_tpu/pipeline.py:705-726): the full-read
        # or strips forward where every kept row has a whole receptive
        # field inside its window, else the windowed forward
        self.strip_ctx = -(-(rf - 1 + o.step_size) // 128) * 128 \
            - o.step_size
        fast_ok = (not self.chunked and o.assembly_mode == "first"
                   and o.chunk_len % o.step_size == 0
                   and o.chunk_len - o.step_size >= self.strip_ctx)
        self.use_fullread = o.prep_mode in ("auto", "fullread") and fast_ok
        self.use_strips = o.prep_mode == "strips" and fast_ok
        if o.prep_mode in ("strips", "fullread") and not fast_ok:
            raise ValueError(
                f"prep_mode={o.prep_mode!r} requires global decode, "
                "'first' assembly, step | window, and window-step >= ctx "
                f"({self.strip_ctx})")
        # chunk windows (radian_tpu/pipeline.py:761-812): the head fix-up
        # length, whether the fused path applies, the tiled crop's offset
        # and stride, and the ``chunk_lm`` checks.  Zero-history fix-up:
        # RF-1 rounded up to 128; none in 'fullprobs'
        self.chunk_head = (0 if o.chunk_prep == "fullprobs"
                           else -(-(rf - 1) // 128) * 128)
        self.use_chunk_fused = (
            self.chunked
            and o.chunk_prep in ("auto", "fused", "fullprobs")
            and self.chunk_head < o.chunk_len
            and o.chunk_max_lab % 2 == 0)
        if o.chunk_prep in ("fused", "fullprobs") and not self.use_chunk_fused:
            raise ValueError(
                f"chunk_prep={o.chunk_prep!r} needs head {self.chunk_head} < "
                f"chunk_len {o.chunk_len} and an even chunk_max_lab")
        # tiled crop ('fullprobs' only): the widest stride <= chunk_crop_
        # stride whose kept span leaves >= RF-1 steps of decode warm-up on
        # its left and one step of margin on its right
        crop_off, stride = 0, 1
        if o.chunk_prep == "fullprobs" and o.chunk_crop:
            for k in range(o.chunk_crop_stride, 0, -1):
                off_k = o.chunk_len - (k + 1) * o.step_size
                if off_k >= rf - 1:
                    crop_off, stride = off_k, k
                    break
        # tiled only where the device crops (crop_off > 0): a 0 offset
        # would concatenate whole overlapping windows (a deviation from
        # the JAX package, ROADMAP Queue 3)
        self.chunk_tiled = crop_off > 0
        self.crop_off, self.crop_stride = (crop_off, stride) \
            if self.chunk_tiled else (0, 1)
        self.chunk_lm = bool(o.chunk_lm)
        if self.chunk_lm and not (self.chunk_tiled and has_lm):
            raise ValueError(
                "chunk_lm needs lm= and the tiled crop "
                "(chunk_prep='fullprobs', chunk_crop=True)")
        if self.chunk_lm and \
                self.crop_off // SAMPLES_PER_BASE < o.context_len:
            # a deviation from the JAX package, ROADMAP Queue 3
            raise ValueError(
                f"chunk_lm needs at least context_len {o.context_len} "
                f"bases of decode warm-up before a kept span: the crop "
                f"leaves {self.crop_off} samples, ~"
                f"{self.crop_off // SAMPLES_PER_BASE} bases at "
                f"~{SAMPLES_PER_BASE} samples a base; lengthen chunk_len "
                "or shorten step_size")
        # the effective compaction cap: chunk_max_lab and chunk_len each
        # rounded down to a multiple of 4 for the 2-bit packing
        self.chunk_cap = min(o.chunk_max_lab - o.chunk_max_lab % 4,
                             o.chunk_len - o.chunk_len % 4)

    def plan(self, bc: "Basecaller", signals) -> list:
        """``[(read indices, ReadBatch)]`` of ``bc.batches``."""
        return [(idxs, self.batch(idxs, b))
                for idxs, b in bc.batches(signals)]

    def batch(self, idxs, bucket: int) -> ReadBatch:
        return ReadBatch(idxs, bucket, self.options.read_batch)

    def check_streaming(self) -> None:
        """Radian's batches stream."""


class GlobalPath(_RadianPath):
    """Radian's global mode: the forward the geometry allows, one beam
    search over each read's assembled matrix, the labels rendered."""

    render_span = "radian.render"

    def run(self, bc: "Basecaller", batch: ReadBatch, padded, lengths):
        """→ ``(mads, nibble-packed labels)``."""
        with profiling.span("radian.forward", bc.device):
            mats, t_reads, mads = bc.forward(padded, lengths)
        with profiling.span("radian.decode", bc.device):
            packed, _ = bc.decode(mats, t_reads)
        return mads, packed

    def render(self, bc: "Basecaller", batch: ReadBatch, record,
               results) -> None:
        mads, packed = record
        bad = _skipped(mads)
        rev = unpack_labels(packed)
        for j, i in enumerate(batch.reads):
            if not bad[j]:
                results[i] = labels_to_seq(rev[j])  # already 5'→3'


class ChunkPath(_RadianPath):
    """Radian's chunk mode (module docstring): each window decoded alone,
    the fragments stitched (or, tiled, concatenated) on the host or, with
    ``consensus='device'``, on the Basecaller's device."""

    chunked = True
    render_span = "radian.stitch"

    @property
    def render_on_device(self) -> bool:
        return not self.chunk_tiled and self.options.consensus == "device"

    def run(self, bc: "Basecaller", batch: ReadBatch, padded, lengths):
        """→ ``(mads, packed labels, windows a read, n_labels)`` on the
        fused paths, ``(mads, packed labels, windows a read)`` on
        'windows'."""
        o, dev = self.options, bc.device
        if self.use_chunk_fused:
            geom = bc.chunk_geometry(lengths, batch.bucket)
            with profiling.span("radian.forward", dev):
                norm, probs_full, mads = bc.chunk_forward(padded, lengths)
                probs = bc.chunk_window_probs(norm, probs_full, geom)
            del norm, probs_full
            with profiling.span("radian.decode", dev):
                packed, n_lab = bc.chunk_decode(probs, geom)
            return mads, packed, geom.n_dec, n_lab
        with profiling.span("radian.forward", dev):
            probs, n_wins, pad_ends, mads = _prep_and_model(
                bc.model, padded, lengths, opts=o,
                max_windows=max_windows_for(batch.bucket, o.chunk_len,
                                            o.step_size))
        with profiling.span("radian.decode", dev):
            packed, _ = _decode_windows(probs, n_wins, pad_ends, opts=o)
        return mads, packed, n_wins

    def render(self, bc: "Basecaller", batch: ReadBatch, record,
               results) -> None:
        o, idxs = self.options, batch.reads
        mads, packed, n_wins = record[:3]
        n_lab = record[3] if self.use_chunk_fused else None
        bad = _skipped(mads)
        if n_lab is not None:
            # the fused paths kept at most chunk_cap labels a window: a
            # window over it would be cut short, so fail loudly instead
            win_valid = np.arange(n_lab.shape[1])[None, :] < n_wins[:, None]
            row_ok = (np.arange(n_lab.shape[0]) < len(idxs)) & ~bad
            over = (n_lab > self.chunk_cap) & win_valid & row_ok[:, None]
            if over.any():
                raise RuntimeError(
                    f"chunk window emitted {int(n_lab[over].max())} labels "
                    f"> the effective compaction cap {self.chunk_cap} "
                    f"(chunk_max_lab {o.chunk_max_lab} rounded to a "
                    "multiple of 4); raise BasecallOptions.chunk_max_lab")
        if self.chunk_tiled:
            # the kept spans partition the read, so its 5'→3' string is
            # every window's labels as stored (last emission first), the
            # windows last to first: one pass over the whole batch
            live = np.arange(n_lab.shape[1])[None, :] < n_wins[:, None]
            labs = unpack_labels2(packed, np.where(live, n_lab, 0))
            seqs = rows_to_seqs(labs[:, ::-1].reshape(len(labs), -1),
                                reverse=False)
            for j, i in enumerate(idxs):
                if not bad[j]:
                    results[i] = seqs[j]
            return

        def fragments(j):
            w = int(n_wins[j])
            if n_lab is None:
                # 'windows': nibble-packed labels over each whole window
                return rows_to_seqs(unpack_labels(packed[j, :w]))
            return rows_to_seqs(unpack_labels2(packed[j, :w], n_lab[j, :w]))

        def stitch_one(j):
            if n_lab is not None:
                # 'fused': the 2-bit rows rendered and stitched in C++
                w = int(n_wins[j])
                return assemble_read_packed2(packed[j, :w], n_lab[j, :w])
            return assemble_fragments(fragments(j))

        todo = [(j, i) for j, i in enumerate(idxs) if not bad[j]]
        if o.consensus == "device":
            # every read's votes in one padded call on the card
            seqs = assemble_fragments_device_batch(
                [fragments(j) for j, _ in todo], device=bc.device)
        elif len(todo) > 3:
            seqs = _stitch_pool().map(stitch_one, [j for j, _ in todo])
        else:
            seqs = map(stitch_one, [j for j, _ in todo])
        for (_, i), seq in zip(todo, seqs):
            results[i] = seq[::-1]  # 5'→3', as the reference's basecall.py


class CrfPath:
    """The CRF path (module docstring) of a Bonito model of either
    family, ``kind`` its ``model.type``: one replica, no LM, chunks of
    ``size`` samples overlapping by ``overlap`` (its config's
    ``basecaller`` section), ``step`` samples a decoded step, a CRF of
    ``state_len``, ``options.chunk_batch`` chunks a batch."""

    plan_span = "radian.tx.chunk"
    render_span = "radian.tx.stitch"
    render_on_device = False

    def __init__(self, model: torch.nn.Module, config: DotDict,
                 options: BasecallOptions, has_lm: bool, n_devices: int):
        o = self.options = options
        kind = self.kind = config.model.type
        if has_lm:
            raise ValueError(f"a {kind} model decodes without an LM")
        if n_devices != 1:
            raise NotImplementedError(
                f"a {kind} model runs on one device, not a mesh")
        if o.chunk_batch < 1:
            raise ValueError(f"chunk_batch {o.chunk_batch} < 1")
        section = config.get("basecaller")
        if section is None:
            raise ValueError(f"a {kind} config needs a basecaller "
                             "section (chunksize, overlap)")
        self.size = int(section.chunksize)
        self.overlap = int(section.overlap)
        if self.size % model.sample_stride \
                or not 0 <= self.overlap < self.size:
            raise ValueError(
                f"chunksize {self.size} must be a multiple of the stem's "
                f"stride {model.sample_stride}, overlap {self.overlap} in "
                "[0, chunksize)")
        self.step, self.state_len = model.stride, model.state_len

    def plan(self, bc: "Basecaller", signals) -> list:
        """``[(read indices, ChunkBatch)]`` (``ops/chunking.py``)."""
        return [(b.reads, b) for b in chunking.plan(
            [len(x) for x in signals], size=self.size, overlap=self.overlap,
            step=self.step, rows=self.options.chunk_batch)]

    def batch(self, idxs, batch: chunking.ChunkBatch) -> chunking.ChunkBatch:
        return batch

    def check_streaming(self) -> None:
        raise NotImplementedError(
            f"streaming a {self.kind} model: use basecall_signals")

    def run(self, bc: "Basecaller", batch: chunking.ChunkBatch, reads,
            lengths, table):
        """→ ``(mads, Viterbi paths)``."""
        with profiling.span("radian.forward", bc.device):
            scores, mads = bc.crf_scores(reads, lengths, table)
        with profiling.span("radian.decode", bc.device):
            path = viterbi_path(scores[:batch.n_chunks], self.state_len)
        return mads, path

    def render(self, bc: "Basecaller", batch: chunking.ChunkBatch, record,
               results) -> None:
        mads, path = record
        batch.stitch(path, _skipped(mads), results)


class Basecaller:
    """Bucketed, batched basecaller, global or chunk mode.

    ``lm`` (a ``KmerLM`` of ``options.context_len``) fuses the k-mer LM
    into the global decode, or with ``options.chunk_lm`` into the tiled
    chunk decode; its tables go to the device once, here, packed
    (``KmerLM.compressed()``) when that is under
    ``options.packed_lm_max_bytes`` and dense otherwise, in
    ``options.lm_table_dtype``.

    Pass ``mesh`` (a ``parallel.Mesh`` with a ``data`` axis, e.g. from
    ``parallel.make_mesh``) to shard each read batch over its data
    devices in one process, as the JAX package's ``shard_map`` does: one
    replica of the model and the LM tables on each data device, each
    batch's ``read_batch`` rows split into equal slices (so
    ``read_batch`` must divide by the data size), each slice run and
    copied to the host from its own thread, the strings joined in row
    order.  Reads are independent, so the strings are the unsharded
    ones.  ``device`` must be one of the mesh's devices: it holds the
    unsharded helpers (``forward``, ``decode``, ``chunk_*``) and the
    device consensus.  Without a mesh, the Basecaller is a mesh of one
    replica on ``device``.

    A ``model`` axis above 1 is accepted, as in the JAX package, whose
    ``shard_map`` keeps the parameters replicated and the batch split
    over ``data`` only, so each device of a model row computes its data
    slice again and keeps one copy.  Here the first device of each model
    row (``Mesh.data_devices``) runs the slice, once: the same strings,
    with none of the redundant copies (a deliberate deviation).

    ``self.path`` is the decode path the constructor chose, with its
    geometry: ``GlobalPath`` or ``ChunkPath`` by ``options.decode_type``
    for radian's model, ``CrfPath`` for a config whose ``model.type`` is
    a Bonito CRF family's (``bonito_tx_crf``, ``bonito_lstm_crf``: the
    model and its chunks, module docstring).
    """

    def __init__(
        self,
        params: dict[str, torch.Tensor],
        config: DotDict | None = None,
        lm: KmerLM | None = None,
        options: BasecallOptions | None = None,
        compute_dtype: torch.dtype = torch.float32,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self.config = config if config is not None else default_config()
        self.options = o = options or BasecallOptions()
        if o.decode_type not in ("global", "chunk"):
            raise ValueError(f"decode_type={o.decode_type!r}: 'global' or "
                             "'chunk'")
        if o.consensus not in ("reference", "device"):
            raise ValueError(f"consensus={o.consensus!r}: 'reference' or "
                             "'device'")
        if o.beam_width > MAX_BEAM:
            raise NotImplementedError(
                f"beam_width {o.beam_width} > {MAX_BEAM}: the reference's "
                "int8 backpointers (parent*8 + append+1) overflow from beam "
                "17 on, so wider beams have no reference to hold the port "
                "to (ROADMAP.md, Queue 3: int8 backpointer overflow)")
        if o.assembly_mode not in ("first", "mean"):
            raise ValueError(f"assembly_mode={o.assembly_mode!r}: 'first' "
                             "or 'mean'")
        if o.prep_mode not in ("auto", "fullread", "strips", "windows"):
            raise ValueError(f"prep_mode={o.prep_mode!r}: 'auto', "
                             "'fullread', 'strips' or 'windows'")
        self.device = resolve_device(device)
        self.mesh = (make_mesh(data=1, devices=[self.device])
                     if mesh is None else mesh)
        devices = self._mesh_devices(self.mesh)
        self.lm_fusion = (None if lm is None
                          else self._lm_tables(lm, compute_dtype))
        self.model = build_model(self.config, compute_dtype)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        # the one choice of decode path: the model's family (a CRF model
        # of either family has the geometry CrfPath reads:
        # sample_stride, stride, state_len), then the mode
        if hasattr(self.model, "state_len"):
            if o.decode_type != "global":
                raise ValueError(
                    f"decode_type={o.decode_type!r} is radian's; a "
                    f"{self.config.model.type} model chunks by its "
                    "config's basecaller section")
            self.path = CrfPath(self.model, self.config, o, lm is not None,
                                len(devices))
        else:
            self.path = (ChunkPath if o.decode_type == "chunk"
                         else GlobalPath)(self.model, o, lm is not None)
        # one replica a data device: ``self`` on ``device`` (it serves the
        # unsharded helpers), copies of its model and tables elsewhere
        home = devices.index(self.device)
        self._replicas = [self if i == home else self._replica(d)
                          for i, d in enumerate(devices)]
        # two threads a replica (on a mesh of several): one batch's slice
        # launches while the previous one's still does
        self._shard_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2 * len(devices), thread_name_prefix="radian-shard")
        # the sequence number of a call, which its spans carry
        self._calls = itertools.count()

    def _replica(self, device: torch.device) -> "Basecaller":
        """This Basecaller with its model and LM tables copied to
        ``device``."""
        rep = copy.copy(self)
        rep.device = device
        rep.model = copy.deepcopy(self.model).to(device)
        if self.lm_fusion is not None:
            rep.lm_fusion = self.lm_fusion._replace(
                t1=self.lm_fusion.t1.to(device),
                t2=self.lm_fusion.t2.to(device))
        return rep

    def _mesh_devices(self, mesh) -> list[torch.device]:
        """The mesh's data devices, checked as the JAX package checks a
        mesh (radian_tpu/pipeline.py:632-640)."""
        o = self.options
        if "data" not in mesh.axis_names:
            raise ValueError("inference mesh needs a 'data' axis")
        if o.read_batch % mesh.shape["data"] != 0:
            raise ValueError(
                f"read_batch {o.read_batch} must be divisible by the mesh "
                f"data axis ({mesh.shape['data']})")
        devices = replicated_sharding(mesh)
        if self.device not in devices:
            raise ValueError(f"device {self.device} is not among the mesh's "
                             f"data devices {[str(d) for d in devices]}")
        return [resolve_device(d) for d in devices]

    def _lm_tables(self, lm: KmerLM, compute_dtype) -> LMFusion:
        """The LM's tables on the device, in the layout and dtype the
        options pick (radian_tpu/pipeline.py:654-688)."""
        o = self.options
        if lm.context_len != o.context_len:
            raise ValueError(f"LM context_len {lm.context_len} != "
                             f"options.context_len {o.context_len}")
        if o.lm_table_dtype == "auto":
            dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                     else torch.float32)
        elif o.lm_table_dtype in _TABLE_DTYPES:
            dtype = _TABLE_DTYPES[o.lm_table_dtype]
        else:
            raise ValueError(f"lm_table_dtype={o.lm_table_dtype!r}: 'auto', "
                             "'float32' or 'bfloat16'")
        cut = (o.packed_lm_max_bytes if o.packed_lm_max_bytes is not None
               else PACKED_LM_MAX_BYTES)
        t1 = t2 = None
        if _packed_lm_bound_bytes(lm) < cut:
            l1, vals = lm.compressed()
            if l1.nbytes + vals.nbytes < cut:
                # l1 (bitmap words and ranks) stays int32
                t1, t2 = torch.from_numpy(l1), torch.from_numpy(vals).to(dtype)
        packed = t1 is not None
        if not packed:
            t1 = torch.from_numpy(lm.probs).to(dtype)
            t2 = torch.from_numpy(lm.entropy).to(dtype)
        return LMFusion(t1.to(self.device), t2.to(self.device), packed,
                        o.context_len, o.sig_threshold, o.rna_threshold)

    # -- device programs -------------------------------------------------

    @torch.inference_mode()
    def forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """Padded ``[N, L]`` batch → ``(mats [N, T, 5], t_reads, mads)``
        by the global forward the constructor chose (``T = L``, or
        ``L // step · step`` on the strips path)."""
        o, p = self.options, self.path
        if p.use_fullread:
            return _prep_model_assemble_fullread(self.model, signals,
                                                 lengths, opts=o)
        if p.use_strips:
            return _prep_model_assemble_strips(
                self.model, signals, lengths, opts=o, ctx=p.strip_ctx,
                n_strips=signals.shape[1] // o.step_size)
        return _prep_model_assemble_windows(self.model, signals, lengths,
                                            opts=o)

    @torch.inference_mode()
    def decode(self, mats: torch.Tensor, t_reads: torch.Tensor):
        """Assembled matrices → ``(packed labels [N, T/2] uint8, n_labels)``."""
        # the kernels; their wrappers run the plain version on CPU tensors
        if self.lm_fusion is None:
            rev, n_lab, _ = beam_search_cuda(mats, t_reads,
                                             self.options.beam_width)
        else:
            rev, n_lab, _ = beam_search_lm_cuda(
                mats, t_reads, self.options.beam_width, self.lm_fusion)
        return pack_labels(rev), n_lab

    # the fused chunk paths in three steps, each a method for timing

    def chunk_geometry(self, lengths: torch.Tensor,
                       bucket: int) -> ChunkGeometry:
        """The decoded windows of a batch of ``bucket``-sample reads."""
        o = self.options
        return _chunk_geometry(
            lengths.to(self.device), window=o.chunk_len, step=o.step_size,
            stride=self.path.crop_stride,
            max_windows=max_windows_for(bucket, o.chunk_len, o.step_size))

    @torch.inference_mode()
    def chunk_forward(self, signals: torch.Tensor, lengths: torch.Tensor):
        """Padded ``[N, L]`` batch → ``(norm [N, L], probs_full [N, L +
        chunk_len, 5], mads)``: normalised, then ONE causal forward over
        each whole read, zero-extended by ``chunk_len`` so the tail
        window's padding exists in it too.

        The TCN is causal with receptive field RF, so a window's output at
        in-window position ``p >= RF-1`` is the full-read output at its
        absolute position.  A bfloat16 forward stores ``probs_full`` in
        bfloat16, as the JAX package does.
        """
        o, model = self.options, self.model
        norm, mads = mad_normalise(signals, lengths, o.outlier_clip)
        padded = F.pad(norm, (0, o.chunk_len))
        profiling.count("forward_samples", padded.numel())
        probs_full = model(padded[..., None], probs=True)
        if model.compute_dtype == torch.bfloat16:
            probs_full = probs_full.to(torch.bfloat16)
        return norm, probs_full, mads

    @torch.inference_mode()
    def chunk_window_probs(self, norm, probs_full, geom: ChunkGeometry):
        """Each decoded window's probabilities, ``[N·D, chunk_len, 5]``
        float32.

        Steps ``[head, chunk_len)`` come from the full-read pass at their
        absolute positions; steps ``[0, head)`` from a zero-history
        forward over the window's first ``head`` samples, the reference's
        window start (the path's ``chunk_head``: RF-1 rounded up to 128,
        'fused').  With ``head == 0`` ('fullprobs') every step comes from
        the full-read pass.
        """
        head, window = self.path.chunk_head, self.options.chunk_len
        n, d = geom.starts.shape
        dev = norm.device
        rows = torch.arange(n, device=dev)[:, None]
        tidx = geom.starts[..., None] + torch.arange(head, window, device=dev)
        probs = probs_full[rows, tidx.reshape(n, -1)].reshape(
            n * d, window - head, -1)
        if head:
            # norm is zero past a read's length; the clamp only keeps the
            # index inside the bucket
            hidx = geom.starts[..., None] + torch.arange(head, device=dev)
            strips = norm[rows, torch.clamp(hidx.reshape(n, -1),
                                            max=norm.shape[1] - 1)]
            head_probs = _model_in_groups(self.model,
                                          strips.reshape(n * d, head))
            probs = torch.cat([head_probs.to(probs.dtype), probs], 1)
        return probs.float()

    @torch.inference_mode()
    def chunk_decode(self, probs: torch.Tensor, geom: ChunkGeometry):
        """All of a batch's windows decoded in one launch → ``(2-bit-packed
        compacted labels [N, D, cap/4] uint8, n_labels [N, D] int32)``,
        ``cap`` the path's ``chunk_cap``, with ``chunk_lm`` the LM fused.

        In the tiled crop (``crop_off > 0``) only each window's kept span
        of labels survives (``_crop_spans``) and the counts are of those.
        Backtraced column ``k`` is time step ``window-1-k``.
        """
        o, p = self.options, self.path
        n, d = geom.starts.shape
        lens = geom.lens.reshape(-1)
        if p.chunk_lm:
            rev, n_lab, _ = beam_search_lm_cuda(probs, lens, o.beam_width,
                                                self.lm_fusion)
        else:
            rev, n_lab, _ = beam_search_cuda(probs, lens, o.beam_width)
        if p.crop_off > 0:
            window = probs.shape[1]
            lo, hi = _crop_spans(geom, step=o.step_size, crop_off=p.crop_off,
                                 stride=p.crop_stride)
            t = window - 1 - torch.arange(window, device=rev.device)[None, :]
            keep = (t >= lo.reshape(-1, 1)) & (t < hi.reshape(-1, 1))
            rev = torch.where(keep, rev, -1)
            n_lab = (rev >= 0).sum(1)
        return (_compact_pack2(rev, p.chunk_cap).reshape(n, d,
                                                         p.chunk_cap // 4),
                n_lab.reshape(n, d).to(torch.int32))

    # the CRF path

    @torch.inference_mode()
    def crf_scores(self, reads: torch.Tensor, lengths: torch.Tensor,
                   table: torch.Tensor):
        """A chunk batch's device inputs (``ChunkBatch.host_arrays``) →
        ``(scores [rows, T, 4^state_len·5], mads [R])``: each whole read
        MAD-normalised, each row's chunk gathered from its read (a short
        read repeated), the model over the rows."""
        norm, mads = mad_normalise(reads, lengths, self.options.outlier_clip)
        row, start = table[:, 0], table[:, 1]
        idx = (start[:, None]
               + torch.arange(self.path.size, device=reads.device)) \
            % lengths.long()[row][:, None]
        return self.model(norm[row[:, None], idx]), mads

    def chunk_batches(self, signals: Sequence[np.ndarray]):
        """``[(read indices, ChunkBatch)]``: the chunks of the reads,
        ``options.chunk_batch`` a batch (``ops/chunking.py``)."""
        return self.path.plan(self, signals)

    # -- host orchestration ----------------------------------------------

    def _bucket(self, length: int) -> int:
        """Smallest ladder entry >= length when a ladder is configured
        (quantum rounding above it), else quantum rounding."""
        o = self.options
        if o.bucket_lengths:
            for b in sorted(o.bucket_lengths):
                if length <= b:
                    return b
        return bucket_length(length, o.bucket_quantum)

    def warmup(self, lengths: Sequence[int] | None = None) -> float:
        """Run one single-read batch per bucket; returns elapsed seconds."""
        if lengths is None:
            if not self.options.bucket_lengths:
                raise ValueError(
                    "warmup() needs `lengths` or options.bucket_lengths")
            lengths = self.options.bucket_lengths
        t0 = time.perf_counter()
        for b in sorted({self._bucket(n) for n in lengths}):
            sig = np.zeros(b, np.int16)
            sig[::2] = 100  # non-zero MAD so the read isn't skipped
            self.basecall_signals([sig])
        return time.perf_counter() - t0

    def batches(self, signals: Sequence[np.ndarray]):
        """``[(read indices, bucket)]``: length-sorted, one bucket each,
        at most ``read_batch`` reads."""
        o = self.options
        order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
        out: list[tuple[list[int], int]] = []
        batch: list[int] = []
        cur_bucket = None
        for i in order:
            b = self._bucket(len(signals[i]))
            if batch and (b != cur_bucket or len(batch) == o.read_batch):
                out.append((batch, cur_bucket))
                batch = []
            cur_bucket = b
            batch.append(i)
        if batch:
            out.append((batch, cur_bucket))
        return out

    def pad_batch(self, idxs, bucket, signals):
        """One fixed-size padded batch on the device: ``read_batch`` rows
        of ``bucket`` samples (filler rows repeat the first read and are
        discarded).  int16 signals travel as int16.  For a chunk batch
        (``bucket`` a ``ChunkBatch``) the arrays of its
        ``host_arrays``."""
        batch = self.path.batch(idxs, bucket)
        return tuple(torch.from_numpy(x).to(self.device) for x in
                     batch.host_arrays(signals, self.options.bucket_quantum))

    def basecall_signals(
        self, signals: Sequence[np.ndarray]
    ) -> list[str | None]:
        """Basecall raw signals → 5'→3' sequences (None = skipped)."""
        results: list[str | None] = [None] * len(signals)
        with profiling.span("radian.call", self.device,
                            call=next(self._calls)):
            with profiling.span(self.path.plan_span):
                plan = self.path.plan(self, signals)
            self._run_batches(((signals, b) for _, b in plan), results)
        return results

    def _run_batches(self, batches, results,
                     collected=lambda batch: None) -> None:
        """Each ``(signals, batch)`` of ``batches`` run on the device and
        rendered into ``results``, two in flight: batch k+1 is launched
        before batch k is rendered; ``collected(batch)`` follows each
        render.  A CUDA replica's copy back is queued, not waited for,
        so the render of batch k waits on batch k's event alone and runs
        while the device works on batch k+1.

        While tracing, the renders of records copied back from a card
        are counted (``renders``), and so are those that began before a
        later batch's copies were done (``renders_overlapped``)."""
        inflight = []

        def collect():
            batch, futures, k = inflight.pop(0)
            pending = [f.result() for f in futures]
            events = [p.event for p in pending if p.event is not None]
            if events:
                # this batch's own events: never the stream or the
                # device, which would wait for batch k+1 too
                with profiling.span("radian.d2h.wait", batch=k):
                    for ev in events:
                        ev.synchronize()
                if profiling.tracing():
                    profiling.count("renders", 1)
                    profiling.count("renders_overlapped", int(any(
                        not f.done() or not f.result().ready()
                        for _, later, _ in inflight for f in later)))
            # the slices' records (numpy views, each holding its tensor,
            # in row order), each array joined by rows
            parts = [[x.numpy() for x in p.tensors] for p in pending]
            record = (parts[0] if len(parts) == 1
                      else [np.concatenate(f) for f in zip(*parts)])
            p = self.path
            with profiling.span(p.render_span, self.device
                                if p.render_on_device else None, batch=k):
                p.render(self, batch, record, results)
            collected(batch)

        for k, (signals, batch) in enumerate(batches):
            futures = self._dispatch_batch(batch, signals, k)
            inflight.append((batch, futures, k))
            if len(inflight) >= 2:
                collect()
        while inflight:
            collect()

    def _dispatch_batch(self, batch, signals, k: int) -> list:
        """Launch batch ``k``'s device work, a row slice a replica;
        returns the slices' futures of their ``_Pending`` records, in row
        order.  Several replicas each launch from a shard thread, so that
        one device's launches do not hold back the others.  A lone
        replica launches on the calling thread, where a card's queue is
        the same and torch's CPU ops keep their speed (from a worker
        thread they ran at about half of it): its future is finished
        when this returns, its copy back queued behind the batch."""
        split = data_sharding(self.mesh)
        with profiling.span("radian.pad", batch=k):
            host = batch.host_arrays(signals, self.options.bucket_quantum)
        if profiling.tracing():
            batch.count(signals)
        parts = [split.parts(torch.from_numpy(x)) for x in host]
        run = (_run_here if len(self._replicas) == 1
               else self._shard_pool.submit)
        parent = profiling.current()
        return [run(rep._slice_to_host, [x for x, _ in arrays], batch,
                    parent, k)
                for rep, *arrays in zip(self._replicas, *parts)]

    def _slice_to_host(self, host: list[torch.Tensor], batch, parent,
                       k: int) -> _Pending:
        """A mesh slice: its host arrays (rows of the batch's
        ``host_arrays``) copied to this replica's device and through the
        path's device run, and its record sent back to the host
        (``parent`` and ``k``: its spans').

        On a CUDA replica nothing here waits for the device: the inputs
        go up from pinned memory (the caching host allocator keeps a
        buffer until its copy has run), and the record comes back into
        pinned host tensors behind the batch's work, with an event
        after the copies."""
        cuda = self.device.type == "cuda"
        with _on(self.device), profiling.within(parent, k):
            with profiling.span("radian.h2d", self.device):
                arrays = [(x.pin_memory() if cuda else x).to(
                    self.device, non_blocking=True) for x in host]
            with torch.inference_mode():
                record = self.path.run(self, batch, *arrays)
            with profiling.span("radian.d2h", self.device):
                if not cuda:
                    return _Pending(list(record), None)
                out = [torch.empty(x.shape, dtype=x.dtype,
                                   pin_memory=True).copy_(x, non_blocking=True)
                       for x in record]
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                return _Pending(out, done)

    def basecall_stream(self, reads: Iterable[Fast5Read],
                        writer: FastaWriter,
                        verbose: bool = True) -> tuple[int, int]:
        """Streaming basecall: bounded memory, fasta written in read order.

        Reads are taken from ``reads`` one at a time and grouped by
        bucket; a bucket's batch is dispatched when it is full (the rest
        at the end), two batches in flight, and the in-order prefix of
        finished reads is written as it completes.  Returns
        ``(written, total)``.
        """
        self.path.check_streaming()
        results: dict[int, str | None] = {}
        ids: dict[int, str] = {}
        next_flush = n_written = 0

        def batches():
            # bucket → its pending reads' signals by index
            pending: dict[int, dict[int, np.ndarray]] = {}
            for idx, read in enumerate(reads):
                ids[idx] = read.read_id
                b = self._bucket(len(read.signal))
                pending.setdefault(b, {})[idx] = read.signal
                if len(pending[b]) == self.options.read_batch:
                    sigs = pending.pop(b)
                    yield sigs, self.path.batch(list(sigs), b)
            for b in sorted(pending):
                yield pending[b], self.path.batch(list(pending[b]), b)

        def flush(done):
            nonlocal n_written, next_flush
            for i in done.reads:
                results.setdefault(i, None)
            while next_flush in results:
                n_written += _write_read(writer, ids.pop(next_flush),
                                         results.pop(next_flush), verbose)
                next_flush += 1

        with profiling.span("radian.call", self.device,
                            call=next(self._calls)):
            self._run_batches(batches(), results, flush)
        # every read is flushed in order by the end
        return n_written, next_flush

    def basecall_directory(
        self,
        fast5_dir: str | Path,
        fasta_dir: str | Path,
        verbose: bool = True,
        reads: Iterable[Fast5Read] | None = None,
        streaming: bool = False,
    ) -> int:
        """Basecall every read under ``fast5_dir`` into fasta shards."""
        if reads is None:
            reads = iter_fast5_dir(fast5_dir)
        t0 = time.time()
        with FastaWriter(fasta_dir, self.options.reads_per_fasta) as w:
            if streaming:
                n_written, n_total = self.basecall_stream(reads, w, verbose)
            else:
                reads = list(reads)
                n_total = len(reads)
                seqs = self.basecall_signals([r.signal for r in reads])
                n_written = sum(_write_read(w, r.read_id, seq, verbose)
                                for r, seq in zip(reads, seqs))
        if verbose:
            dt = time.time() - t0
            print(f"Basecalled {n_written}/{n_total} reads in {dt:.2f}s "
                  f"({n_written / dt:.2f} reads/s)")
        return n_written


def load_basecaller(
    checkpoint: str | Path | None = None,
    config_path: str | Path | None = None,
    rna_model: str | Path | None = None,
    options: BasecallOptions | None = None,
    seed: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
    device: str | torch.device = "cuda",
) -> Basecaller:
    """Build a Basecaller from file paths (None checkpoint → seeded init,
    the JAX package's weights for ``seed``).

    ``checkpoint`` is a flax-layout ``.npz`` (the JAX package's format)
    or the reference's Keras weights ``.h5`` (needs ``h5py``);
    ``rna_model`` the reference's k-mer LM JSON (None or 'None': no LM).
    A Bonito CRF config (``bonito_tx_crf``, ``bonito_lstm_crf``) takes
    an ``.npz`` of its model's state dict, or none: Bonito's init for
    ``seed`` (published Bonito weights do not load yet).
    """
    device = resolve_device(device)
    if config_path is None:
        config = default_config()
    else:
        from radian_tpu_torch.config import get_config

        config = get_config(config_path)
    family = CRF_FAMILIES.get(config.model.get("type"))
    if family is not None:
        if checkpoint is None:
            weights = family.init(config.model, seed)
        elif str(checkpoint).endswith(".npz"):
            weights = load_params_npz(checkpoint)
        else:
            raise ValueError(f"a {config.model.type} checkpoint is an .npz "
                             f"of its state dict, not {checkpoint}")
        params = {k: torch.from_numpy(np.asarray(v))
                  for k, v in weights.items()}
    elif checkpoint is None:
        params = params_from_flax(init_params(config, seed))
    elif str(checkpoint).endswith(".h5"):
        params = params_from_flax(load_keras_h5(checkpoint, config))
    else:
        params = params_from_flax(load_params_npz(checkpoint))
    options = options or BasecallOptions()
    lm = None
    if rna_model is not None and str(rna_model) != "None":
        lm = load_kmer_json(rna_model, options.context_len)
    return Basecaller(params, config, lm, options, compute_dtype,
                      mesh=mesh, device=device)
