"""End-to-end global-mode basecalling (counterpart of radian_tpu/pipeline.py).

Reads are sorted by length, grouped into length buckets and fixed-size
padded batches, and each batch runs on the device:

  MAD-normalise → one causal full-read TCN forward (float32 or
  bfloat16) → "first"-assembly renormalise/trim → CTC beam search (a
  CUDA kernel, with the k-mer LM fused in when one is given) →
  nibble-packed labels

while the host does fast5 ingest, padding, label rendering and fasta
output.  Ported so far: global decode with or without the LM (dense or
packed tables, float32 or bfloat16), 'first' assembly via the full-read
forward.  Options outside it raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from radian_tpu_torch.config import DotDict, default_config
from radian_tpu_torch.io.fast5 import Fast5Read, iter_fast5_dir
from radian_tpu_torch.io.fasta import FastaWriter
from radian_tpu_torch.lm.kmer import KmerLM, load_kmer_json
from radian_tpu_torch.models.checkpoint import load_params_npz, params_from_flax
from radian_tpu_torch.models.sig2seq import SigToSeq, build_model
from radian_tpu_torch.ops.beam_cuda import (
    MAX_BEAM,
    beam_search_cuda,
    beam_search_lm_cuda,
)
from radian_tpu_torch.ops.beam_search import (
    LMFusion,
    labels_to_seq,
    pack_labels,
    unpack_labels,
)
from radian_tpu_torch.ops.preprocess import bucket_length, mad_normalise


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


@dataclasses.dataclass(frozen=True)
class BasecallOptions:
    """Decode options; same fields and defaults as the JAX package's
    ``BasecallOptions`` (reference basecall.py:19-37 CLI defaults).  The
    chunk-mode fields are accepted for symmetry and unused by this slice,
    which rejects the values that would need them."""

    chunk_len: int = 1024
    step_size: int = 128
    outlier_clip: float = 4.0
    beam_width: int = 6
    decode_type: str = "global"  # 'global' | 'chunk'
    sig_threshold: float = 0.5
    rna_threshold: float = 0.5
    context_len: int = 11
    assembly_mode: str = "first"  # reference parity; 'mean' = corrected
    read_batch: int = 8  # reads decoded concurrently (global mode)
    bucket_quantum: int = 4096
    # optional fixed bucket ladder: lengths round up to the smallest entry
    # (quantum rounding above the top entry)
    bucket_lengths: tuple[int, ...] | None = None
    reads_per_fasta: int = 1000
    decode_backend: str = "auto"  # 'auto' = the CUDA kernel (beam <= 16)
    consensus: str = "reference"
    prep_mode: str = "auto"  # 'auto' | 'fullread' | 'strips' | 'windows'
    chunk_prep: str = "auto"
    chunk_slab: int = 4
    chunk_max_lab: int = 512
    chunk_crop: bool = True
    chunk_crop_stride: int = 2
    chunk_lm: bool = False
    # packed-LM layout cut in bytes (None = PACKED_LM_MAX_BYTES)
    packed_lm_max_bytes: int | None = None
    # LM table storage: 'auto' = bfloat16 when the forward runs in
    # bfloat16, float32 otherwise; the fusion runs in float32 on the rows
    lm_table_dtype: str = "auto"  # 'auto' | 'float32' | 'bfloat16'


def unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to radian_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: {item})")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises instead of quietly falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


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
    ssum = mats.sum(-1, keepdim=True)
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
    probs = model(norm[..., None], probs=True)
    lengths = lengths.to(torch.int64)
    # reference window accounting (preprocess.py:4-22) for trim/renorm
    n_full = torch.clamp((lengths - window) // step + 1, min=0)
    n_wins = n_full + 1
    pad_ends = window - (lengths - n_full * step)
    mats, t_reads = _first_renorm_trim(probs, n_wins, pad_ends,
                                       window=window, step=step)
    return mats, t_reads, mads


class Basecaller:
    """Bucketed, batched global-mode basecaller on one device.

    ``lm`` (a ``KmerLM`` of ``options.context_len``) fuses the k-mer LM
    into the decode; its tables go to the device once, here, packed
    (``KmerLM.compressed()``) when that is under
    ``options.packed_lm_max_bytes`` and dense otherwise, in
    ``options.lm_table_dtype``.
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
        if mesh is not None:
            raise unported("mesh", "multi-GPU")
        if o.decode_type != "global":
            raise unported(f"decode_type={o.decode_type!r}", "chunk modes")
        if o.chunk_lm:
            raise unported("chunk_lm", "chunk modes")
        if o.assembly_mode != "first":
            raise unported(f"assembly_mode={o.assembly_mode!r}",
                           "strips/windows/mean")
        if o.prep_mode not in ("auto", "fullread"):
            raise unported(f"prep_mode={o.prep_mode!r}",
                           "strips/windows/mean")
        if o.decode_backend != "auto":
            raise ValueError(f"decode_backend={o.decode_backend!r}: the "
                             "port decodes with its CUDA kernel ('auto')")
        self.device = resolve_device(device)
        self.lm_fusion = (None if lm is None
                          else self._lm_tables(lm, compute_dtype))
        self.model = build_model(self.config, compute_dtype)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        rf = self.model.receptive_field
        strip_ctx = -(-(rf - 1 + o.step_size) // 128) * 128 - o.step_size
        if o.chunk_len % o.step_size or o.chunk_len - o.step_size < strip_ctx:
            # the JAX package falls back to the windowed forward here
            raise unported(
                f"window {o.chunk_len} / step {o.step_size} (the full-read "
                f"forward needs step | window and window-step >= {strip_ctx})",
                "strips/windows/mean")
        if o.beam_width > MAX_BEAM:
            raise NotImplementedError(
                f"beam_width {o.beam_width} > {MAX_BEAM}: the reference's "
                "int8 backpointers (parent*8 + append+1) overflow from beam "
                "17 on, so wider beams have no reference to hold the port "
                "to (ROADMAP.md, Queue 3: int8 backpointer overflow)")

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
        """Padded ``[N, L]`` batch → ``(mats [N, L, 5], t_reads, mads)``."""
        return _prep_model_assemble_fullread(self.model, signals, lengths,
                                             opts=self.options)

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
        discarded).  int16 signals travel as int16."""
        n = self.options.read_batch
        real = len(idxs)
        dtypes = {np.asarray(signals[i]).dtype for i in idxs}
        host_dtype = (np.int16 if dtypes == {np.dtype(np.int16)}
                      else np.float32)
        padded = np.zeros((n, bucket), host_dtype)
        lengths = np.zeros(n, np.int32)
        for j in range(n):
            sig = signals[idxs[j]] if j < real else signals[idxs[0]]
            padded[j, : len(sig)] = sig
            lengths[j] = len(sig)
        return (torch.from_numpy(padded).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def basecall_signals(
        self, signals: Sequence[np.ndarray]
    ) -> list[str | None]:
        """Basecall raw signals → 5'→3' sequences (None = skipped)."""
        results: list[str | None] = [None] * len(signals)
        # two-deep pipeline: batch k+1's device work is queued before
        # batch k's labels are copied back, so host work overlaps it
        inflight: list = []
        for idxs, b in self.batches(signals):
            inflight.append(self._dispatch_batch(idxs, b, signals))
            if len(inflight) >= 2:
                self._collect_batch(inflight.pop(0), results)
        for pend in inflight:
            self._collect_batch(pend, results)
        return results

    def _dispatch_batch(self, idxs, bucket, signals):
        padded, lengths = self.pad_batch(idxs, bucket, signals)
        mats, t_reads, mads = self.forward(padded, lengths)
        packed, _ = self.decode(mats, t_reads)
        return idxs, mads, packed

    @staticmethod
    def _collect_batch(pending, results):
        idxs, mads, packed = pending
        mads = mads.cpu().numpy()
        bad = ~np.isfinite(mads) | (mads == 0)
        rev = unpack_labels(packed.cpu().numpy())
        for j, i in enumerate(idxs):
            if not bad[j]:
                results[i] = labels_to_seq(rev[j])  # already 5'→3'

    def basecall_directory(
        self,
        fast5_dir: str | Path,
        fasta_dir: str | Path,
        verbose: bool = True,
        reads: Iterable[Fast5Read] | None = None,
        streaming: bool = False,
    ) -> int:
        """Basecall every read under ``fast5_dir`` into fasta shards."""
        if streaming:
            raise unported("streaming", "streaming")
        if reads is None:
            reads = iter_fast5_dir(fast5_dir)
        t0 = time.time()
        reads = list(reads)
        seqs = self.basecall_signals([r.signal for r in reads])
        n_written = 0
        with FastaWriter(fasta_dir, self.options.reads_per_fasta) as w:
            for read, seq in zip(reads, seqs):
                if seq is None:
                    if verbose:
                        print(f"{read.read_id} signal issue, "
                              "skipping this read.")
                    continue
                w.write(read.read_id, seq)
                n_written += 1
        if verbose:
            dt = time.time() - t0
            print(f"Basecalled {n_written}/{len(reads)} reads in {dt:.2f}s "
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
    """Build a Basecaller from file paths (None checkpoint → seeded init).

    ``checkpoint`` is a flax-layout ``.npz`` (the JAX package's format);
    ``rna_model`` the reference's k-mer LM JSON (None or 'None': no LM).
    """
    device = resolve_device(device)
    if config_path is None:
        config = default_config()
    else:
        from radian_tpu_torch.config import get_config

        config = get_config(config_path)
    if checkpoint is None:
        model = build_model(config)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        params = model.state_dict()
    elif str(checkpoint).endswith(".h5"):
        raise unported("Keras .h5 import", "utilities")
    else:
        params = params_from_flax(load_params_npz(checkpoint))
    options = options or BasecallOptions()
    lm = None
    if rna_model is not None and str(rna_model) != "None":
        lm = load_kmer_json(rna_model, options.context_len)
    return Basecaller(params, config, lm, options, compute_dtype,
                      mesh=mesh, device=device)
