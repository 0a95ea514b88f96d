#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (radian_tpu_torch).

Drives the port's main paths on one CUDA device at the full width of
the repo's trained model (bench_data/trained/params.npz, 2,200,581
parameters): the default global-mode no-LM basecall, global mode with
the bench's 12-mer LM fused in (float32 and bfloat16 forwards), chunk
mode (the reference's --decode-type chunk) and chunk_lm (the tiled,
LM-fused chunk decode), the global strips / windows / 'mean' forwards
and the fallback geometry, chunk mode with the device consensus,
training (the training CLI at the default config's full width, on
synthetic shards), the multi-GPU paths (a mesh of two replicas, read
sharding, data-parallel training in a process group) and tensor
parallelism (the model split over a mesh's model axis) on the one
card, and checks them:

  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc builds every csrc/*.cu kernel and g++ the csrc/*.cc
              host sources (stitcher, shard codec, OpenMP decoder) from
              this checkout (one compiler a source, in
              parallel); ptxas registers, stack frame and spills per
              kernel instantiation
  3. kernel   no-LM beam-search kernels vs their plain PyTorch version,
              both on the card: N=64, T up to 1,040 (not a multiple of the
              32-step tile), beams 1/2/6/8/12/16
              and one case with exact-zero probabilities; labels and
              n_labels identical, scores within 1e-5 absolute
  3b. lm      the LM-fused decode kernel vs its plain version the same
              way (lengths down to 1 and 0): beams 1/6/15/16, ctx
              0/1/3/11/12, dense and packed tables in
              float32 and bfloat16, gate thresholds (0.5, 0.5) and
              (0.0, 10.0), one exact-zero case; and the count of reads
              whose LM string differs from the no-LM one (must be > 0)
  4. model    SigToSeq on the card (TF32 off) vs the port's CPU run,
              4 reads of ~4,000 samples; max |dp| <= 1e-4
  5. e2e      Basecaller (beam 6, read_batch 256, bucket quantum 4096) on
              512 synthetic reads of 5,120-15,360 samples: warm-up, then
              a timed run with every kernel launch count set to 0; reads/s,
              Msamples/s, forward/decode ms per batch, peak memory; every
              kernel must have launched; card strings == CPU strings on a
              small input at beams 6 and 16
  5b. e2e-lm  the same reads and options with the bench's LM (rng 42,
              ctx 11, 200,000 contexts, concentration 0.2; dense, its
              packed bound being over the cut), once with the float32
              forward and tables, once with the bfloat16 forward and
              (auto) bfloat16 tables; the LM decode and backtrace kernels
              must launch and the no-LM decode must not; the fused TCN
              kernel must launch once a convolution a batch (12) in the
              bfloat16 run and never in the float32 one; float32 card
              strings == CPU strings on phase 4's reads; bfloat16 strings
              vs the CPU's bfloat16 run and max |dp| bf16 vs f32 reported
  5c. tcn     the fused bf16 TCN kernels (csrc/tcn_conv.cu) vs their
              plain version on the card, each convolution of each block
              from the same input, on the first global batch's shape (256
              reads, T 8,192) and on 4 reads of T 4,001 (off the 128-row
              tile and 32): within TCN_MAX_FLIPS roundings; the whole
              bf16 forward's probabilities vs the unfused path's (max
              |dp|, within TCN_MAX_DP_SHARE of the unfused bf16 path's
              from f32); launches a forward (one a convolution in bf16, none
              in f32, none in phase 7's f32 chunk runs or phase 9d's
              training steps); the stack timed beside its bound, the plain
              version and the unfused cuDNN + glue stack (library_ms)
  5d. tx      Bonito's v5 transformer-CRF model at its published widths
              (seeded): 5 reads through the Basecaller in 16-chunk
              batches ending on a partial one, the Viterbi kernels
              launched once a batch, the attention kernel once a layer
              a batch and the norm kernel twice; the kernels against
              the plain Viterbi on each batch's bf16 scores (bit-equal
              paths), and on the first batch's tiled to the main path's
              512 chunks, timed there beside the bound; the bf16 scores
              within the cell's score_gap of the f32 reference's
              on 4 chunks
  5e. txa     the windowed attention kernel (csrc/tx_attention.cu) vs
              its plain version on the card at [512, 1024, 8, 64] and
              ragged lengths (5 chunks of 200 tokens, 3 of 5): rotated q
              and k bit-equal to rotary()'s, the output within
              TXA_MAX_FLIPS roundings; the whole bf16 forward's scores
              on 16 chunks vs the band_attention path's (within
              TXA_MAX_DP_SHARE of that path's gap from f32); launches a
              forward (18 in bf16, none in f32) and no call of
              F.scaled_dot_product_attention on the bf16 path (18 on the
              f32 and band paths); ptxas registers, stack
              and spills; timed beside its bound, the plain version and
              the band path (library_ms).  Then the DeepNorm residual +
              RMSNorm kernel (csrc/tx_norm.cu): launches a forward (36
              in bf16, none in f32 or under autograd); vs its plain
              version at [524288, 512], ragged row counts and d 256,
              768 and 1,024, every element within one bf16 rounding;
              timed beside its bound, the plain version and F.rms_norm
              on y + alpha * x (library_ms)
  5f. overlap  the two-deep dispatch loop: one 3-batch call against the
              same reads sent one batch a call (nothing overlaps there),
              strings equal, for the global path with phase 5b's LM (bf16,
              read_batch 64) and the CRF path with the tiny transformer
              (tests/torch_tx_tiny.py, bf16, chunk_batch 16, against each
              read alone); the bulk call once under
              torch.cuda.set_sync_debug_mode("warn") (no synchronising
              operation on the global path) and once traced for the
              renders_overlapped / renders counters
  6. kernels  each no-LM kernel vs its plain version on the inputs the main
              path gave it (the first batch), timed with CUDA events,
              beside its bound (bytes or operations over the H100's peaks);
              the decode kernel also timed at beam 16 on that batch
  6b. lm-kernels  the LM decode kernel vs its plain version on the first
              LM batch, and timed there with dense float32, dense bfloat16
              and packed float32/bfloat16 tables of the same LM, beside the
              no-LM decode kernel on the same batch; then the same on
              seeded Dirichlet(0.2) matrices of that shape (the row-heavy
              regime); LM/no-LM and dense/packed ratios of each run
  7. chunk    Basecaller(decode_type='chunk') with the defaults ('fused',
              reference consensus, beam 6, read_batch 256) on phase 5's
              512 reads in float32: warm-up, then a timed run with the
              launch counts set to 0 (the decode and backtrace kernels
              must launch, the LM kernel must not); reads/s, Msamples/s,
              peak memory; per batch the full-read forward, head forward,
              decode and host stitch ms; card strings == CPU strings on
              phase 4's reads for 'fused', 'windows' and 'fullprobs' (the
              tiled crop), and 'fused' == 'windows' (a mismatch prints
              each differing window and its max |dp|)
  7b. chunk-lm  'fullprobs' + tiled crop + chunk_lm with the bench's LM:
              float32 card == CPU strings on phase 4's reads; the
              bfloat16 forward and tables timed and split on the 512
              reads (the LM and backtrace kernels and the fused TCN
              kernel must launch, the no-LM decode must not), its strings
              vs the CPU's bfloat16 run reported; warm single-read
              latency (read_batch 1, median of 5) beside global+LM's
  7c. chunk-kernels  the no-LM decode and backtrace kernels vs their
              plain versions on all of phase 7's first batch of windows
              (length-0 windows included; bit-exact backpointers, labels
              and counts, scores within 1e-5), the LM decode kernel the
              same on phase 7b's first batch; each timed there beside its
              bound, in the kernels line under "chunk"
  8. global-prep  the global 'strips', 'windows' and 'mean' forwards
              (f32, beam 6, read_batch 256) on phase 5's 512 reads: each
              split per batch into bc.forward (prep, model, assembly) and
              bc.decode ms (the split is the warm-up), then timed with the
              launch counts set to 0 (reads/s, Msamples/s, peak GB; the
              decode and backtrace kernels must launch, the LM kernel
              must not); the first batch's strips and windows 'first'
              matrices within 1e-4 of the full-read forward's from row
              RF-1 on (the strips' first RF-1 rows differ by design, as in
              the JAX package: printed); card strings == CPU strings on
              the first 2,000 samples of phase 4's reads (a 2,048-sample
              bucket, which the plain CPU decoder runs far faster than
              the 4,096-sample one) for the three and the fallback
              geometry (step 96, the windowed forward); the decode and
              backtrace kernels bit-exact vs their plain versions on the
              'mean' batch (its first 16 rows, lengths clamped to 2,048
              steps) and the decode kernel timed on all of it
  8b. consensus-device  chunk 'fused' with consensus='device': card
              strings == CPU strings on phase 4's reads (the card run
              with the launch counts set to 0); on phase 7's first batch
              the host collect with the device stitch (one padded
              call over the batch's reads, as the pipeline runs it, and
              one read a call) timed beside the C++ stitch's (twice
              each, alternating); the two device stitches' strings equal
  9. train    a. 8 train and 2 val TFRecord shards of 512 synthetic
              windows (1,024 samples, dwell 40 +- 8 a base, as
              scripts/bench_train.py) written by the port, then
              radian_tpu_torch.cli.train at the default config (2,200,581
              parameters, batch 32, Adam 1e-4): 2 epochs of 128 steps with
              --eval-edit-distance and --export-npz; the last epoch's loss
              must be below 0.7x the first logged loss, the val loss and
              edit distance finite, the checkpoints and best/ written;
              b. a fresh Trainer restores the newest checkpoint: params and
              optimizer state bit-equal to the trained ones, step 256,
              resume epoch 2; e. the exported .npz basecalls phase 4's
              reads through the decode and backtrace kernels (counts set
              to 0 just before), strings == a CPU Basecaller's on it;
              c. seed 0, batch 8: 3 steps on the card and 3 on the CPU
              over the same batches, in float32 the first step's loss
              within 1e-5 relative and its gradients within 1e-3 of each
              leaf's largest, the 3 losses within 1e-2 (max |dparam|
              reported), then bfloat16 reported; d. batch
              256 in float32 and bfloat16: ms a step, windows/s, model
              TFLOP/s (6 FLOPs a weight a sample), peak GB, and the step
              split by CUDA events into forward / CTC / backward /
              optimizer; the CTC loss's forward + backward timed alone
              beside its plain recursion, their gradients within 1e-3
  10. multi   the multi-GPU paths, on the one card: a. Basecaller(mesh=
              make_mesh(data=2, devices=[cuda:0, cuda:0])), two replicas
              splitting each read_batch, on phase 5's 512 reads (timed,
              the launch counts set to 0 just before: the decode and
              backtrace kernels must launch once a slice), strings ==
              phase 5's; chunk 'fused' and global+LM the same way on
              phase 4's reads, == phases 7 and 5b's card strings; b.
              two processes given torchrun's variables (both LOCAL_RANK
              0, the one card) form the group by initialize() as the
              CLI's --shard-reads does, load a Basecaller on a bare
              'cuda' and run basecall_sharded as rank 0 and 1 of 2 over
              phase 4's reads (a fast5 directory where h5py is
              installed, else the reads), merged: == the unsharded
              fasta; c. a one-rank NCCL
              group: phase 9c's 3 steps (batch 8, f32, cuDNN
              deterministic) bit-equal to the steps without a group (and
              a second run without one, reported), then a step at batch
              256 f32 in the group beside phase 9d's, and the gradient
              all-reduce (2,200,581 f32) alone; d. two processes, two
              gloo ranks on the card, phase 9c's global batches split
              5 + 3 (rank 1 padded with zero-weight filler), 3 steps:
              the ranks' parameters bit-equal, the 3 losses within 1e-5
              relative of 10c's steps without a group
  11. tp      tensor parallelism, the model row on the one card: a.
              Trainer(mesh=make_mesh(1, 2, [cuda:0, cuda:0])) at the
              default config's full width (every conv and dense_relu
              split in two), float32, cuDNN deterministic: phase 9c's 3
              steps held against 10c's unsharded steps with 9c's gates
              (first-step loss 1e-5 relative, gathered first-step
              gradients 1e-3 of each leaf's largest, losses 1e-2), then
              ms a step at batch 256, float32 and bfloat16, beside 9d's;
              b. two gloo rank processes, each with a model row of two
              on the card (a 2x2 grid), on 10d's 5 + 3 split: the ranks'
              gathered parameters bit-equal, the losses held to 11a's
              with 9c's gates (first step 1e-5, all 1e-2); c. 11a's
              export (the full leaves, equal to the gathered ones)
              basecalls phase 4's reads through the
              decode and backtrace kernels, each launched once a batch
              (counts set to 0 just before), and Basecaller(mesh=
              make_mesh(2, 2, [cuda:0] * 4)) gives phase 5's strings on
              them, the kernels launched once a data slice

Each phase prints its seconds ("[phase-time] step=...").

Prints one JSON line of phase 9's numbers, the nvidia-smi line, one JSON
line of kernel numbers, one of phase 5f's counters, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script
exits non-zero before that line.  Needs one CUDA device, nvcc and g++:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
TRAINED = REPO / "bench_data" / "trained" / "params.npz"
# H100 SXM published peaks at 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# phase 6b: the plain LM decode runs this many steps of the first batch
LM_PLAIN_STEPS = 8192
# phase 3b: (beam, ctx_len, packed, bf16 tables, (s_thr, r_thr), zeros)
LM_CASES = ((6, 11, False, False, (0.5, 0.5), False),
            (6, 11, False, True, (0.0, 10.0), False),
            (16, 12, True, False, (0.5, 0.5), False),
            (1, 1, False, False, (0.0, 10.0), False),
            (6, 3, True, True, (0.5, 0.5), False),
            (16, 3, False, True, (0.0, 10.0), False),
            (6, 12, True, True, (0.0, 10.0), True),
            (6, 0, False, True, (0.0, 10.0), False),
            (15, 0, True, False, (0.0, 10.0), False),
            (15, 11, False, False, (0.5, 0.5), False))
# phase 9c, card against CPU in float32 from the same seeded params: the
# first step's loss and gradients (each leaf's largest entry the scale),
# then the losses of 3 steps.  Adam's first updates are lr·sign(g) an
# element, so an element whose gradient is within rounding of 0 moves ±lr
# apart on the two devices: after 3 steps at lr 1e-4 the params differ by
# up to ~3e-4 and the early, unstable losses by up to ~0.3 % (H100 80GB
# HBM3 at 700 W: 2.5e-3), where the same parameters give 1e-7.
FIRST_STEP_LOSS_RTOL = 1e-5
FIRST_STEP_GRAD_RTOL = 1e-3
CARD_VS_CPU_LOSS_RTOL = 1e-2
# phase 9d: F.ctc_loss against the plain recursion, gradients through a
# log-softmax at batch 256, T 1,024: entries are at most 1, but both sides
# carry the loss (~500) in float32 (spacing 6e-5) through their exps
CTC_GRAD_ATOL = 1e-3
# phase 8's card vs CPU strings: the first samples of phase 4's reads,
# in a 2,048-sample bucket; the plain CPU decoder's time on a bucket
# grows faster than its length, and this cut pays for phase 11
PREP_CHECK_SAMPLES = 2000
# bytes of one LM row lookup, by (packed, bf16): dense probs + entropy;
# packed l1 (word, rank) + vals row
ROW_BYTES = {(False, False): 20, (False, True): 10, (True, False): 28,
             (True, True): 18}


def _line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def decode_ops_per_step(w: int) -> int:
    """Operations one decode step needs for one read: ~29·W² (merge tests
    over [4, W, W], top-W selection over 5W slots) + ~83·W (candidate
    scoring, logaddexps, state updates).  The warp kernel does more (each
    lane ranks its slots against all 5W), but a bound counts the work,
    not one design's way of doing it."""
    return 29 * w * w + 83 * w


def lm_ops_per_step(w: int) -> int:
    """Operations the LM fusion adds to one read's decode step: per beam
    two fused 4-base distributions (an add, two multiplies and a log a
    base), the gates, the context shift and one row lookup (~47·W); per
    step the signal's sum, renormalisation, entropy and five logs (~35)."""
    return 47 * w + 35


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    registers, stack frame and spill bytes."""
    out, name, props = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
        elif name and "stack frame" in ln:
            props = ", ".join(x.strip() for x in ln.split(","))
        elif name and "Used" in ln and "registers" in ln:
            w = re.search(r"kernelILi(\d+)E", name)
            kind = re.search(r"(beam_(?:decode_lm|decode|backtrace)_kernel)",
                             name)
            table = re.search(r"(Dense|Packed)TableI(f|\d+__nv_bfloat16)E",
                              name)
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{kind.group(1) if kind else name}"
                       f"{f' W={w.group(1)}' if w else ''}"
                       + (f" {table.group(1).lower()} "
                          f"{'f32' if table.group(2) == 'f' else 'bf16'}"
                          if table else "")
                       + f": {regs} registers, {props}")
            name, props = None, ""
    return out


def random_lm(rng, ctx_len: int, real_frac: float):
    """A KmerLM over every context of ``ctx_len`` bases: a share
    ``real_frac`` of them real, with Dirichlet(0.2) rows (often under the
    0.5 entropy gate), the rest uniform."""
    from radian_tpu_torch.lm.kmer import KmerLM, _entropy_rows

    mask = rng.random(4 ** ctx_len) < real_frac
    probs = np.full((len(mask), 4), 0.25, np.float32)
    probs[mask] = rng.dirichlet(np.full(4, 0.2), int(mask.sum()))
    return KmerLM(ctx_len, probs, _entropy_rows(probs.astype(np.float64)),
                  mask)


def lm_fusion(lm, packed: bool, bf16: bool, dev, thr=(0.5, 0.5)):
    """The decode's LMFusion for ``lm`` on ``dev``: dense or packed
    (``lm.compressed()``), float32 or bfloat16 values."""
    import torch

    from radian_tpu_torch.ops.beam_search import LMFusion

    dtype = torch.bfloat16 if bf16 else torch.float32
    if packed:
        l1, vals = lm.compressed()
        t1, t2 = torch.from_numpy(l1), torch.from_numpy(vals).to(dtype)
    else:
        t1 = torch.from_numpy(lm.probs).to(dtype)
        t2 = torch.from_numpy(lm.entropy).to(dtype)
    return LMFusion(t1.to(dev), t2.to(dev), packed, lm.context_len, *thr)


def table_bytes(fusion) -> int:
    return sum(t.numel() * t.element_size() for t in (fusion.t1, fusion.t2))


def plain_lm_decode(mats, lengths, w, fusion):
    """The plain LM decode on ``[N, T, 5]`` probabilities, in the
    kernel's layouts."""
    import torch

    from radian_tpu_torch.ops import beam_search as plain

    probs_tn = mats.permute(1, 2, 0)
    bp, nlab, score = plain.beam_search_bp(torch.log(probs_tn), lengths, w,
                                           fusion, probs_tn)
    return bp.permute(2, 0, 1), nlab, score


def check_lm_kernel(dev, n: int, t_max: int, cases) -> None:
    """Phase 3b: the LM decode kernel (and the backtrace) vs the plain
    version on Dirichlet(0.2) matrices; fails on any difference, and
    unless the LM changes some strings against the no-LM kernels."""
    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops import beam_search as plain

    rng = np.random.default_rng(5)
    lms = {}
    compared = differing = changed = 0
    for w, ctx, packed, bf16, thr, zero in cases:
        if ctx not in lms:  # ctx 12: a quarter real; shorter: all real
            lms[ctx] = random_lm(rng, ctx, 0.25 if ctx >= 12 else 1.0)
        fusion = lm_fusion(lms[ctx], packed, bf16, dev, thr)
        mats = rng.dirichlet(np.full(5, 0.2), size=(n, t_max))
        mats = mats.astype(np.float32)
        if zero:
            mats[rng.random(mats.shape) < 0.2] = 0.0
        lengths = rng.integers(1, t_max + 1, n).astype(np.int32)
        lengths[:3] = t_max, 0, 1
        m = torch.from_numpy(mats).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        bp_k, nlab_k, sc_k = beam_cuda.beam_decode_lm_cuda(m, ln, w, fusion)
        rev_k = beam_cuda.beam_backtrace_cuda(bp_k)
        bp_p, nlab_p, sc_p = plain_lm_decode(m, ln, w, fusion)
        rev_p = plain.backtrace_batch(bp_p.permute(1, 2, 0))
        rev_nolm, _, _ = beam_cuda.beam_search_cuda(m, ln, w)
        torch.cuda.synchronize()
        bad = ((bp_k != bp_p).flatten(1).any(1) | (rev_k != rev_p).any(1)
               | (nlab_k != nlab_p) | ((sc_k - sc_p).abs() > 1e-5))
        moved = int((rev_k != rev_nolm).any(1).sum())
        compared += n
        differing += int(bad.sum())
        changed += moved
        _line("lm", beam=w, ctx=ctx, table=f"{'packed' if packed else 'dense'}"
              f"-{'bf16' if bf16 else 'f32'}", thresholds=thr, zero_probs=zero,
              reads=n, T=t_max, differing=int(bad.sum()),
              max_abs_score_err=float((sc_k - sc_p).abs().max()),
              strings_changed_by_lm=moved)
    _line("lm", reads_compared=compared, reads_differing=differing,
          strings_changed_by_lm=changed)
    if differing:
        _fail(f"LM decode kernel disagrees with the plain version on "
              f"{differing}/{compared} reads")
    if not changed:
        _fail("the LM changed no string: the fusion never fired")


def e2e_lm(dev, flat, reads, small, opts):
    """Phase 5b: the Basecaller with the bench's LM on the card, float32
    then bfloat16.  Returns the float32 run's launch counts, its first
    batch ``(mats, t_reads)`` and the two runs' LM tables."""
    import torch

    from radian_tpu_torch.lm.kmer import build_dense_tables, random_kmer_model
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.ops.preprocess import mad_normalise
    from radian_tpu_torch.pipeline import (
        Basecaller,
        BasecallOptions,
        _packed_lm_bound_bytes,
    )

    lm = build_dense_tables(random_kmer_model(
        np.random.default_rng(42), context_len=11, n_contexts=200_000,
        concentration=0.2), 11)
    params = params_from_flax(flat)
    n_samples = sum(len(r) for r in reads)
    small_opts = BasecallOptions(beam_width=opts.beam_width, read_batch=4,
                                 bucket_quantum=4096)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        bc = Basecaller(params, lm=lm, options=opts, compute_dtype=dtype,
                        device=dev)
        fusion = bc.lm_fusion
        bc.basecall_signals(reads)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        t0 = time.perf_counter()
        seqs = bc.basecall_signals(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_batches = len(bc.batches(reads))
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        _line("e2e-lm", forward=name, reads=len(reads), batches=n_batches,
              reads_per_s=f"{len(reads) / wall:.2f}",
              msamples_per_s=f"{n_samples / wall / 1e6:.3f}",
              wall_s=f"{wall:.3f}", peak_mem_gb=f"{peak_gb:.2f}",
              lm_layout="packed" if fusion.packed else "dense",
              lm_packed_bound_bytes=_packed_lm_bound_bytes(lm),
              lm_table_dtype=str(fusion.t2.dtype).replace("torch.", ""),
              lm_table_bytes=table_bytes(fusion),
              launches=json.dumps(launches, separators=(",", ":")))
        if (not launches["beam_decode_lm"] or not launches["beam_backtrace"]
                or launches["beam_decode"]):
            _fail(f"the LM path did not run through its kernels: {launches}")
        # the main path's forward: one fused launch a convolution in bf16
        # (12 a batch), none in f32
        want_tcn = 2 * len(bc.model.tcn.blocks) * n_batches
        if launches["tcn_conv"] != (want_tcn if name == "bf16" else 0):
            _fail(f"the {name} LM path launched tcn_conv "
                  f"{launches['tcn_conv']} times over {n_batches} batches")
        if any(not s for s in seqs):
            _fail("a read came back empty or skipped on the LM path")
        first = global_split(bc, reads, "e2e-lm", forward=name)
        want = Basecaller(params, lm=lm, options=small_opts,
                          compute_dtype=dtype,
                          device="cpu").basecall_signals(small)
        got = Basecaller(params, lm=lm, options=small_opts,
                         compute_dtype=dtype,
                         device=dev).basecall_signals(small)
        same = sum(a == b for a, b in zip(got, want))
        _line("e2e-lm-check", forward=name, reads=len(small),
              identical_to_cpu=same, lengths=[len(x) for x in got])
        if name == "f32":
            if same != len(small):
                _fail("card strings differ from the port's CPU run with "
                      "the LM (float32)")
            out = {"launches": launches, "first": first,
                   "fusions": {"f32": fusion}, "small_strings": got}
        else:
            out["fusions"]["bf16"] = fusion
            out["tcn_launches"] = launches["tcn_conv"]
            out["tcn_batches"] = n_batches
        del bc
    # bfloat16 vs float32 probabilities on the card, phase 4's reads
    l_max = max(len(x) for x in small)
    padded = np.zeros((len(small), l_max), np.int16)
    for i, x in enumerate(small):
        padded[i, :len(x)] = x
    lens = torch.tensor([len(x) for x in small], dtype=torch.int32)
    norm, _ = mad_normalise(torch.from_numpy(padded), lens)
    probs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(compute_dtype=dtype)
        model.load_state_dict(params)
        model.to(dev).eval()
        with torch.inference_mode():
            probs[dtype] = model(norm.to(dev)[..., None], probs=True)
    _line("e2e-lm-check", max_abs_dp_bf16_vs_f32=float(
        (probs[torch.float32] - probs[torch.bfloat16]).abs().max()))
    out["lm"] = lm
    return out


def lm_kernels(dev, run, w: int) -> dict:
    """Phase 6b: the LM decode kernel vs its plain version on the first
    batch of the float32 LM run (its first LM_PLAIN_STEPS steps), then
    timed on the whole batch with each table layout beside its bound."""
    import torch

    from radian_tpu_torch.ops import beam_cuda

    mats, t_reads = run["first"]
    fusion = run["fusions"]["f32"]
    n_b, t_b, _ = mats.shape
    k = min(t_b, LM_PLAIN_STEPS)
    m_k = mats[:, :k].contiguous()
    l_k = torch.clamp(t_reads, max=k)
    bp_k, nlab_k, sc_k = beam_cuda.beam_decode_lm_cuda(m_k, l_k, w, fusion)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp_p, nlab_p, sc_p = plain_lm_decode(m_k, l_k, w, fusion)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((sc_k - sc_p).abs().max())
    if not (torch.equal(bp_k, bp_p) and torch.equal(nlab_k, nlab_p)
            and err <= 1e-5):
        _fail("LM decode kernel disagrees with the plain version on the "
              "LM path's first batch")
    k_ms = cuda_ms(lambda: beam_cuda.beam_decode_lm_cuda(m_k, l_k, w, fusion),
                   3)
    _line("lm-kernels", batch_reads=n_b, plain_steps=k, T=t_b, beam=w,
          max_abs_score_err=err, kernel_ms=f"{k_ms:.3f}",
          plain_ms=f"{plain_ms:.1f}")
    # the same LM in each layout; packed rows equal dense rows bit for bit
    tables = {("dense", "f32"): fusion,
              ("dense", "bf16"): run["fusions"]["bf16"],
              ("packed", "f32"): lm_fusion(run["lm"], True, False, dev),
              ("packed", "bf16"): lm_fusion(run["lm"], True, True, dev)}
    out = {"plain_ms": plain_ms, "max_abs_err": err, "plain_steps": k}
    out.update(time_layouts("model", mats, t_reads, w, tables))
    # the row-heavy regime: seeded Dirichlet(0.2) matrices, every read
    # full length, where more gates open and more beams extend
    dm = np.random.default_rng(7).dirichlet(np.full(5, 0.2), (n_b, t_b))
    time_layouts("dirichlet", torch.from_numpy(dm.astype(np.float32)).to(dev),
                 torch.full((n_b,), t_b, dtype=torch.int32, device=dev), w,
                 tables)
    return out


def time_layouts(label, mats, t_reads, w, tables) -> dict:
    """Time the LM decode kernel with each table layout on ``[N, T, 5]``
    probabilities, beside its bound, and the no-LM decode kernel on their
    logs in the same run; print the LM/no-LM and dense/packed ratios.
    Fails unless dense and packed tables of one dtype decode alike."""
    import torch

    from radian_tpu_torch.ops import beam_cuda

    n_b, t_b, _ = mats.shape
    active = (torch.arange(t_b, device=mats.device)[None, :]
              < t_reads.long()[:, None])[..., None]  # [N, T, 1]
    steps = int(active.sum())
    out, bps = {}, {}
    for (layout, dt), f in tables.items():
        bps[layout, dt] = bp = beam_cuda.beam_decode_lm_cuda(
            mats, t_reads, w, f)[0]
        n_ext = int((((bp.int() & 7) != 0) & active).sum())
        row_b = ROW_BYTES[layout == "packed", dt == "bf16"]
        ms = cuda_ms(
            lambda: beam_cuda.beam_decode_lm_cuda(mats, t_reads, w, f), 3)
        b_ms, b_by = bound(
            20 * steps + w * t_b * n_b + 8 * n_b + row_b * n_ext,
            (decode_ops_per_step(w) + lm_ops_per_step(w)) * steps)
        out[layout, dt] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        # table bytes: the bound's (one row per extension) and what the
        # kernel requests (all 4W child rows of every live step, before
        # any cache)
        _line("lm-kernels", input=label, table=f"{layout}-{dt}",
              table_bytes=table_bytes(f), active_steps=steps,
              row_lookups=n_ext, bound_row_bytes=row_b * n_ext,
              fetched_row_bytes=row_b * 4 * w * steps, decode_ms=f"{ms:.3f}",
              decode_us_per_step=f"{ms * 1e3 / t_b:.3f}",
              bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    for dt in ("f32", "bf16"):
        if not torch.equal(bps["dense", dt], bps["packed", dt]):
            _fail(f"dense and packed {dt} tables decode differently "
                  f"({label})")
    logm = beam_cuda.log_probs(mats)
    nolm_ms = cuda_ms(lambda: beam_cuda.beam_decode_cuda(logm, t_reads, w), 3)
    _line("lm-kernels", input=label, nolm_decode_ms=f"{nolm_ms:.3f}",
          lm_over_nolm_dense_f32=f"{out['dense', 'f32']['ms'] / nolm_ms:.3f}",
          dense_over_packed_f32=(
              f"{out['dense', 'f32']['ms'] / out['packed', 'f32']['ms']:.3f}"))
    return out


def zero_launches() -> None:
    from radian_tpu_torch.ops import beam_cuda, tcn_conv

    for k in (beam_cuda.beam_decode_cuda, beam_cuda.beam_decode_lm_cuda,
              beam_cuda.beam_backtrace_cuda, tcn_conv.tcn_conv):
        k.launches = 0


def read_launches() -> dict:
    from radian_tpu_torch.ops import beam_cuda, tcn_conv

    return {"beam_decode": beam_cuda.beam_decode_cuda.launches,
            "beam_decode_lm": beam_cuda.beam_decode_lm_cuda.launches,
            "beam_backtrace": beam_cuda.beam_backtrace_cuda.launches,
            "tcn_conv": tcn_conv.tcn_conv.launches}


def timed_run(dev, bc, reads, phase: str, warm: bool = True,
              **kv) -> tuple[list, dict]:
    """A warm-up run (unless the caller ran these batches already), then
    a timed run of ``bc.basecall_signals`` with every launch count set to
    0 just before it; prints reads/s, Msamples/s and peak memory; returns
    the strings and the counts."""
    import torch

    if warm:
        bc.basecall_signals(reads)  # cuDNN plans, allocator, library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    seqs = bc.basecall_signals(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_samples = sum(len(r) for r in reads)
    _line(phase, **kv, reads=len(reads), batches=len(bc.batches(reads)),
          reads_per_s=f"{len(reads) / wall:.2f}",
          msamples_per_s=f"{n_samples / wall / 1e6:.3f}",
          wall_s=f"{wall:.3f}",
          peak_mem_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}",
          launches=json.dumps(launches, separators=(",", ":")))
    if any(not s for s in seqs):
        _fail(f"a read came back empty or skipped ({phase})")
    return seqs, launches


def chunk_split(bc, reads, phase: str, heads: str) -> tuple:
    """Per-batch split of a fused chunk path, synchronised after each
    step: the full-read forward, the windows' probabilities (``heads``:
    the head fix-up forward and the gather, or the gather alone), the
    decode (log, kernel, backtrace, crop, compaction) and the host stitch
    (label copy included).  Returns the first batch's ``(probs, lens)``."""
    import torch

    first, split = None, []
    for idxs, bucket in bc.batches(reads):
        sig_t, len_t = bc.pad_batch(idxs, bucket, reads)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        geom = bc.chunk_geometry(len_t, bucket)
        norm, probs_full, mads = bc.chunk_forward(sig_t, len_t)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        probs = bc.chunk_window_probs(norm, probs_full, geom)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed, n_lab = bc.chunk_decode(probs, geom)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        bc.path.render(bc, bc.path.batch(idxs, bucket), [
            x.cpu().numpy() for x in (mads, packed, geom.n_dec, n_lab)], {})
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        split.append(ms)
        _line(f"{phase}-batch", bucket=bucket, reads=len(idxs),
              windows=probs.shape[0], active_steps=int(geom.lens.sum()),
              fullread_forward_ms=f"{ms[0]:.2f}", **{heads: f"{ms[1]:.2f}"},
              decode_ms=f"{ms[2]:.2f}", stitch_ms=f"{ms[3]:.2f}")
        if first is None:
            first = (probs, geom.lens.reshape(-1).to(torch.int32))
        del probs, norm, probs_full
    mean = np.mean(split, axis=0)
    _line(phase, fullread_forward_ms_per_batch=f"{mean[0]:.2f}",
          **{f"{heads}_per_batch": f"{mean[1]:.2f}"},
          decode_ms_per_batch=f"{mean[2]:.2f}",
          stitch_ms_per_batch=f"{mean[3]:.2f}")
    return first


def chunk_window_diff(dev, phase: str, make, sigs) -> None:
    """For a card-vs-CPU string mismatch on a fused chunk path: print the
    windows whose labels differ between the two devices and the max
    |dp| of their probabilities (``make(device)`` builds the
    Basecaller; all reads go into one batch of the largest bucket,
    which changes no window's values)."""
    import torch

    out = {}
    for d, on_cpu in (("cpu", True), (dev, False)):
        bc = make(d)
        bucket = bc._bucket(max(len(s) for s in sigs))
        sig_t, len_t = bc.pad_batch(list(range(len(sigs))), bucket, sigs)
        geom = bc.chunk_geometry(len_t, bucket)
        probs = bc.chunk_window_probs(*bc.chunk_forward(sig_t, len_t)[:2],
                                      geom)
        packed, n_lab = bc.chunk_decode(probs, geom)
        out[on_cpu] = (probs.cpu(), packed.cpu(), n_lab.cpu(),
                       geom.n_dec.cpu())
    (p_c, k_c, n_c, d_c), (p_g, k_g, n_g, _) = out[True], out[False]
    n_rows = n_c.shape[1]
    for j in range(len(sigs)):
        for w in range(int(d_c[j])):
            if n_c[j, w] != n_g[j, w] or not torch.equal(k_c[j, w], k_g[j, w]):
                r = j * n_rows + w
                _line(f"{phase}-diff", read=j, window=w,
                      labels_cpu=int(n_c[j, w]), labels_card=int(n_g[j, w]),
                      max_abs_dp=float((p_c[r] - p_g[r]).abs().max()))


def e2e_chunk(dev, reads, small) -> dict:
    """Phase 7: chunk mode with the defaults (fused, reference consensus)
    on the card, timed and split; card strings vs the port's CPU strings
    for 'fused', 'windows' and 'fullprobs' with the tiled crop."""
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    opts = BasecallOptions(decode_type="chunk", beam_width=6, read_batch=256,
                           bucket_quantum=4096)
    bc = load_basecaller(TRAINED, options=opts, device=dev)
    if (not bc.path.use_chunk_fused or bc.path.chunk_head != 256
            or bc.path.chunk_tiled):
        _fail("the default chunk options did not pick the fused path")
    _, launches = timed_run(dev, bc, reads, "chunk", path="fused",
                            forward="f32")
    if (not launches["beam_decode"] or not launches["beam_backtrace"]
            or launches["beam_decode_lm"]):
        _fail(f"the chunk path did not run through its kernels: {launches}")
    first = chunk_split(bc, reads, "chunk", "head_forward_ms")
    got = {}
    for prep in ("fused", "windows", "fullprobs"):
        small_opts = BasecallOptions(decode_type="chunk", chunk_prep=prep,
                                     beam_width=6, read_batch=4,
                                     bucket_quantum=4096)

        def make(d, o=small_opts):
            return load_basecaller(TRAINED, options=o, device=d)

        want = make("cpu").basecall_signals(small)
        got[prep] = make(dev).basecall_signals(small)
        same = sum(a == b for a, b in zip(got[prep], want))
        _line("chunk-check", path=prep, reads=len(small),
              identical_to_cpu=same, lengths=[len(s) for s in got[prep]])
        if same != len(small):
            if prep != "windows":
                chunk_window_diff(dev, "chunk-check", make, small)
            _fail(f"chunk card strings differ from the port's CPU run "
                  f"({prep})")
    if got["fused"] != got["windows"]:
        _fail("chunk 'fused' and 'windows' strings differ on the card")
    return {"launches": launches, "first": first,
            "small_strings": got["fused"]}


def e2e_chunk_lm(dev, flat, reads, small, lm) -> dict:
    """Phase 7b: 'fullprobs' + tiled crop + chunk_lm with the bench's LM:
    float32 card vs CPU strings on phase 4's reads; the bfloat16 forward
    and tables timed and split on the 512 reads, its strings vs the
    CPU's bfloat16 run (reported); warm single-read latency beside
    global+LM's."""
    import torch

    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

    params = params_from_flax(flat)
    kw = dict(decode_type="chunk", chunk_prep="fullprobs", chunk_lm=True,
              beam_width=6, bucket_quantum=4096)

    def make(d, dtype=torch.float32, read_batch=4):
        return Basecaller(params, lm=lm, options=BasecallOptions(
            read_batch=read_batch, **kw), compute_dtype=dtype, device=d)

    want = make("cpu").basecall_signals(small)
    got = make(dev).basecall_signals(small)
    same = sum(a == b for a, b in zip(got, want))
    _line("chunk-lm-check", forward="f32", reads=len(small),
          identical_to_cpu=same, lengths=[len(s) for s in got])
    if same != len(small):
        chunk_window_diff(dev, "chunk-lm-check", make, small)
        _fail("chunk_lm card strings differ from the port's CPU run (f32)")
    bc = make(dev, torch.bfloat16, 256)
    if not (bc.path.chunk_tiled and bc.path.chunk_lm) \
            or bc.path.crop_off != 640:
        _fail("chunk_lm did not pick the tiled crop")
    _, launches = timed_run(dev, bc, reads, "chunk-lm", forward="bf16",
                            lm_table_dtype=str(bc.lm_fusion.t2.dtype)
                            .replace("torch.", ""),
                            crop_off=bc.path.crop_off,
                            crop_stride=bc.path.crop_stride)
    if (not launches["beam_decode_lm"] or not launches["beam_backtrace"]
            or launches["beam_decode"]):
        _fail(f"chunk_lm did not run through its kernels: {launches}")
    # the bf16 full-read forward takes the fused TCN kernels, one launch a
    # convolution
    if (not launches["tcn_conv"]
            or launches["tcn_conv"] % (2 * len(bc.model.tcn.blocks))):
        _fail(f"chunk_lm's bf16 forward launched tcn_conv "
              f"{launches['tcn_conv']} times")
    first = chunk_split(bc, reads, "chunk-lm", "window_gather_ms")
    want = make("cpu", torch.bfloat16).basecall_signals(small)
    got = make(dev, torch.bfloat16).basecall_signals(small)
    _line("chunk-lm-check", forward="bf16", reads=len(small),
          identical_to_cpu=sum(a == b for a, b in zip(got, want)),
          lengths=[len(s) for s in got])
    # warm single-read latency, the median-length read of the 512
    read = sorted(reads, key=len)[len(reads) // 2]
    for name, bc1 in (("chunk_lm", make(dev, torch.bfloat16, 1)),
                      ("global_lm", Basecaller(
                          params, lm=lm, options=BasecallOptions(
                              beam_width=6, read_batch=1,
                              bucket_quantum=4096),
                          compute_dtype=torch.bfloat16, device=dev))):
        ms = []
        for _ in range(6):  # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bc1.basecall_signals([read])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        _line("chunk-lm-latency", path=name, forward="bf16",
              samples=len(read), median_ms=f"{np.median(ms[1:]):.2f}",
              runs_ms=[round(x, 2) for x in ms[1:]])
    return {"launches": launches, "first": first, "fusion": bc.lm_fusion}


def chunk_kernels(dev, chunk_run, lm_run, w: int) -> dict:
    """Phase 7c: each kernel vs its plain version on the first chunk
    batch's window matrices (all of them, length-0 windows included),
    then timed there beside its bound; the LM kernel the same on the
    first chunk_lm batch with that run's tables."""
    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops import beam_search as plain

    out = {}
    probs, lens = chunk_run["first"]
    n_b, t_b, _ = probs.shape
    if not (lens == 0).any():
        _fail("the compared chunk batch has no length-0 windows")
    logm = beam_cuda.log_probs(probs)
    bp_k, nlab_k, sc_k = beam_cuda.beam_decode_cuda(logm, lens, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp_p, nlab_p, sc_p = plain.beam_search_bp(logm.permute(1, 2, 0), lens, w)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((sc_k - sc_p).abs().max())
    if not (torch.equal(bp_k, bp_p.permute(2, 0, 1)) and
            torch.equal(nlab_k, nlab_p) and err <= 1e-5):
        _fail("decode kernel disagrees with the plain version on the chunk "
              "batch")
    rev_k = beam_cuda.beam_backtrace_cuda(bp_k)
    t0 = time.perf_counter()
    rev_p = plain.backtrace_batch(bp_k.permute(1, 2, 0))
    torch.cuda.synchronize()
    bt_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(rev_k, rev_p):
        _fail("backtrace kernel disagrees with the plain version on the "
              "chunk batch")
    steps = int(lens.long().sum())
    ms = cuda_ms(lambda: beam_cuda.beam_decode_cuda(logm, lens, w), 3)
    b_ms, b_by = bound(20 * steps + w * t_b * n_b + 12 * n_b,
                       decode_ops_per_step(w) * steps)
    bt_ms = cuda_ms(lambda: beam_cuda.beam_backtrace_cuda(bp_k), 5)
    bt_b_ms, bt_b_by = bound(t_b * n_b * (1 + 4), 3 * t_b * n_b)
    shape = [n_b, t_b, w]
    out["decode"] = {"launches": chunk_run["launches"]["beam_decode"],
                     "shape": shape, "active_steps": steps,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
    out["backtrace"] = {"launches": chunk_run["launches"]["beam_backtrace"],
                        "shape": shape, "max_abs_err": 0.0, "ms": bt_ms,
                        "plain_ms": bt_plain_ms, "bound_ms": bt_b_ms,
                        "bound_by": bt_b_by}
    _line("chunk-kernels", windows=n_b, T=t_b, beam=w, active_steps=steps,
          zero_length_windows=int((lens == 0).sum()), max_abs_score_err=err,
          decode_ms=f"{ms:.3f}", decode_plain_ms=f"{plain_ms:.1f}",
          decode_bound_ms=f"{b_ms:.4f}", decode_bound_by=b_by,
          ns_per_window_step=f"{ms * 1e6 / steps:.3f}",
          backtrace_ms=f"{bt_ms:.3f}", backtrace_plain_ms=f"{bt_plain_ms:.1f}",
          backtrace_bound_ms=f"{bt_b_ms:.4f}")

    probs, lens = lm_run["first"]
    fusion = lm_run["fusion"]
    n_b, t_b, _ = probs.shape
    if not (lens == 0).any():
        _fail("the compared chunk_lm batch has no length-0 windows")
    bp_k, nlab_k, sc_k = beam_cuda.beam_decode_lm_cuda(probs, lens, w, fusion)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp_p, nlab_p, sc_p = plain_lm_decode(probs, lens, w, fusion)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((sc_k - sc_p).abs().max())
    if not (torch.equal(bp_k, bp_p) and torch.equal(nlab_k, nlab_p)
            and err <= 1e-5):
        _fail("LM decode kernel disagrees with the plain version on the "
              "chunk_lm batch")
    active = (torch.arange(t_b, device=probs.device)[None, :]
              < lens.long()[:, None])[..., None]
    steps = int(active.sum())
    n_ext = int((((bp_k.int() & 7) != 0) & active).sum())
    row_b = ROW_BYTES[fusion.packed, fusion.t2.dtype == torch.bfloat16]
    ms = cuda_ms(lambda: beam_cuda.beam_decode_lm_cuda(probs, lens, w,
                                                       fusion), 3)
    b_ms, b_by = bound(20 * steps + w * t_b * n_b + 8 * n_b + row_b * n_ext,
                       (decode_ops_per_step(w) + lm_ops_per_step(w)) * steps)
    out["decode_lm"] = {"launches": lm_run["launches"]["beam_decode_lm"],
                        "shape": [n_b, t_b, w], "active_steps": steps,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
    _line("chunk-kernels", kernel="beam_decode_lm", windows=n_b, T=t_b,
          beam=w, active_steps=steps, row_lookups=n_ext,
          zero_length_windows=int((lens == 0).sum()),
          table=f"{'packed' if fusion.packed else 'dense'}-"
                f"{str(fusion.t2.dtype).replace('torch.', '')}",
          max_abs_score_err=err, decode_ms=f"{ms:.3f}",
          decode_plain_ms=f"{plain_ms:.1f}", decode_bound_ms=f"{b_ms:.4f}",
          decode_bound_by=b_by, ns_per_window_step=f"{ms * 1e6 / steps:.3f}")
    return out


def global_split(bc, reads, phase: str, **kv) -> tuple:
    """Per-batch ``bc.forward`` (prep, model, assembly) and ``bc.decode``
    ms of a global path, synchronised after each, with the forward's
    TFLOP/s.  Returns the first batch's ``(mats, t_reads)``."""
    import torch

    fwd_ms, dec_ms, first = [], [], None
    # model FLOPs per sample: 2 per weight (conv kernels and dense matrices)
    flop_per_sample = 2 * sum(p.numel() for p in bc.model.parameters()
                              if p.dim() > 1)
    for idxs, bucket in bc.batches(reads):
        sig_t, len_t = bc.pad_batch(idxs, bucket, reads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mats, t_reads, _ = bc.forward(sig_t, len_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bc.decode(mats, t_reads)
        torch.cuda.synchronize()
        fwd_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) * 1e3)
        tflops = flop_per_sample * sig_t.numel() / (fwd_ms[-1] * 1e9)
        _line(f"{phase}-batch", **kv, bucket=bucket, reads=len(idxs),
              T=mats.shape[1], forward_ms=f"{fwd_ms[-1]:.2f}",
              decode_ms=f"{dec_ms[-1]:.2f}", forward_tflops=f"{tflops:.1f}",
              decode_us_per_step=f"{dec_ms[-1] * 1e3 / mats.shape[1]:.2f}")
        if first is None:
            first = (mats, t_reads.to(torch.int32))
        else:
            del mats, t_reads
    _line(phase, **kv, forward_ms_per_batch=f"{np.mean(fwd_ms):.2f}",
          decode_ms_per_batch=f"{np.mean(dec_ms):.2f}")
    return first


def global_prep(dev, reads, small, opts) -> dict:
    """Phase 8: the global 'strips', 'windows' and 'mean' forwards on
    phase 5's reads, each split per batch (the warm-up) then timed with
    the launch counts set to 0; their first batch's matrices against the
    full-read forward's; card vs CPU strings on the first
    PREP_CHECK_SAMPLES samples of phase 4's reads for the three and the
    fallback geometry (step 96); the decode and backtrace
    kernels vs their plain versions on the 'mean' batch.  Returns the
    'mean' run's counts."""
    import dataclasses

    import torch

    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops import beam_search as plain
    from radian_tpu_torch.pipeline import load_basecaller

    w = opts.beam_width
    full = load_basecaller(TRAINED, options=opts, device=dev)
    rf = full.model.receptive_field
    ref = None
    out = {}
    for name, kw in (("strips", dict(prep_mode="strips")),
                     ("windows", dict(prep_mode="windows")),
                     ("mean", dict(assembly_mode="mean"))):
        bc = load_basecaller(TRAINED, options=dataclasses.replace(opts, **kw),
                             device=dev)
        if bc.path.use_fullread or bc.path.use_strips is not (
                name == "strips"):
            _fail(f"prep {name} did not pick its forward")
        mats, t_reads = global_split(bc, reads, "global-prep", path=name)
        _, launches = timed_run(dev, bc, reads, "global-prep", warm=False,
                                path=name, forward="f32")
        if (not launches["beam_decode"] or not launches["beam_backtrace"]
                or launches["beam_decode_lm"]):
            _fail(f"global {name} did not run through its kernels: "
                  f"{launches}")
        if ref is None:
            idxs, bucket = full.batches(reads)[0]
            ref, ref_t, _ = full.forward(*full.pad_batch(idxs, bucket,
                                                          reads))
            del full
        if not (torch.equal(t_reads.long(), ref_t.long())
                and torch.isfinite(mats).all()):
            _fail(f"global {name}: lengths or values wrong on the first "
                  "batch")
        t_len = mats.shape[1]
        dp = (mats - ref[:, :t_len]).abs()
        late, early = float(dp[:, rf - 1:].max()), float(dp[:, :rf - 1].max())
        _line("global-prep-check", path=name, T=t_len,
              max_abs_dp_vs_fullread_from_rf=f"{late:.3e}",
              max_abs_dp_vs_fullread_first_rf_rows=f"{early:.3e}")
        if name != "mean" and not late <= 1e-4:
            _fail(f"global {name} matrices differ from the full-read "
                  f"forward's by {late} from row RF-1 on")
        out[name] = {"launches": launches}
        if name == "mean":
            out["first"] = (mats, t_reads)
        del bc, mats
    del ref

    head = [x[:PREP_CHECK_SAMPLES] for x in small]
    for name, kw in (("strips", dict(prep_mode="strips")),
                     ("windows", dict(prep_mode="windows")),
                     ("mean", dict(assembly_mode="mean")),
                     ("step96", dict(step_size=96))):
        small_opts = dataclasses.replace(opts, read_batch=4,
                                         bucket_quantum=2048, **kw)
        want = load_basecaller(TRAINED, options=small_opts,
                               device="cpu").basecall_signals(head)
        got = load_basecaller(TRAINED, options=small_opts,
                              device=dev).basecall_signals(head)
        same = sum(a == b for a, b in zip(got, want))
        _line("global-prep-check", path=name, reads=len(head),
              samples=PREP_CHECK_SAMPLES, identical_to_cpu=same,
              lengths=[len(x) for x in got])
        if same != len(head):
            _fail(f"global {name}: card strings differ from the port's CPU "
                  "run")

    # the kernels on the 'mean' batch: plain versions on its first 16
    # rows, clamped to 2,048 steps; the decode kernel timed on all of it
    mats, t_reads = out["first"]
    m16 = mats[:16, :2048].contiguous()
    l16 = torch.clamp(t_reads[:16], max=2048).contiguous()
    logm = beam_cuda.log_probs(m16)
    bp_k, nlab_k, sc_k = beam_cuda.beam_decode_cuda(logm, l16, w)
    bp_p, nlab_p, sc_p = plain.beam_search_bp(logm.permute(1, 2, 0), l16, w)
    err = float((sc_k - sc_p).abs().max())
    rev_k = beam_cuda.beam_backtrace_cuda(bp_k)
    rev_p = plain.backtrace_batch(bp_k.permute(1, 2, 0))
    exact = (torch.equal(bp_k, bp_p.permute(2, 0, 1))
             and torch.equal(nlab_k, nlab_p) and err <= 1e-5)
    logm = beam_cuda.log_probs(mats)
    ms = cuda_ms(lambda: beam_cuda.beam_decode_cuda(logm, t_reads, w), 3)
    _line("global-prep-kernels", path="mean", compared_rows=16,
          compared_steps=int(l16.sum()), max_abs_score_err=err,
          decode_bit_exact=exact, backtrace_equal=torch.equal(rev_k, rev_p),
          decode_ms_whole_batch=f"{ms:.3f}",
          decode_us_per_step=f"{ms * 1e3 / mats.shape[1]:.3f}")
    if not exact:
        _fail("decode kernel disagrees with the plain version on the "
              "'mean' batch")
    if not torch.equal(rev_k, rev_p):
        _fail("backtrace kernel disagrees with the plain version on the "
              "'mean' batch")
    del out["first"]
    return out


def device_consensus(dev, reads, small) -> dict:
    """Phase 8b: chunk 'fused' with ``consensus='device'``: card vs CPU
    strings on phase 4's reads (the card run with the launch counts set
    to 0 just before it); on phase 7's first batch, the host collect
    with the device stitch (one padded call, and one read a call) timed
    beside the C++ stitch's."""
    import torch

    from radian_tpu_torch.ops.beam_search import rows_to_seqs, unpack_labels2
    from radian_tpu_torch.ops.consensus_device import (
        assemble_fragments_device,
    )
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    kw = dict(decode_type="chunk", beam_width=6, bucket_quantum=4096)
    small_opts = BasecallOptions(consensus="device", read_batch=4, **kw)
    want = load_basecaller(TRAINED, options=small_opts,
                           device="cpu").basecall_signals(small)
    bc = load_basecaller(TRAINED, options=small_opts, device=dev)
    if not bc.path.use_chunk_fused or bc.path.chunk_tiled:
        _fail("device consensus did not run on the fused path")
    zero_launches()
    got = bc.basecall_signals(small)
    torch.cuda.synchronize()
    launches = read_launches()
    same = sum(a == b for a, b in zip(got, want))
    _line("consensus-device-check", path="fused", reads=len(small),
          identical_to_cpu=same, lengths=[len(x) for x in got],
          launches=json.dumps(launches, separators=(",", ":")))
    if (not launches["beam_decode"] or not launches["beam_backtrace"]
            or launches["beam_decode_lm"]):
        _fail(f"device consensus did not run through its kernels: "
              f"{launches}")
    if same != len(small) or any(not x for x in got):
        _fail("device consensus: card strings differ from the port's CPU "
              "run")

    stitch = {c: load_basecaller(TRAINED, options=BasecallOptions(
        consensus=c, read_batch=256, **kw), device=dev)
        for c in ("reference", "device")}
    bc = stitch["device"]
    idxs, bucket = bc.batches(reads)[0]
    sig_t, len_t = bc.pad_batch(idxs, bucket, reads)
    geom = bc.chunk_geometry(len_t, bucket)
    norm, probs_full, mads = bc.chunk_forward(sig_t, len_t)
    probs = bc.chunk_window_probs(norm, probs_full, geom)
    del norm, probs_full
    packed, n_lab = bc.chunk_decode(probs, geom)
    torch.cuda.synchronize()
    rec = (mads, packed, geom.n_dec, n_lab)
    # the device stitch as the pipeline runs it (every read's votes in one
    # padded call) beside the C++ stitch and, for comparison, the device
    # stitch one read a call (the JAX package's way), fragments rendered
    # from the same labels
    def per_read():
        p, n = packed.cpu().numpy(), n_lab.cpu().numpy()
        w = geom.n_dec.cpu().numpy()
        return [assemble_fragments_device(
            rows_to_seqs(unpack_labels2(p[j, :w[j]], n[j, :w[j]])),
            device=dev)[::-1] for j in range(len(idxs))]

    seqs, ms = {}, {}
    for c in ("reference", "device", "per_read") * 2:
        res = {}
        t0 = time.perf_counter()
        if c == "per_read":
            seqs[c] = per_read()
        else:
            p = stitch[c].path
            p.render(stitch[c], p.batch(idxs, bucket),
                     [x.cpu().numpy() for x in rec], res)
            seqs[c] = [res[i] for i in idxs]
        torch.cuda.synchronize()
        ms.setdefault(c, []).append((time.perf_counter() - t0) * 1e3)
    agree = sum(a == b for a, b in zip(seqs["device"], seqs["reference"]))
    _line("consensus-device", bucket=bucket, reads=len(idxs),
          windows=int(geom.n_dec[:len(idxs)].sum()),
          cpp_stitch_ms=[round(x, 2) for x in ms["reference"]],
          device_stitch_ms=[round(x, 2) for x in ms["device"]],
          device_stitch_per_read_ms=[round(x, 2) for x in ms["per_read"]],
          strings_equal_to_cpp=agree)
    if any(not x for x in seqs["device"]):
        _fail("device consensus gave an empty string on the chunk batch")
    if seqs["per_read"] != seqs["device"]:
        _fail("device consensus: the batched and per-read stitches differ")
    return {"launches": launches}


def _train_split(trainer, batch, reps: int) -> dict:
    """Mean ms of each part of a train step, CUDA events between them:
    the forward, the CTC loss (weighted mean), the backward and the
    optimizer update."""
    import torch

    from radian_tpu_torch.ops.ctc import ctc_loss

    parts = ("forward", "ctc", "backward", "optimizer")
    ms = dict.fromkeys(parts, 0.0)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        lp = trainer.model(batch["signal"][..., None], train=True)
        ev[1].record()
        losses = ctc_loss(lp, batch["input_length"], batch["labels"],
                          batch["label_length"])
        w = batch["weight"]
        loss = (losses * w).sum() / w.sum().clamp_min(1.0)
        ev[2].record()
        grads = torch.autograd.grad(loss, list(trainer.params.values()))
        ev[3].record()
        trainer.opt_state = trainer.tx.apply(
            trainer.params, dict(zip(trainer.params, grads)),
            trainer.opt_state)
        trainer.step += 1
        ev[4].record()
        ev[4].synchronize()
        for i, p in enumerate(parts):
            ms[p] += ev[i].elapsed_time(ev[i + 1]) / reps
    return ms


def train_phase(dev, small) -> dict:
    """Phase 9: training through the port's CLI at full width (see the
    module docstring, a-e).  Returns the numbers of the "train" line and
    the decode kernels' launches in 9e."""
    import tempfile

    import torch

    from radian_tpu_torch.cli import train as train_cli
    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.io.tfrecord import write_shard
    from radian_tpu_torch.models.sig2seq import param_count
    from radian_tpu_torch.ops import tcn_conv
    from radian_tpu_torch.ops.ctc import ctc_loss, ctc_loss_reference
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    out = {}
    rng = np.random.default_rng(9)
    levels = kmer_level_table(rng)
    # scripts/bench_train.py's traffic: RNA002-like dwell, ~26 labels a
    # 1,024-sample window
    traffic = dict(window=1024, levels=levels, dwell_mean=40.0,
                   dwell_std=8.0)
    with tempfile.TemporaryDirectory(prefix="radian-train-") as tmp:
        tmp = Path(tmp)
        # 9a. shards, then the CLI: default config, batch 32, 2 epochs
        t0 = time.perf_counter()
        for split, n_shards in (("train", 8), ("val", 2)):
            (tmp / "shards" / split).mkdir(parents=True)
            for s in range(n_shards):
                b = synth_windows(rng, 512, **traffic)
                write_shard(tmp / "shards" / split / f"{s}.tfrecords", [
                    {"signal": b["signal"][i],
                     "label": b["labels"][i][: b["label_length"][i]].astype(
                         np.float32),
                     "signal_length": 1024,
                     "label_length": int(b["label_length"][i])}
                    for i in range(512)])
        shards_s = time.perf_counter() - t0
        ck, logs, npz = tmp / "ckpt", tmp / "logs", tmp / "trained.npz"
        t0 = time.perf_counter()
        trainer = train_cli.main([
            "-s", str(tmp / "shards"), "--steps-per-epoch", "128",
            "--n-epochs", "2", "--device", str(dev),
            "--checkpoint-dir", str(ck), "--log-dir", str(logs),
            "--eval-edit-distance", "--export-npz", str(npz)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        log = [json.loads(x) for x in
               (logs / "metrics.jsonl").read_text().splitlines()]
        first = next(x["value"] for x in log if x["tag"] == "train/loss")
        epoch_loss = [x["value"] for x in log
                      if x["tag"] == "train/epoch_loss"]
        val = [x["value"] for x in log if x["tag"] == "val/loss"]
        ed = [x["value"] for x in log if x["tag"] == "val/edit_distance"]
        rate = [x["value"] for x in log
                if x["tag"] == "train/windows_per_s"]
        _line("train-cli", shards_s=f"{shards_s:.1f}", cli_s=f"{cli_s:.1f}",
              steps=trainer.step, first_logged_loss=f"{first:.3f}",
              epoch_loss=[round(x, 3) for x in epoch_loss],
              val_loss=[round(x, 3) for x in val],
              val_edit_distance=[round(x, 4) for x in ed],
              windows_per_s=[round(x, 1) for x in rate])
        out.update(first_logged_loss=first, epoch_loss=epoch_loss,
                   val_loss=val, val_edit_distance=ed, cli_s=cli_s)
        if trainer.step != 256 or len(epoch_loss) != 2:
            _fail(f"train: {trainer.step} steps over {len(epoch_loss)} "
                  "epochs, 256 over 2 expected")
        if not epoch_loss[-1] < 0.7 * first:
            _fail(f"train: last epoch loss {epoch_loss[-1]} is not below "
                  f"0.7 x the first logged loss {first}")
        if (len(val) != 2 or len(ed) != 2
                or not np.isfinite(val + ed).all()):
            _fail(f"train: val loss {val}, edit distance {ed}")
        best = [p.name for p in (ck / "best").iterdir()]
        if (sorted(p.name for p in ck.iterdir()) != ["0", "1", "best"]
                or best != [str(int(np.argmin(val)))]):
            _fail(f"train: checkpoints {sorted(ck.iterdir())}, best {best}")

        # 9b. resume: a fresh Trainer restores the newest checkpoint
        fresh = Trainer(default_config(), TrainConfig(
            checkpoint_dir=str(ck), device=str(dev)))
        resume = fresh.restore_checkpoint()
        same = (all(torch.equal(fresh.params[k], v)
                    for k, v in trainer.params.items())
                and fresh.opt_state.count == trainer.opt_state.count
                and all(torch.equal(fresh.opt_state.slots[s][k], v)
                        for s, b in trainer.opt_state.slots.items()
                        for k, v in b.items()))
        _line("train-resume", resume_epoch=resume, step=fresh.step,
              params_and_opt_state_bit_equal=same)
        if not same or resume != 2 or fresh.step != 256:
            _fail("train: the restored checkpoint is not the trained state")
        del fresh, trainer

        # 9e. basecall with the exported weights, through the kernels
        opts = BasecallOptions(beam_width=6, read_batch=4,
                               bucket_quantum=4096)
        want = load_basecaller(npz, options=opts,
                               device="cpu").basecall_signals(small)
        bc = load_basecaller(npz, options=opts, device=dev)
        zero_launches()
        got = bc.basecall_signals(small)
        torch.cuda.synchronize()
        launches = read_launches()
        same = sum(a == b for a, b in zip(got, want))
        _line("train-basecall", reads=len(small), identical_to_cpu=same,
              lengths=[len(x) for x in got],
              launches=json.dumps(launches, separators=(",", ":")))
        if (not launches["beam_decode"] or not launches["beam_backtrace"]
                or launches["beam_decode_lm"]):
            _fail(f"train: the exported weights did not basecall through "
                  f"the decode kernels: {launches}")
        if same != len(small):
            _fail("train: card strings of the trained weights differ from "
                  "the CPU's")
        out["basecall_launches"] = launches

    # 9c. card vs CPU: seed 0, full width, batch 8, the same 3 batches
    batches = [synth_windows(rng, 8, **traffic) for _ in range(3)]
    for dtype in ("float32", "bfloat16"):
        losses, grads, params, secs = {}, {}, {}, {}
        for d in (dev, "cpu"):
            tr = Trainer(default_config(), TrainConfig(
                checkpoint_dir=None, device=str(d), compute_dtype=dtype))
            t0 = time.perf_counter()
            # the first step's gradients, from the same seeded params
            g = torch.autograd.grad(tr.loss(tr._put_batch(batches[0])),
                                    list(tr.params.values()))
            grads[str(d)] = [x.cpu() for x in g]
            losses[str(d)] = [float(tr.train_step(tr._put_batch(b)))
                              for b in batches]
            secs[str(d)] = time.perf_counter() - t0
            params[str(d)] = {k: v.detach().cpu()
                              for k, v in tr.params.items()}
        card, cpu = (np.asarray(losses[k]) for k in (str(dev), "cpu"))
        rel = np.abs(card - cpu) / np.abs(cpu)
        grad_rel = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(grads[str(dev)], grads["cpu"]))
        dp = max(float((params[str(dev)][k] - v).abs().max())
                 for k, v in params["cpu"].items())
        _line("train-card-vs-cpu", dtype=dtype, steps=3, batch=8,
              card_losses=[round(float(x), 5) for x in card],
              cpu_losses=[round(float(x), 5) for x in cpu],
              rel_loss_diff=[f"{x:.3e}" for x in rel],
              first_step_grad_rel_diff=f"{grad_rel:.3e}",
              max_abs_param_diff=f"{dp:.3e}",
              card_s=f"{secs[str(dev)]:.1f}", cpu_s=f"{secs['cpu']:.1f}")
        if dtype == "float32":
            out["batches_9c"] = batches
        out[f"card_vs_cpu_{dtype}"] = {
            "rel_loss_diff": rel.tolist(),
            "first_step_grad_rel_diff": grad_rel,
            "max_abs_param_diff": dp, "cpu_s": secs["cpu"]}
        if dtype == "float32" and not (
                rel[0] <= FIRST_STEP_LOSS_RTOL
                and grad_rel <= FIRST_STEP_GRAD_RTOL
                and rel.max() <= CARD_VS_CPU_LOSS_RTOL):
            _fail(f"train: card and CPU differ (float32): losses {rel} "
                  f"relative (first step > {FIRST_STEP_LOSS_RTOL} or any > "
                  f"{CARD_VS_CPU_LOSS_RTOL}), first-step gradients "
                  f"{grad_rel} of each leaf's largest (> "
                  f"{FIRST_STEP_GRAD_RTOL})")

    # 9d. throughput at batch 256 (scripts/bench_train.py's middle size);
    # a training step, autograd on, never takes the fused TCN kernels
    b = synth_windows(rng, 256, **traffic)
    tcn_before = tcn_conv.tcn_conv.launches
    for dtype in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        tr = Trainer(default_config(), TrainConfig(
            checkpoint_dir=None, device=str(dev), compute_dtype=dtype))
        batch = tr._put_batch(b)
        for _ in range(3):  # cuDNN plans, the allocator
            tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        n_steps = 10
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss = tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        split = _train_split(tr, batch, 3)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        # 2 FLOPs a weight a sample forward, twice that backward
        tflops = 6 * param_count(tr.model) * 256 * 1024 / step_ms / 1e9
        _line("train-throughput", dtype=dtype, batch=256,
              ms_per_step=f"{step_ms:.2f}",
              windows_per_s=f"{256e3 / step_ms:.1f}",
              model_tflops=f"{tflops:.2f}", peak_mem_gb=f"{peak_gb:.2f}",
              loss=f"{float(loss):.3f}",
              **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})
        out[f"throughput_{dtype}"] = {
            "ms_per_step": step_ms, "windows_per_s": 256e3 / step_ms,
            "model_tflops": tflops, "peak_gb": peak_gb, "split_ms": split}
    out["tcn_launches"] = tcn_conv.tcn_conv.launches - tcn_before

    # the CTC loss alone, forward and backward, on this batch's
    # log-probabilities: F.ctc_loss beside the plain recursion
    with torch.no_grad():
        lp = tr.model(batch["signal"][..., None]).detach()
    args = (batch["input_length"], batch["labels"], batch["label_length"])

    def ctc_step(fn):
        x = lp.clone().requires_grad_()
        fn(x, *args).sum().backward()

    ctc_ms = cuda_ms(lambda: ctc_step(ctc_loss), 5)
    t0 = time.perf_counter()
    ctc_step(ctc_loss_reference)
    torch.cuda.synchronize()
    ctc_plain_ms = (time.perf_counter() - t0) * 1e3
    # F.ctc_loss's backward is the gradient with respect to the logits of
    # a log-softmax: compare the two through one
    grads = []
    for fn in (ctc_loss, ctc_loss_reference):
        x = lp.clone().requires_grad_()
        fn(torch.log_softmax(x, -1), *args).sum().backward()
        grads.append(x.grad)
    ctc_err = float((grads[0] - grads[1]).abs().max())
    # bound: log-probs read and their gradient written; the alpha and beta
    # recursions over each row's 2U+1 states (~12 operations a state-step
    # each) and ~5 a (step, class) for the gradient
    n, t, c = lp.shape
    states = int((2 * batch["label_length"].long() + 1).sum())
    ctc_bound, ctc_by = bound(2 * n * t * c * 4,
                              2 * 12 * states * t + 5 * n * t * c)
    _line("train-ctc", batch=n, T=t, ms=f"{ctc_ms:.3f}",
          plain_ms=f"{ctc_plain_ms:.1f}", bound_ms=f"{ctc_bound:.4f}",
          bound_by=ctc_by, max_abs_grad_err=f"{ctc_err:.3e}")
    if not ctc_err <= CTC_GRAD_ATOL:
        _fail(f"train: F.ctc_loss's gradient differs from the plain "
              f"recursion's by {ctc_err}")
    out["ctc"] = {"ms": ctc_ms, "plain_ms": ctc_plain_ms,
                  "bound_ms": ctc_bound, "bound_by": ctc_by,
                  "library_ms": ctc_ms, "max_abs_grad_err": ctc_err}
    return out


# phase 10d: two gloo ranks on one card against one process, 3 steps
# (both with cuDNN deterministic, so the two differ only in the ranks'
# partial sums); measured on the card at most 1.1e-7.  Adam's first
# updates are lr·sign(g) an element, so a stack that rounds the partial
# sums further apart can move an element ±lr apart and miss this: a CPU
# rehearsal of the phase put step 3 at 1.6e-4
DDP_LOSS_RTOL = 1e-5
DDP_SPLIT = 5  # rank 0's rows of each global batch of 8; rank 1 pads 3
DDP_TIMEOUT_S = 300
# phase 10b's Basecaller, in each rank and unsharded
SHARD_OPTS = dict(beam_width=6, read_batch=2, bucket_quantum=4096)


def mesh_inference(dev, reads, opts, want, e2e_rate, small, small_want,
                   chunk_want, lm, lm_want) -> dict:
    """Phase 10a: ``Basecaller(mesh=make_mesh(data=2, devices=[dev,
    dev]))``, two replicas on the one card, against phases 5, 7 and 5b's
    strings; every slice must launch the decode (or LM decode) and the
    backtrace kernels.  Returns the 512-read run's launch counts."""
    import torch

    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.pipeline import (
        Basecaller,
        BasecallOptions,
        load_basecaller,
    )

    mesh = make_mesh(data=2, devices=[dev, dev])
    bc = load_basecaller(TRAINED, options=opts, mesh=mesh, device=dev)
    seqs, launches = timed_run(dev, bc, reads, "mesh", path="global",
                               data=2, replicas=len(bc._replicas))
    slices = 2 * len(bc.batches(reads))
    same = sum(a == b for a, b in zip(seqs, want))
    _line("mesh", path="global", identical_to_phase5=same,
          phase5_reads_per_s=f"{e2e_rate:.2f}", slices=slices)
    if same != len(reads):
        _fail(f"mesh strings differ from phase 5's on {len(reads) - same} "
              "reads")
    if (launches["beam_decode"] != slices
            or launches["beam_backtrace"] != slices
            or launches["beam_decode_lm"]):
        _fail(f"a mesh slice did not launch its kernels: {launches} for "
              f"{slices} slices")
    out = {"launches": launches}
    params = params_from_flax(load_params_npz(TRAINED))
    small_kw = dict(beam_width=6, read_batch=4, bucket_quantum=4096)
    for path, want_small, kw, lm_ in (
            ("chunk-fused", chunk_want, dict(decode_type="chunk"), None),
            ("global-lm", lm_want, {}, lm)):
        bc = Basecaller(params, lm=lm_, options=BasecallOptions(
            **small_kw, **kw), mesh=mesh, device=dev)
        zero_launches()
        got = bc.basecall_signals(small)
        torch.cuda.synchronize()
        n = read_launches()
        decode = "beam_decode_lm" if lm_ is not None else "beam_decode"
        slices = 2 * len(bc.batches(small))
        same = sum(a == b for a, b in zip(got, want_small))
        _line("mesh", path=path, reads=len(small), identical=same,
              slices=slices, launches=json.dumps(n, separators=(",", ":")))
        if same != len(small):
            _fail(f"mesh strings differ from the unsharded card run "
                  f"({path})")
        if n[decode] != slices or n["beam_backtrace"] != slices:
            _fail(f"a mesh slice did not launch its kernels ({path}): {n}")
    return out


def sharded_reads(dev, small, tmp: Path) -> None:
    """Phase 10b: two processes, each given torchrun's variables, run
    ``basecall_sharded`` as rank 0 and 1 of 2 over phase 4's reads (a
    fast5 directory where h5py is installed, else the reads themselves);
    their shards merged equal this process's unsharded fasta."""
    import socket

    from radian_tpu_torch.io.fast5 import Fast5Read
    from radian_tpu_torch.parallel.distributed import merge_fasta_shards
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    ids = [f"read{i}" for i in range(len(small))]
    np.savez(tmp / "reads.npz", **dict(zip(ids, small)))
    try:
        import h5py
    except ImportError:
        source = "reads (no h5py here)"
    else:
        (tmp / "f5").mkdir()
        with h5py.File(tmp / "f5" / "reads.fast5", "w") as f:
            for rid, sig in zip(ids, small):
                raw = f.create_group(f"read_{rid}/Raw")
                raw.attrs["read_id"] = rid
                raw.create_dataset("Signal", data=sig)
        source = "fast5"
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    outs = rank_processes("--shard-rank", tmp, dev, env=lambda r: dict(
        RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
    merged = merge_fasta_shards(tmp / "sharded", tmp / "merged.fasta", ids)
    reads = [Fast5Read(rid, sig) for rid, sig in zip(ids, small)]
    load_basecaller(TRAINED, options=BasecallOptions(**SHARD_OPTS), device=dev
                    ).basecall_directory(None, tmp / "one", verbose=False,
                                         reads=reads)
    same = ((tmp / "merged.fasta").read_text()
            == (tmp / "one" / "reads-0.fasta").read_text())
    _line("shard-reads", source=source, ranks=[o["rank"] for o in outs],
          devices=[o["device"] for o in outs],
          written=[o["written"] for o in outs], merged=merged,
          merged_equals_unsharded=same,
          seconds=[round(o["seconds"], 1) for o in outs])
    if [o["rank"] for o in outs] != [0, 1] or any(
            o["world"] != 2 for o in outs):
        _fail(f"the shard ranks did not form a group of 2: {outs}")
    if not same or merged != len(small):
        _fail("the merged fasta shards differ from the unsharded fasta")


def shard_rank_main(rank: int, tmp: Path, device: str) -> int:
    """One rank of phase 10b (``chip_smoke.py --shard-rank R DIR cuda``,
    torchrun's variables set): the CLI's --shard-reads route."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from radian_tpu_torch.io.fast5 import Fast5Read
    from radian_tpu_torch.parallel.distributed import (
        basecall_sharded,
        initialize,
        world_size,
    )
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller

    t0 = time.perf_counter()
    initialize(device=device)
    bc = load_basecaller(TRAINED, options=BasecallOptions(**SHARD_OPTS), device=device)
    reads = None
    f5 = tmp / "f5"
    if not f5.exists():
        data = np.load(tmp / "reads.npz")
        reads = [Fast5Read(rid, data[rid]) for rid in data]
    written = basecall_sharded(bc, f5, tmp / "sharded", False, reads=reads)
    print(json.dumps({"rank": dist.get_rank(), "world": world_size(),
                      "device": str(bc.device), "written": written,
                      "seconds": time.perf_counter() - t0}))
    dist.destroy_process_group()
    return 0


def rank_processes(flag: str, tmp: Path, dev, env=None) -> list[dict]:
    """Run ``chip_smoke.py FLAG R TMP DEVICE`` for ranks 0 and 1 together,
    each with ``env(R)`` added, within DDP_TIMEOUT_S; the last stdout line
    of each, as JSON."""
    import os

    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         str(tmp), dev.type], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, **(env(r) if env else {})))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DDP_TIMEOUT_S)
            if p.returncode != 0:
                _fail(f"rank process {flag} failed (exit {p.returncode}):"
                      f"\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def one_rank_group(dev, batches, tmp: Path, step_ms_9d: float) -> dict:
    """Phase 10c: the Trainer's steps in a one-rank NCCL group equal the
    steps without a group bit for bit (cuDNN deterministic for both);
    then a step at batch 256 f32 in the group, beside phase 9d's, and the
    gradient all-reduce alone."""
    import datetime

    import torch
    import torch.distributed as dist

    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    def steps():
        tr = Trainer(default_config(), TrainConfig(checkpoint_dir=None,
                                                   device=str(dev)))
        losses = [tr.train_step(tr._put_batch(b)) for b in batches]
        return tr.grouped, losses, tr.params

    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {"none": steps(), "none_again": steps()}
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl'}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        runs["group"] = steps()
        torch.backends.cudnn.deterministic = det

        def equal(a, b):
            return (all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
                    and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

        rerun_equal = equal(runs["none"], runs["none_again"])
        group_equal = equal(runs["none"], runs["group"])
        dp = max(float((runs["group"][2][k] - v).abs().max())
                 for k, v in runs["none"][2].items())
        _line("ddp-one-rank", backend="nccl", grouped=runs["group"][0],
              steps=len(batches), rerun_bit_equal=rerun_equal,
              group_bit_equal=group_equal, max_abs_param_diff=f"{dp:.3e}",
              losses=[float(x) for x in runs["group"][1]])
        if not runs["group"][0] or not group_equal:
            _fail("the Trainer's steps in a one-rank NCCL group differ "
                  "from the steps without a group")
        out.update(group_bit_equal=group_equal, rerun_bit_equal=rerun_equal,
                   losses_no_group=[float(x) for x in runs["none"][1]])
        del runs

        # batch 256 f32 in the group, as phase 9d
        rng = np.random.default_rng(10)
        b = synth_windows(rng, 256, window=1024,
                          levels=kmer_level_table(rng), dwell_mean=40.0,
                          dwell_std=8.0)
        torch.cuda.empty_cache()
        tr = Trainer(default_config(), TrainConfig(checkpoint_dir=None,
                                                   device=str(dev)))
        batch = tr._put_batch(b)
        for _ in range(3):
            tr.train_step(batch)
        torch.cuda.synchronize()
        n_steps = 10
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        flat = torch.cat([p.detach().reshape(-1)
                          for p in tr.params.values()])
        ar_ms = cuda_ms(lambda: dist.all_reduce(flat), 20)
        cat_ms = cuda_ms(lambda: torch.cat([p.detach().reshape(-1)
                                            for p in tr.params.values()]), 20)
        _line("ddp-one-rank", batch=256, dtype="float32",
              ms_per_step=f"{step_ms:.2f}",
              phase9d_ms_per_step=f"{step_ms_9d:.2f}",
              allreduce_ms=f"{ar_ms:.4f}", cat_ms=f"{cat_ms:.4f}",
              allreduce_mb=f"{flat.numel() * 4 / 1e6:.2f}")
        out.update(ms_per_step=step_ms, phase9d_ms_per_step=step_ms_9d,
                   allreduce_ms=ar_ms, cat_ms=cat_ms,
                   params=int(flat.numel()))
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()
    return out


def two_ranks(dev, batches, want_losses, tmp: Path) -> dict:
    """Phase 10d: two processes, two gloo ranks on the one card, 3 steps
    on phase 9c's global batches of 8 (rank 0 5 rows, rank 1 3 padded
    to 5): the ranks' parameters equal, the losses within DDP_LOSS_RTOL
    of one process's on the card (phase 10c, cuDNN deterministic)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()  # this process's cache, for the ranks'
    np.savez(tmp / "batches.npz", **{f"{s}/{k}": v
                                     for s, b in enumerate(batches)
                                     for k, v in b.items()})
    outs = rank_processes("--ddp-rank", tmp, dev)
    params = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
              for r in range(2)]
    equal = all(torch.equal(v, params[1][k]) for k, v in params[0].items())
    got = np.asarray(outs[0]["losses"])
    rel = np.abs(got - want_losses) / np.abs(want_losses)
    _line("ddp-two-ranks", backend="gloo", ranks=2, steps=len(batches),
          rows=[o["rows"] for o in outs], params_bit_equal=equal,
          losses=[float(x) for x in got],
          one_process_losses=[float(x) for x in want_losses],
          rel_loss_diff=[f"{x:.3e}" for x in rel],
          seconds=[round(o["seconds"], 1) for o in outs])
    if not equal or outs[0]["losses"] != outs[1]["losses"]:
        _fail("the two ranks' parameters or losses differ")
    if not rel.max() <= DDP_LOSS_RTOL:
        _fail(f"two ranks' losses differ from one process's by {rel} "
              f"relative (> {DDP_LOSS_RTOL})")
    return {"params_bit_equal": equal, "rel_loss_diff": rel.tolist()}


def ddp_rank_main(rank: int, tmp: Path, device: str) -> int:
    """One rank of phase 10d (``chip_smoke.py --ddp-rank R DIR cuda``)."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'gloo'}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    torch.backends.cudnn.deterministic = True
    cfg = default_config()
    cfg.train.batch_size = DDP_SPLIT
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=None, device=device))
    data = np.load(tmp / "batches.npz")
    rows = slice(0, DDP_SPLIT) if rank == 0 else slice(DDP_SPLIT, None)
    losses, real = [], []
    for s in range(len({k.split("/")[0] for k in data})):
        local = {k.split("/")[1]: data[k][rows] for k in data
                 if k.startswith(f"{s}/")}
        batch = tr._put_batch(local)
        real.append([batch["signal"].shape[0], float(batch["weight"].sum())])
        losses.append(float(tr.train_step(batch)))
    torch.save({k: v.detach().cpu() for k, v in tr.params.items()},
               tmp / f"rank{rank}.pt")
    print(json.dumps({"rank": tr.rank, "world": tr.world, "losses": losses,
                      "rows": real, "seconds": time.perf_counter() - t0}))
    torch.distributed.destroy_process_group()
    return 0


# phase 11b: two ranks with a model row each against one process's
# sharded steps (11a), both cuDNN deterministic, held to phase 9c's
# gates (the first step's loss FIRST_STEP_LOSS_RTOL, every loss
# CARD_VS_CPU_LOSS_RTOL): the ranks' partial gradient sums round apart,
# and Adam's sign-like first updates amplify that, as in 9c.  Measured
# on the card (H100 80GB HBM3, 700 W): steps 1-2 equal, step 3 1.35e-5
# apart, where 10d's unsharded ranks stayed within 1.1e-7


def _grad_rel(got: dict, want: dict) -> float:
    """The largest gradient difference, each leaf's over its largest."""
    return max(float((got[k] - v).abs().max() / v.abs().max())
               for k, v in want.items())


def tensor_parallel(dev, batches, want_losses, small, small_want,
                    step_ms_9d: dict, tmp: Path) -> dict:
    """Phase 11 (see the module docstring, a-c).  Returns the numbers of
    the "train" line's "tensor_parallel" entry and the decode kernels'
    launches in 11c."""
    import torch

    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.models.checkpoint import (
        gather_params,
        leaf_name,
        load_params_npz,
        params_to_flax,
        save_params_npz,
    )
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer
    from radian_tpu_torch.utils.synthetic import kmer_level_table, synth_windows

    out = {}
    mesh = make_mesh(1, 2, [dev, dev])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # 11a. 3 steps of phase 9c's batches against 10c's unsharded ones
        grads = {}
        for name, m in (("whole", None), ("tp", mesh)):
            tr = Trainer(default_config(), TrainConfig(
                checkpoint_dir=None, device=str(dev)), mesh=m)
            g = torch.autograd.grad(tr.loss(tr._put_batch(batches[0])),
                                    list(tr.params.values()))
            grads[name] = gather_params(dict(zip(tr.params, g)), "cpu")
        split = sorted({leaf_name(k)[0] for k in tr.params
                        if leaf_name(k)[1] is not None})
        n_split = sum(v.numel() for k, v in gather_params(tr.params).items()
                      if k in split)
        losses = np.asarray([float(tr.train_step(tr._put_batch(b)))
                             for b in batches])
    finally:
        torch.backends.cudnn.deterministic = det
    rel = np.abs(losses - want_losses) / np.abs(want_losses)
    grad_rel = _grad_rel(grads["tp"], grads["whole"])
    _line("tp-steps", mesh="1x2", devices=[str(d) for d in tr.row],
          split_leaves=len(split), split_params=n_split,
          losses=[float(x) for x in losses],
          unsharded_losses=[float(x) for x in want_losses],
          rel_loss_diff=[f"{x:.3e}" for x in rel],
          first_step_grad_rel_diff=f"{grad_rel:.3e}")
    if len(split) != 28 or n_split != 2_199_936:
        _fail(f"tp: {len(split)} leaves ({n_split} parameters) split, 28 "
              "(2,199,936) expected")
    if not (rel[0] <= FIRST_STEP_LOSS_RTOL and grad_rel <= FIRST_STEP_GRAD_RTOL
            and rel.max() <= CARD_VS_CPU_LOSS_RTOL):
        _fail(f"tp: the sharded steps differ from the unsharded ones: "
              f"losses {rel} relative, first-step gradients {grad_rel}")
    out.update(losses=losses.tolist(), rel_loss_diff=rel.tolist(),
               first_step_grad_rel_diff=grad_rel, split_params=n_split)

    # 11c. the export: the full leaves, through the decode kernels
    npz = tmp / "tp.npz"
    save_params_npz(tr.model, npz)
    flat, gathered = load_params_npz(npz), params_to_flax(tr.model)
    export_equal = flat.keys() == gathered.keys() and all(
        np.array_equal(v, gathered[k]) for k, v in flat.items())
    opts = BasecallOptions(beam_width=6, read_batch=4, bucket_quantum=4096)
    bc = load_basecaller(npz, options=opts, device=dev)
    zero_launches()
    got = bc.basecall_signals(small)
    torch.cuda.synchronize()
    launches = read_launches()
    n_batches = len(bc.batches(small))
    _line("tp-export", export_equals_gathered=export_equal,
          reads=len(small), batches=n_batches, lengths=[len(x) for x in got],
          launches=json.dumps(launches, separators=(",", ":")))
    if not export_equal:
        _fail("tp: the export is not the gathered parameters")
    if (launches["beam_decode"] != n_batches
            or launches["beam_backtrace"] != n_batches
            or launches["beam_decode_lm"] or not all(got)):
        _fail(f"tp: the export did not basecall through the decode "
              f"kernels once a batch: {launches}, lengths "
              f"{[len(x) for x in got]}")
    out["basecall_launches"] = launches
    mesh22 = make_mesh(2, 2, [dev] * 4)
    bc = load_basecaller(TRAINED, options=opts, mesh=mesh22, device=dev)
    zero_launches()
    got = bc.basecall_signals(small)
    torch.cuda.synchronize()
    n = read_launches()
    slices = 2 * len(bc.batches(small))
    same = sum(a == b for a, b in zip(got, small_want))
    _line("tp-mesh", mesh="2x2", replicas=len(bc._replicas), reads=len(small),
          identical_to_phase5=same, slices=slices,
          launches=json.dumps(n, separators=(",", ":")))
    if same != len(small):
        _fail("tp: the 2x2 mesh's strings differ from phase 5's")
    if n["beam_decode"] != slices or n["beam_backtrace"] != slices:
        _fail(f"tp: a 2x2 mesh slice did not launch its kernels: {n}")
    out["mesh_2x2"] = {"identical": same, "launches": n}
    del bc

    # 11a. ms a step at batch 256 beside 9d's
    rng = np.random.default_rng(11)
    b = synth_windows(rng, 256, window=1024, levels=kmer_level_table(rng),
                      dwell_mean=40.0, dwell_std=8.0)
    for dtype in ("float32", "bfloat16"):
        del tr
        torch.cuda.empty_cache()
        tr = Trainer(default_config(), TrainConfig(
            checkpoint_dir=None, device=str(dev), compute_dtype=dtype),
            mesh=mesh)
        batch = tr._put_batch(b)
        for _ in range(3):
            tr.train_step(batch)
        torch.cuda.synchronize()
        n_steps = 10
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        tr_split = _train_split(tr, batch, 3)
        _line("tp-throughput", mesh="1x2", dtype=dtype, batch=256,
              ms_per_step=f"{step_ms:.2f}",
              phase9d_ms_per_step=f"{step_ms_9d[dtype]:.2f}",
              **{f"{k}_ms": f"{v:.2f}" for k, v in tr_split.items()})
        out[f"throughput_{dtype}"] = {
            "ms_per_step": step_ms, "phase9d_ms_per_step": step_ms_9d[dtype],
            "split_ms": tr_split}
    del tr, batch
    torch.cuda.empty_cache()

    # 11b. two ranks, a model row each
    (tmp / "b").mkdir()
    np.savez(tmp / "b" / "batches.npz", **{f"{s}/{k}": v
                                           for s, b in enumerate(batches)
                                           for k, v in b.items()})
    outs = rank_processes("--tp-rank", tmp / "b", dev)
    params = [np.load(tmp / "b" / f"rank{r}.npz") for r in range(2)]
    equal = all(np.array_equal(params[0][k], params[1][k])
                for k in params[0].files)
    got = np.asarray(outs[0]["losses"])
    rel = np.abs(got - losses) / np.abs(losses)
    _line("tp-two-ranks", backend="gloo", mesh="2x2",
          rows=[o["row"] for o in outs], params_bit_equal=equal,
          losses=[float(x) for x in got],
          rel_loss_diff_vs_11a=[f"{x:.3e}" for x in rel],
          seconds=[round(o["seconds"], 1) for o in outs])
    if not equal or outs[0]["losses"] != outs[1]["losses"]:
        _fail("tp: the two ranks' parameters or losses differ")
    if not (rel[0] <= FIRST_STEP_LOSS_RTOL
            and rel.max() <= CARD_VS_CPU_LOSS_RTOL):
        _fail(f"tp: two ranks' losses differ from one process's by {rel} "
              f"relative (first step > {FIRST_STEP_LOSS_RTOL} or any > "
              f"{CARD_VS_CPU_LOSS_RTOL})")
    out["two_ranks"] = {"params_bit_equal": equal,
                        "rel_loss_diff": rel.tolist()}
    return out


def tp_rank_main(rank: int, tmp: Path, device: str) -> int:
    """One rank of phase 11b (``chip_smoke.py --tp-rank R DIR cuda``): a
    model row of two on the one card, 10d's split."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from radian_tpu_torch.config import default_config
    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.parallel import make_mesh
    from radian_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'gloo'}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    torch.backends.cudnn.deterministic = True
    cfg = default_config()
    cfg.train.batch_size = DDP_SPLIT
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=None),
                 mesh=make_mesh(2, 2, [device] * 4))
    data = np.load(tmp / "batches.npz")
    rows = slice(0, DDP_SPLIT) if rank == 0 else slice(DDP_SPLIT, None)
    losses = []
    for s in range(len({k.split("/")[0] for k in data})):
        local = {k.split("/")[1]: data[k][rows] for k in data
                 if k.startswith(f"{s}/")}
        losses.append(float(tr.train_step(tr._put_batch(local))))
    np.savez(tmp / f"rank{rank}.npz", **params_to_flax(tr.model))
    print(json.dumps({"rank": tr.rank, "world": tr.world, "losses": losses,
                      "row": [str(d) for d in tr.row],
                      "seconds": time.perf_counter() - t0}))
    dist.destroy_process_group()
    return 0


# phase 5c: the fused TCN kernels against their plain version on the card
# (an output of each block from the same input), and the whole bf16
# forward's probabilities against the unfused path's.  (reads, T): the
# first global batch; T off a multiple of the kernel's 128-row tile and 32
TCN_CASES = ((256, 8192), (4, 4001))
# The kernel and the plain version sum the f32 products in another order:
# the two sums differ by up to ~sqrt(K) f32 ulps of the sum of |products|
# (2^-19 of it, K = 768), and each bf16 rounding after can flip by one ulp
# of the value rounded there: the product (+ bias), the residual sum, the
# output.  A difference is counted in flips: |d| over the sum of those
# allowances; 1 = one flip at every point
TCN_MAX_FLIPS = 2.0
# The whole bf16 forward's probabilities, fused against unfused (max |dp|
# over every read, step and class), as a share of the unfused bf16
# forward's own max |dp| from the f32 forward on the same reads: the two
# bf16 paths differ only by those flips, carried through six blocks, and
# must stay nearer each other than bf16 is to f32.  Readings on an H100
# (T 8,192 / 4,001): fused vs unfused 0.0622 / 0.0310, unfused vs f32
# 0.1002 / 0.0736, shares 0.62 / 0.42; 1 would be bf16's own error
TCN_MAX_DP_SHARE = 0.8


def _ulp(x):
    import torch

    return torch.exp2(torch.floor(torch.log2(x.float().abs())) - 7)


def _flips(got, want, x, w, d, bias, residual=None) -> float:
    """Largest ``|got - want|`` of ``tcn_conv(x, w, bias, d, ...)`` in
    flips (above); ``residual``: the block input the convolution's output
    is added to, ``[N, T, C]``."""
    import torch

    product = _product_f32(x, w, d)
    room = (_ulp(product.abs() + bias.float().abs()) + _ulp(want)
            + _product_f32(x.abs(), w.abs(), d) * 2.0 ** -19)
    del product
    if residual is not None:
        room += _ulp(residual)
    diff = (got.float() - want.float()).abs()
    return float(torch.where(diff > 0, diff / room, 0.0).max())


def _product_f32(x, w, d):
    """The convolution of ``tcn_conv``'s ``x`` and packed ``w`` without
    bias, in f32 (TF32 off), ``[N, T, C_out]``."""
    from radian_tpu_torch.models.tcn import causal_conv1d

    c_in = x.shape[2]
    w = w.float().view(w.shape[0], -1, c_in).transpose(1, 2).contiguous()
    return causal_conv1d(x.float().transpose(1, 2), w, None,
                         d).transpose(1, 2)


def tcn_phase(dev, flat) -> dict:
    """Phase 5c: the fused TCN path (``ops/tcn_conv.py``,
    ``csrc/tcn_conv.cu``) on TCN_CASES: each convolution's kernel output
    against the plain version on the card; the forward's probabilities
    against the unfused path's; launches a forward (one a convolution on
    the bf16 path, none in f32); times of the kernel, the plain version
    and the unfused cuDNN + glue path beside the bound."""
    import torch

    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.ops import tcn_conv as tc
    from radian_tpu_torch.ops.preprocess import mad_normalise
    from radian_tpu_torch.utils.synthetic import kmer_level_table

    peak_ops = 989e12  # H100 SXM bf16 dense, 700 W
    params = params_from_flax(flat)
    models = {}
    for dt in (torch.bfloat16, torch.float32):
        models[dt] = build_model(compute_dtype=dt)
        models[dt].load_state_dict(params)
        models[dt].to(dev).eval()
    model = models[torch.bfloat16]
    blocks = model.tcn.blocks
    levels = kmer_level_table(np.random.default_rng(1))
    out = {}
    for n, t_len in TCN_CASES:
        rng = np.random.default_rng(7)
        lens = rng.integers(min(5120, t_len // 2), t_len + 1, n)
        lens[0] = t_len
        padded = np.zeros((n, t_len), np.int16)
        for i, x in enumerate(synth_signals(rng, lens, levels)):
            padded[i, :len(x)] = x
        norm, _ = mad_normalise(torch.from_numpy(padded).to(dev),
                                torch.from_numpy(lens.astype(np.int32)).to(dev))
        sig = norm.to(torch.bfloat16)
        flips, differ, convs = [], [], []
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            h = None
            for block in blocks:
                d = block.conv0.dilation
                w0, b0 = tc.packed(block.conv0, torch.bfloat16)
                w1, b1 = tc.packed(block.conv1, torch.bfloat16)
                if h is None:
                    w_sc, b_sc = tc.packed(block.shortcut, torch.bfloat16)
                    x0, kw = sig[..., None], {
                        "shortcut": (sig, w_sc.view(-1), b_sc)}
                    res = sig[..., None] * w_sc.view(-1) + b_sc
                else:
                    x0, kw, res = h, {"residual": h}, h
                y_k = tc.tcn_conv(x0, w0, b0, d)
                y_p = tc.tcn_conv_plain(x0, w0, b0, d)
                u0 = _flips(y_k, y_p, x0, w0, d, b0)
                h_k = tc.tcn_conv(y_p, w1, b1, d, **kw)
                h_p = tc.tcn_conv_plain(y_p, w1, b1, d, **kw)
                u1 = _flips(h_k, h_p, y_p, w1, d, b1, res)
                differ.append(round(float((h_k != h_p).float().mean()), 5))
                flips.append((round(u0, 3), round(u1, 3)))
                convs.append((x0, w0, b0, d, {}))
                convs.append((y_p, w1, b1, d, kw))
                h = h_p
            del y_k, y_p, h_k, h_p, h, res
            x = norm[..., None]
            tc.tcn_conv.launches = 0
            p_fused = model(x, probs=True)
            launches_bf16 = tc.tcn_conv.launches
            tc.tcn_conv.launches = 0
            p_f32 = models[torch.float32](x, probs=True)
            launches_f32 = tc.tcn_conv.launches
        # the unfused path: autograd on, nothing to record
        model.requires_grad_(False)
        with torch.enable_grad():
            p_unfused = model(x, probs=True)
            lib_ms = cuda_ms(lambda: model.tcn(
                sig[:, None, :]).transpose(1, 2).contiguous(), 3)
        model.requires_grad_(True)
        dp = float((p_fused - p_unfused).abs().max())
        dp_bf16 = float((p_unfused - p_f32).abs().max())
        dp_fused_f32 = float((p_fused - p_f32).abs().max())
        del p_fused, p_unfused, p_f32
        with torch.inference_mode():
            fused_ms = cuda_ms(lambda: tc.tcn_forward(model.tcn, sig), 3)
            model_ms = cuda_ms(lambda: model(x, probs=True), 3)
            conv_ms = [cuda_ms(lambda c=c: tc.tcn_conv(c[0], c[1], c[2], c[3],
                                                       **c[4]), 3)
                       for c in convs]
            plain_ms = [cuda_ms(lambda c=c: tc.tcn_conv_plain(
                c[0], c[1], c[2], c[3], **c[4]), 3) for c in convs]
        del convs
        rows = n * t_len
        flops = 2 * rows * sum(p.numel() for p in model.tcn.parameters()
                               if p.dim() > 1)
        # bf16 elements a row: the signal, block 0's first output, each
        # GEMM convolution's input read and output written, and the
        # residual read again by the second convolution of blocks 1-5
        n_bytes = rows * 2 * (1 + 256 + 11 * 2 * 256 + 5 * 256)
        bound_ms, bound_by = max((flops / peak_ops * 1e3, "operations"),
                                 (n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes"))
        worst = max(max(u) for u in flips)
        _line("tcn", reads=n, T=t_len, max_flips=json.dumps(flips),
              share_differing=json.dumps(differ),
              max_abs_dp_vs_unfused=f"{dp:.3e}",
              max_abs_dp_unfused_vs_f32=f"{dp_bf16:.3e}",
              max_abs_dp_vs_f32=f"{dp_fused_f32:.3e}",
              launches_bf16=launches_bf16, launches_f32=launches_f32,
              stack_ms=f"{fused_ms:.3f}", bound_ms=f"{bound_ms:.3f}",
              bound_by=bound_by, library_ms=f"{lib_ms:.3f}",
              plain_ms=f"{sum(plain_ms):.3f}", model_ms=f"{model_ms:.3f}",
              tflops=f"{flops / fused_ms / 1e9:.1f}",
              conv_ms=json.dumps([round(v, 3) for v in conv_ms]))
        if not worst <= TCN_MAX_FLIPS:
            _fail(f"fused TCN kernel {worst} roundings from its plain "
                  f"version (T {t_len})")
        if not dp <= TCN_MAX_DP_SHARE * dp_bf16:
            _fail(f"the fused forward's probabilities are {dp} from the "
                  f"unfused path's (T {t_len}), over {TCN_MAX_DP_SHARE} of "
                  f"the unfused bf16 path's {dp_bf16} from f32")
        if launches_bf16 != 2 * len(blocks) or launches_f32:
            _fail(f"tcn_conv launched {launches_bf16} times a bf16 forward "
                  f"and {launches_f32} in f32")
        out[t_len] = {"ms": fused_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "plain_ms": sum(plain_ms),
                      "library_ms": lib_ms, "model_ms": model_ms,
                      "max_flips": worst, "max_abs_dp": dp,
                      "max_abs_dp_unfused_vs_f32": dp_bf16,
                      "forward_launches": launches_bf16}
    return out


# phase 5d: the transformer-CRF model (models/tx_crf.py) at Bonito's v5
# sup widths (the benchmark cell's configuration file), seeded with the
# benchmark's Bonito init: reads whose chunks fill one 16-chunk batch and
# end on a partial one, through the Basecaller (the Viterbi kernels a
# batch, the attention kernel once a layer a batch), the kernels against
# the plain Viterbi on each batch's own bf16
# scores (bit-equal paths, backpointers and final states), again at the
# main path's 512-chunk batch (the first batch's scores tiled 32 times:
# ~10.7 GB of scores, offsets past 2^32) and timed there, and the bf16
# forward's scores against the f32 reference's
# (benchmark/core/reference_tx_crf.py) on TX_GAP_CHUNKS chunks, within
# the benchmark cell's score_gap limit
TX_BATCH = 16
TX_MAIN_BATCH = 512  # the cell's chunk_batch
TX_LENGTHS = (3000, 12288, 12289, 41000, 140900)  # 1+1+2+4+13 = 21 chunks
TX_GAP_CHUNKS = 4
TX_CHECKS = REPO / "benchmark" / "checks" / "tx_sup_bf16.bulk_long.json"
TX_CONFIG = REPO / "benchmark" / "configs" / "bonito-tx-sup-v5-bf16.json"


def tx_phase(dev, levels) -> dict:
    """Phase 5d (above): the kernels' launches on the main path (the
    Viterbi kernels' and the attention kernel's), the Viterbi paths
    against the plain version's, their time beside the bound, and the
    bf16 scores' gap from the f32 reference."""
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.ops import crf_viterbi as cv
    from radian_tpu_torch.ops import tx_attention as txa
    from radian_tpu_torch.ops import tx_norm as txn
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions

    cfg = DotDict(json.loads(TX_CONFIG.read_text())["model_config"])
    weights = ref.bonito_init(cfg.model, 16)
    bc = Basecaller({k: torch.from_numpy(v) for k, v in weights.items()},
                    cfg, None, BasecallOptions(chunk_batch=TX_BATCH),
                    torch.bfloat16, device=dev)
    reads = synth_signals(np.random.default_rng(16), TX_LENGTHS, levels)
    plan = bc.chunk_batches(reads)
    cv.crf_viterbi.launches = cv.crf_backtrace.launches = 0
    txa.tx_attention.launches = txn.tx_norm.launches = 0
    seqs = bc.basecall_signals(reads)
    torch.cuda.synchronize()
    launches = {"crf_viterbi": cv.crf_viterbi.launches,
                "crf_backtrace": cv.crf_backtrace.launches}
    txa_launches = txa.tx_attention.launches
    txn_launches = txn.tx_norm.launches
    _line("tx-e2e", reads=len(reads), batches=len(plan),
          chunks=[b.n_chunks for _, b in plan],
          lengths=[len(x) for x in seqs], launches=json.dumps(launches),
          tx_attention_launches=txa_launches, tx_norm_launches=txn_launches)
    if any(v != len(plan) for v in launches.values()):
        _fail(f"the Viterbi kernels did not launch once a batch: {launches}")
    if txa_launches != cfg.model.encoder.num_layers * len(plan):
        _fail(f"tx_attention launched {txa_launches} times on the main "
              f"path's {len(plan)} batches (want "
              f"{cfg.model.encoder.num_layers} a batch)")
    if txn_launches != 2 * cfg.model.encoder.num_layers * len(plan):
        _fail(f"tx_norm launched {txn_launches} times on the main path's "
              f"{len(plan)} batches (want "
              f"{2 * cfg.model.encoder.num_layers} a batch: two a layer)")
    if any(not x for x in seqs):
        _fail("a transformer-CRF read came back empty or skipped")
    if plan[0][1].n_chunks != TX_BATCH or plan[-1][1].n_chunks >= TX_BATCH:
        _fail("phase 5d's reads must fill a batch and end on a partial one")
    first = None
    for idxs, b in (plan[0], plan[-1]):
        scores, _ = bc.crf_scores(*bc.pad_batch(idxs, b, reads))
        s = scores[:b.n_chunks]
        bp, fin = cv.crf_viterbi(s, 5)
        path = cv.crf_backtrace(bp, fin)
        bp_p, fin_p = cv.viterbi_forward_plain(s, 5)
        path_p = cv.backtrace_plain(bp_p, fin_p)
        same = (torch.equal(bp, bp_p) and torch.equal(fin, fin_p)
                and torch.equal(path, path_p))
        _line("tx-viterbi", chunks=b.n_chunks, steps=s.shape[1],
              equal=same, moves=int((path >= 0).sum()))
        if not same:
            _fail("the Viterbi kernels disagree with the plain version")
        if first is None:
            first = (b, scores, bp_p, fin_p, path_p)
    b, scores, bp_p, fin_p, path_p = first
    # the main path's batch: the first batch's scores tiled to 512 chunks
    tile = TX_MAIN_BATCH // TX_BATCH
    big = scores[:TX_BATCH].repeat(tile, 1, 1)
    bp, fin = cv.crf_viterbi(big, 5)
    path = cv.crf_backtrace(bp, fin)
    same = (torch.equal(bp, bp_p.repeat(tile, 1, 1))
            and torch.equal(fin, fin_p.repeat(tile))
            and torch.equal(path, path_p.repeat(tile, 1)))
    _line("tx-viterbi", chunks=big.shape[0], steps=big.shape[1],
          score_bytes=big.numel() * big.element_size(), equal=same)
    if not same:
        _fail("the Viterbi kernels disagree with the plain version at the "
              "main path's batch")
    del path, bp_p, fin_p, path_p
    fwd_ms = cuda_ms(lambda: cv.crf_viterbi(big, 5), 3)
    bt_ms = cuda_ms(lambda: cv.crf_backtrace(bp, fin), 3)
    t0 = time.perf_counter()
    cv.backtrace_plain(*cv.viterbi_forward_plain(scores[:TX_BATCH], 5))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n, t_len, width = big.shape
    states = width // 5
    # the 4 move scores a state-step and the blank score once (as
    # benchmark/core/counts_tx_crf.py counts them)
    n_bytes = n * (t_len * states * 4 * 2 + 2 + t_len * states + 2 * t_len
                   + 4)
    n_ops = n * (9 * t_len * states + states + 3 * t_len)
    bound_ms, by = bound(n_bytes, n_ops)
    del big, bp, fin
    _line("tx-kernels", chunks=n, steps=t_len, states=states,
          viterbi_ms=f"{fwd_ms:.3f}", backtrace_ms=f"{bt_ms:.3f}",
          bound_ms=f"{bound_ms:.3f}", bound_by=by,
          share=f"{bound_ms / (fwd_ms + bt_ms):.3f}",
          plain_ms_16_chunks=f"{plain_ms:.1f}")
    # the bf16 forward's scores against the f32 reference's
    p = ref.params(weights, dev)
    size, overlap = cfg.basecaller.chunksize, cfg.basecaller.overlap
    gap, seen = 0.0, {}
    for r in range(TX_GAP_CHUNKS):
        i = b.reads[b.row_read[r]]
        m = seen.get(i, 0)
        seen[i] = m + 1
        ch = ref.chunks(ref.mad_normalise(reads[i], 4.0), size, overlap)[m]
        want = ref.forward(p, cfg.model, torch.from_numpy(ch).to(dev))
        gap = max(gap, float((scores[r].float() - want).abs().max()))
    limit = json.loads(TX_CHECKS.read_text())["limits"]["score_gap"]
    _line("tx-gap", chunks=TX_GAP_CHUNKS, score_gap=f"{gap:.4f}",
          limit=limit)
    if not gap <= limit:
        _fail(f"the bf16 scores are {gap} from the f32 reference's "
              f"(limit {limit})")
    return {"launches": launches, "ms": fwd_ms, "backtrace_ms": bt_ms,
            "plain_ms_16_chunks": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "score_gap": gap,
            "tx_attention_launches": txa_launches,
            "tx_norm_launches": txn_launches, "batches": len(plan)}


# phase 5e: the transformer-CRF windowed attention kernel
# (csrc/tx_attention.cu) against its plain version on the card, on random
# q, k, v of scale 2 at the published window (127, 128): the main path's
# [512, 1024, 8, 64], then ragged lengths (5 chunks of 200 tokens: a tile
# and a partial one; 3 of 5: under one step)
TXA_CASES = ((512, 1024), (5, 200), (3, 5))
# Both round each probability to bf16 before P.V and the output once; the
# kernel's S and P.V sums run in another order than cuBLAS's, so a
# probability near a rounding boundary can round the other way.  A
# difference is counted against one flip of every probability (2^-8 of the
# softmax-weighted mean of |v|) plus one ulp of the output: 1 = every
# point flipped.  Readings on an H100: 1.089 at [512, 1024], 0.63 at 200
TXA_MAX_FLIPS = 2.0
# The whole bf16 forward's scores, kernel against the band_attention path
# (autograd on), as a share of that path's own gap from the float32
# forward on the same chunks: the two bf16 paths differ only by those
# flips, carried through 18 layers, and must stay nearer each other than
# bf16 is to float32
TXA_MAX_DP_SHARE = 0.8
TXA_CHUNKS = 16  # chunks of the whole-forward check


def txa_phase(dev, levels, ptxas: list[str]) -> dict:
    """Phase 5e (above): the kernel's rotated q and k bit-equal to the
    plain version's, its output within TXA_MAX_FLIPS roundings, the whole
    forward's scores within TXA_MAX_DP_SHARE of the band path's gap from
    float32, its launches (18 a bf16 forward, none in float32), and its
    time beside the bound, the plain version's and the band path's."""
    import torch

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.models.tx_crf import band_attention, band_mask, rotary
    from radian_tpu_torch.ops import tx_attention as txa
    from radian_tpu_torch.ops import tx_norm as txn

    torch.backends.cuda.matmul.allow_tf32 = False
    for ln in ptxas:
        print(f"  ptxas tx_attention: {ln}")
    cfg = DotDict(json.loads(TX_CONFIG.read_text())["model_config"])
    enc = cfg.model.encoder
    left, right = enc.attn_window
    base, heads, d = enc.rotary_base, enc.nhead, enc.d_model // enc.nhead
    out = {"ptxas": ptxas}
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for n, t in TXA_CASES:
        qkv = (torch.randn(n, t, 3, heads, d, generator=gen, device=dev)
               * 2).to(torch.bfloat16)
        cos, sin = txa.rotary_table(t, d, base, dev)
        rot = torch.empty(n, t, 2, heads, d, dtype=torch.bfloat16, device=dev)
        got = txa.tx_attention(qkv, cos, sin, left, right, rotated=rot)
        torch.cuda.synchronize()
        rot_equal = all(torch.equal(rot[:, :, i], rotary(qkv[:, :, i], base))
                        and torch.equal(rot[:, :, i],
                                        txa.rotate(qkv[:, :, i], cos, sin))
                        for i in (0, 1))
        want = txa.tx_attention_plain(qkv, cos, sin, left, right)
        abs_v = qkv.clone()
        abs_v[:, :, 2] = abs_v[:, :, 2].abs()
        room = (_ulp(want) + 2.0 ** -8 * txa.tx_attention_plain(
            abs_v, cos, sin, left, right).float())
        del abs_v
        diff = (got.float() - want.float()).abs()
        flips = float(torch.where(diff > 0, diff / room, 0.0).max())
        case = {"rot_equal": rot_equal, "max_flips": flips,
                "share_differing": float((diff > 0).float().mean())}
        del room, diff, rot, got, want
        if (n, t) == TXA_CASES[0]:
            mask = band_mask(t, left, right, dev)

            def band():
                q = rotary(qkv[:, :, 0], base)
                k = rotary(qkv[:, :, 1], base)
                return band_attention(q, k, qkv[:, :, 2], left, right,
                                      mask).reshape(n, t, -1)

            case["ms"] = cuda_ms(lambda: txa.tx_attention(
                qkv, cos, sin, left, right), 10)
            case["plain_ms"] = cuda_ms(lambda: txa.tx_attention_plain(
                qkv, cos, sin, left, right), 1)
            case["library_ms"] = cuda_ms(band, 3)
            # q, k and v read once and o written once
            case["bound_ms"], case["bound_by"] = bound(4 * n * t * heads * d
                                                       * 2, 0)
        _line("txa", chunks=n, tokens=t, heads=heads, head_dim=d,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in case.items()})
        if not rot_equal:
            _fail(f"the kernel's rotated q, k differ from rotary()'s "
                  f"([{n}, {t}])")
        if not flips <= TXA_MAX_FLIPS:
            _fail(f"tx_attention is {flips} roundings from its plain "
                  f"version ([{n}, {t}])")
        if (n, t) == TXA_CASES[0]:
            out.update(case)
        else:
            out.setdefault("ragged", {})[f"{n}x{t}"] = case
        del qkv
    # the whole forward: kernel, band path (autograd on), float32
    weights = ref.bonito_init(cfg.model, 16)
    models = {}
    for dt in (torch.bfloat16, torch.float32):
        models[dt] = build_model(cfg, compute_dtype=dt)
        models[dt].load_state_dict({k: torch.from_numpy(v)
                                    for k, v in weights.items()})
        models[dt].to(dev).eval()
    rng = np.random.default_rng(23)
    size = cfg.basecaller.chunksize
    x = torch.from_numpy(np.stack([
        ref.mad_normalise(sig, 4.0).astype(np.float32) for sig in
        synth_signals(rng, [size] * TXA_CHUNKS, levels)])).to(dev)
    # F.scaled_dot_product_attention's calls a forward, by path
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_calls = {}

    def counted(*args, **kwargs):
        sdpa_calls[path] = sdpa_calls.get(path, 0) + 1
        return sdpa(*args, **kwargs)

    launches, norm_launches = {}, {}
    torch.nn.functional.scaled_dot_product_attention = counted
    try:
        with torch.inference_mode():
            for dt in (torch.bfloat16, torch.float32):
                path = str(dt).split(".")[1]
                txa.tx_attention.launches = txn.tx_norm.launches = 0
                s = models[dt](x).float()
                launches[path] = txa.tx_attention.launches
                norm_launches[path] = txn.tx_norm.launches
                if dt == torch.bfloat16:
                    s_kernel = s
                else:
                    s_f32 = s
        bf16 = models[torch.bfloat16]
        bf16.requires_grad_(False)
        path = "band"
        txn.tx_norm.launches = 0
        with torch.enable_grad():
            s_band = bf16(x).float()
        norm_launches[path] = txn.tx_norm.launches
        bf16.requires_grad_(True)
    finally:
        torch.nn.functional.scaled_dot_product_attention = sdpa
    dp = float((s_kernel - s_band).abs().max())
    dp_band = float((s_band - s_f32).abs().max())
    dp_kernel = float((s_kernel - s_f32).abs().max())
    _line("txa-forward", chunks=TXA_CHUNKS, max_abs_ds_vs_band=f"{dp:.4f}",
          max_abs_ds_band_vs_f32=f"{dp_band:.4f}",
          max_abs_ds_vs_f32=f"{dp_kernel:.4f}",
          share=f"{dp / dp_band:.3f}", launches=json.dumps(launches),
          tx_norm_launches=json.dumps(norm_launches),
          sdpa_calls=json.dumps(sdpa_calls))
    if not dp <= TXA_MAX_DP_SHARE * dp_band:
        _fail(f"the bf16 forward's scores are {dp} from the band path's, "
              f"over {TXA_MAX_DP_SHARE} of its {dp_band} from float32")
    layers = enc.num_layers
    if launches != {"bfloat16": layers, "float32": 0}:
        _fail(f"tx_attention launched {launches} a forward (want "
              f"{layers} in bf16, 0 in float32)")
    if sdpa_calls != {"float32": layers, "band": layers}:
        _fail(f"F.scaled_dot_product_attention ran {sdpa_calls} a forward "
              f"(want none on the bf16 kernel path)")
    if norm_launches != {"bfloat16": 2 * layers, "float32": 0, "band": 0}:
        _fail(f"tx_norm launched {norm_launches} a forward (want "
              f"{2 * layers} in bf16, 0 in float32 and under autograd)")
    out.update(forward_launches=launches, sdpa_calls=sdpa_calls,
               max_abs_ds_vs_band=dp, max_abs_ds_band_vs_f32=dp_band,
               tx_norm_forward_launches=norm_launches)
    return out


# phase 5e, last: the DeepNorm residual + RMSNorm kernel (csrc/tx_norm.cu)
# against add_rmsnorm_plain on the card, at the published alpha and eps,
# on y of scale 3, x of scale 1 and a weight near 1: (rows, d) the main
# path's [524288, 512] (512 chunks of 1,024 tokens), row counts off a
# block's 8 warps, and the other widths the kernel takes.  Both compute
# the output in float32 and round once; only the order of the sum of
# squares differs, so an output near a rounding boundary may round the
# other way: every element within one bf16 rounding of the plain one's
TXN_CASES = ((524288, 512), (5, 512), (1003, 512), (1003, 768), (33, 256),
             (1003, 1024))


def txn_check(dev, ptxas: list[str]) -> dict:
    """Phase 5e, last (above): the norm kernel within one bf16 rounding of
    its plain version, the share of elements that differ, and its time at
    the main path's shape beside the bound, the plain version's and
    ``F.rms_norm``'s on ``y + α·x`` (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F

    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.ops import tx_norm as txn

    for ln in ptxas:
        print(f"  ptxas tx_norm: {ln}")
    enc = DotDict(json.loads(TX_CONFIG.read_text())["model_config"]).model.encoder
    alpha, eps = enc.deepnorm_alpha, enc.norm_eps
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    out = {"ptxas": ptxas}
    for rows, d in TXN_CASES:
        y = (torch.randn(rows, d, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        x = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
        w = (1 + 0.2 * torch.randn(d, generator=gen, device=dev)).to(
            torch.bfloat16)
        got = txn.add_rmsnorm(y, x, w, alpha, eps)
        torch.cuda.synchronize()
        want = txn.add_rmsnorm_plain(y, x, w, alpha, eps)
        diff = (got.float() - want.float()).abs()
        room = torch.maximum(_ulp(want), _ulp(got))
        case = {"max_roundings": float((diff / room).nan_to_num(0.0).max()),
                "share_differing": float((diff > 0).float().mean()),
                "finite": bool(torch.isfinite(got).all())}
        del diff, room, got, want
        if (rows, d) == TXN_CASES[0]:
            case["ms"] = cuda_ms(lambda: txn.add_rmsnorm(y, x, w, alpha, eps),
                                 20)
            case["plain_ms"] = cuda_ms(
                lambda: txn.add_rmsnorm_plain(y, x, w, alpha, eps), 5)
            case["library_ms"] = cuda_ms(
                lambda: F.rms_norm(y + alpha * x, (d,), w, eps), 5)
            # y and x read once, the output written once
            case["bound_ms"], case["bound_by"] = bound(3 * 2 * rows * d, 0)
        _line("txn", rows=rows, d=d,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in case.items()})
        if not (case["finite"] and case["max_roundings"] <= 1.0):
            _fail(f"tx_norm is {case['max_roundings']} bf16 roundings from "
                  f"its plain version ([{rows}, {d}])")
        if (rows, d) == TXN_CASES[0]:
            out.update(case)
        else:
            out.setdefault("ragged", {})[f"{rows}x{d}"] = case
        del y, x, w
    return out


# phase 5f: lengths of one 12,288-sample bucket, 3 batches of 64 reads;
# the tiny transformer's reads cut into 16 + 16 + 8 chunks
OVERLAP_BATCH = 64
OVERLAP_LENGTHS = (8193, 12289)
OVERLAP_TX_LENGTHS = (30000, 45000, 52000, 38000, 60000, 41000, 47000,
                      33000, 25000, 36000)


def overlap_phase(dev, flat, lm, levels) -> dict:
    """Phase 5f (above): each path's bulk call against one batch a call,
    its synchronising operations, and its overlapped renders."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.core import reference_tx_crf as ref
    from radian_tpu_torch.config import DotDict
    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.pipeline import Basecaller, BasecallOptions
    from radian_tpu_torch.utils import profiling
    from tests.torch_tx_tiny import config as tx_tiny

    rng = np.random.default_rng(23)
    glob = Basecaller(params_from_flax(flat), lm=lm, options=BasecallOptions(
        beam_width=6, read_batch=OVERLAP_BATCH, bucket_quantum=4096),
        compute_dtype=torch.bfloat16, device=dev)
    g_reads = synth_signals(rng, rng.integers(*OVERLAP_LENGTHS,
                                              3 * OVERLAP_BATCH), levels)
    cfg = DotDict(tx_tiny())
    tx = Basecaller({k: torch.from_numpy(v) for k, v in
                     ref.bonito_init(cfg.model, 7).items()}, cfg, None,
                    BasecallOptions(chunk_batch=16), torch.bfloat16,
                    device=dev)
    t_reads = synth_signals(rng, OVERLAP_TX_LENGTHS, levels)
    out = {}
    for name, bc, reads, alone in (
            ("global-lm", glob, g_reads,
             [idxs for idxs, _ in glob.batches(g_reads)]),
            ("tx-tiny", tx, t_reads, [[i] for i in range(len(t_reads))])):
        n_batches = len(bc.path.plan(bc, reads))
        if n_batches != 3:
            _fail(f"phase 5f's {name} reads make {n_batches} batches, not 3")
        bc.basecall_signals(reads)  # warm-up
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                bulk = bc.basecall_signals(reads)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        want = [None] * len(reads)
        for idxs in alone:
            for i, seq in zip(idxs, bc.basecall_signals(
                    [reads[i] for i in idxs])):
                want[i] = seq
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            traced = bc.basecall_signals(reads)
        counts = profiling.counters()
        profiling.reset()
        same = sum(a == b for a, b in zip(bulk, want))
        out[name] = {"renders": counts.get("renders", 0),
                     "renders_overlapped": counts.get("renders_overlapped",
                                                      0),
                     "sync_warnings": syncs}
        _line("overlap", path=name, reads=len(reads), batches=n_batches,
              identical_to_one_batch_a_call=same,
              traced_identical=traced == bulk, **out[name])
        if same != len(reads) or traced != bulk or any(not x for x in bulk):
            _fail(f"phase 5f: the {name} bulk call's strings differ from "
                  "one batch a call's")
        if out[name]["renders"] != n_batches:
            _fail(f"phase 5f: {out[name]['renders']} renders counted over "
                  f"{n_batches} batches ({name})")
    if out["global-lm"]["sync_warnings"]:
        _fail("phase 5f: the global path synchronised the stream "
              f"{out['global-lm']['sync_warnings']} times in a bulk call")
    return out


def synth_signals(rng, lengths, levels):
    from radian_tpu_torch.utils.synthetic import synth_read

    out = []
    for n in lengths:
        sig, _ = synth_read(rng, int(n) // 8 + 64, levels)
        while len(sig) < n:
            sig = np.concatenate([sig, synth_read(rng, 64, levels)[0]])
        out.append((sig[:n] * 60 + 500).astype(np.int16))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from radian_tpu_torch import _build
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model
    from radian_tpu_torch.ops import beam_cuda, tcn_conv
    from radian_tpu_torch.ops import beam_search as plain
    from radian_tpu_torch.ops.preprocess import mad_normalise
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller
    from radian_tpu_torch.utils.synthetic import kmer_level_table

    dev = torch.device("cuda", 0)
    t_start = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        _line("phase-time", step=name, seconds=f"{now - t_phase:.1f}",
              total_s=f"{now - t_start:.1f}")
        t_phase = now

    # 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    _line("device", torch_name=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    phase_done("1")

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    for name in sorted(p.stem for p in (*_build.CSRC.glob("*.cu"),
                                        *_build.CSRC.glob("*.cc"))):
        _build.load(name)
    _line("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=sorted(report) or "cached")
    for name, rep in report.items():
        for ln in ptxas_summary(rep["ptxas"]):
            print(f"  ptxas {name}: {ln}")

    phase_done("2")

    # 3. kernel vs plain (random peaked matrices) ------------------------
    rng = np.random.default_rng(0)
    # T 1,040 is not a multiple of the kernels' 32-step tile, so the last,
    # partial tile of the decode, LM decode and backtrace is held too
    n, t_max = 64, 1040
    compared = differing = 0
    for w, zero in ((1, False), (2, False), (6, False), (8, False),
                    (12, False), (16, False), (6, True)):
        mats = rng.dirichlet(np.full(5, 0.2), size=(n, t_max))
        mats = mats.astype(np.float32)
        if zero:
            mats[rng.random(mats.shape) < 0.2] = 0.0
        lengths = rng.integers(1, t_max + 1, n).astype(np.int32)
        lengths[0] = t_max
        m = torch.from_numpy(mats).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        rev_k, nlab_k, sc_k = beam_cuda.beam_search_cuda(m, ln, w)
        rev_p, nlab_p, sc_p = plain.beam_search_batch(m, ln, w)
        torch.cuda.synchronize()
        bad = ((rev_k != rev_p).any(1) | (nlab_k != nlab_p)
               | ((sc_k - sc_p).abs() > 1e-5))
        compared += n
        differing += int(bad.sum())
        _line("kernel", beam=w, zero_probs=zero, reads=n, T=t_max,
              differing=int(bad.sum()),
              max_abs_score_err=float((sc_k - sc_p).abs().max()))
    _line("kernel", reads_compared=compared, reads_differing=differing)
    if differing:
        _fail(f"beam kernel disagrees with the plain version on "
              f"{differing}/{compared} reads")

    phase_done("3")

    # 3b. LM kernel vs plain ------------------------------------------------
    check_lm_kernel(dev, n, t_max, LM_CASES)

    phase_done("3b")

    # 4. model on the card vs the CPU ------------------------------------
    flat = load_params_npz(TRAINED)
    levels = kmer_level_table(np.random.default_rng(1))
    sigs = synth_signals(np.random.default_rng(2), [4000, 3900, 4100, 4050],
                         levels)
    l_max = max(len(s) for s in sigs)
    padded = np.zeros((4, l_max), np.int16)
    for i, s in enumerate(sigs):
        padded[i, :len(s)] = s
    lens = torch.tensor([len(s) for s in sigs], dtype=torch.int32)
    norm, _ = mad_normalise(torch.from_numpy(padded), lens)
    probs = {}
    for d in ("cpu", dev):
        model = build_model()
        model.load_state_dict(params_from_flax(flat))
        model.to(d).eval()
        with torch.inference_mode():
            probs[str(d)] = model(norm.to(d)[..., None], probs=True).cpu()
    dp = float((probs["cpu"] - probs[str(dev)]).abs().max())
    _line("model", reads=4, samples=l_max, max_abs_dp=f"{dp:.3e}",
          cudnn_tf32=torch.backends.cudnn.allow_tf32)
    if not dp <= 1e-4 or not torch.isfinite(probs[str(dev)]).all():
        _fail(f"card probabilities differ from the CPU by {dp}")

    phase_done("4")

    # 5. end to end ------------------------------------------------------
    opts = BasecallOptions(beam_width=6, read_batch=256, bucket_quantum=4096)
    bc = load_basecaller(TRAINED, options=opts, device=dev)
    rng = np.random.default_rng(3)
    read_lens = rng.integers(5120, 15361, 512)
    reads = synth_signals(rng, read_lens, levels)
    n_samples = int(read_lens.sum())
    bc.basecall_signals(reads)  # warm-up: cuDNN plans, allocator, library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    beam_cuda.beam_decode_cuda.launches = 0
    beam_cuda.beam_backtrace_cuda.launches = 0
    t0 = time.perf_counter()
    seqs = bc.basecall_signals(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"beam_decode": beam_cuda.beam_decode_cuda.launches,
                "beam_backtrace": beam_cuda.beam_backtrace_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_batches = len(bc.batches(reads))
    _line("e2e", reads=len(reads), batches=n_batches,
          reads_per_s=f"{len(reads) / wall:.2f}",
          msamples_per_s=f"{n_samples / wall / 1e6:.3f}",
          wall_s=f"{wall:.3f}", peak_mem_gb=f"{peak_gb:.2f}",
          launches=json.dumps(launches, separators=(",", ":")))
    if any(v == 0 for v in launches.values()):
        _fail(f"a kernel of the main path never launched: {launches}")
    if any(not s for s in seqs):
        _fail("a read came back empty or skipped")

    # per-batch split, synchronised after each program
    first = global_split(bc, reads, "e2e")

    small = sigs  # phase 4's four ~4,000-sample reads
    for beam in (6, 16):
        small_opts = BasecallOptions(beam_width=beam, read_batch=4,
                                     bucket_quantum=4096)
        want = load_basecaller(TRAINED, options=small_opts,
                               device="cpu").basecall_signals(small)
        got = load_basecaller(TRAINED, options=small_opts,
                              device=dev).basecall_signals(small)
        same = sum(a == b for a, b in zip(got, want))
        _line("e2e-check", beam=beam, reads=len(small),
              identical_to_cpu=same, lengths=[len(s) for s in got])
        if beam == 6:
            small_seqs = got
        if same != len(small):
            _fail(f"card strings differ from the port's CPU run at beam "
                  f"{beam}")

    phase_done("5")

    # 5b. end to end with the LM -----------------------------------------
    lm_run = e2e_lm(dev, flat, reads, small, opts)

    phase_done("5b")

    # 5c. the fused TCN kernels ------------------------------------------
    tcn = tcn_phase(dev, flat)

    phase_done("5c")

    # 5d. the transformer-CRF model and its Viterbi kernels ---------------
    tx = tx_phase(dev, levels)
    tx_attention_launches = tx.pop("tx_attention_launches")
    tx_norm_launches = tx.pop("tx_norm_launches")
    tx_attention_batches = tx.pop("batches")

    phase_done("5d")

    # 5e. the transformer-CRF windowed attention kernel -------------------
    txa_out = txa_phase(dev, levels, ptxas_summary(
        report["tx_attention"]["ptxas"]) if "tx_attention" in report
        else ["cached"])
    txn_out = txn_check(dev, ptxas_summary(report["tx_norm"]["ptxas"])
                        if "tx_norm" in report else ["cached"])
    txn_out["forward_launches"] = txa_out.pop("tx_norm_forward_launches")

    phase_done("5e")

    # 5f. the two-deep dispatch loop's overlap ------------------------------
    overlap = overlap_phase(dev, flat, lm_run["lm"], levels)

    phase_done("5f")

    # 6. kernels on the main path's inputs (first batch) -----------------
    mats, t_reads = first
    n_b, t_b, _ = mats.shape
    w = opts.beam_width
    logm = beam_cuda.log_probs(mats)  # [N, T, 5]
    logm_tn = logm.permute(1, 2, 0)  # the plain version's [T, 5, N]
    bp_k, nlab_k, sc_k = beam_cuda.beam_decode_cuda(logm, t_reads, w)
    bp_p, nlab_p, sc_p = plain.beam_search_bp(logm_tn, t_reads, w)
    bp_p = bp_p.permute(2, 0, 1)  # [T, W, N] -> the kernel's [N, T, W]
    dec_err = float((sc_k - sc_p).abs().max())
    if not (torch.equal(bp_k, bp_p) and torch.equal(nlab_k, nlab_p)
            and dec_err <= 1e-5):
        _fail("decode kernel disagrees with the plain version on the "
              "main path's inputs")
    rev_k = beam_cuda.beam_backtrace_cuda(bp_k)
    rev_p = plain.backtrace_batch(bp_k.permute(1, 2, 0))
    if not torch.equal(rev_k, rev_p):
        _fail("backtrace kernel disagrees with the plain version")
    dec_ms = cuda_ms(lambda: beam_cuda.beam_decode_cuda(logm, t_reads, w), 3)
    t0 = time.perf_counter()
    plain.beam_search_bp(logm_tn, t_reads, w)
    torch.cuda.synchronize()
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    bt_ms = cuda_ms(lambda: beam_cuda.beam_backtrace_cuda(bp_k), 5)
    t0 = time.perf_counter()
    plain.backtrace_batch(bp_k.permute(1, 2, 0))
    torch.cuda.synchronize()
    bt_plain_ms = (time.perf_counter() - t0) * 1e3

    steps = int(torch.clamp(t_reads.long(), 0, t_b).sum())
    dec_bound, dec_by = bound(
        20 * steps + w * t_b * n_b + 12 * n_b,
        decode_ops_per_step(w) * steps)
    bt_bound, bt_by = bound(t_b * n_b * (1 + 4), 3 * t_b * n_b)
    _line("kernels", batch_reads=n_b, T=t_b, beam=w, active_steps=steps,
          decode_ms=f"{dec_ms:.3f}", decode_plain_ms=f"{dec_plain_ms:.1f}",
          decode_us_per_step=f"{dec_ms * 1e3 / t_b:.3f}",
          backtrace_ms=f"{bt_ms:.3f}",
          backtrace_plain_ms=f"{bt_plain_ms:.1f}")
    dec16_ms = cuda_ms(
        lambda: beam_cuda.beam_decode_cuda(logm, t_reads, 16), 3)
    dec16_bound, _ = bound(20 * steps + 16 * t_b * n_b + 12 * n_b,
                           decode_ops_per_step(16) * steps)
    _line("kernels-w16", batch_reads=n_b, T=t_b, beam=16,
          decode_ms=f"{dec16_ms:.3f}", decode_bound_ms=f"{dec16_bound:.4f}",
          decode_us_per_step=f"{dec16_ms * 1e3 / t_b:.3f}")

    phase_done("6")

    # 6b. the LM kernel on the LM path's first batch -----------------------
    lmk = lm_kernels(dev, lm_run, w)
    del first, mats, t_reads, logm, logm_tn, bp_k, bp_p, rev_k, rev_p
    lm_run.pop("first")

    phase_done("6b")

    # 7. chunk mode (fused) -------------------------------------------------
    # the f32 chunk path and training never take the fused TCN kernels
    tcn_conv.tcn_conv.launches = 0
    chunk_run = e2e_chunk(dev, reads, small)
    tcn["launches_chunk_f32"] = tcn_conv.tcn_conv.launches

    phase_done("7")

    # 7b. chunk_lm (fullprobs, tiled crop, the bench LM) -------------------
    chunk_lm_run = e2e_chunk_lm(dev, flat, reads, small, lm_run["lm"])

    phase_done("7b")

    # 7c. the kernels on the chunk paths' first batches --------------------
    ck = chunk_kernels(dev, chunk_run, chunk_lm_run, w)
    del chunk_run["first"], chunk_lm_run["first"]
    phase_done("7c")

    # 8. global strips / windows / 'mean' and the fallback geometry --------
    global_prep(dev, reads, small, opts)
    phase_done("8")

    # 8b. chunk mode with the device consensus ---------------------------
    device_consensus(dev, reads, small)
    phase_done("8b")

    # 9. training: the CLI, resume, card vs CPU, throughput, basecall ------
    train = train_phase(dev, small)
    tcn["launches_train"] = train.pop("tcn_launches")
    _line("tcn-launches", chunk_f32=tcn["launches_chunk_f32"],
          train_steps=tcn["launches_train"])
    if tcn["launches_chunk_f32"] or tcn["launches_train"]:
        _fail("the fused TCN kernels launched on the f32 chunk path or in "
              "a training step")
    phase_done("9")

    # 10. multi-GPU paths on the one card -----------------------------------
    import tempfile

    mesh = mesh_inference(dev, reads, opts, seqs, len(reads) / wall, small,
                          small_seqs, chunk_run["small_strings"],
                          lm_run["lm"], lm_run["small_strings"])
    phase_done("10a")
    with tempfile.TemporaryDirectory(prefix="radian-multi-") as tmp:
        tmp = Path(tmp)
        (tmp / "b").mkdir()
        (tmp / "c").mkdir()
        (tmp / "d").mkdir()
        sharded_reads(dev, small, tmp / "b")
        phase_done("10b")
        batches = train.pop("batches_9c")
        group = one_rank_group(dev, batches, tmp / "c",
                               train["throughput_float32"]["ms_per_step"])
        phase_done("10c")
        group_losses = np.asarray(group.pop("losses_no_group"))
        train["ddp"] = {"one_rank_nccl": group,
                        "two_ranks_gloo": two_ranks(dev, batches,
                                                    group_losses, tmp / "d")}
        phase_done("10d")

        # 11. tensor parallelism on the one card ----------------------------
        (tmp / "tp").mkdir()
        tp = tensor_parallel(
            dev, batches, group_losses, small, small_seqs,
            {k: train[f"throughput_{k}"]["ms_per_step"]
             for k in ("float32", "bfloat16")}, tmp / "tp")
        train["tensor_parallel"] = tp
        phase_done("11")
    kernels = [
        {"name": "beam_decode", "route": "cuda",
         "source": "radian_tpu_torch/csrc/beam_search.cu",
         "replaces": "radian_tpu/ops/beam_pallas.py:369",
         "launches": launches["beam_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None, "chunk": ck["decode"],
         "train_launches": train["basecall_launches"]["beam_decode"],
         "mesh_launches": mesh["launches"]["beam_decode"],
         "tp_launches": tp["basecall_launches"]["beam_decode"]},
        {"name": "beam_backtrace", "route": "cuda",
         "source": "radian_tpu_torch/csrc/beam_search.cu",
         "replaces": "radian_tpu/ops/beam_search.py:420",
         "launches": launches["beam_backtrace"], "max_abs_err": 0.0,
         "ms": bt_ms, "plain_ms": bt_plain_ms, "bound_ms": bt_bound,
         "bound_by": bt_by, "library_ms": None, "chunk": ck["backtrace"],
         "train_launches": train["basecall_launches"]["beam_backtrace"],
         "mesh_launches": mesh["launches"]["beam_backtrace"],
         "tp_launches": tp["basecall_launches"]["beam_backtrace"]},
        {"name": "beam_decode_lm", "route": "cuda",
         "source": "radian_tpu_torch/csrc/beam_search_lm.cu",
         "replaces": "radian_tpu/ops/beam_search.py:176",
         "launches": lm_run["launches"]["beam_decode_lm"],
         "max_abs_err": lmk["max_abs_err"],
         "ms": lmk["dense", "f32"]["ms"], "plain_ms": lmk["plain_ms"],
         "bound_ms": lmk["dense", "f32"]["bound_ms"],
         "bound_by": lmk["dense", "f32"]["bound_by"], "library_ms": None,
         "chunk": ck["decode_lm"],
         "train_launches": train["basecall_launches"]["beam_decode_lm"],
         "mesh_launches": mesh["launches"]["beam_decode_lm"],
         "tp_launches": tp["basecall_launches"]["beam_decode_lm"]},
        {"name": "tcn_conv", "route": "cuda",
         "source": "radian_tpu_torch/csrc/tcn_conv.cu",
         "replaces": "none (XLA's convolution + fusion; cuDNN + glue here)",
         **tcn[TCN_CASES[0][1]],
         "launches": lm_run["tcn_launches"],
         "launch_batches": lm_run["tcn_batches"],
         "chunk_lm_launches": chunk_lm_run["launches"]["tcn_conv"],
         "off_tile": tcn[TCN_CASES[1][1]],
         "chunk_f32_launches": tcn["launches_chunk_f32"],
         "train_step_launches": tcn["launches_train"]},
        {"name": "crf_viterbi", "route": "cuda",
         "source": "radian_tpu_torch/csrc/crf_viterbi.cu",
         "replaces": "none (the transformer-CRF model's decode)", **tx},
        {"name": "tx_attention", "route": "cuda",
         "source": "radian_tpu_torch/csrc/tx_attention.cu",
         "replaces": "none (the transformer-CRF model's attention: rotary "
                     "+ band_attention around SDPA here)", **txa_out,
         "launches": tx_attention_launches,
         "launch_batches": tx_attention_batches},
        {"name": "tx_norm", "route": "cuda",
         "source": "radian_tpu_torch/csrc/tx_norm.cu",
         "replaces": "none (the transformer-CRF model's DeepNorm residual "
                     "+ RMSNorm: add_rmsnorm_plain's float32 PyTorch "
                     "kernels here)", **txn_out,
         "launches": tx_norm_launches,
         "launch_batches": tx_attention_batches},
    ]
    _line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"train": train}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"overlap": overlap}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # one rank of phase 10d
        sys.exit(ddp_rank_main(int(sys.argv[2]), Path(sys.argv[3]),
                               sys.argv[4]))
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase 11b
        sys.exit(tp_rank_main(int(sys.argv[2]), Path(sys.argv[3]),
                              sys.argv[4]))
    if sys.argv[1:2] == ["--shard-rank"]:  # one rank of phase 10b
        sys.exit(shard_rank_main(int(sys.argv[2]), Path(sys.argv[3]),
                                 sys.argv[4]))
    sys.exit(main())
