#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (radian_tpu_torch).

Drives the port's main path, the default global-mode no-LM basecall, on
one CUDA device at the full width of the repo's trained model
(bench_data/trained/params.npz, 2,200,581 parameters), and checks it:

  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc builds every csrc/*.cu kernel from this checkout; ptxas
              registers, stack frame and spills per kernel instantiation
  3. kernel   beam-search kernels vs their plain PyTorch version, both on
              the card: N=64, T up to 1,500, beams 1/2/6/8/12/16 and one
              case with exact-zero probabilities; labels and n_labels
              identical, scores within 1e-5 absolute
  4. model    SigToSeq on the card (TF32 off) vs the port's CPU run,
              4 reads of ~4,000 samples; max |dp| <= 1e-4
  5. e2e      Basecaller (beam 6, read_batch 256, bucket quantum 4096) on
              512 synthetic reads of 5,120-15,360 samples: warm-up, then
              a timed run with every kernel launch count set to 0; reads/s,
              Msamples/s, forward/decode ms per batch, peak memory; every
              kernel must have launched; card strings == CPU strings on a
              small input at beams 6 and 16
  6. kernels  each kernel vs its plain version on the inputs the main
              path gave it (the first batch), timed with CUDA events,
              beside its bound (bytes or operations over the H100's peaks);
              the decode kernel also timed at beam 16 on that batch

Prints the nvidia-smi line, one JSON line of kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script
exits non-zero before that line.  Needs one CUDA device and nvcc:

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
            kind = re.search(r"(beam_(?:decode|backtrace)_kernel)", name)
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{kind.group(1) if kind else name}"
                       f"{f' W={w.group(1)}' if w else ''}: {regs} registers, "
                       f"{props}")
            name, props = None, ""
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
    from radian_tpu_torch.ops import beam_cuda
    from radian_tpu_torch.ops import beam_search as plain
    from radian_tpu_torch.ops.preprocess import mad_normalise
    from radian_tpu_torch.pipeline import BasecallOptions, load_basecaller
    from radian_tpu_torch.utils.synthetic import kmer_level_table

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    _line("device", torch_name=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.load(name)
    _line("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=sorted(report) or "cached")
    for name, rep in report.items():
        for ln in ptxas_summary(rep["ptxas"]):
            print(f"  ptxas {name}: {ln}")

    # 3. kernel vs plain (random peaked matrices) ------------------------
    rng = np.random.default_rng(0)
    n, t_max = 64, 1500
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
    fwd_ms, dec_ms = [], []
    first = None
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
        _line("e2e-batch", bucket=bucket, reads=len(idxs),
              forward_ms=f"{fwd_ms[-1]:.2f}", decode_ms=f"{dec_ms[-1]:.2f}",
              forward_tflops=f"{tflops:.1f}",
              decode_us_per_step=f"{dec_ms[-1] * 1e3 / bucket:.2f}")
        if first is None:
            first = (mats, t_reads.to(torch.int32))
        else:
            del mats, t_reads
    _line("e2e", forward_ms_per_batch=f"{np.mean(fwd_ms):.2f}",
          decode_ms_per_batch=f"{np.mean(dec_ms):.2f}")

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
        if same != len(small):
            _fail(f"card strings differ from the port's CPU run at beam "
                  f"{beam}")

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
    kernels = [
        {"name": "beam_decode", "route": "cuda",
         "source": "radian_tpu_torch/csrc/beam_search.cu",
         "replaces": "radian_tpu/ops/beam_pallas.py:369",
         "launches": launches["beam_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": None},
        {"name": "beam_backtrace", "route": "cuda",
         "source": "radian_tpu_torch/csrc/beam_search.cu",
         "replaces": "radian_tpu/ops/beam_search.py:420",
         "launches": launches["beam_backtrace"], "max_abs_err": 0.0,
         "ms": bt_ms, "plain_ms": bt_plain_ms, "bound_ms": bt_bound,
         "bound_by": bt_by, "library_ms": None},
    ]
    _line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
