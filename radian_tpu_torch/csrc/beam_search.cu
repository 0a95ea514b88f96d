// CTC prefix beam search without LM fusion, one warp per read, for sm_90a.
//
// Replaces the TPU kernel radian_tpu/ops/beam_pallas.py::beam_search_pallas
// (pl.pallas_call at :369, body _kernel :252 / _beam_step :72) and the
// backtrace scan it calls, radian_tpu/ops/beam_search.py::backtrace_batch
// (:420).  The semantics are those of beam_search_batch(lm_enabled=False)
// (radian_tpu/ops/beam_search.py:176-417), mirrored step by step by the
// plain PyTorch version radian_tpu_torch/ops/beam_search.py::_step:
//   - COPY + 4 EXTEND candidates per beam, in slot order 5*beam + col;
//   - EXTEND(b1,c)/COPY(b2) merges found by length + two 32-bit rolling
//     hashes (wrapping uint32 multiply), combined by logaddexp written as
//     JAX's formula with its NaN branch;
//   - scores floored at SCORE_FLOOR, the W best kept in the order (score
//     descending, smallest slot on ties);
//   - steps at t >= lengths[n] write identity backpointers w*8 and leave
//     the state unchanged.
// The Pallas kernel differs on exact-zero probabilities (no floor, a
// NaN-producing logaddexp); this kernel follows the scan.
//
// What bounds it on this card: latency.  Per (t, read) it reads 20 B of
// log-probs and writes W B of backpointers, and the whole step is a few
// thousand operations, far under the byte and operation rates; but step
// t+1 needs step t's beams, so a read's time is T x one step's dependent
// chain, and a batch of a few hundred reads leaves most warp slots idle.
// The design shortens the chain and spreads the reads:
//   - one warp per read (two warps a block), so 256 reads occupy 128 SMs;
//     lane w < W owns beam w and its five candidates, in registers, with
//     no dynamically indexed per-thread array;
//   - merge pairs are found in one W-wide loop over the beams' records,
//     read from shared memory as 16-byte broadcasts; the few matches are
//     then folded in by loops over their bit masks;
//   - selection in one pass, by rank, spread over all 32 lanes: lane l
//     ranks slots l, l+32, l+64 (< 5W) against the 5W keys (ordered score
//     bits, -slot); the slot of rank k < W goes to pick[k], and lane k
//     gathers its new beam from that slot's row;
//   - logaddexp skips expf/log1pf where expf(-|d|) is exactly 0;
//   - log-probs [N, T, 5] (a read's steps contiguous) come in tiles of 32
//     steps, loaded one tile ahead into registers by coalesced lane loads;
//   - backpointers [N, T, W] are staged per tile in shared memory and
//     flushed as coalesced contiguous bytes.
// The backtrace walks 32 steps per tile: lane i holds step t0-i's W-byte
// row (the next tile's rows already in flight), and the beam index is
// chased across lanes with __shfl_sync instead of one global load a step.
//
// The step (candidates, merges, ranking, gather) is in beam_step.cuh,
// shared with the LM-fused decode kernel in beam_search_lm.cu.
//
// Layouts: logm [N, T, 5] f32 (log-probs), lengths [N] i32,
// bp [N, T, W] int8 packed parent*8 + (append+1) (at most 124 for W <= 16),
// score [N] f32, nlab [N] i32, rev [N, T] i32.  Built with nvcc -O3
// without --use_fast_math, so expf/log1pf are the same functions torch's
// CUDA kernels call for the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_step.cuh"

using namespace radian;

namespace {

template <int W>
__global__ void __launch_bounds__(32 * kWarps)
beam_decode_kernel(const float* __restrict__ logm, const int* __restrict__ lengths,
                   int8_t* __restrict__ bp, float* __restrict__ score,
                   int* __restrict__ nlab, int T, int N) {
  __shared__ WarpScratch scratch[kWarps];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  WarpScratch& s = scratch[threadIdx.x >> 5];
  Beam bm = initial_beam(lane);

  int steps = lengths[n];
  steps = steps < 0 ? 0 : (steps > T ? T : steps);
  const float* lm_read = logm + static_cast<size_t>(n) * T * 5;
  int8_t* bp_read = bp + static_cast<size_t>(n) * T * W;

  // lane loads tile elements lane + 32*i (i < 5) of the flat [step][5] tile
  float pre[5];
  auto load_tile = [&](int t0) {
    const int lim = (T - t0) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int e = lane + 32 * i;
      pre[i] = e < lim ? lm_read[static_cast<size_t>(t0) * 5 + e] : 0.0f;
    }
  };
  if (steps > 0) load_tile(0);

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    const int ns = max(0, min(nt, steps - t0));  // live steps in this tile
    if (ns > 0) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int e = lane + 32 * i;
        s.lp[e / 5][e % 5] = pre[i];
      }
      __syncwarp();
      if (t0 + kTile < steps) load_tile(t0 + kTile);
    }
    for (int tt = 0; tt < ns; ++tt) {
      const float4 lq = *reinterpret_cast<const float4*>(&s.lp[tt][0]);
      const float lpc[4] = {lq.x, lq.y, lq.z, lq.w};
      search_step<W>(s, lane, bm, lpc, lpc, s.lp[tt][4], [] {});
      if (lane < W) gather_beam<W>(s, lane, tt, bm);
    }
    __syncwarp();
    flush_bp<W>(s, lane, bp_read, t0, nt, ns);
  }
  if (lane == 0) {
    score[n] = bm.pt;
    nlab[n] = bm.len;
  }
}

// Walk beam 0 back through the packed backpointers: rev[n, T-1-t] is the
// label appended at step t (-1 for a copy), i.e. 5'->3' order.  A tile is
// the up to 32 rows ending at row `top`: the warp loads its bytes
// coalesced (the next tile's loads in flight during this tile's walk),
// lane b < W takes column b of every row, and each step is one shuffle
// from lane `beam`.  Lane i keeps the label of row top - i.
__global__ void __launch_bounds__(32 * kWarps)
beam_backtrace_kernel(const int8_t* __restrict__ bp, int* __restrict__ rev,
                      int T, int W, int N) {
  __shared__ uint8_t tiles[kWarps][32 * kMaxBeam];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  uint8_t* tile = tiles[threadIdx.x >> 5];
  const uint8_t* rows = reinterpret_cast<const uint8_t*>(bp) + static_cast<size_t>(n) * T * W;
  int* out = rev + static_cast<size_t>(n) * T;

  uint8_t raw[kMaxBeam];  // bytes lane + 32k of the tile
  auto load_tile = [&](int top) {
    const int lo = max(0, top - 31);
    const int count = (top + 1 - lo) * W;
    const uint8_t* src = rows + static_cast<size_t>(lo) * W;
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k) {
      const int i = lane + 32 * k;
      raw[k] = k < W && i < count ? src[i] : 0;
    }
  };
  if (T > 0) load_tile(T - 1);
  int beam = 0;
  for (int top = T - 1; top >= 0; top -= 32) {
    const int nt = min(32, top + 1);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kMaxBeam; ++k)
      if (k < W) tile[lane + 32 * k] = raw[k];
    __syncwarp();
    int col[32];  // lane b: byte b of row top - i
#pragma unroll
    for (int i = 0; i < 32; ++i)
      col[i] = lane < W && i < nt ? tile[(nt - 1 - i) * W + lane] : 0;
    if (top >= 32) load_tile(top - 32);
    int label = -1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < nt) {
        const int sel = __shfl_sync(kFull, col[i], beam);
        if (lane == i) label = (sel & 7) - 1;
        beam = sel >> 3;  // < W for pointers the decode kernel wrote
      }
    }
    if (lane < nt) out[T - 1 - top + lane] = label;
  }
}

template <int W>
cudaError_t launch_decode(const float* logm, const int* lengths, int8_t* bp,
                          float* score, int* nlab, int T, int N, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  beam_decode_kernel<W><<<blocks, 32 * kWarps, 0, stream>>>(logm, lengths, bp, score,
                                                            nlab, T, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry first makes `device` (the tensors' CUDA ordinal) current for
// the calling thread: this library links nvcc's static CUDA runtime, whose
// current device is its own, not torch's.  Returns a cudaError_t (0 =
// launched); the caller raises on anything else.
int radian_beam_decode(const void* logm, const void* lengths, void* bp, void* score,
                       void* nlab, int T, int N, int W, int device, void* stream) {
  if (N <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  const float* lm = static_cast<const float*>(logm);
  const int* ln = static_cast<const int*>(lengths);
  int8_t* b = static_cast<int8_t*>(bp);
  float* s = static_cast<float*>(score);
  int* nl = static_cast<int*>(nlab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_decode<1>(lm, ln, b, s, nl, T, N, st);
    case 2: return launch_decode<2>(lm, ln, b, s, nl, T, N, st);
    case 3: return launch_decode<3>(lm, ln, b, s, nl, T, N, st);
    case 4: return launch_decode<4>(lm, ln, b, s, nl, T, N, st);
    case 5: return launch_decode<5>(lm, ln, b, s, nl, T, N, st);
    case 6: return launch_decode<6>(lm, ln, b, s, nl, T, N, st);
    case 7: return launch_decode<7>(lm, ln, b, s, nl, T, N, st);
    case 8: return launch_decode<8>(lm, ln, b, s, nl, T, N, st);
    case 9: return launch_decode<9>(lm, ln, b, s, nl, T, N, st);
    case 10: return launch_decode<10>(lm, ln, b, s, nl, T, N, st);
    case 11: return launch_decode<11>(lm, ln, b, s, nl, T, N, st);
    case 12: return launch_decode<12>(lm, ln, b, s, nl, T, N, st);
    case 13: return launch_decode<13>(lm, ln, b, s, nl, T, N, st);
    case 14: return launch_decode<14>(lm, ln, b, s, nl, T, N, st);
    case 15: return launch_decode<15>(lm, ln, b, s, nl, T, N, st);
    case 16: return launch_decode<16>(lm, ln, b, s, nl, T, N, st);
    default: return cudaErrorInvalidValue;
  }
}

int radian_beam_backtrace(const void* bp, void* rev, int T, int W, int N, int device,
                          void* stream) {
  if (N <= 0) return 0;
  if (W < 1 || W > kMaxBeam) return cudaErrorInvalidValue;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  const int blocks = (N + kWarps - 1) / kWarps;
  beam_backtrace_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bp), static_cast<int*>(rev), T, W, N);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
