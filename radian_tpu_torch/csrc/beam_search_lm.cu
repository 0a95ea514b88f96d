// CTC prefix beam search with gated k-mer LM fusion, one warp per read,
// for sm_90a.
//
// Replaces the LM-fused step of the TPU decoder,
// radian_tpu/ops/beam_search.py::_step with lm_enabled=True (:176; the LM
// branches :185-199, :331-333, :344-387), which stayed a plain XLA
// lax.scan on the TPU because Mosaic has no per-lane scattered loads.  The
// semantics are those of beam_search_batch(lm_enabled=True), mirrored step
// by step by the plain PyTorch version radian_tpu_torch/ops/beam_search.py
// (_step with an LMFusion):
//   - the no-LM search (beam_step.cuh), with each beam scoring its COPY of
//     base c by log(dist_c[c]) and its EXTEND by c by log(dist_e[c]);
//   - dist = ((row[c] + s_base[c]) * 0.5) * s_sum where the gate opens
//     (LM row entropy < r_thr and signal entropy > s_thr and the labeling
//     long enough: length >= ctx_len + 1 for COPY, which uses the row of
//     the previous context, length >= ctx_len for EXTEND, which uses the
//     row of the full last-ctx_len context), else the signal's m[c];
//   - each beam carries its contexts (packed base 4, big-endian) and both
//     rows; an extension shifts the base into the context and looks up one
//     row, a copy inherits its parent's; inactive steps change nothing.
//
// What bounds it on this card: latency, as in the no-LM kernel (step t+1
// needs step t's beams), plus one dependent row load per extended beam a
// step, random over a table of up to 84 MB (dense f32 at ctx 11: more
// than the 50 MB L2).  The design keeps the no-LM kernel's step and adds:
//   - the tile of 32 steps' probabilities is turned, lane i for step i,
//     into the five log-probs, s_sum, s_base and the signal entropy, once
//     per step for all beams;
//   - lane w holds beam w's two contexts and two rows in registers and
//     takes logf of the fused values only where its gate is open (else the
//     tile's log m[c]);
//   - the gather copies the parent's contexts and rows from shared
//     records; an extended lane then loads its new row: dense, probs and
//     entropy as two independent loads; packed, the l1 (word, rank) pair,
//     then the vals row; bf16 widened to f32 by __bfloat162float.
// Arithmetic: the fusion and entropy products and sums are written with
// __fmul_rn/__fadd_rn, so nvcc cannot contract them into FMAs that the
// plain version's separate torch kernels never form, and every sum runs
// left to right as the plain version writes it.  Built without
// --use_fast_math: logf, expf, log1pf and '/' are torch's own.
//
// Layouts: probs [N, T, 5] f32 (probabilities), lengths [N] i32; dense
// tables probs [R, 4] and entropy [R], packed l1 [ceil(R/32), 2] i32 and
// vals [U+1, 5], f32 or bf16; bp [N, T, W] int8 parent*8 + (append+1),
// score [N] f32, nlab [N] i32, as the no-LM kernel writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_step.cuh"

using namespace radian;

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct DenseTable {
  const T* probs;  // [R, 4]
  const T* ent;    // [R]
  __device__ __forceinline__ void row(uint32_t ctx, float (&r)[5]) const {
    const T* p = probs + static_cast<size_t>(ctx) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = widen(p[c]);
    r[4] = widen(ent[ctx]);
  }
};

template <typename T>
struct PackedTable {
  const int2* l1;  // [ceil(R/32)]: (presence word, rank before the word)
  const T* vals;   // [U+1, 5]; row 0 = the absent contexts' shared row
  __device__ __forceinline__ void row(uint32_t ctx, float (&r)[5]) const {
    const int2 wr = l1[ctx >> 5];
    const uint32_t word = static_cast<uint32_t>(wr.x);
    const uint32_t bit = ctx & 31u;
    const uint32_t idx = ((word >> bit) & 1u)
                             ? static_cast<uint32_t>(wr.y) + 1u +
                                   __popc(word & ((1u << bit) - 1u))
                             : 0u;
    const T* v = vals + static_cast<size_t>(idx) * 5;
#pragma unroll
    for (int c = 0; c < 5; ++c) r[c] = widen(v[c]);
  }
};

// The LM's per-warp scratch beside WarpScratch.
struct __align__(16) LmScratch {
  float sig[kTile][8];      // per step: s_base[0..3], s_sum, signal entropy
  int2 ctx[kMaxBeam];       // (ctx_full, ctx_prev), read by the gather
  float full[kMaxBeam][8];  // rows of ctx_full / ctx_prev: p[0..3], entropy
  float prev[kMaxBeam][8];
};

// ((row + s_base) * 0.5) * s_sum, rounded after each operation
__device__ __forceinline__ float fuse(float row, float s_base, float s_sum) {
  return __fmul_rn(__fmul_rn(__fadd_rn(row, s_base), 0.5f), s_sum);
}

template <int W, typename Table>
__global__ void __launch_bounds__(32 * kWarps)
beam_decode_lm_kernel(const float* __restrict__ probs, const int* __restrict__ lengths,
                      Table table, int ctx_len, float s_thr, float r_thr,
                      int8_t* __restrict__ bp, float* __restrict__ score,
                      int* __restrict__ nlab, int T, int N) {
  __shared__ WarpScratch scratch[kWarps];
  __shared__ LmScratch lm_scratch[kWarps];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  WarpScratch& s = scratch[threadIdx.x >> 5];
  LmScratch& lm = lm_scratch[threadIdx.x >> 5];
  Beam bm = initial_beam(lane);
  uint32_t ctx_full = 0u, ctx_prev = 0u;
  float rf[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // row of ctx_full
  float rp[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // row of ctx_prev
  // 4^ctx_len - 1: the context keeps its last ctx_len bases (ctx_len <= 15)
  const uint32_t ctx_mask = (1u << (2 * ctx_len)) - 1u;

  int steps = lengths[n];
  steps = steps < 0 ? 0 : (steps > T ? T : steps);
  const float* pr_read = probs + static_cast<size_t>(n) * T * 5;
  int8_t* bp_read = bp + static_cast<size_t>(n) * T * W;

  // lane loads tile elements lane + 32*i (i < 5) of the flat [step][5] tile
  float pre[5];
  auto load_tile = [&](int t0) {
    const int lim = (T - t0) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int e = lane + 32 * i;
      pre[i] = e < lim ? pr_read[static_cast<size_t>(t0) * 5 + e] : 0.0f;
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
      // lane i prepares step i: log-probs in place, then the signal's sum,
      // renormalised bases and entropy
      if (lane < ns) {
        float m[5];
#pragma unroll
        for (int c = 0; c < 5; ++c) m[c] = s.lp[lane][c];
        const float s_sum = __fadd_rn(__fadd_rn(__fadd_rn(m[0], m[1]), m[2]), m[3]);
        float term[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = s_sum > 0.0f ? m[c] / s_sum : m[c];
          term[c] = p > 0.0f ? __fmul_rn(p, logf(p)) : 0.0f;
          lm.sig[lane][c] = s_sum > 0.0f ? p : 0.0f;
        }
        lm.sig[lane][4] = s_sum;
        lm.sig[lane][5] = -__fadd_rn(__fadd_rn(__fadd_rn(term[0], term[1]), term[2]), term[3]);
#pragma unroll
        for (int c = 0; c < 5; ++c) s.lp[lane][c] = logf(m[c]);
      }
      __syncwarp();
    }
    for (int tt = 0; tt < ns; ++tt) {
      const float4 lq = *reinterpret_cast<const float4*>(&s.lp[tt][0]);
      const float lpm[4] = {lq.x, lq.y, lq.z, lq.w};
      const float4 sb = *reinterpret_cast<const float4*>(&lm.sig[tt][0]);
      const float s_base[4] = {sb.x, sb.y, sb.z, sb.w};
      const float s_sum = lm.sig[tt][4];
      const bool sig_open = lm.sig[tt][5] > s_thr;
      const bool gate_c = sig_open && bm.len >= ctx_len + 1 && rp[4] < r_thr;
      const bool gate_e = sig_open && bm.len >= ctx_len && rf[4] < r_thr;
      float lpc[4], lpe[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lpc[c] = gate_c ? logf(fuse(rp[c], s_base[c], s_sum)) : lpm[c];
        lpe[c] = gate_e ? logf(fuse(rf[c], s_base[c], s_sum)) : lpm[c];
      }
      search_step<W>(s, lane, bm, lpc, lpe, s.lp[tt][4], [&] {
        lm.ctx[lane] = make_int2(static_cast<int>(ctx_full), static_cast<int>(ctx_prev));
        store_row<float4>(lm.full[lane], rf);
        store_row<float4>(lm.prev[lane], rp);
      });
      if (lane < W) {
        const int slot = gather_beam<W>(s, lane, tt, bm);
        const int parent = slot / 5;
        const int j = slot - 5 * parent;  // 0 = copy, 1 + base = extend
        const int2 pc = lm.ctx[parent];
        if (j > 0) {
          ctx_prev = static_cast<uint32_t>(pc.x);
          ctx_full = (ctx_prev * 4u + static_cast<uint32_t>(j - 1)) & ctx_mask;
#pragma unroll
          for (int c = 0; c < 5; ++c) rp[c] = lm.full[parent][c];
          table.row(ctx_full, rf);
        } else {
          ctx_full = static_cast<uint32_t>(pc.x);
          ctx_prev = static_cast<uint32_t>(pc.y);
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            rf[c] = lm.full[parent][c];
            rp[c] = lm.prev[parent][c];
          }
        }
      }
    }
    __syncwarp();
    flush_bp<W>(s, lane, bp_read, t0, nt, ns);
  }
  if (lane == 0) {
    score[n] = bm.pt;
    nlab[n] = bm.len;
  }
}

struct Args {
  const float* probs;
  const int* lengths;
  int ctx_len;
  float s_thr, r_thr;
  int8_t* bp;
  float* score;
  int* nlab;
  int T, N;
  cudaStream_t stream;
};

// Instantiations for W = 1..kMaxBeam; picks the one for w at run time.
template <int W, typename Table>
cudaError_t launch(int w, const Table& table, const Args& a) {
  if (w == W) {
    const int blocks = (a.N + kWarps - 1) / kWarps;
    beam_decode_lm_kernel<W, Table><<<blocks, 32 * kWarps, 0, a.stream>>>(
        a.probs, a.lengths, table, a.ctx_len, a.s_thr, a.r_thr, a.bp, a.score, a.nlab,
        a.T, a.N);
    return cudaGetLastError();
  }
  if constexpr (W < kMaxBeam) {
    return launch<W + 1, Table>(w, table, a);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// table_kind: 0 dense f32, 1 dense bf16, 2 packed f32, 3 packed bf16;
// t1/t2 = probs/entropy (dense) or l1/vals (packed).  Returns a
// cudaError_t (0 = launched); the caller raises on anything else.
int radian_beam_decode_lm(const void* probs, const void* lengths, const void* t1,
                          const void* t2, int table_kind, int ctx_len, float s_thr,
                          float r_thr, void* bp, void* score, void* nlab, int T, int N,
                          int W, void* stream) {
  if (N <= 0) return 0;
  if (W < 1 || W > kMaxBeam || ctx_len < 0 || ctx_len > 15) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(probs), static_cast<const int*>(lengths), ctx_len,
               s_thr, r_thr, static_cast<int8_t*>(bp), static_cast<float*>(score),
               static_cast<int*>(nlab), T, N, static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  switch (table_kind) {
    case 0:
      return launch<1>(W, DenseTable<float>{static_cast<const float*>(t1),
                                            static_cast<const float*>(t2)}, a);
    case 1:
      return launch<1>(W, DenseTable<bf16>{static_cast<const bf16*>(t1),
                                           static_cast<const bf16*>(t2)}, a);
    case 2:
      return launch<1>(W, PackedTable<float>{static_cast<const int2*>(t1),
                                             static_cast<const float*>(t2)}, a);
    case 3:
      return launch<1>(W, PackedTable<bf16>{static_cast<const int2*>(t1),
                                            static_cast<const bf16*>(t2)}, a);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
