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
// needs step t's beams), plus one row per extended beam a step, random
// over a table of up to 84 MB (dense f32 at ctx 11: more than the 50 MB
// L2), plus the logs of the fused distributions.  A first version loaded
// the row after the step's ranking and had each lane take 8 logs at the
// top of the next step: a memory round trip and ~400 cycles on every
// step's chain (measured with clock64() probes in a scratch build).
// The design:
//   - the tile of 32 steps' probabilities is turned, lane i for step i,
//     into the five log-probs, s_sum, s_base and the signal entropy, once
//     per step for all beams;
//   - lane w holds beam w's two contexts and two rows in registers and
//     publishes them for the gather while the step's records are written;
//   - the contexts are base 4 with the newest base lowest, so the only
//     rows a beam can need at this step's gather are those of its context's
//     four children (ctx_full*4 + c) & mask: consecutive rows of a dense
//     table, one l1 word of a packed one.  At the top of the step, lane l
//     fetches child l%4 of beam l/4 (and of beam 8 + l/4 from W 9 on), the
//     context shuffled from the beam's lane, into this step's half of a
//     double-buffered shared child buffer, while the step's merges and
//     ranking run: dense, the probabilities (and an f32 entropy) by
//     cp.async, a bf16 entropy (2 bytes, too small for cp.async) by a load
//     into a register; packed, the l1 word at the top and the vals row once
//     the merges are done (f32 by cp.async, bf16 by loads: a 10-byte row
//     has no 4-byte alignment).  The step's land() hook waits for them and
//     stores what sits in registers before the ranking's last __syncwarp;
//     an extended lane then takes its row from the buffer, widened from
//     bf16 by __bfloat162float, instead of loading it;
//   - the scores: COPY needs only its last base's, so a step takes at most
//     5W logs, spread over the lanes (beam f/5, column f%5): inputs and
//     results travel by shuffles from and to the beam's lane, and where no
//     gate of the step is open (a warp vote) no lane takes a log;
//   - the gather copies the parent's contexts and rows from the published
//     records.
// Arithmetic: the fusion and entropy products and sums are written with
// __fmul_rn/__fadd_rn, so nvcc cannot contract them into FMAs that the
// plain version's separate torch kernels never form, and every sum runs
// left to right as the plain version writes it.  Built without
// --use_fast_math: logf, expf, log1pf and '/' are torch's own.
//
// Layouts: probs [N, T, 5] f32 (probabilities), lengths [N] i32; dense
// tables probs [R, 4] and entropy [R], packed l1 [ceil(R/32), 2] i32 and
// vals [U+1, 5], f32 or bf16; bp [N, T, W] int8 parent*8 + (append+1),
// score [N] f32, nlab [N] i32, as the no-LM kernel writes them.  Every
// row fetched is one of 4^ctx_len <= R contexts, so no fetch leaves the
// table, ctx_len 0 (all children row 0) included.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_step.cuh"

using namespace radian;

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// A table fetches a row into a child slot in three parts: issue() at the
// top of the step, mid() once the merges are done, land() after the
// cp.asyncs are waited for; Stage carries registers between them.
template <typename T>
struct DenseTable {
  using Value = T;
  const T* probs;  // [R, 4]
  const T* ent;    // [R]
  struct Stage {
    T e;  // bf16 entropy
  };
  __device__ __forceinline__ void issue(uint32_t ctx, T (&dst)[8], Stage& st) const {
    __pipeline_memcpy_async(&dst[0], probs + static_cast<size_t>(ctx) * 4, 4 * sizeof(T));
    if constexpr (sizeof(T) == 4) {
      __pipeline_memcpy_async(&dst[4], ent + ctx, 4);
    } else {
      st.e = __ldg(ent + ctx);
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ void mid(T (&)[8], Stage&) const {}
  __device__ __forceinline__ void land(T (&dst)[8], const Stage& st) const {
    if constexpr (sizeof(T) != 4) dst[4] = st.e;
  }
};

template <typename T>
struct PackedTable {
  using Value = T;
  const int2* l1;  // [ceil(R/32)]: (presence word, rank before the word)
  const T* vals;   // [U+1, 5]; row 0 = the absent contexts' shared row
  struct Stage {
    int2 wr;     // the context's l1 entry
    uint32_t bit;
    T v[5];      // bf16 row
  };
  __device__ __forceinline__ void issue(uint32_t ctx, T (&)[8], Stage& st) const {
    st.wr = __ldg(l1 + (ctx >> 5));
    st.bit = ctx & 31u;
  }
  __device__ __forceinline__ void mid(T (&dst)[8], Stage& st) const {
    const uint32_t word = static_cast<uint32_t>(st.wr.x);
    const uint32_t idx = ((word >> st.bit) & 1u)
                             ? static_cast<uint32_t>(st.wr.y) + 1u +
                                   __popc(word & ((1u << st.bit) - 1u))
                             : 0u;
    const T* v = vals + static_cast<size_t>(idx) * 5;
    if constexpr (sizeof(T) == 4) {  // 4-byte aligned: five cp.asyncs
#pragma unroll
      for (int c = 0; c < 5; ++c) __pipeline_memcpy_async(&dst[c], v + c, 4);
      __pipeline_commit();
    } else {
#pragma unroll
      for (int c = 0; c < 5; ++c) st.v[c] = __ldg(v + c);
    }
  }
  __device__ __forceinline__ void land(T (&dst)[8], const Stage& st) const {
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int c = 0; c < 5; ++c) dst[c] = st.v[c];
    }
  }
};

// The LM's per-warp scratch beside WarpScratch.
template <typename T>
struct __align__(16) LmScratch {
  float sig[kTile][8];      // per step: s_base[0..3], s_sum, signal entropy
  int2 ctx[kMaxBeam];       // (ctx_full, ctx_prev), read by the gather
  float full[kMaxBeam][8];  // rows of ctx_full / ctx_prev: p[0..3], entropy
  float prev[kMaxBeam][8];
  T child[2][4 * kMaxBeam][8];  // by step parity: beam b's children's rows,
                                // slot 4b + base, as the table stores them
};

// Lane l's share of the 4W child rows: slots l and l + 32.
template <int W>
constexpr int kFetches = (4 * W + 31) / 32;
// Lane l's share of the 5W fused scores: l, l + 32, l + 64.
template <int W>
constexpr int kFused = (5 * W + 31) / 32;

// search_step's hooks: finish each lane's fetches inside the step.
template <int W, typename Table>
struct ChildFetch {
  Table table;
  typename Table::Value (*child)[8];  // this step's buffer
  typename Table::Stage (&st)[kFetches<W>];
  int lane;
  __device__ __forceinline__ void mid() const {
#pragma unroll
    for (int q = 0; q < kFetches<W>; ++q)
      if (lane + 32 * q < 4 * W) table.mid(child[lane + 32 * q], st[q]);
  }
  __device__ __forceinline__ void land() const {
    __pipeline_wait_prior(0);
#pragma unroll
    for (int q = 0; q < kFetches<W>; ++q)
      if (lane + 32 * q < 4 * W) table.land(child[lane + 32 * q], st[q]);
  }
};

// ((row + s_base) * 0.5) * s_sum, rounded after each operation
__device__ __forceinline__ float fuse(float row, float s_base, float s_sum) {
  return __fmul_rn(__fmul_rn(__fadd_rn(row, s_base), 0.5f), s_sum);
}

// At least one block an SM: a batch of a few hundred reads fills the
// card's 132 SMs with one block each, and ptxas may then keep every
// instantiation's registers (W 16 with a packed bf16 table: ~170)
// without spilling.
template <int W, typename Table>
__global__ void __launch_bounds__(32 * kWarps, 1)
beam_decode_lm_kernel(const float* __restrict__ probs, const int* __restrict__ lengths,
                      Table table, int ctx_len, float s_thr, float r_thr,
                      int8_t* __restrict__ bp, float* __restrict__ score,
                      int* __restrict__ nlab, int T, int N) {
  using Value = typename Table::Value;
  __shared__ WarpScratch scratch[kWarps];
  __shared__ LmScratch<Value> lm_scratch[kWarps];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  WarpScratch& s = scratch[threadIdx.x >> 5];
  LmScratch<Value>& lm = lm_scratch[threadIdx.x >> 5];
  Beam bm = initial_beam(lane);
  uint32_t ctx_full = 0u, ctx_prev = 0u;
  float rf[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // row of ctx_full
  float rp[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // row of ctx_prev
  // 4^ctx_len - 1: the context keeps its last ctx_len bases (ctx_len <= 15)
  const uint32_t ctx_mask = (1u << (2 * ctx_len)) - 1u;
  typename Table::Stage st[kFetches<W>];
  int cb = 0;  // this step's child buffer

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
      // fetch the children of each beam's context into this step's buffer
#pragma unroll
      for (int q = 0; q < kFetches<W>; ++q) {
        const int k = lane + 32 * q;  // slot 4 * beam + base
        const uint32_t ctx = __shfl_sync(kFull, ctx_full, (k >> 2) & 31);
        if (k < 4 * W)
          table.issue((ctx * 4u + static_cast<uint32_t>(k & 3)) & ctx_mask, lm.child[cb][k],
                      st[q]);
      }
      // the scores: log m[c], or where a gate opens the log of the fused
      // distribution; COPY needs only its last base's.  The 5W logs are
      // spread over the lanes, (beam f/5, column f%5) for f = lane + 32q,
      // each lane taking its inputs from the owner's registers and the
      // owner its scores back by shuffles; no lane takes a log unless some
      // gate is open.
      const float4 lq = *reinterpret_cast<const float4*>(&s.lp[tt][0]);
      float lpe[4] = {lq.x, lq.y, lq.z, lq.w};
      float lpc0 = bm.last == 1 ? lq.y : bm.last == 2 ? lq.z : bm.last == 3 ? lq.w : lq.x;
      const float s_sum = lm.sig[tt][4];
      const bool sig_open = lm.sig[tt][5] > s_thr;  // the step's signal gate
      // the owner's gates and the values they fuse: COPY the row of
      // ctx_prev at its last base, EXTEND the row of ctx_full
      const bool own_c = lane < W && sig_open && bm.last >= 0 && bm.len >= ctx_len + 1 &&
                         rp[4] < r_thr;
      const bool own_e = lane < W && sig_open && bm.len >= ctx_len && rf[4] < r_thr;
      const int last = bm.last < 0 ? 0 : bm.last;
      const float rpl = last == 1 ? rp[1] : last == 2 ? rp[2] : last == 3 ? rp[3] : rp[0];
      if (__any_sync(kFull, own_c || own_e)) {
        const int gates = (own_c ? 1 : 0) | (own_e ? 2 : 0) | (last << 2);
        float v[kFused<W>];
#pragma unroll
        for (int q = 0; q < kFused<W>; ++q) {
          const int f = lane + 32 * q;
          const int b = f < 5 * W ? f / 5 : 0;
          const int jc = f - 5 * (f / 5);  // column 0 = COPY, 1 + c = EXTEND by c
          const int g = __shfl_sync(kFull, gates, b);
          const float x0 = __shfl_sync(kFull, rpl, b);
          const float x1 = __shfl_sync(kFull, rf[0], b);
          const float x2 = __shfl_sync(kFull, rf[1], b);
          const float x3 = __shfl_sync(kFull, rf[2], b);
          const float x4 = __shfl_sync(kFull, rf[3], b);
          const int col = jc > 0 ? jc - 1 : g >> 2;
          const float x = jc == 0 ? x0 : jc == 1 ? x1 : jc == 2 ? x2 : jc == 3 ? x3 : x4;
          v[q] = 0.0f;
          if ((g >> (jc > 0 ? 1 : 0)) & 1) v[q] = logf(fuse(x, lm.sig[tt][col], s_sum));
        }
        // owner w takes column c from lane (5w + c) % 32 of round (5w + c) / 32
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const int f = 5 * lane + c;
          float got = 0.0f;
#pragma unroll
          for (int q = 0; q < kFused<W>; ++q) {
            const float y = __shfl_sync(kFull, v[q], f & 31);
            if (f >> 5 == q) got = y;
          }
          if (c == 0) {
            if (own_c) lpc0 = got;
          } else if (own_e) {
            lpe[c - 1] = got;
          }
        }
      }
      const float lpc[4] = {lpc0, lpc0, lpc0, lpc0};  // search_step reads lpc[last]
      search_step<W>(
          s, lane, bm, lpc, lpe, s.lp[tt][4],
          [&] {
            lm.ctx[lane] = make_int2(static_cast<int>(ctx_full), static_cast<int>(ctx_prev));
            store_row<float4>(lm.full[lane], rf);
            store_row<float4>(lm.prev[lane], rp);
          },
          ChildFetch<W, Table>{table, lm.child[cb], st, lane});
      if (lane < W) {
        const int slot = gather_beam<W>(s, lane, tt, bm);
        const int parent = slot / 5;
        const int j = slot - 5 * parent;  // 0 = copy, 1 + base = extend
        const int2 pc = lm.ctx[parent];
        if (j > 0) {
          ctx_prev = static_cast<uint32_t>(pc.x);
          ctx_full = (ctx_prev * 4u + static_cast<uint32_t>(j - 1)) & ctx_mask;
          const Value (&ch)[8] = lm.child[cb][4 * parent + j - 1];
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            rp[c] = lm.full[parent][c];
            rf[c] = widen(ch[c]);
          }
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
      cb ^= 1;
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
// t1/t2 = probs/entropy (dense) or l1/vals (packed).  `device` (the
// tensors' CUDA ordinal) is made current for the calling thread first:
// nvcc's static runtime keeps its own current device, apart from torch's.
// Returns a cudaError_t (0 = launched); the caller raises on anything else.
int radian_beam_decode_lm(const void* probs, const void* lengths, const void* t1,
                          const void* t2, int table_kind, int ctx_len, float s_thr,
                          float r_thr, void* bp, void* score, void* nlab, int T, int N,
                          int W, int device, void* stream) {
  if (N <= 0) return 0;
  if (W < 1 || W > kMaxBeam || ctx_len < 0 || ctx_len > 15) return cudaErrorInvalidValue;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
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
