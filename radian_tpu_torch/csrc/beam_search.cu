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
// Layouts: logm [N, T, 5] f32 (log-probs), lengths [N] i32,
// bp [N, T, W] int8 packed parent*8 + (append+1) (at most 124 for W <= 16),
// score [N] f32, nlab [N] i32, rev [N, T] i32.  Built with nvcc -O3
// without --use_fast_math, so expf/log1pf are the same functions torch's
// CUDA kernels call for the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kNegHalf = -1.0e29f;
constexpr float kScoreFloor = -1.0e38f;
constexpr uint32_t kH1Mult = 2654435761u;
constexpr uint32_t kH2Mult = 2246822519u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBeam = 16;
constexpr int kWarps = 2;  // reads (warps) per block
constexpr int kTile = 32;  // steps per log-prob / backpointer tile
constexpr int kInvalid = 0x40000000;  // flag on a record's len: beam invalid

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (isnan(d)) return a + b;
  // beyond |d| ~ 104 expf(-|d|) is exactly 0, and log1pf(0) = 0
  if (fabsf(d) > 200.0f) return fmaxf(a, b) + 0.0f;
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

// Monotone map of a non-NaN float to uint32 (+0 and -0 map alike).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Five values into a 16-byte aligned row of eight: one vector store + one.
template <typename V, typename T>
__device__ __forceinline__ void store_row(T (&row)[8], const T (&v)[5]) {
  *reinterpret_cast<V*>(&row[0]) = V{v[0], v[1], v[2], v[3]};
  row[4] = v[4];
}

// One warp's scratch.  Records are written by their owner lane and read
// by every lane as broadcasts, between __syncwarp()s.
struct __align__(16) WarpScratch {
  float lp[kTile][8];           // log-probs of the current tile, [step][class]
  int4 beam[kMaxBeam];          // (len | kInvalid if invalid, h1, h2, last)
  float4 copy[kMaxBeam];        // COPY candidate before merging: (nb, b, t, -)
  float4 ext_nb[kMaxBeam];      // EXTEND candidates' pr_nb before merging
  int wins[kMaxBeam];           // bit c: EXTEND(w, c) absorbs its copies
  int4 state[kMaxBeam];         // (len, h1, h2, last), read by the gather
  float cand_b[kMaxBeam][8];    // merged candidates, [beam][col 0..4]
  float cand_nb[kMaxBeam][8];
  float cand_t[kMaxBeam][8];
  uint32_t key[kMaxBeam][8];    // ordered floored scores, [beam][col]
  int pick[kMaxBeam];           // slot that becomes beam k
  int8_t bp[kTile * kMaxBeam];  // backpointers of the current tile
};

template <int W>
__global__ void __launch_bounds__(32 * kWarps)
beam_decode_kernel(const float* __restrict__ logm, const int* __restrict__ lengths,
                   int8_t* __restrict__ bp, float* __restrict__ score,
                   int* __restrict__ nlab, int T, int N) {
  constexpr int kSlots = 5 * W;
  constexpr int kPerLane = (kSlots + 31) / 32;  // slots a lane ranks
  __shared__ WarpScratch scratch[kWarps];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  WarpScratch& s = scratch[threadIdx.x >> 5];
  const bool owner = lane < W;

  // beam state of lane w (beam w); lanes >= W hold an invalid beam
  float pb = lane == 0 ? 0.0f : kNeg;
  float pnb = kNeg;
  float pt = lane == 0 ? 0.0f : kNeg;
  int last = -1, len = 0;
  uint32_t h1 = 1u, h2 = 1u;

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
      const float lp_blank = s.lp[tt][4];

      // own candidates: COPY and the four EXTENDs of beam `lane`
      const bool valid = pt > kNegHalf;
      const float sel = last == 0 ? lpc[0] : last == 1 ? lpc[1]
                      : last == 2 ? lpc[2] : last == 3 ? lpc[3] : 0.0f;
      const float cnb = len > 0 ? pnb + sel : kNeg;
      const float cb = pt + lp_blank;
      const float ct = logaddexp(cb, cnb);
      float enb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) enb[c] = (last == c ? pb : pt) + lpc[c];
      const uint32_t m1 = h1 * kH1Mult, m2 = h2 * kH2Mult;
      if (owner) {
        s.beam[lane] = make_int4(valid ? len : (len | kInvalid), static_cast<int>(h1),
                                 static_cast<int>(h2), last);
        s.copy[lane] = make_float4(cnb, cb, ct, 0.0f);
        s.ext_nb[lane] = make_float4(enb[0], enb[1], enb[2], enb[3]);
      }
      __syncwarp();

      // merge pairs, both ways: bit b of `fwd` = some EXTEND(lane, c) has
      // COPY(b)'s labeling; bit b of `bwd` = some EXTEND(b, c) has ours
      uint32_t fwd = 0u, bwd = 0u;
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const int4 a = s.beam[b];
        const uint32_t f1 = static_cast<uint32_t>(a.y) - m1 - 1u;
        const uint32_t f2 = static_cast<uint32_t>(a.z) - m2 - 1u;
        const uint32_t r1 = h1 - static_cast<uint32_t>(a.y) * kH1Mult - 1u;
        const uint32_t r2 = h2 - static_cast<uint32_t>(a.z) * kH2Mult - 1u;
        if (a.x == len + 1 && f1 == f2 && f1 < 4u) fwd |= 1u << b;
        if (len == a.x + 1 && r1 == r2 && r1 < 4u) bwd |= 1u << b;
      }
      if (!valid) fwd = bwd = 0u;

      // extend side: EXTEND(lane, c) keeps the merged mass iff its slot
      // 5*lane+1+c precedes the copy's 5*b, i.e. iff b > lane
      bool has[4] = {false, false, false, false};
      bool wins[4] = {false, false, false, false};
      float nb_in[4] = {kNeg, kNeg, kNeg, kNeg};
      float b_in[4] = {kNeg, kNeg, kNeg, kNeg};
      float t_in[4] = {kNeg, kNeg, kNeg, kNeg};
      for (uint32_t m = fwd; m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        const uint32_t c = static_cast<uint32_t>(s.beam[b].y) - m1 - 1u;
        const float4 cp = s.copy[b];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c == static_cast<uint32_t>(k)) {
            has[k] = true;
            wins[k] = wins[k] || b > lane;
            nb_in[k] = fmaxf(nb_in[k], cp.x);
            b_in[k] = fmaxf(b_in[k], cp.y);
            t_in[k] = fmaxf(t_in[k], cp.z);
          }
        }
      }
      if (owner) {
        s.wins[lane] = (wins[0] ? 1 : 0) | (wins[1] ? 2 : 0) | (wins[2] ? 4 : 0) |
                       (wins[3] ? 8 : 0);
      }
      __syncwarp();

      // copy side: COPY(lane) against the EXTEND(b, c) that match it
      bool copy_killed = false;
      float copy_extra = kNeg;
      for (uint32_t m = bwd; m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        const uint32_t c = h1 - static_cast<uint32_t>(s.beam[b].y) * kH1Mult - 1u;
        const float4 e = s.ext_nb[b];
        const float ev = c == 0u ? e.x : c == 1u ? e.y : c == 2u ? e.z : e.w;
        if ((s.wins[b] >> c) & 1) copy_killed = true;
        else copy_extra = fmaxf(copy_extra, ev);
      }

      // merged candidates, col 0 = COPY, col 1+c = EXTEND(c)
      float cand_b[5], cand_nb[5], cand_t[5];
      cand_b[0] = copy_killed ? kNeg : cb;
      cand_nb[0] = copy_killed ? kNeg : logaddexp(cnb, copy_extra);
      cand_t[0] = copy_killed ? kNeg : logaddexp(ct, copy_extra);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = enb[c];
        cand_b[1 + c] = kNeg;
        cand_nb[1 + c] = e;
        cand_t[1 + c] = e;
        if (has[c]) {
          if (wins[c]) {  // absorbs the matching copies
            cand_b[1 + c] = b_in[c];
            cand_nb[1 + c] = logaddexp(e, nb_in[c]);
            cand_t[1 + c] = logaddexp(t_in[c], e);
          } else {  // merged into an earlier copy
            cand_nb[1 + c] = kNeg;
            cand_t[1 + c] = kNeg;
          }
        }
      }
      if (owner) {
        uint32_t key[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) key[j] = ordered(fmaxf(cand_t[j], kScoreFloor));
        store_row<float4>(s.cand_b[lane], cand_b);
        store_row<float4>(s.cand_nb[lane], cand_nb);
        store_row<float4>(s.cand_t[lane], cand_t);
        store_row<uint4>(s.key[lane], key);
        s.state[lane] = make_int4(len, static_cast<int>(h1), static_cast<int>(h2), last);
      }
      __syncwarp();

      // top-W by rank: lane ranks slots lane + 32q against all 5W keys
      // (64-bit key: ordered score, then 0xffff - slot so ties go to the
      // smaller slot); the slot of rank k < W becomes beam k
      uint64_t mine[kPerLane];
      int rank[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int slot = lane + 32 * q;
        mine[q] = slot < kSlots
                      ? (static_cast<uint64_t>(s.key[slot / 5][slot % 5]) << 32) |
                            (0xffffu - slot)
                      : ~0ull;
        rank[q] = 0;
      }
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const uint4 kq = *reinterpret_cast<const uint4*>(&s.key[b][0]);
        const uint32_t kb[5] = {kq.x, kq.y, kq.z, kq.w, s.key[b][4]};
#pragma unroll
        for (int jb = 0; jb < 5; ++jb) {
          const uint64_t other =
              (static_cast<uint64_t>(kb[jb]) << 32) | (0xffffu - (5 * b + jb));
#pragma unroll
          for (int q = 0; q < kPerLane; ++q) rank[q] += other > mine[q] ? 1 : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int slot = lane + 32 * q;
        if (slot < kSlots && rank[q] < W) s.pick[rank[q]] = slot;
      }
      __syncwarp();

      // gather: lane k takes the slot of rank k
      if (owner) {
        const int slot = s.pick[lane];
        const int parent = slot / 5;
        const int j = slot - 5 * parent;  // 0 = copy, 1 + base = extend
        const int4 st = s.state[parent];
        const bool ext = j > 0;
        pb = s.cand_b[parent][j];
        pnb = s.cand_nb[parent][j];
        pt = s.cand_t[parent][j];
        last = ext ? j - 1 : st.w;
        len = st.x + (ext ? 1 : 0);
        h1 = ext ? static_cast<uint32_t>(st.y) * kH1Mult + static_cast<uint32_t>(j)
                 : static_cast<uint32_t>(st.y);
        h2 = ext ? static_cast<uint32_t>(st.z) * kH2Mult + static_cast<uint32_t>(j)
                 : static_cast<uint32_t>(st.z);
        s.bp[tt * W + lane] = static_cast<int8_t>(parent * 8 + j);
      }
    }
    __syncwarp();
    // flush: live steps from the tile, identity pointers past the length
    int8_t* dst = bp_read + static_cast<size_t>(t0) * W;
    for (int i = lane; i < nt * W; i += 32) {
      const int tt = i / W;
      dst[i] = tt < ns ? s.bp[i] : static_cast<int8_t>((i - tt * W) * 8);
    }
  }
  if (lane == 0) {
    score[n] = pt;
    nlab[n] = len;
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

// Returns a cudaError_t (0 = launched); the caller raises on anything else.
int radian_beam_decode(const void* logm, const void* lengths, void* bp, void* score,
                       void* nlab, int T, int N, int W, void* stream) {
  if (N <= 0) return 0;
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

int radian_beam_backtrace(const void* bp, void* rev, int T, int W, int N, void* stream) {
  if (N <= 0) return 0;
  if (W < 1 || W > kMaxBeam) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  beam_backtrace_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bp), static_cast<int*>(rev), T, W, N);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
