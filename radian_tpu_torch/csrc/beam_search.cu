// CTC prefix beam search without LM fusion, one thread per read, for sm_90a.
//
// Replaces the TPU kernel radian_tpu/ops/beam_pallas.py::beam_search_pallas
// (pl.pallas_call at :369, body _kernel :252 / _beam_step :72) and the
// backtrace scan it calls, radian_tpu/ops/beam_search.py::backtrace_batch.
// The semantics are those of beam_search_batch(lm_enabled=False)
// (radian_tpu/ops/beam_search.py:176-417), mirrored step by step by the
// plain PyTorch version radian_tpu_torch/ops/beam_search.py::_step:
//   - COPY + 4 EXTEND candidates per beam, in slot order 5*beam + col;
//   - EXTEND(b1,c)/COPY(b2) merges found by length + two 32-bit rolling
//     hashes (wrapping uint32 multiply), combined by logaddexp written as
//     JAX's formula with its NaN branch;
//   - scores floored at SCORE_FLOOR before the top-W selection, picked
//     slots knocked to KNOCKED, ties to the smallest slot;
//   - steps at t >= lengths[n] write identity backpointers w*8 and leave
//     the state unchanged.
// The Pallas kernel differs on exact-zero probabilities (no floor, a
// NaN-producing logaddexp); this kernel follows the scan.
//
// What bounds it on the card: the serial dependence over T, not bytes.
// Per (t, read) it reads 20 B of log-probs and writes W B of
// backpointers, against ~1-2k dependent instructions of candidate
// scoring, merge tests and selection.  One thread carries one read's
// whole time loop, its beam state in registers / local arrays, so with
// read_batch reads only read_batch threads are busy (256 reads = 2
// blocks on 2 of 132 SMs).  That is the next kernel PR's problem: a
// warp per read, or the W x 5 candidate layout spread across lanes, are
// the candidate redesigns.
//
// Layouts: logm [T, 5, N] f32 (read index fastest, so a warp's loads at
// step t are coalesced), lengths [N] i32, bp [T, W, N] int8 packed
// parent*8 + (append+1), score [N] f32, nlab [N] i32, rev [N, T] i32.
// Built with nvcc -O3 without --use_fast_math, so expf/log1pf are the
// same functions torch's CUDA kernels call for the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kNegHalf = -1.0e29f;
constexpr float kScoreFloor = -1.0e38f;
constexpr float kKnocked = -3.0e38f;
constexpr uint32_t kH1Mult = 2654435761u;
constexpr uint32_t kH2Mult = 2246822519u;
constexpr int kThreads = 128;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (isnan(d)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
beam_decode_kernel(const float* __restrict__ logm, const int* __restrict__ lengths,
                   int8_t* __restrict__ bp, float* __restrict__ score,
                   int* __restrict__ nlab, int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);

  float pb[W], pnb[W], pt[W];
  int last[W], len[W];
  uint32_t h1[W], h2[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pb[w] = w == 0 ? 0.0f : kNeg;
    pnb[w] = kNeg;
    pt[w] = w == 0 ? 0.0f : kNeg;
    last[w] = -1;
    len[w] = 0;
    h1[w] = 1u;
    h2[w] = 1u;
  }

  int steps = lengths[n];
  steps = steps < 0 ? 0 : (steps > T ? T : steps);
  for (int t = 0; t < steps; ++t) {
    float lp[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) lp[c] = logm[(static_cast<size_t>(t) * 5 + c) * sN + n];

    bool valid[W];
    float cnb[W], cb[W], ct[W];  // COPY candidates: pr_nb_c, pr_b_c, pr_t_c
    float enb[4][W];             // EXTEND candidates' pr_nb
    uint32_t e1[4][W], e2[4][W];  // extension hashes
#pragma unroll
    for (int w = 0; w < W; ++w) {
      valid[w] = pt[w] > kNegHalf;
      const float sel = last[w] >= 0 ? lp[last[w]] : 0.0f;
      cnb[w] = len[w] > 0 ? pnb[w] + sel : kNeg;
      cb[w] = pt[w] + lp[4];
      ct[w] = logaddexp(cb[w], cnb[w]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        enb[c][w] = (last[w] == c ? pb[w] : pt[w]) + lp[c];
        e1[c][w] = h1[w] * kH1Mult + static_cast<uint32_t>(c + 1);
        e2[c][w] = h2[w] * kH2Mult + static_cast<uint32_t>(c + 1);
      }
    }

    // merge detection EXTEND(b1, c) vs COPY(b2); the extend keeps the
    // merged mass iff its slot 5*b1+1+c precedes the copy's 5*b2
    float copy_extra[W];
    bool copy_killed[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      copy_extra[w] = kNeg;
      copy_killed[w] = false;
    }
    float cand_b[5 * W], cand_nb[5 * W], cand_t[5 * W];
#pragma unroll
    for (int b1 = 0; b1 < W; ++b1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bool has = false, wins = false;
        float nb_in = kNeg, b_in = kNeg, t_in = kNeg;
        uint32_t mask = 0;
#pragma unroll
        for (int b2 = 0; b2 < W; ++b2) {
          const bool m = valid[b1] && valid[b2] && len[b2] == len[b1] + 1 &&
                         h1[b2] == e1[c][b1] && h2[b2] == e2[c][b1];
          if (m) {
            mask |= 1u << b2;
            has = true;
            wins = wins || (5 * b1 + 1 + c < 5 * b2);
            nb_in = fmaxf(nb_in, cnb[b2]);
            b_in = fmaxf(b_in, cb[b2]);
            t_in = fmaxf(t_in, ct[b2]);
          }
        }
#pragma unroll
        for (int b2 = 0; b2 < W; ++b2) {
          if (mask & (1u << b2)) {
            if (wins) copy_killed[b2] = true;
            else copy_extra[b2] = fmaxf(copy_extra[b2], enb[c][b1]);
          }
        }
        const bool killed = has && !wins;
        const bool absorb = has && wins;
        const float e = enb[c][b1];
        const int s = 5 * b1 + 1 + c;
        cand_nb[s] = killed ? kNeg : (absorb ? logaddexp(e, nb_in) : e);
        cand_b[s] = absorb ? b_in : kNeg;
        cand_t[s] = killed ? kNeg : (absorb ? logaddexp(t_in, e) : e);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int s = 5 * w;
      cand_b[s] = copy_killed[w] ? kNeg : cb[w];
      cand_nb[s] = copy_killed[w] ? kNeg : logaddexp(cnb[w], copy_extra[w]);
      cand_t[s] = copy_killed[w] ? kNeg : logaddexp(ct[w], copy_extra[w]);
    }

    // iterative top-W selection: max score, smallest slot among ties
    float sc[5 * W];
#pragma unroll
    for (int s = 0; s < 5 * W; ++s) sc[s] = fmaxf(cand_t[s], kScoreFloor);
    float npb[W], npnb[W], npt[W];
    int nlast[W], nlen[W];
    uint32_t nh1[W], nh2[W];
    int8_t* bpt = bp + static_cast<size_t>(t) * W * sN + n;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int best = 0;
      float bv = sc[0];
#pragma unroll
      for (int s = 1; s < 5 * W; ++s) {
        if (sc[s] > bv) {
          bv = sc[s];
          best = s;
        }
      }
      const int parent = best / 5;
      const int append = best - 5 * parent - 1;  // -1 = copy
      const bool is_ext = append >= 0;
      npb[k] = cand_b[best];
      npnb[k] = cand_nb[best];
      npt[k] = cand_t[best];
      nlast[k] = is_ext ? append : last[parent];
      nlen[k] = len[parent] + (is_ext ? 1 : 0);
      nh1[k] = is_ext ? h1[parent] * kH1Mult + static_cast<uint32_t>(append + 1) : h1[parent];
      nh2[k] = is_ext ? h2[parent] * kH2Mult + static_cast<uint32_t>(append + 1) : h2[parent];
      bpt[k * sN] = static_cast<int8_t>(parent * 8 + append + 1);
      sc[best] = kKnocked;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pb[w] = npb[w];
      pnb[w] = npnb[w];
      pt[w] = npt[w];
      last[w] = nlast[w];
      len[w] = nlen[w];
      h1[w] = nh1[w];
      h2[w] = nh2[w];
    }
  }
  for (int t = steps; t < T; ++t) {
    int8_t* bpt = bp + static_cast<size_t>(t) * W * sN + n;
#pragma unroll
    for (int w = 0; w < W; ++w) bpt[w * sN] = static_cast<int8_t>(w * 8);
  }
  score[n] = pt[0];
  nlab[n] = len[0];
}

// Walk beam 0 back through the packed backpointers: rev[n, T-1-t] is the
// label appended at step t (-1 for a copy), i.e. 5'->3' order.
__global__ void __launch_bounds__(kThreads)
beam_backtrace_kernel(const int8_t* __restrict__ bp, int* __restrict__ rev,
                      int T, int W, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);
  int* out = rev + static_cast<size_t>(n) * T;
  int beam = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int sel = bp[(static_cast<size_t>(t) * W + beam) * sN + n];
    out[T - 1 - t] = (sel & 7) - 1;
    beam = (sel >> 3) & 7;  // always < W for pointers this kernel's pair wrote
  }
}

template <int W>
cudaError_t launch_decode(const float* logm, const int* lengths, int8_t* bp,
                          float* score, int* nlab, int T, int N, cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  beam_decode_kernel<W><<<blocks, kThreads, 0, stream>>>(logm, lengths, bp, score, nlab, T, N);
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
    default: return cudaErrorInvalidValue;
  }
}

int radian_beam_backtrace(const void* bp, void* rev, int T, int W, int N, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + kThreads - 1) / kThreads;
  beam_backtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bp), static_cast<int*>(rev), T, W, N);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
