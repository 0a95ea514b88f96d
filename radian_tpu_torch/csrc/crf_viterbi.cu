// CRF Viterbi decode of the transformer-CRF model (Bonito's CTC_CRF), for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no CRF model.  It is the decode of
// the port's second model family (models/tx_crf.py, ops/crf_viterbi.py), and no
// PyTorch call computes a Viterbi path.  The plain PyTorch version beside it is
// ops/crf_viterbi.py::viterbi_forward_plain / backtrace_plain, with the same
// arithmetic: float32 sums of the scores (bf16 or f32) onto alpha, the stay
// (column 0) then the 4 moves compared with a strict >, so ties go to the lowest
// column, and the final state the lowest of those with the largest alpha.
//
// Semantics: S = 4^state_len states, the newest base in the low 2 bits.  Scores
// [N, T, S*5], a state's stay score then its 4 move scores; column 1+r moves from
// state r*(S/4) + s/4.  alpha_0 = 0;
//   alpha_{t+1}[s] = max(alpha_t[s] + sc[t,s,0], max_r alpha_t[r*S/4 + s/4] + sc[t,s,1+r]).
// bp[n, t, s] is the winning column (one byte a state-step); a move into s
// emits base s % 4.
//
// What bounds it on this card: bytes and latency.  A step of one chunk reads
// S*5 scores (10 KB in bf16 at S = 1,024) and writes S bytes of backpointers for
// ~9 operations a state, far below the operation rate; and step t+1 needs all of
// step t's alpha, so a chunk's time is T x one step's dependent chain.  The
// design:
//   - one block a chunk, one thread a state (1,024 threads at state_len 5), so a
//     batch of 512 chunks runs two blocks an SM over two waves;
//   - alpha double-buffered in shared memory: a step is one __syncthreads;
//   - the next step's score row is loaded as 16-byte vectors into registers at
//     the start of the step, stored to the other shared-memory buffer after the
//     step's arithmetic, so its global latency hides behind the step;
//   - backpointers written as one coalesced byte a thread a step;
//   - the final argmax by warp shuffles.
// The backtrace is one thread a chunk walking T bytes back (one load a step).
//
// Layouts: scores [N, T, S*5] f32 or bf16 (16-byte aligned), bp [N, T, S] u8,
// final [N] i32, path [N, T] i8 (the emitted base, -1 for a stay).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 5;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The larger of (v, s) and (v2, s2): the larger value, the lower state on ties.
__device__ __forceinline__ void keep_best(float& v, int& s, float v2, int s2) {
  if (v2 > v || (v2 == v && s2 < s)) {
    v = v2;
    s = s2;
  }
}

template <int S, typename T>
__global__ void __launch_bounds__(S < 32 ? 32 : S)
    crf_viterbi_fwd_kernel(const T* __restrict__ scores, uint8_t* __restrict__ bp,
                           int* __restrict__ final_state, int T_len) {
  constexpr int kThreads = S < 32 ? 32 : S;
  constexpr int kRow = S * kCols;
  constexpr int kVec = kRow * int(sizeof(T)) / 16;
  static_assert(kRow * sizeof(T) % 16 == 0, "a score row is whole 16-byte vectors");
  constexpr int kVecPerThread = (kVec + kThreads - 1) / kThreads;
  __shared__ float alpha[2][S];
  __shared__ __align__(16) T row[2][kRow];

  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(scores + size_t(n) * T_len * kRow);
  uint8_t* out = bp + size_t(n) * T_len * S;
  if (T_len > 0) {
    for (int i = s; i < kVec; i += kThreads) reinterpret_cast<uint4*>(row[0])[i] = src[i];
  }
  if (s < S) alpha[0][s] = 0.f;
  __syncthreads();

  const int from = s >> 2;
  int cur = 0;
  for (int t = 0; t < T_len; ++t) {
    const bool more = t + 1 < T_len;
    uint4 next[kVecPerThread];
    if (more) {
#pragma unroll
      for (int j = 0; j < kVecPerThread; ++j) {
        const int i = s + j * kThreads;
        if (i < kVec) next[j] = src[size_t(t + 1) * kVec + i];
      }
    }
    if (s < S) {
      const T* r = row[cur] + s * kCols;
      const float* a = alpha[cur];
      float best = a[s] + to_float(r[0]);
      int col = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v = a[b * (S / 4) + from] + to_float(r[1 + b]);
        if (v > best) {
          best = v;
          col = b + 1;
        }
      }
      alpha[cur ^ 1][s] = best;
      out[size_t(t) * S + s] = uint8_t(col);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kVecPerThread; ++j) {
        const int i = s + j * kThreads;
        if (i < kVec) reinterpret_cast<uint4*>(row[cur ^ 1])[i] = next[j];
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  // the final state: the largest alpha, the lowest state on ties
  float v = s < S ? alpha[cur][s] : -__int_as_float(0x7f800000);
  int st = s < S ? s : 0x7fffffff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int s2 = __shfl_down_sync(0xffffffffu, st, off);
    keep_best(v, st, v2, s2);
  }
  constexpr int kWarps = kThreads / 32;
  if constexpr (kWarps > 1) {
    // the score rows are no longer read: their memory holds the warps' bests
    float* wv = reinterpret_cast<float*>(row[0]);
    int* ws = reinterpret_cast<int*>(row[0]) + kWarps;
    if ((s & 31) == 0) {
      wv[s >> 5] = v;
      ws[s >> 5] = st;
    }
    __syncthreads();
    if (s < 32) {
      v = s < kWarps ? wv[s] : -__int_as_float(0x7f800000);
      st = s < kWarps ? ws[s] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, v, off);
        const int s2 = __shfl_down_sync(0xffffffffu, st, off);
        keep_best(v, st, v2, s2);
      }
    }
  }
  if (s == 0) final_state[n] = st;
}

__global__ void crf_viterbi_backtrace_kernel(const uint8_t* __restrict__ bp,
                                             const int* __restrict__ final_state,
                                             int8_t* __restrict__ path, int T_len, int N, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint8_t* b = bp + size_t(n) * T_len * S;
  int8_t* p = path + size_t(n) * T_len;
  const int quarter = S >> 2;
  int s = final_state[n];
  for (int t = T_len - 1; t >= 0; --t) {
    const int c = b[size_t(t) * S + s];
    p[t] = c ? int8_t(s & 3) : int8_t(-1);
    if (c) s = (c - 1) * quarter + (s >> 2);
  }
}

template <int S, typename T>
int launch_forward(const void* scores, void* bp, void* final_state, int T_len, int N,
                   cudaStream_t stream) {
  constexpr int kThreads = S < 32 ? 32 : S;
  crf_viterbi_fwd_kernel<S, T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<uint8_t*>(bp), static_cast<int*>(final_state),
      T_len);
  return cudaGetLastError();
}

template <typename T>
int forward_for(int state_len, const void* scores, void* bp, void* final_state, int T_len,
                int N, cudaStream_t stream) {
  switch (state_len) {
    case 2: return launch_forward<16, T>(scores, bp, final_state, T_len, N, stream);
    case 3: return launch_forward<64, T>(scores, bp, final_state, T_len, N, stream);
    case 4: return launch_forward<256, T>(scores, bp, final_state, T_len, N, stream);
    case 5: return launch_forward<1024, T>(scores, bp, final_state, T_len, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry first makes `device` (the tensors' CUDA ordinal) current: this
// library links nvcc's static CUDA runtime, whose current device is its own.
// Returns a cudaError_t (0 = launched); the caller raises on anything else.
// dtype: 0 float32, 1 bfloat16.
int radian_crf_viterbi(const void* scores, int dtype, void* bp, void* final_state, int T, int N,
                       int state_len, int device, void* stream) {
  if (N <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward_for<float>(state_len, scores, bp, final_state, T, N, st);
  if (dtype == 1) return forward_for<__nv_bfloat16>(state_len, scores, bp, final_state, T, N, st);
  return cudaErrorInvalidValue;
}

int radian_crf_backtrace(const void* bp, const void* final_state, void* path, int T, int N, int S,
                         int device, void* stream) {
  if (N <= 0) return 0;
  if (S < 16 || S > 1024) return cudaErrorInvalidValue;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  constexpr int kThreads = 32;
  crf_viterbi_backtrace_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const int*>(final_state),
      static_cast<int8_t*>(path), T, N, S);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
