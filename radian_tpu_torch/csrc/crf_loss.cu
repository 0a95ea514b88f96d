// Bonito's CTC-CRF sequence loss and its gradient, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no CRF model.  It is the training loss
// of the port's CRF models (ops/crf_loss.py), a forward-backward over two lattices
// that no PyTorch call computes.  The plain PyTorch version beside it is
// ops/crf_loss.py::loss_plain / grad_plain, with the same arithmetic: float32
// lattices, normalised a step at a time with the largest value of the step before,
// the offsets summed in float64.
//
// Semantics: S = 4^L states (L = state_len), scores [N, T, S*5], a state's stay score
// then its 4 move scores; column 1+r moves from r*(S/4) + s/4.
//   full:   a_0 = 0; a_{t+1}[s] = lse(a_t[s] + sc[t,s,0], a_t[prev_r(s)] + sc[t,s,1+r])
//   target: position j = 0..P-1 (P = n-L+1) is the k-mer k_j of bases b_j..b_{j+L-1};
//           b_0[0] = 0, -inf elsewhere;
//           b_{t+1}[j] = lae(b_t[j] + sc[t,k_j,0], b_t[j-1] + sc[t,k_j,1+b_{j-1}])
//   loss_n = (logZ - logZ_target) / n, and d loss / d sc = g_n (P_full - P_target) / n,
//   P the edge posteriors.
// Each lattice's step t+1 has the largest value of step t taken off (a lag of one
// step: the warps' partial maxima of step t are already in shared memory when step
// t+1 starts, so finding the largest costs one load and five shuffles a warp, no
// further barrier); the offsets C_t (forward) and D_t (backward) sum in float64 in
// every thread alike.  An edge's posterior is exp(a_t[src] + sc + b_{t+1}[s] - K_t),
// K_t = logZ - C_t - D_{t+1}.
//
// What bounds it on this card: latency.  Step t+1 of a row needs all of step t, so a
// row's time is T times one step's dependent chain (a barrier, five loads from shared
// memory, a five-way logsumexp); a step reads S*5 scores (10 KB in bf16 at L = 5),
// far below the memory rate over 64 rows.  The design:
//   - one block a row, 1,024 threads: thread s holds state s of the full lattice and
//     target positions s and s + 1,024 (so P <= 2,048);
//   - the step's score row staged in shared memory as float32, double-buffered: the
//     next row's loads go to registers at the start of a step and to the other buffer
//     after its arithmetic, so their latency hides behind the step; one barrier a step;
//   - forward: a_t of both lattices written to global memory (float32) for the
//     backward, and the offsets; the loss and the two log-partitions at the end;
//   - backward, one pass from T-1 down: the full lattice's 5 posteriors of state s in
//     registers; the target lattice's posteriors added into a shared row by atomics
//     (positions may share a k-mer); the step's gradient is written a step later,
//     once the barrier has gathered the target's share, in the scores' dtype, so the
//     target row is double-buffered too and a step keeps one barrier.
//
// Layouts: scores [N, T, S*5] f32 or bf16; targets [N, n_max] i32 (bases 0..3);
// lengths [N] i32; alpha [N, T, S] f32; alpha_t [N, T, P_max] f32 (P_max = n_max-L+1);
// offsets [N, 2, T] f64 (C_t, then the target's); logz [N, 2] f64; loss [N] f32;
// grad_out [N] f32; grad [N, T, S*5] in the scores' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 5;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 2;  // target positions a thread
constexpr int kMaxPos = kThreads * kPPT;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// log(exp(x0) + ... + exp(x4)); -inf when every x is -inf
__device__ __forceinline__ float lse5(float x0, float x1, float x2, float x3, float x4) {
  const float m = fmaxf(fmaxf(fmaxf(x0, x1), fmaxf(x2, x3)), x4);
  if (m == neg_inf()) return m;
  return m + logf(expf(x0 - m) + expf(x1 - m) + expf(x2 - m) + expf(x3 - m) + expf(x4 - m));
}

__device__ __forceinline__ float lse2(float x0, float x1) {
  const float m = fmaxf(x0, x1);
  if (m == neg_inf()) return m;
  return m + logf(expf(x0 - m) + expf(x1 - m));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the largest of the kWarps partial maxima in part[0..kWarps), in every lane
__device__ __forceinline__ float block_max(const float* part) {
  return warp_max(part[threadIdx.x & 31]);
}

// A thread's target positions: the k-mer and the column of the move into it.
struct Positions {
  int k[kPPT];
  int col[kPPT];
};

template <int L>
__device__ __forceinline__ Positions positions(const int* tg, int P) {
  Positions p;
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = threadIdx.x + q * kThreads;
    int k = 0, col = 0;
    if (j < P) {
#pragma unroll
      for (int i = 0; i < L; ++i) k = k * 4 + (tg[j + i] & 3);
      col = j > 0 ? 1 + (tg[j - 1] & 3) : 0;
    }
    p.k[q] = k;
    p.col[q] = col;
  }
  return p;
}

template <int S, typename T>
struct Row {
  static constexpr int kLen = S * kCols;
  static constexpr int kLoads = (kLen + kThreads - 1) / kThreads;
  T v[kLoads];

  __device__ __forceinline__ void load(const T* src) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kLen) v[i] = src[e];
    }
  }
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kLen) dst[e] = to_float(v[i]);
    }
  }
};

template <int S>
constexpr size_t forward_smem() {
  return sizeof(float) * (2 * S * kCols + 2 * S + 2 * kMaxPos + 2 * 2 * kWarps);
}

template <int L, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    crf_loss_forward_kernel(const T* __restrict__ scores, const int* __restrict__ targets,
                            int n_max, const int* __restrict__ lengths, int T_len, int P_max,
                            float* __restrict__ alpha, float* __restrict__ alpha_t,
                            double* __restrict__ offsets, double* __restrict__ logz,
                            float* __restrict__ loss) {
  constexpr int S = 1 << (2 * L);
  constexpr int kLen = S * kCols;
  extern __shared__ float smem[];
  float* row = smem;               // [2][kLen]
  float* a = row + 2 * kLen;       // [2][S]
  float* at = a + 2 * S;           // [2][kMaxPos]
  float* part = at + 2 * kMaxPos;  // [2 buffers][2 lattices][kWarps]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lengths[n];
  const int P = len - L + 1;
  const Positions pos = positions<L>(targets + size_t(n) * n_max, P);
  const T* src = scores + size_t(n) * T_len * kLen;
  float* a_out = alpha + size_t(n) * T_len * S;
  float* at_out = alpha_t + size_t(n) * T_len * P_max;
  double* c_out = offsets + size_t(n) * 2 * T_len;

  Row<S, T> next;
  if (T_len > 0) {
    next.load(src);
    next.put(row);
  }
  float va = tid < S ? 0.f : neg_inf();
  if (tid < S) a[tid] = 0.f;
  float vt = neg_inf();
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = tid + q * kThreads;
    if (j < P) {
      const float v = j == 0 ? 0.f : neg_inf();
      at[j] = v;
      vt = fmaxf(vt, v);
    }
  }
  va = warp_max(va);
  vt = warp_max(vt);
  if ((tid & 31) == 0) {
    part[tid >> 5] = va;
    part[kWarps + (tid >> 5)] = vt;
  }
  __syncthreads();

  double c = 0.0, ct = 0.0;
  int cur = 0;
  for (int t = 0; t < T_len; ++t) {
    const bool more = t + 1 < T_len;
    if (more) next.load(src + size_t(t + 1) * kLen);
    const float* r = row + cur * kLen;
    const float* ac = a + cur * S;
    const float* atc = at + cur * kMaxPos;
    const float* pc = part + cur * 2 * kWarps;
    const float m = block_max(pc);
    const float mt = block_max(pc + kWarps);
    // the state's and the positions' values at step t, kept for the backward
    if (tid < S) a_out[size_t(t) * S + tid] = ac[tid];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = tid + q * kThreads;
      if (j < P) at_out[size_t(t) * P_max + j] = atc[j];
    }
    if (tid == 0) {
      c_out[t] = c;
      c_out[T_len + t] = ct;
    }
    c += double(m);
    ct += double(mt);

    va = neg_inf();
    if (tid < S) {
      const int s = tid;
      const float* rs = r + s * kCols;
      const int from = s >> 2;
      const float v = lse5(ac[s] + rs[0], ac[from] + rs[1], ac[S / 4 + from] + rs[2],
                           ac[2 * (S / 4) + from] + rs[3], ac[3 * (S / 4) + from] + rs[4]) -
                      m;
      a[(cur ^ 1) * S + s] = v;
      va = v;
    }
    vt = neg_inf();
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = tid + q * kThreads;
      if (j < P) {
        const float* rk = r + pos.k[q] * kCols;
        const float stay = atc[j] + rk[0];
        const float move = j > 0 ? atc[j - 1] + rk[pos.col[q]] : neg_inf();
        const float v = lse2(stay, move) - mt;
        at[(cur ^ 1) * kMaxPos + j] = v;
        vt = fmaxf(vt, v);
      }
    }
    va = warp_max(va);
    vt = warp_max(vt);
    float* pn = part + (cur ^ 1) * 2 * kWarps;
    if ((tid & 31) == 0) {
      pn[tid >> 5] = va;
      pn[kWarps + (tid >> 5)] = vt;
    }
    if (more) next.put(row + (cur ^ 1) * kLen);
    __syncthreads();
    cur ^= 1;
  }

  // logZ = C_T + lse_s a_T[s]; the target's is C_T + a_T[P-1]
  const float* ac = a + cur * S;
  const float m = block_max(part + cur * 2 * kWarps);
  float e = tid < S ? expf(ac[tid] - m) : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
  float* sums = row;  // the score rows are no longer read
  __syncthreads();
  if ((tid & 31) == 0) sums[tid >> 5] = e;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += sums[w];
    const double z = c + double(m) + double(logf(total));
    const double zt = ct + double(at[cur * kMaxPos + P - 1]);
    logz[2 * n] = z;
    logz[2 * n + 1] = zt;
    loss[n] = float((z - zt) / double(len));
  }
}

template <int S>
constexpr size_t backward_smem() {
  return sizeof(float) * (2 * S * kCols + 2 * S * kCols + 2 * S + 2 * S + 2 * kMaxPos +
                          2 * kMaxPos + 2 * 2 * kWarps) +
         sizeof(int) * 2 * kMaxPos;
}

template <int L, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    crf_loss_backward_kernel(const T* __restrict__ scores, const int* __restrict__ targets,
                             int n_max, const int* __restrict__ lengths, int T_len, int P_max,
                             const float* __restrict__ alpha, const float* __restrict__ alpha_t,
                             const double* __restrict__ offsets, const double* __restrict__ logz,
                             const float* __restrict__ grad_out, T* __restrict__ grad) {
  constexpr int S = 1 << (2 * L);
  constexpr int Q = S / 4;
  constexpr int kLen = S * kCols;
  extern __shared__ float smem[];
  float* row = smem;                   // [2][kLen] the step's scores
  float* tgt = row + 2 * kLen;         // [2][kLen] the target's posteriors
  float* a = tgt + 2 * kLen;           // [2][S] a_t
  float* b = a + 2 * S;                // [2][S] b_t
  float* at = b + 2 * S;               // [2][kMaxPos]
  float* bt = at + 2 * kMaxPos;        // [2][kMaxPos]
  float* part = bt + 2 * kMaxPos;      // [2][2][kWarps]
  int* kmer = reinterpret_cast<int*>(part + 2 * 2 * kWarps);  // [kMaxPos] k_j * 5 + col_j

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lengths[n];
  const int P = len - L + 1;
  const Positions pos = positions<L>(targets + size_t(n) * n_max, P);
  const T* src = scores + size_t(n) * T_len * kLen;
  const float* a_in = alpha + size_t(n) * T_len * S;
  const float* at_in = alpha_t + size_t(n) * T_len * P_max;
  const double* c_in = offsets + size_t(n) * 2 * T_len;
  T* out = grad + size_t(n) * T_len * kLen;
  const double z = logz[2 * n], zt = logz[2 * n + 1];
  const float scale = grad_out[n] / float(len);
  if (T_len <= 0) return;

  // step T: b = 0 for every state, the target's 0 at its last position
  const int last = T_len & 1;
  float vb = neg_inf(), vbt = neg_inf();
  if (tid < S) {
    b[last * S + tid] = 0.f;
    vb = 0.f;
  }
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = tid + q * kThreads;
    if (j < P) {
      const float v = j == P - 1 ? 0.f : neg_inf();
      bt[last * kMaxPos + j] = v;
      vbt = fmaxf(vbt, v);
      kmer[j] = pos.k[q] * kCols + pos.col[q];
    }
  }
  for (int e = tid; e < 2 * kLen; e += kThreads) tgt[e] = 0.f;
  vb = warp_max(vb);
  vbt = warp_max(vbt);
  if ((tid & 31) == 0) {
    part[last * 2 * kWarps + (tid >> 5)] = vb;
    part[last * 2 * kWarps + kWarps + (tid >> 5)] = vbt;
  }
  // step T-1's scores and forward values
  const int first = (T_len - 1) & 1;
  {
    Row<S, T> r0;
    r0.load(src + size_t(T_len - 1) * kLen);
    r0.put(row + first * kLen);
    if (tid < S) a[first * S + tid] = a_in[size_t(T_len - 1) * S + tid];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = tid + q * kThreads;
      if (j < P) at[first * kMaxPos + j] = at_in[size_t(T_len - 1) * P_max + j];
    }
  }
  __syncthreads();

  double d = 0.0, dt = 0.0;
  double cf = c_in[T_len - 1], cft = c_in[2 * T_len - 1];  // C_t of the step at hand
  float pf[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f};  // step t+1's full posteriors
  for (int t = T_len - 1; t >= 0; --t) {
    const int p = t & 1, q1 = p ^ 1;
    const bool more = t > 0;
    Row<S, T> next;
    float next_a = 0.f, next_at[kPPT];
    double next_c = 0.0, next_ct = 0.0;
    if (more) {
      next.load(src + size_t(t - 1) * kLen);
      if (tid < S) next_a = a_in[size_t(t - 1) * S + tid];
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const int j = tid + q * kThreads;
        next_at[q] = j < P ? at_in[size_t(t - 1) * P_max + j] : 0.f;
      }
      next_c = c_in[t - 1];
      next_ct = c_in[T_len + t - 1];
    }
    const float m = block_max(part + q1 * 2 * kWarps);
    const float mt = block_max(part + q1 * 2 * kWarps + kWarps);
    const float K = float(z - cf - d);
    const float Kt = float(zt - cft - dt);
    const float* r = row + p * kLen;
    const float* ac = a + p * S;
    const float* bn = b + q1 * S;
    const float* atc = at + p * kMaxPos;
    const float* btn = bt + q1 * kMaxPos;

    // step t+1's gradient, now that the barrier has gathered its target share
    if (tid < S && t + 1 < T_len) {
      float* tr = tgt + q1 * kLen + tid * kCols;
      T* o = out + size_t(t + 1) * kLen + tid * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store(o + c, (pf[c] - tr[c]) * scale);
        tr[c] = 0.f;
      }
    }

    float vb_new = neg_inf();
    if (tid < S) {
      const int s = tid;
      const float* rs = r + s * kCols;
      const int from = s >> 2;
      const float bs = bn[s] - K;
      pf[0] = expf(ac[s] + rs[0] + bs);
#pragma unroll
      for (int c = 1; c < kCols; ++c) pf[c] = expf(ac[(c - 1) * Q + from] + rs[c] + bs);
      // b_t[s]: stay, or the moves into (s % Q)*4 + e, scored in their column 1 + s/Q
      const int into = (s % Q) * 4;
      const int col = 1 + s / Q;
      const float v = lse5(bn[s] + rs[0], bn[into] + r[into * kCols + col],
                           bn[into + 1] + r[(into + 1) * kCols + col],
                           bn[into + 2] + r[(into + 2) * kCols + col],
                           bn[into + 3] + r[(into + 3) * kCols + col]) -
                      m;
      b[p * S + s] = v;
      vb_new = v;
    }
    float vbt_new = neg_inf();
    float* tp = tgt + p * kLen;
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = tid + q * kThreads;
      if (j < P) {
        const int kc = pos.k[q] * kCols;
        const float bj = btn[j] - Kt;
        const float stay = atc[j] + r[kc] + bj;
        if (stay > neg_inf()) atomicAdd(tp + kc, expf(stay));
        if (j > 0) {
          const float move = atc[j - 1] + r[kc + pos.col[q]] + bj;
          if (move > neg_inf()) atomicAdd(tp + kc + pos.col[q], expf(move));
        }
        const float nxt = j + 1 < P ? btn[j + 1] + r[kmer[j + 1]] : neg_inf();
        const float v = lse2(btn[j] + r[kc], nxt) - mt;
        bt[p * kMaxPos + j] = v;
        vbt_new = fmaxf(vbt_new, v);
      }
    }
    d += double(m);
    dt += double(mt);
    vb_new = warp_max(vb_new);
    vbt_new = warp_max(vbt_new);
    if ((tid & 31) == 0) {
      part[p * 2 * kWarps + (tid >> 5)] = vb_new;
      part[p * 2 * kWarps + kWarps + (tid >> 5)] = vbt_new;
    }
    if (more) {
      next.put(row + q1 * kLen);
      if (tid < S) a[q1 * S + tid] = next_a;
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const int j = tid + q * kThreads;
        if (j < P) at[q1 * kMaxPos + j] = next_at[q];
      }
    }
    cf = next_c;
    cft = next_ct;
    __syncthreads();
  }
  // step 0's gradient
  if (tid < S) {
    const float* tr = tgt + tid * kCols;
    T* o = out + tid * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o + c, (pf[c] - tr[c]) * scale);
  }
}

template <int L, typename T>
int launch(bool backward, const void* scores, const int* targets, int n_max, const int* lengths,
           int N, int T_len, int P_max, float* alpha, float* alpha_t, double* offsets,
           double* logz, float* loss, const float* grad_out, void* grad, cudaStream_t stream) {
  constexpr int S = 1 << (2 * L);
  if (!backward) {
    constexpr size_t smem = forward_smem<S>();
    auto kernel = crf_loss_forward_kernel<L, T>;
    if (const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        e != cudaSuccess)
      return e;
    kernel<<<N, kThreads, smem, stream>>>(static_cast<const T*>(scores), targets, n_max, lengths,
                                          T_len, P_max, alpha, alpha_t, offsets, logz, loss);
  } else {
    constexpr size_t smem = backward_smem<S>();
    auto kernel = crf_loss_backward_kernel<L, T>;
    if (const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        e != cudaSuccess)
      return e;
    kernel<<<N, kThreads, smem, stream>>>(static_cast<const T*>(scores), targets, n_max, lengths,
                                          T_len, P_max, alpha, alpha_t, offsets, logz, grad_out,
                                          static_cast<T*>(grad));
  }
  return cudaGetLastError();
}

template <typename T>
int launch_for(int state_len, bool backward, const void* scores, const int* targets, int n_max,
               const int* lengths, int N, int T_len, int P_max, float* alpha, float* alpha_t,
               double* offsets, double* logz, float* loss, const float* grad_out, void* grad,
               cudaStream_t stream) {
#define RADIAN_CRF_LOSS_CASE(L)                                                             \
  case L:                                                                                   \
    return launch<L, T>(backward, scores, targets, n_max, lengths, N, T_len, P_max, alpha, \
                        alpha_t, offsets, logz, loss, grad_out, grad, stream);
  switch (state_len) {
    RADIAN_CRF_LOSS_CASE(2)
    RADIAN_CRF_LOSS_CASE(3)
    RADIAN_CRF_LOSS_CASE(4)
    RADIAN_CRF_LOSS_CASE(5)
    default: return cudaErrorInvalidValue;
  }
#undef RADIAN_CRF_LOSS_CASE
}

int dispatch(int dtype, int state_len, bool backward, const void* scores, const int* targets,
             int n_max, const int* lengths, int N, int T_len, int P_max, float* alpha,
             float* alpha_t, double* offsets, double* logz, float* loss, const float* grad_out,
             void* grad, cudaStream_t stream) {
  if (P_max < 1 || P_max > kMaxPos) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_for<float>(state_len, backward, scores, targets, n_max, lengths, N, T_len,
                             P_max, alpha, alpha_t, offsets, logz, loss, grad_out, grad, stream);
  if (dtype == 1)
    return launch_for<__nv_bfloat16>(state_len, backward, scores, targets, n_max, lengths, N,
                                     T_len, P_max, alpha, alpha_t, offsets, logz, loss, grad_out,
                                     grad, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry first makes `device` (the tensors' CUDA ordinal) current: this
// library links nvcc's static CUDA runtime, whose current device is its own.
// Returns a cudaError_t (0 = launched); the caller raises on anything else.
// dtype: 0 float32, 1 bfloat16.
int radian_crf_loss_forward(const void* scores, int dtype, const void* targets, int n_max,
                            const void* lengths, int N, int T, int state_len, int P_max,
                            void* alpha, void* alpha_t, void* offsets, void* logz, void* loss,
                            int device, void* stream) {
  if (N <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  return dispatch(dtype, state_len, false, scores, static_cast<const int*>(targets), n_max,
                  static_cast<const int*>(lengths), N, T, P_max, static_cast<float*>(alpha),
                  static_cast<float*>(alpha_t), static_cast<double*>(offsets),
                  static_cast<double*>(logz), static_cast<float*>(loss), nullptr, nullptr,
                  static_cast<cudaStream_t>(stream));
}

int radian_crf_loss_backward(const void* scores, int dtype, const void* targets, int n_max,
                             const void* lengths, int N, int T, int state_len, int P_max,
                             const void* alpha, const void* alpha_t, const void* offsets,
                             const void* logz, const void* grad_out, void* grad, int device,
                             void* stream) {
  if (N <= 0) return 0;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  return dispatch(dtype, state_len, true, scores, static_cast<const int*>(targets), n_max,
                  static_cast<const int*>(lengths), N, T, P_max,
                  const_cast<float*>(static_cast<const float*>(alpha)),
                  const_cast<float*>(static_cast<const float*>(alpha_t)),
                  const_cast<double*>(static_cast<const double*>(offsets)),
                  const_cast<double*>(static_cast<const double*>(logz)), nullptr,
                  static_cast<const float*>(grad_out), grad, static_cast<cudaStream_t>(stream));
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
