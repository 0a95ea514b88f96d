// The transformer-CRF encoder's DeepNorm residual and RMSNorm, one launch a
// norm, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no transformer.  It replaces
// the chain of float32 PyTorch kernels that ops/tx_norm.py::
// add_rmsnorm_plain runs on the bf16 card path (two .float() copies, the
// scaled residual, the sum, its square, the mean, rsqrt and two products,
// the .to(bf16) copy: ~10 kernels and ~17.7 GB of float32 traffic a call
// at [524288, 512]).
//
// What it computes, rounding for rounding as the plain version: for each row
// of d elements, h = fl(y + fl(alpha * x)) in float32 (alpha rounded to
// float32, products and sums by __fmul_rn / __fadd_rn so that no FMA
// contraction changes h); r = rsqrtf(fl(sum of fl(h * h)) / d + eps); out =
// bf16_rn(fl(fl(h * r) * w)).  Only the order of the sum of squares differs
// from torch's reduction: a lane sums its own elements in order, then the
// warp's 32 sums meet by xor shuffles (every lane gets the same bits).
//
// What bounds it on this card: bytes.  y and x are read once and the output
// is written once, 3 * 2 * rows * d bytes (1.61 GB at [524288, 512]: 0.481
// ms at 3.35 TB/s), against ~8 operations an element.  The design keeps
// enough bytes in flight to reach that bound:
//   - one warp a row: a lane holds K = d / 256 pieces of 8 elements each of
//     y, x and the output (16-byte loads and stores, the warp's 32 lanes on
//     512 neighbouring bytes a piece); no shared memory;
//   - a persistent grid of as many resident blocks as the card holds, each
//     warp walking the rows with a stride of the grid's warps, the weight
//     (bf16) held in registers across its rows;
//   - the next row's y and x loads are issued before the current row's
//     arithmetic and reduction, so each warp keeps a row in flight while it
//     computes.
// Loads are streaming (__ldcs): nothing is read twice.
//
// Layouts (contiguous, 16-byte aligned): y, x, out [rows, d] bf16; w [d]
// bf16; d = 256 * K, K in 1 .. kMaxPieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kPiece = 8;       // bf16 elements a 16-byte piece
constexpr int kMaxPieces = 4;   // d up to 1,024
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// a row's pieces: piece k of lane l holds elements (k * 32 + l) * 8 .. + 7
template <int K>
__device__ __forceinline__ void load_row(const bf16* __restrict__ y, const bf16* __restrict__ x,
                                         long long row, int lane, uint4 (&yv)[K],
                                         uint4 (&xv)[K]) {
  const uint4* yr = reinterpret_cast<const uint4*>(y + row * (256 * K)) + lane;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * (256 * K)) + lane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    yv[k] = __ldcs(yr + 32 * k);
    xv[k] = __ldcs(xr + 32 * k);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    tx_norm_kernel(const bf16* __restrict__ y, const bf16* __restrict__ x,
                   const bf16* __restrict__ w, bf16* __restrict__ out, long long rows,
                   float alpha, float eps) {
  constexpr int kD = 256 * K;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  uint4 wv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wv[k] = reinterpret_cast<const uint4*>(w)[32 * k + lane];
  uint4 yv[K], xv[K];
  load_row<K>(y, x, row, lane, yv, xv);
  for (; row < rows; row += warps) {
    float h[K][kPiece];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t* yw = reinterpret_cast<const uint32_t*>(&yv[k]);
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[k]);
#pragma unroll
      for (int j = 0; j < kPiece / 2; ++j) {
        h[k][2 * j] = __fadd_rn(lo(yw[j]), __fmul_rn(alpha, lo(xw[j])));
        h[k][2 * j + 1] = __fadd_rn(hi(yw[j]), __fmul_rn(alpha, hi(xw[j])));
      }
    }
    // the next row's loads go out before this row's reduction
    if (row + warps < rows) load_row<K>(y, x, row + warps, lane, yv, xv);
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < kPiece; ++j) ss = __fadd_rn(ss, __fmul_rn(h[k][j], h[k][j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(kD)), eps));
    uint4* o = reinterpret_cast<uint4*>(out + row * kD) + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t* ww = reinterpret_cast<const uint32_t*>(&wv[k]);
      uint4 ov;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
      for (int j = 0; j < kPiece / 2; ++j) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            __fmul_rn(__fmul_rn(h[k][2 * j], r), lo(ww[j])),
            __fmul_rn(__fmul_rn(h[k][2 * j + 1], r), hi(ww[j])));
        ow[j] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      o[32 * k] = ov;
    }
  }
}

// blocks of kThreads the card keeps resident, once a device and K (0: the
// query failed)
template <int K>
int resident_blocks(int device) {
  static int blocks[kMaxDevices];
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tx_norm_kernel<K>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

template <int K>
int launch(const void* y, const void* x, const void* w, void* out, long long rows, float alpha,
           float eps, int device, cudaStream_t stream) {
  const int resident = resident_blocks<K>(device);
  if (resident == 0) return cudaErrorInvalidValue;
  const long long needed = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = needed < resident ? static_cast<int>(needed) : resident;
  tx_norm_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), rows, alpha, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [rows, d] = RMSNorm(y + alpha * x) * w, all bf16, d = 256 * K with K
// in 1 .. 4.  First makes `device` (the tensors' CUDA ordinal) current for
// the calling thread: this library links nvcc's static CUDA runtime, whose
// current device is its own, not torch's.  Returns a cudaError_t (0 =
// launched); the caller raises on anything else.
int radian_tx_norm(const void* y, const void* x, const void* w, void* out, long long rows, int d,
                   float alpha, float eps, int device, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 256 != 0 || d / 256 > kMaxPieces) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d / 256) {
    case 1: return launch<1>(y, x, w, out, rows, alpha, eps, device, st);
    case 2: return launch<2>(y, x, w, out, rows, alpha, eps, device, st);
    case 3: return launch<3>(y, x, w, out, rows, alpha, eps, device, st);
    default: return launch<4>(y, x, w, out, rows, alpha, eps, device, st);
  }
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
