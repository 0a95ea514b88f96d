// The TCN's causal dilated convolutions in bf16, channels-last, each with
// its bias, ReLU and residual epilogue fused in, for sm_90a.
//
// Replaces no Pallas kernel: radian_tpu/models/tcn.py leaves the stack to
// XLA, whose convolution fuses its elementwise neighbours on the TPU.  The
// port's first route was cuDNN's conv1d in [N, C, T] plus PyTorch's
// elementwise kernels: F.pad copies, cuDNN's NCHW<->NHWC transposes, the
// bf16 bias add, the ReLUs and the residual sum in f32, ~60 bytes moved an
// activation element a block.  Here one launch computes one convolution and
// its whole epilogue, with the activations [N, T, C] from the input to the
// dense head.
//
// What bounds it on this card: a 256 -> 256 convolution with k = 3 is
// 2 * 768 * 256 = 393,216 FLOP a row of time against ~2 bytes read and 2
// written a channel (and 2 more for the residual), ~190 FLOP a byte: at
// 989 TFLOP/s bf16 and 3.35 TB/s, the tensor cores bound it, barely; the
// epilogue's bytes cost about as long as the products.  The design:
//   - an implicit GEMM: M = the rows of time of one read (a 128-row tile
//     never crosses reads), N = C_out = 256, K = k * C_in = 768; tap j's
//     K chunk is the contiguous [128, 64] slab of x at t - (k-1-j) * d;
//   - TMA feeds it: a 3-D map over x [N, T, C] loads each slab with the
//     128-byte swizzle wgmma reads; rows t < 0 (the causal padding) and
//     t >= T (the ragged last tile) are out of bounds and come in as zeros,
//     so no F.pad and any T;
//   - wgmma m64n256k16 (bf16 in, f32 accumulate): the only route to the
//     card's tensor-core rate; mma.sync peaks lower on Hopper;
//   - warp specialised and persistent: one producer warp keeps TMA loads of
//     a 4-stage ring in flight (48 KB a stage: the x slab and the [256, 64]
//     weight chunk, from L2), two consumer warpgroups each own 64 rows of the
//     tile and all 256 output channels (128 f32 accumulators a thread); a
//     block walks over tiles, so its next tile's loads run during this
//     tile's epilogue;
//   - the epilogue runs on the accumulators in registers and rounds where
//     the unfused path does (models/tcn.py): the f32 sum to bf16, + the bf16
//     bias (an f32 add, rounded once: torch's bf16 add), ReLU; for a block's
//     second convolution then relu(input + branch) in f32, rounded to bf16.
//     The block input is read back (mode 1) or, for block 0, recomputed from
//     the 1-channel signal as its 1x1 shortcut with the shortcut's own
//     roundings (mode 2), never stored 256 wide: at 256 reads of 8,192
//     rows, mode 2 takes 1.9 ms where PyTorch's bf16 shortcut
//     (x * w + b, two passes over [N, T, 256]) fed to mode 1 takes 4.3, and
//     the whole stack 21.4 ms against 24.0 (the same bits either way);
//   - weights are packed once, [C_out, k * C_in] with K = tap * C_in + c_in
//     (ops/tcn_conv.py caches them).
// On an H100 80GB HBM3 at 700 W a convolution over 256 reads of 8,192 rows
// takes 1.6-2.0 ms against its 0.83 ms bound (~45-50 % of the bf16
// peak); the residual epilogue adds ~0.25 ms, so the epilogue, which both
// consumer warpgroups run while the tensor cores wait, is the next cost.
// Sharing each weight chunk between the 2 blocks of a cluster (TMA
// multicast, half the weight bytes from L2) made it ~30 % slower.
// Block 0's first convolution (1 -> 256, K = k) is no GEMM: a SIMT kernel,
// tcn_conv_in_kernel, a warp a row of time writing 512 contiguous bytes.
//
// Layouts (all contiguous, bf16): x, res, out [N, T, 256]; signal [N, T];
// w [256, k * 256] (tcn_conv_kernel) or [256, k] (tcn_conv_in_kernel);
// bias, sc_w, sc_b [256].  The plain PyTorch version is
// radian_tpu_torch/ops/tcn_conv.py::tcn_conv_plain.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;                 // channels in and out of a GEMM conv
constexpr int kBM = 128;                // rows of time a tile
constexpr int kBK = 64;                 // K a chunk: one 128-byte swizzle row
constexpr int kStages = 4;              // ring depth
constexpr int kChunksPerTap = kC / kBK;
constexpr int kABytes = kBM * kBK * 2;  // x slab of a chunk
constexpr int kBBytes = kC * kBK * 2;   // weight chunk
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;           // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
// the ring, the 2 * kStages barriers, and room to align the ring to 1024 B
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

enum Mode { kPlain = 0, kResidual = 1, kShortcut = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle TMA writes: start address >> 4, leading offset 1 (unused by this
// layout), stride 1024 B between 8-row groups, layout SWIZZLE_128B.  The
// k16 slice kk of a 64-wide chunk starts 32 * kk bytes in.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], both K-major in shared memory.
// Thread (warp w, lane l) of the warpgroup holds rows 16w + l/4 + 8i and
// columns 8j + 2(l%4) + e in d[4j + 2i + e].
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the unfused path's rounding points: the f32 sum rounded to bf16, plus the
// bf16 bias in f32 rounded once, ReLU (a NaN stays NaN, as torch.relu)
__device__ __forceinline__ float bias_relu(float acc, float b) {
  const float y = __bfloat162float(__float2bfloat16_rn(acc));
  const float z = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, b)));
  return z < 0.f ? 0.f : z;
}

// relu(input + branch) in f32, rounded to bf16
__device__ __forceinline__ bf16 residual_relu(float r, float y) {
  const float s = __fadd_rn(r, y);
  return __float2bfloat16_rn(s < 0.f ? 0.f : s);
}

// block 0's 1x1 shortcut of the 1-channel signal: bf16(s * w), + the bf16
// bias, rounded, as the unfused shortcut convolution rounds
__device__ __forceinline__ float shortcut(float s, float w, float b) {
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(s, w)));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(p, b)));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
tcn_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const bf16* __restrict__ bias, bf16* __restrict__ out,
                const bf16* __restrict__ res, const bf16* __restrict__ signal,
                const bf16* __restrict__ sc_w, const bf16* __restrict__ sc_b, int T,
                int k, int dilation, int tiles_per_read, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = k * kChunksPerTap;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n = tile / tiles_per_read;
        const int t0 = (tile - n * tiles_per_read) * kBM;
        for (int kc = 0; kc < n_chunks; ++kc) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kStageBytes);
          const int tap = kc / kChunksPerTap;
          const uint32_t a = ring + stage * kStageBytes;
          tma_load_3d(a, &map_x, full(stage), (kc % kChunksPerTap) * kBK,
                      t0 - (k - 1 - tap) * dilation, n);
          tma_load_2d(a + kABytes, &map_w, full(stage), kc * kBK, 0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup g computes rows [64g, 64g + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(full(stage), phase);
        const uint32_t a = ring + stage * kStageBytes + g * 64 * (kBK * 2);
        const uint32_t b = ring + stage * kStageBytes + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
        wgmma_commit();
        fence_acc(acc);
        // the previous chunk's products are done: release its stage
        wgmma_wait<1>();
        if (kc > 0 && lane == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty(prev));

      // epilogue, from the accumulators
      const int n = tile / tiles_per_read;
      const int t_row = (tile - n * tiles_per_read) * kBM + g * 64 + warp * 16 + (lane >> 2);
      const int cb = 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t_row + 8 * i;
        if (t >= T) continue;
        const size_t row = static_cast<size_t>(n) * T + t;
        bf16* o = out + row * kC;
        float s = 0.f;
        if (kMode == kShortcut) s = __bfloat162float(signal[row]);
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          const int c = 8 * j + cb;
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
          const float y0 = bias_relu(acc[4 * j + 2 * i], __low2float(bb));
          const float y1 = bias_relu(acc[4 * j + 2 * i + 1], __high2float(bb));
          __nv_bfloat162 v;
          if (kMode == kPlain) {
            v = __floats2bfloat162_rn(y0, y1);
          } else {
            float r0, r1;
            if (kMode == kResidual) {
              const __nv_bfloat162 r =
                  *reinterpret_cast<const __nv_bfloat162*>(res + row * kC + c);
              r0 = __low2float(r);
              r1 = __high2float(r);
            } else {
              const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(sc_w + c);
              const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(sc_b + c);
              r0 = shortcut(s, __low2float(w), __low2float(b));
              r1 = shortcut(s, __high2float(w), __high2float(b));
            }
            v.x = residual_relu(r0, y0);
            v.y = residual_relu(r1, y1);
          }
          *reinterpret_cast<__nv_bfloat162*>(o + c) = v;
        }
      }
    }
  }
}

// Block 0's first convolution, 1 -> 256 channels: a warp a row of time at
// a time, lane l computing channels [8l, 8l + 8) and storing them as 16
// bytes; each lane keeps its k * 8 weights and 8 biases in registers while
// its warp walks over rows.
constexpr int kInWarps = 8;    // warps a block
constexpr int kInMaxTaps = 8;  // k the kernel takes

__global__ void __launch_bounds__(32 * kInWarps)
tcn_conv_in_kernel(const bf16* __restrict__ signal, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                   long long rows, int T, int k, int dilation) {
  const int c0 = 8 * (threadIdx.x & 31);
  float wr[kInMaxTaps][8], br[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    br[e] = __bfloat162float(bias[c0 + e]);
#pragma unroll
    for (int tap = 0; tap < kInMaxTaps; ++tap)
      wr[tap][e] = tap < k ? __bfloat162float(w[(c0 + e) * k + tap]) : 0.f;
  }
  const long long warps = static_cast<long long>(gridDim.x) * kInWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kInWarps + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const int t = static_cast<int>(row % T);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < kInMaxTaps; ++tap) {
      const int back = (k - 1 - tap) * dilation;
      if (tap >= k || t < back) continue;  // t < back: the causal padding
      const float s = __bfloat162float(signal[row - back]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(s, wr[tap][e], acc[e]);
    }
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(bias_relu(acc[e], br[e]));
    *reinterpret_cast<uint4*>(out + row * kC + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with the 128-byte swizzle; out-of-bounds boxes read 0
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// the card's SM count, once a device (0: the query failed)
int sm_count(int device) {
  static int sms[kMaxDevices];
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

template <int kMode>
cudaError_t launch_conv(const CUtensorMap& mx, const CUtensorMap& mw, const bf16* bias,
                        bf16* out, const bf16* res, const bf16* signal, const bf16* sc_w,
                        const bf16* sc_b, int N, int T, int k, int dilation, int device,
                        cudaStream_t stream) {
  // the kernel's shared-memory attribute, once a device
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        tcn_conv_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  const int sms = sm_count(device);
  const int tiles_per_read = (T + kBM - 1) / kBM;
  const long long n_tiles = static_cast<long long>(N) * tiles_per_read;
  if (sms == 0 || n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  // persistent: one block an SM, each walking over tiles
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  tcn_conv_kernel<kMode><<<grid, kThreads, kSmemBytes, stream>>>(
      mx, mw, bias, out, res, signal, sc_w, sc_b, T, k, dilation, tiles_per_read,
      static_cast<int>(n_tiles));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry first makes `device` (the tensors' CUDA ordinal) current for
// the calling thread: this library links nvcc's static CUDA runtime, whose
// current device is its own, not torch's.  Returns a cudaError_t (0 =
// launched); the caller raises on anything else.

// out = epilogue(conv(x, w) + bias) for x [N, T, 256]; mode 0: relu;
// 1: relu(res + relu(.)) with res [N, T, 256]; 2: the same with res the
// shortcut of signal [N, T] by sc_w, sc_b.
int radian_tcn_conv(const void* x, const void* w, const void* bias, void* out,
                    const void* res, const void* signal, const void* sc_w,
                    const void* sc_b, int mode, int N, int T, int k, int dilation,
                    int device, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (k < 1 || dilation < 1) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[3] = {kC, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(N)};
  const cuuint64_t x_strides[2] = {kC * 2, static_cast<cuuint64_t>(T) * kC * 2};
  const cuuint32_t x_box[3] = {kBK, kBM, 1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(k) * kC, kC};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(k) * kC * 2};
  const cuuint32_t w_box[2] = {kBK, kC};
  if (!make_map(&mx, x, 3, x_dims, x_strides, x_box) ||
      !make_map(&mw, w, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const bf16* r = static_cast<const bf16*>(res);
  const bf16* s = static_cast<const bf16*>(signal);
  const bf16* sw = static_cast<const bf16*>(sc_w);
  const bf16* sb = static_cast<const bf16*>(sc_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain:
      return launch_conv<kPlain>(mx, mw, b, o, r, s, sw, sb, N, T, k, dilation, device, st);
    case kResidual:
      return launch_conv<kResidual>(mx, mw, b, o, r, s, sw, sb, N, T, k, dilation, device,
                                    st);
    case kShortcut:
      return launch_conv<kShortcut>(mx, mw, b, o, r, s, sw, sb, N, T, k, dilation, device,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out = relu(conv(signal, w) + bias), signal [N, T] (1 channel), w [256, k]
int radian_tcn_conv_in(const void* signal, const void* w, const void* bias, void* out,
                       int N, int T, int k, int dilation, int device, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (k < 1 || k > kInMaxTaps || dilation < 1) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(N) * T;
  // 8 blocks an SM, each warp walking over rows
  const long long blocks = (rows + kInWarps - 1) / kInWarps;
  const int grid = static_cast<int>(blocks < 8LL * sms ? blocks : 8LL * sms);
  tcn_conv_in_kernel<<<grid, 32 * kInWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(signal), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), rows, T, k, dilation);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
