// The transformer-CRF encoder's windowed multi-head attention with its
// rotary embedding, one launch a layer, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no transformer.  It replaces
// the glue the port first ran around PyTorch's memory-efficient SDPA kernel
// (models/tx_crf.py's rotary + band_attention): float32 rotary copies, a
// padded, transposed q, unfolded K and V bands of 3x the tensor, a mask
// expanded a head, the output transposed back, ~23 ms a layer at
// [512, 1024, 8, 64] on an H100.
//
// What it computes (the plain version is ops/tx_attention.py::
// tx_attention_plain): qkv = Wqkv's output [N, T, 3, H, 64] bf16, read in
// place; q and k rotated in float32 by a [T, 32] cos/sin table, each
// product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn: no
// FMA contraction), rounded to bf16 once, so they equal rotary()'s bit for
// bit; query i attends to keys i - left .. i + right of its own chunk
// (left, right <= 128); scores and the online softmax in float32 (exp2 of
// s * log2(e)/sqrt(D) less the running maximum, in steps of 64 keys), P
// rounded to bf16 for the P.V product, row sums and the output sums in
// float32; o = O * (1 / l) written as [N, T, H * 64] bf16, for out_proj.
//
// What bounds it on this card: per layer it must read q, k and v and write
// o, 4 * N * T * H * 64 * 2 bytes (2.147 GB at [512, 1024, 8, 64]: 0.641 ms
// at 3.35 TB/s), against ~275 GFLOP of useful products (0.28 ms at 989
// TFLOP/s) and an exp2 a score (MUFU, 16 a clock an SM: ~0.36 ms for the
// 320 keys a query computed).  So it is bound by bytes, if each of q, k
// and v is read once, and the exp2s and products hide under the loads.
// The design:
//   - a block walks over (chunk, head) pairs (persistent: one block an SM,
//     so the next pair's first tiles load while this pair's last tile
//     computes, and no block starts cold on a pair of ~8 tiles);
//   - a pair's query tiles of 128 rows in order; tile b's window lies in
//     key tiles b-1, b, b+1, so the K/V tiles live in a 4-slot ring in
//     shared memory: each is loaded by TMA once (128 rows of 128 bytes
//     straight out of qkv's [N, T, 3 * H * 64] rows, in the 128-byte
//     swizzle wgmma reads) and read by 3 query tiles while the next tile
//     loads; Q tiles in a 3-slot ring;
//   - warp specialised: one producer thread issues the TMA loads, a
//     group a query tile (K/V tile b, Q tile b, the table's rows of tile
//     b); three rotator warps rotate K and Q in place from the table tile
//     in shared memory, once each, so the consumers never wait on it (the
//     table read a row at a time from L2 for every pair cost 0.7 ms a
//     layer); two consumer warpgroups each own 64 query rows of a tile;
//   - S = Q.K^T on wgmma m64n64k16 (both operands in shared memory); O +=
//     P.V on wgmma with P from registers (the accumulator layout is the A
//     fragment layout) and V as it came (MN-major, transposed by the
//     instruction); step i + 1's S and step i's P.V are issued together;
//   - keys in steps of 64: tile b first (it holds every row's own key),
//     then b-1, then b+1; a step outside a warpgroup's window is skipped
//     (5 steps a warpgroup of 6, at the (127, 128) window: 320 keys
//     computed for 256 useful), and only the steps across the window's
//     edges or the chunk's end are masked;
//   - rows of a ragged last tile: TMA zero-fills rows t >= T, the mask
//     excludes keys t >= T (a zero-filled row is never a key), and the
//     output, staged in shared memory (8 KB a warpgroup, swizzled), goes
//     out by a TMA store that clips rows t >= T.
// On an H100 80GB HBM3 at 700 W it takes 1.41-1.44 ms a layer at [512,
// 1024, 8, 64] against the 0.641 ms bound: the loads with the S products
// alone take 0.73 ms; the rotation adds ~0.2 and the softmax ~0.3.  The
// softmax of a warpgroup does not overlap its own P.V (ptxas waits for
// P.V before the softmax, whose temporaries reuse P's registers): only the
// other warpgroup's work fills that wait.
//
// Layouts (contiguous): qkv [N, T, 3, H, 64] bf16; cos, sin [T, 32] f32;
// out [N, T, H, 64] bf16; rot (optional, for checks) [N, T, 2, H, 64] bf16
// receives the rotated q and k.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;      // head dim: a 128-byte row a token
constexpr int kTile = 128;  // queries a tile, keys a K/V tile
constexpr int kStep = 64;   // keys a softmax step
constexpr int kKvSlots = 4;  // tiles b-1, b, b+1 and the next
constexpr int kQSlots = 3;   // tiles b, b+1 and the next
constexpr int kTileBytes = kTile * kD * 2;  // 16 KB
constexpr int kKvBytes = 2 * kTileBytes;    // K then V
constexpr int kStepBytes = kStep * kD * 2;  // 64 rows: 8 KB
constexpr int kTabBytes = kTile * kD * 4;   // a tile's cos then sin rows
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kRotatorWarps = 3;  // the producer warpgroup's warps 1-3
constexpr int kConsumerWarps = 8;
constexpr int kRotBatch = 2;  // items a rotator thread loads at once
// registers a thread after setmaxnreg: a block starts with 168 a thread
// (65,536 / 384, in steps of 8), and the consumers' increase waits for the
// producer warpgroup's decrease to free as many
constexpr int kProducerRegs = 112, kConsumerRegs = 192;
static_assert(128 * (168 - kProducerRegs) >= 256 * (kConsumerRegs - 168),
              "the consumers would wait for registers forever");
// shared memory: the K/V ring, the Q ring, the output staging (8 KB a
// consumer warpgroup), the table tile, the barriers; 1 KB to align
constexpr int kQOff = kKvSlots * kKvBytes;
constexpr int kOOff = kQOff + kQSlots * kTileBytes;
constexpr int kTabOff = kOOff + kTileBytes;
constexpr int kBarOff = kTabOff + kTabBytes;
constexpr int kBars = 3 * kKvSlots + 3 * kQSlots + 2;
constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;
static_assert(kSmemBytes <= 232448, "over a block's shared memory");

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

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the staging buffer's last store has read it (read) / is done (all)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle TMA writes: 128-byte
// rows, 1,024 bytes between 8-row groups.  K-major (S's Q and K): the k16
// slice kk starts 32 * kk bytes in.  MN-major (P.V's V, keys as rows): the
// k16 slice kk (keys 16kk..) starts 16 * 128 * kk bytes in.
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

// keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], both K-major in shared memory.
// Thread (warp w, lane l) of the warpgroup holds rows 16w + l/4 + 8i and
// columns 8j + 2(l%4) + e in d[4j + 2i + e].
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (a0..a3: rows
// l/4 and l/4 + 8, columns 2(l%4) + {0, 1} and + 8, of the warp's 16 rows),
// B MN-major in shared memory (transposed by the instruction)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rotary()'s arithmetic on one element pair: each product and sum rounded
__device__ __forceinline__ void rotate_pair(float x1, float x2, float c, float s, bf16* o1,
                                            bf16* o2) {
  *o1 = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  *o2 = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

// Rotates a swizzled [128, 64] tile in place by the table tile tab (cos
// rows, then sin rows, 32 floats a row), token t0 + row; rows t >= T are
// TMA's zeros and stay.  The `threads` rotator threads share the work: an
// item is 16 bytes of d in [8c, 8c + 8) of a row and the matching 16 bytes
// of d + 32.  rot, when set, points at the pair's (n, which, h) row 0 of
// the check output, rows rot_stride elements apart.
__device__ __forceinline__ void rotate_tile(uint8_t* tile, const uint8_t* tab, int t0,
                                            int T, int tid, int threads, bf16* rot,
                                            long long rot_stride) {
  for (int item0 = tid; item0 < kTile * 4; item0 += threads * kRotBatch) {
#pragma unroll
    for (int k = 0; k < kRotBatch; ++k) {
      const int item = item0 + k * threads, r = item >> 2, c = item & 3, t = t0 + r;
      if (item >= kTile * 4 || t >= T) continue;
      uint4* p1 = reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4));
      uint4* p2 = reinterpret_cast<uint4*>(tile + r * 128 + (((c + 4) ^ (r & 7)) << 4));
      uint4 v1 = *p1, v2 = *p2;
      const float4* cp = reinterpret_cast<const float4*>(tab + r * 128 + 32 * c);
      const float4* sp = reinterpret_cast<const float4*>(tab + kTabBytes / 2 + r * 128 + 32 * c);
      const float4 cs[2] = {cp[0], cp[1]}, sn[2] = {sp[0], sp[1]};
      const float* cf = reinterpret_cast<const float*>(cs);
      const float* sf = reinterpret_cast<const float*>(sn);
      bf16* x1 = reinterpret_cast<bf16*>(&v1);
      bf16* x2 = reinterpret_cast<bf16*>(&v2);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        rotate_pair(__bfloat162float(x1[e]), __bfloat162float(x2[e]), cf[e], sf[e], &x1[e],
                    &x2[e]);
      *p1 = v1;
      *p2 = v2;
      if (rot != nullptr) {
        bf16* row = rot + t * rot_stride;
        *reinterpret_cast<uint4*>(row + 8 * c) = v1;
        *reinterpret_cast<uint4*>(row + 8 * c + 32) = v2;
      }
    }
  }
}

// The key steps of query tile b: steps 0-1 the two halves of key tile b,
// 2-3 of b - 1, 4-5 of b + 1.
__device__ __forceinline__ int step_tile(int step, int b) {
  return step < 2 ? b : step < 4 ? b - 1 : b + 1;
}

// The first step >= step whose keys meet the window of some row of the
// warpgroup whose first query is q0, or 6.
__device__ __forceinline__ int next_step(int step, int b, int n_tiles, int q0, int T,
                                         int left, int right) {
  for (; step < 6; ++step) {
    const int tile = step_tile(step, b);
    if (tile < 0 || tile >= n_tiles) continue;
    const int k0 = tile * kTile + (step & 1) * kStep;
    if (k0 >= T) continue;
    const int lo = k0 - q0 - (kStep - 1), hi = k0 + (kStep - 1) - q0;
    if (hi < -left || lo > right) continue;
    break;
  }
  return step;
}

// 2^x, with outputs under 2^-126 flushed to 0 (they add nothing a row sum
// of at least 1, or a bf16 probability, can hold)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One step's softmax on the scores s of keys [k0, k0 + 64): masked outside
// the window and past T where the step crosses them; the running maximum
// m (scaled), the factor alpha for what was summed before, s turned into
// p = exp2(s * c - m) in place, the row sums lsum rescaled and added to.
__device__ __forceinline__ void softmax_step(float* s, float* m, float* lsum, float* alpha,
                                             int k0, int q0, int T, int left, int right,
                                             float c, int warp, int lane) {
  const float neg_inf = __int_as_float(0xff800000);
  const int quad = lane & 3;
  const int lo = k0 - q0 - (kStep - 1), hi = k0 + (kStep - 1) - q0;
  if (!(lo >= -left && hi <= right && k0 + kStep <= T)) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * quad + e;
          const int off = key - (q0 + 16 * warp + (lane >> 2) + 8 * i);
          if (off < -left || off > right || key >= T) s[4 * j + 2 * i + e] = neg_inf;
        }
  }
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = neg_inf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m[i], __fmul_rn(mx, c));
    m_use[i] = m_new == neg_inf ? 0.f : m_new;
    alpha[i] = exp2_ftz(__fsub_rn(m[i], m_use[i]));
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = exp2_ftz(__fsub_rn(__fmul_rn(x, c), m_use[i]));
        rs[i] = __fadd_rn(rs[i], x);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = __fadd_rn(__fmul_rn(lsum[i], alpha[i]), rs[i]);
}

// O *= alpha, then P (bf16, wgmma's A fragments) from p
__device__ __forceinline__ void rescale_pack(float* o, const float* alpha, const float* p,
                                             uint32_t (*pa)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[4 * j + 2 * i + e] = __fmul_rn(o[4 * j + 2 * i + e], alpha[i]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

// A slot of a ring: its index, and the phase its i-th use waits for
template <int kSlots>
struct Ring {
  uint32_t i = 0;
  __device__ __forceinline__ int slot(uint32_t k = 0) const { return (i + k) % kSlots; }
  __device__ __forceinline__ uint32_t phase(uint32_t k = 0) const {
    return ((i + k) / kSlots) & 1;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
tx_attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                    const __grid_constant__ CUtensorMap map_o,
                    const __grid_constant__ CUtensorMap map_cos,
                    const __grid_constant__ CUtensorMap map_sin, bf16* __restrict__ rot,
                    int N, int T, int H, int left, int right, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  // a K/V or Q slot's barriers: full (TMA landed), ready (rotated), empty
  // (read); the table's: full, empty (rotations done)
  enum { kFull = 0, kReady = 1, kEmpty = 2 };
  const uint32_t bars = base + kBarOff;
  auto kv_bar = [&](int kind, int s) { return bars + 8 * (kind * kKvSlots + s); };
  auto q_bar = [&](int kind, int s) { return bars + 8 * (3 * kKvSlots + kind * kQSlots + s); };
  auto tab_bar = [&](int kind) {
    return bars + 8 * (3 * kKvSlots + 3 * kQSlots + (kind == kEmpty));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvSlots; ++s) {
      mbar_init(kv_bar(kFull, s), 1);
      mbar_init(kv_bar(kReady, s), kRotatorWarps);
      mbar_init(kv_bar(kEmpty, s), kConsumerWarps);
    }
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(q_bar(kFull, s), 1);
      mbar_init(q_bar(kReady, s), kRotatorWarps);
      mbar_init(q_bar(kEmpty, s), kConsumerWarps);
    }
    mbar_init(tab_bar(kFull), 1);
    mbar_init(tab_bar(kEmpty), kRotatorWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  const int pairs = N * H;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  // A pair's tiles come in groups, one a query tile b, in order: K/V tile b,
  // Q tile b and the table's rows of tile b.  Query tile b reads K/V tiles
  // b - 1 .. b + 1 and Q tile b, so the producer runs a group or two ahead.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // the producer: every TMA load, each slot once its readers let go
      Ring<kKvSlots> kv;
      Ring<kQSlots> q;
      for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
        const int n = p / H, h = p - n * H;
        for (int b = 0; b < n_tiles; ++b, ++kv.i, ++q.i) {
          const int t0 = b * kTile;
          mbar_wait(kv_bar(kEmpty, kv.slot()), kv.phase() ^ 1);
          mbar_expect_tx(kv_bar(kFull, kv.slot()), kKvBytes);
          const uint32_t kv_dst = base + kv.slot() * kKvBytes;
          tma_load_3d(kv_dst, &map_qkv, kv_bar(kFull, kv.slot()), (H + h) * kD, t0, n);
          tma_load_3d(kv_dst + kTileBytes, &map_qkv, kv_bar(kFull, kv.slot()),
                      (2 * H + h) * kD, t0, n);
          mbar_wait(q_bar(kEmpty, q.slot()), q.phase() ^ 1);
          mbar_expect_tx(q_bar(kFull, q.slot()), kTileBytes);
          tma_load_3d(base + kQOff + q.slot() * kTileBytes, &map_qkv, q_bar(kFull, q.slot()),
                      h * kD, t0, n);
          // the table: one slot, its group's rotations done
          mbar_wait(tab_bar(kEmpty), (q.i & 1) ^ 1);
          mbar_expect_tx(tab_bar(kFull), kTabBytes);
          tma_load_2d(base + kTabOff, &map_cos, tab_bar(kFull), 0, t0);
          tma_load_2d(base + kTabOff + kTabBytes / 2, &map_sin, tab_bar(kFull), 0, t0);
        }
      }
    } else if (threadIdx.x >= 32) {
      // the rotators (warps 1-3): K and Q of each group rotated once
      const int tid = threadIdx.x - 32;
      const int threads = 32 * kRotatorWarps;
      const long long rot_stride = 2LL * H * kD;
      Ring<kKvSlots> kv;
      Ring<kQSlots> q;
      for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
        const int n = p / H, h = p - n * H;
        bf16* rot_q = nullptr;
        if (rot != nullptr) rot_q = rot + static_cast<long long>(n) * T * rot_stride + h * kD;
        for (int b = 0; b < n_tiles; ++b, ++kv.i, ++q.i) {
          const int t0 = b * kTile;
          mbar_wait(tab_bar(kFull), q.i & 1);
          mbar_wait(kv_bar(kFull, kv.slot()), kv.phase());
          rotate_tile(gbase + kv.slot() * kKvBytes, gbase + kTabOff, t0, T, tid, threads,
                      rot_q == nullptr ? nullptr : rot_q + H * kD, rot_stride);
          mbar_wait(q_bar(kFull, q.slot()), q.phase());
          rotate_tile(gbase + kQOff + q.slot() * kTileBytes, gbase + kTabOff, t0, T, tid,
                      threads, rot_q, rot_stride);
          fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(tab_bar(kEmpty));
            mbar_arrive(kv_bar(kReady, kv.slot()));
            mbar_arrive(q_bar(kReady, q.slot()));
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows [64g, 64g + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int g = wg - 1;
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5;
  const int quad = lane & 3;
  const uint32_t o_stage = base + kOOff + g * kStepBytes;
  uint8_t* o_stage_g = gbase + kOOff + g * kStepBytes;
  Ring<kKvSlots> kv;  // the pair's K/V tile 0
  Ring<kQSlots> q;    // this query tile's

  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int n = p / H, h = p - n * H;
    for (int b = 0; b < n_tiles; ++b, ++q.i) {
      if (b == 0) mbar_wait(kv_bar(kReady, kv.slot()), kv.phase());
      if (b + 1 < n_tiles) mbar_wait(kv_bar(kReady, kv.slot(b + 1)), kv.phase(b + 1));
      mbar_wait(q_bar(kReady, q.slot()), q.phase());

      const int q0 = b * kTile + 64 * g;  // this warpgroup's first query
      const uint32_t qa = base + kQOff + q.slot() * kTileBytes + g * kStepBytes;
      auto k_addr = [&](int step) {
        return base + kv.slot(step_tile(step, b)) * kKvBytes + (step & 1) * kStepBytes;
      };
      auto issue_s = [&](float* s, int step) {
        const uint32_t ka = k_addr(step);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, smem_desc(qa + 32 * kk), smem_desc(ka + 32 * kk), kk);
        wgmma_commit();
      };
      auto issue_pv = [&](float* o, uint32_t (*pa)[4], int step) {
        const uint32_t va = k_addr(step) + kTileBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], smem_desc(va + 2048 * kk));
        wgmma_commit();
      };
      auto key0 = [&](int step) { return step_tile(step, b) * kTile + (step & 1) * kStep; };
      const float neg_inf = __int_as_float(0xff800000);
      float o[32], s[32], m[2] = {neg_inf, neg_inf}, lsum[2] = {0.f, 0.f}, alpha[2];
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      int cur = q0 < T ? next_step(0, b, n_tiles, q0, T, left, right) : 6;
      if (cur < 6) {
        wgmma_fence();
        issue_s(s, cur);
        wgmma_wait<0>();
        fence_acc(s);
        softmax_step(s, m, lsum, alpha, key0(cur), q0, T, left, right, scale_log2, warp, lane);
        rescale_pack(o, alpha, s, pa);
        // step nxt's S = Q.K^T and step cur's O += P.V are issued together;
        // the softmax of nxt is written to run while P.V is in flight
        // (ptxas reuses P's registers for its temporaries and so waits for
        // P.V first: the other warpgroup fills the issue slots meanwhile)
        for (int nxt = next_step(cur + 1, b, n_tiles, q0, T, left, right); nxt < 6;
             nxt = next_step(nxt + 1, b, n_tiles, q0, T, left, right)) {
          fence_acc(o);
          wgmma_fence();
          issue_s(s, nxt);
          issue_pv(o, pa, cur);
          wgmma_wait<1>();
          fence_acc(s);
          softmax_step(s, m, lsum, alpha, key0(nxt), q0, T, left, right, scale_log2, warp,
                       lane);
          fence_acc(s);
          fence_acc<2>(lsum);
          fence_acc<2>(alpha);
          wgmma_wait<0>();
          fence_acc(o);
          rescale_pack(o, alpha, s, pa);
          cur = nxt;
        }
        fence_acc(o);
        wgmma_fence();
        issue_pv(o, pa, cur);
        wgmma_wait<0>();
        fence_acc(o);
      }
      // this tile's reads of Q and of K/V tile b - 1 are done (and of tile b
      // on the pair's last tile)
      if (lane == 0) {
        mbar_arrive(q_bar(kEmpty, q.slot()));
        if (b >= 1) mbar_arrive(kv_bar(kEmpty, kv.slot(b - 1)));
        if (b == n_tiles - 1) mbar_arrive(kv_bar(kEmpty, kv.slot(b)));
      }

      // epilogue: o = O * (1 / l), to the staging buffer, then one TMA store
      if (wtid == 0) bulk_wait_read();
      named_bar(1 + g, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = lsum[i];
        l = __fadd_rn(l, __shfl_xor_sync(0xffffffff, l, 1));
        l = __fadd_rn(l, __shfl_xor_sync(0xffffffff, l, 2));
        const float inv = __frcp_rn(l);
        const int r = 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t v = pack_bf16(__fmul_rn(o[4 * j + 2 * i], inv),
                                       __fmul_rn(o[4 * j + 2 * i + 1], inv));
          *reinterpret_cast<uint32_t*>(o_stage_g + r * 128 + ((j ^ (r & 7)) << 4) +
                                       4 * quad) = v;
        }
      }
      fence_async_smem();
      named_bar(1 + g, 128);
      if (wtid == 0 && q0 < T) tma_store_3d(&map_o, o_stage, h * kD, q0, n);
    }
    kv.i += n_tiles;
  }
  if (wtid == 0) bulk_wait_all();
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

// a map over `rank` dims of [.., rows, width] elements, boxes of box[0] x
// box[1] (x 1); out-of-bounds elements read 0 and are not written
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
              int rank, const cuuint64_t* dims, const cuuint32_t* box,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t strides[2];
  strides[0] = dims[0] * elem_bytes;
  if (rank == 3) strides[1] = strides[0] * dims[1];
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

}  // namespace

extern "C" {

// out [N, T, H * 64] = the windowed attention of qkv [N, T, 3, H, 64] with
// the rotary table cos, sin [T, 32]; rot (optional) [N, T, 2, H, 64] gets
// the rotated q and k.  First makes `device` (the tensors' CUDA ordinal)
// current for the calling thread: this library links nvcc's static CUDA
// runtime, whose current device is its own, not torch's.  Returns a
// cudaError_t (0 = launched); the caller raises on anything else.
int radian_tx_attention(const void* qkv, const void* cos_t, const void* sin_t, void* out,
                        void* rot, int N, int T, int H, int left, int right,
                        float scale_log2, int device, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  if (H <= 0 || left < 0 || right < 0 || left > kTile || right > kTile ||
      static_cast<long long>(N) * H > 0x7fffffff || 3LL * H * kD > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (const cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return e;
  const cuuint64_t t = static_cast<cuuint64_t>(T), n = static_cast<cuuint64_t>(N);
  const cuuint64_t qkv_dims[3] = {3ull * H * kD, t, n}, o_dims[3] = {1ull * H * kD, t, n};
  const cuuint64_t tab_dims[2] = {kD / 2, t};
  const cuuint32_t tile_box[3] = {kD, kTile, 1}, step_box[3] = {kD, kStep, 1};
  const cuuint32_t tab_box[2] = {kD / 2, kTile};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mq, mo, mc, ms;
  if (!make_map(&mq, bf, 2, qkv, 3, qkv_dims, tile_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mo, bf, 2, out, 3, o_dims, step_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mc, f32, 4, cos_t, 2, tab_dims, tab_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&ms, f32, 4, sin_t, 2, tab_dims, tab_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  // the kernel's shared-memory attribute, once a device
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        tx_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  const int pairs = N * H;
  // persistent: one block an SM, each walking over (chunk, head) pairs
  const int grid = pairs < sms ? pairs : sms;
  tx_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mo, mc, ms, static_cast<bf16*>(rot), N, T, H, left, right, scale_log2);
  return cudaGetLastError();
}

const char* radian_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
