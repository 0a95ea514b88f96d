// One step of the warp-per-read CTC prefix beam search, shared by the
// decode kernels in beam_search.cu (no LM) and beam_search_lm.cu (LM
// fusion).  A warp decodes one read; lane w < W owns beam w.  Given each
// lane's beam and the class log-probs it scores its candidates with, a
// step builds the COPY + 4 EXTEND candidates, merges EXTEND(b1,c)/COPY(b2)
// pairs with equal labelings, ranks the 5W candidates and leaves in
// s.pick[k] the slot that becomes beam k; gather_beam then moves lane k
// to it.  The design notes are in beam_search.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radian {

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

// A lane's beam; lanes >= W hold an invalid one.
struct Beam {
  float pb, pnb, pt;
  int last, len;
  uint32_t h1, h2;
};

__device__ __forceinline__ Beam initial_beam(int lane) {
  return Beam{lane == 0 ? 0.0f : kNeg, kNeg, lane == 0 ? 0.0f : kNeg, -1, 0, 1u, 1u};
}

// Work a kernel runs on all lanes inside the step, beside its own: mid()
// once the merge detection is done, land() before the __syncwarp that
// ends the step (so what land() stores is visible to the gather).  The
// no-LM kernel runs none.
struct NoHooks {
  __device__ __forceinline__ void mid() const {}
  __device__ __forceinline__ void land() const {}
};

// Candidates, merges and ranking for one step.  `lpc[c]` scores the COPY
// of a labeling ending in base c, `lpe[c]` the EXTEND by base c (both
// log(m[c]) without an LM), `lp_blank` the blank.  `publish()` runs on
// owner lanes while the step's records are written, before the __syncwarp
// that precedes the ranking: a kernel writes there the extra per-beam
// records its gather reads.  On return s.pick is complete.
template <int W, typename Publish, typename Hooks = NoHooks>
__device__ __forceinline__ void search_step(WarpScratch& s, int lane, const Beam& bm,
                                            const float (&lpc)[4], const float (&lpe)[4],
                                            float lp_blank, Publish publish,
                                            const Hooks& hooks = Hooks{}) {
  constexpr int kSlots = 5 * W;
  constexpr int kPerLane = (kSlots + 31) / 32;  // slots a lane ranks
  const bool owner = lane < W;
  const float pb = bm.pb, pnb = bm.pnb, pt = bm.pt;
  const int last = bm.last, len = bm.len;
  const uint32_t h1 = bm.h1, h2 = bm.h2;

  // own candidates: COPY and the four EXTENDs of beam `lane`
  const bool valid = pt > kNegHalf;
  const float sel = last == 0 ? lpc[0] : last == 1 ? lpc[1]
                  : last == 2 ? lpc[2] : last == 3 ? lpc[3] : 0.0f;
  const float cnb = len > 0 ? pnb + sel : kNeg;
  const float cb = pt + lp_blank;
  const float ct = logaddexp(cb, cnb);
  float enb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) enb[c] = (last == c ? pb : pt) + lpe[c];
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
  hooks.mid();

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
    publish();
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
  hooks.land();
  __syncwarp();
}

// Owner lane k takes the slot of rank k: its new beam and the step's
// backpointer.  Returns the slot (5 * parent + column; column 0 = copy,
// 1 + base = extend) for kernels that gather more per-beam state.
template <int W>
__device__ __forceinline__ int gather_beam(WarpScratch& s, int lane, int tt, Beam& bm) {
  const int slot = s.pick[lane];
  const int parent = slot / 5;
  const int j = slot - 5 * parent;
  const int4 st = s.state[parent];
  const bool ext = j > 0;
  bm.pb = s.cand_b[parent][j];
  bm.pnb = s.cand_nb[parent][j];
  bm.pt = s.cand_t[parent][j];
  bm.last = ext ? j - 1 : st.w;
  bm.len = st.x + (ext ? 1 : 0);
  bm.h1 = ext ? static_cast<uint32_t>(st.y) * kH1Mult + static_cast<uint32_t>(j)
              : static_cast<uint32_t>(st.y);
  bm.h2 = ext ? static_cast<uint32_t>(st.z) * kH2Mult + static_cast<uint32_t>(j)
              : static_cast<uint32_t>(st.z);
  s.bp[tt * W + lane] = static_cast<int8_t>(parent * 8 + j);
  return slot;
}

// Flush a tile's backpointers to bp_read (a read's [T, W] rows): the live
// steps from s.bp, identity pointers (w * 8) past the read's length.
template <int W>
__device__ __forceinline__ void flush_bp(const WarpScratch& s, int lane, int8_t* bp_read,
                                         int t0, int nt, int ns) {
  int8_t* dst = bp_read + static_cast<size_t>(t0) * W;
  for (int i = lane; i < nt * W; i += 32) {
    const int tt = i / W;
    dst[i] = tt < ns ? s.bp[i] : static_cast<int8_t>((i - tt * W) * 8);
  }
}

}  // namespace radian
