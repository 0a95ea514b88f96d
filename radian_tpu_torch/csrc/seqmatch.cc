// Longest-matching-block of python difflib.SequenceMatcher(None, a, b),
// exact semantics, and the chunk-mode consensus built on it — the host
// stitcher of radian_tpu_torch/ops/consensus.py, whose behavior is pinned
// to the reference's difflib call (reference
// radian/sequence_assembly.py:19-48).  Built with g++ by _build.py into
// _build/ at first use and loaded with ctypes.
//
// Replicates, from the documented stdlib algorithm:
//  - b2j occurrence lists over b
//  - autojunk: for len(b) >= 200, elements occurring more than
//    1 + len(b)//100 times are "popular" and dropped from b2j (with a
//    4-letter alphabet this empties b2j for long fragments — the
//    degenerate behavior is preserved on purpose)
//  - find_longest_match's dynamic-programming scan with its
//    earliest-in-a-then-earliest-in-b tie rule, followed by the
//    extension passes (bjunk is EMPTY under isjunk=None — popular
//    elements are pruned from b2j only, never treated as junk)
//  - get_matching_blocks' queue recursion, sort, and adjacent-block
//    merge
//  - the caller's max(blocks, key=size) = first maximal block in
//    sorted order
//
// Exactness is checked against difflib (ops/consensus.py's plain path)
// in tests/test_torch_consensus.py.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Block {
  long a, b, size;
};

struct Matcher {
  const uint8_t* a;
  const uint8_t* b;
  long la, lb;
  std::vector<std::vector<long>> b2j;  // per byte value, positions in b
  bool popular[256] = {false};

  Matcher(const uint8_t* a_, long la_, const uint8_t* b_, long lb_)
      : a(a_), b(b_), la(la_), lb(lb_), b2j(256) {
    for (long j = 0; j < lb; ++j) b2j[b[j]].push_back(j);
    if (lb >= 200) {
      long ntest = lb / 100 + 1;
      for (int v = 0; v < 256; ++v) {
        if (!b2j[v].empty() && (long)b2j[v].size() > ntest) {
          popular[v] = true;
          b2j[v].clear();
        }
      }
    }
  }

  // With isjunk=None (the reference's call), stdlib's bjunk set is EMPTY:
  // autojunk "popular" elements land in bpopular and are only pruned from
  // b2j — they are NOT junk for the extension passes.  popular[] above is
  // therefore used solely for the b2j pruning in the constructor.

  Block find(long alo, long ahi, long blo, long bhi) const {
    long besti = alo, bestj = blo, bestsize = 0;
    // j2len over b positions; rolling rows like the dict version
    std::vector<long> j2len(lb, 0), newj2len(lb, 0);
    for (long i = alo; i < ahi; ++i) {
      std::fill(newj2len.begin(), newj2len.end(), 0);
      for (long j : b2j[a[i]]) {
        if (j < blo) continue;
        if (j >= bhi) break;
        long k = (j > 0 ? j2len[j - 1] : 0) + 1;
        newj2len[j] = k;
        if (k > bestsize) {
          besti = i - k + 1;
          bestj = j - k + 1;
          bestsize = k;
        }
      }
      std::swap(j2len, newj2len);
    }
    // extend over adjacent equal elements (bjunk is empty — one backward
    // and one forward pass cover both of stdlib's extension phases)
    while (besti > alo && bestj > blo && a[besti - 1] == b[bestj - 1]) {
      --besti; --bestj; ++bestsize;
    }
    while (besti + bestsize < ahi && bestj + bestsize < bhi &&
           a[besti + bestsize] == b[bestj + bestsize]) {
      ++bestsize;
    }
    return {besti, bestj, bestsize};
  }

  std::vector<Block> matching_blocks() const {
    std::vector<std::array<long, 4>> queue{{0, la, 0, lb}};
    std::vector<Block> blocks;
    while (!queue.empty()) {
      auto [alo, ahi, blo, bhi] = queue.back();
      queue.pop_back();
      Block m = find(alo, ahi, blo, bhi);
      if (m.size) {
        blocks.push_back(m);
        if (alo < m.a && blo < m.b)
          queue.push_back({alo, m.a, blo, m.b});
        if (m.a + m.size < ahi && m.b + m.size < bhi)
          queue.push_back({m.a + m.size, ahi, m.b + m.size, bhi});
      }
    }
    std::sort(blocks.begin(), blocks.end(), [](const Block& x, const Block& y) {
      if (x.a != y.a) return x.a < y.a;
      if (x.b != y.b) return x.b < y.b;
      return x.size < y.size;
    });
    // merge adjacent blocks (difflib get_matching_blocks tail pass)
    std::vector<Block> merged;
    long i1 = 0, j1 = 0, k1 = 0;
    for (const Block& m : blocks) {
      if (i1 + k1 == m.a && j1 + k1 == m.b) {
        k1 += m.size;
      } else {
        if (k1) merged.push_back({i1, j1, k1});
        i1 = m.a; j1 = m.b; k1 = m.size;
      }
    }
    if (k1) merged.push_back({i1, j1, k1});
    merged.push_back({la, lb, 0});  // terminator, as difflib emits
    return merged;
  }
};

}  // namespace

namespace {

Block longest_block(const uint8_t* a, long la, const uint8_t* b, long lb) {
  Matcher m(a, la, b, lb);
  auto blocks = m.matching_blocks();
  const Block* best = &blocks[0];
  for (const Block& blk : blocks)
    if (blk.size > best->size) best = &blk;
  return *best;
}

}  // namespace

extern "C" {

// Longest matching block of SequenceMatcher(None, a, b): out = {a_start,
// b_start, size} of the first maximal-size entry of get_matching_blocks().
void LongestBlock(const uint8_t* a, long la, const uint8_t* b, long lb,
                  long* out) {
  Block best = longest_block(a, la, b, lb);
  out[0] = best.a;
  out[1] = best.b;
  out[2] = best.size;
}

// Full chunk-mode consensus: the entire simple_assembly + index2base
// chain (reference radian/sequence_assembly.py:19-48,90-97) in one call —
// the per-pair python/ctypes round trips and the per-character vote loop
// cost ~8 ms/read at ~110 fragments (measured round 4); this runs the
// whole stitch in ~sub-ms.  Exact semantics as ops/consensus.py's
// simple_assembly (the plain version it is tested against):
//  - fragment 0 votes at position 0 but never extends `length`
//    (single-fragment reads assemble empty — reference quirk preserved)
//  - displacement = longest_block(prev, cur).a - .b
//  - votes below position 0 are trimmed; counts grow on demand
//  - consensus = per-position argmax, ties -> lowest base index
//
// `data`: concatenated fragment bytes (values 0..3 = A,C,G,T);
// `offsets`: n_frags+1 prefix offsets into data; `out`: caller buffer of
// at least (total bytes + longest fragment) — consensus length returned.
long AssembleFragments(const uint8_t* data, const long* offsets,
                       long n_frags, uint8_t* out) {
  if (n_frags <= 0) return 0;
  std::vector<std::array<long, 4>> counts;
  counts.reserve(offsets[n_frags] - offsets[0] + 1024);
  auto vote = [&counts](long start, const uint8_t* frag, long len) {
    if (start < 0) {
      frag += -start;
      len -= -start;
      start = 0;
      if (len <= 0) return;
    }
    if ((long)counts.size() < start + len)
      counts.resize(start + len, {0, 0, 0, 0});
    for (long i = 0; i < len; ++i) ++counts[start + i][frag[i]];
  };
  long pos = 0, length = 0;
  vote(0, data + offsets[0], offsets[1] - offsets[0]);
  for (long i = 1; i < n_frags; ++i) {
    const uint8_t* prev = data + offsets[i - 1];
    long lprev = offsets[i] - offsets[i - 1];
    const uint8_t* cur = data + offsets[i];
    long lcur = offsets[i + 1] - offsets[i];
    Block blk = longest_block(prev, lprev, cur, lcur);
    long disp = blk.a - blk.b;
    vote(pos + disp, cur, lcur);
    pos += disp;
    length = std::max(length, pos + lcur);
  }
  // `length` can pass the last voted column (e.g. an empty fragment
  // advances pos without voting); python argmaxes the zero columns to
  // base 0 ('A') — match by zero-extending.
  if ((long)counts.size() < length) counts.resize(length, {0, 0, 0, 0});
  for (long j = 0; j < length; ++j) {
    int best = 0;
    for (int v = 1; v < 4; ++v)
      if (counts[j][v] > counts[j][best]) best = v;
    out[j] = (uint8_t)best;
  }
  return length;
}

// Whole-read chunk consensus straight from compacted nibble-packed label
// rows (ops/beam_search.py pack_labels of front-compacted emissions):
// byte j of a window row holds labels 2j (low nibble) and 2j+1 (high),
// each stored as label+1 with 0 = the -1 padding that only appears after
// the last emission.  Renders each window's fragment (decoder order =
// reversed emission order, see rows_to_seqs) and runs AssembleFragments'
// consensus loop — one native call per read.
long AssembleRead(const uint8_t* packed, long n_wins, long bytes_per_win,
                  uint8_t* out) {
  if (n_wins <= 0) return 0;
  long max_lab = bytes_per_win * 2;
  std::vector<uint8_t> frags(n_wins * max_lab);
  std::vector<long> offsets(n_wins + 1, 0);
  long total = 0;
  std::vector<uint8_t> tmp(max_lab);
  for (long w = 0; w < n_wins; ++w) {
    const uint8_t* row = packed + w * bytes_per_win;
    long m = 0;
    for (long j = 0; j < bytes_per_win; ++j) {
      uint8_t lo = row[j] & 15, hi = row[j] >> 4;
      if (!lo) break;
      tmp[m++] = lo - 1;
      if (!hi) break;
      tmp[m++] = hi - 1;
    }
    for (long i = 0; i < m; ++i) frags[total + i] = tmp[m - 1 - i];
    total += m;
    offsets[w + 1] = total;
  }
  return AssembleFragments(frags.data(), offsets.data(), n_wins, out);
}

// Whole-read chunk consensus straight from the device's compacted
// 2-bit-packed label rows (ops/beam_search.py pack_labels2 of
// front-compacted emissions): labels 0..3 four per byte, lowest bits
// first, plus each window's emission count n_lab.  Renders each window's
// fragment (decoder order = reversed emission order, see rows_to_seqs)
// and runs AssembleFragments' consensus loop — one native call per read,
// no python string fragments at all.
long AssembleRead2(const uint8_t* packed, const int32_t* n_lab,
                   long n_wins, long bytes_per_win, uint8_t* out) {
  if (n_wins <= 0) return 0;
  long max_lab = bytes_per_win * 4;
  std::vector<uint8_t> frags(n_wins * max_lab);
  std::vector<long> offsets(n_wins + 1, 0);
  long total = 0;
  for (long w = 0; w < n_wins; ++w) {
    const uint8_t* row = packed + w * bytes_per_win;
    long m = n_lab[w];
    if (m < 0) m = 0;
    if (m > max_lab) m = max_lab;
    // fragment = reversed emission order
    for (long i = 0; i < m; ++i) {
      long j = m - 1 - i;
      frags[total + i] = (row[j >> 2] >> ((j & 3) * 2)) & 3;
    }
    total += m;
    offsets[w + 1] = total;
  }
  return AssembleFragments(frags.data(), offsets.data(), n_wins, out);
}

}  // extern "C"
