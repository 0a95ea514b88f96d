// Host CTC prefix beam search with k-mer LM fusion, OpenMP across reads
// (the port's copy of radian_tpu/native/beamsearch.cc).
//
// The reference's decoder is a pure-python dict-based loop (reference
// radian/decode.py:100-211).  This engine reproduces those semantics in
// C++ on the host, in double precision:
//
// - labelings live in a prefix-trie arena (node = parent + last base), so
//   beam-merge equality (EXTEND(b1,c) vs COPY(b2)) compares node chains --
//   exact, no hashing;
// - per timestep: COPY + 4 EXTEND candidates per beam, logaddexp merges,
//   insertion-order-stable top-W pruning (matching python's stable sort
//   over dict insertion order);
// - LM fusion gated on LM entropy < r_threshold AND signal entropy >
//   s_threshold, fused distribution ((lm + s4/Σs4)/2)·Σs4 (reference
//   decode.py:52-96), dense [4^ctx, 4] prob table + [4^ctx] entropies.
//
// Exposed via a C ABI consumed with ctypes
// (radian_tpu_torch/ops/beam_native.py); built by radian_tpu_torch/_build.py
// with -fopenmp.  No pipeline path uses it: the card decodes with
// csrc/beam_search.cu and csrc/beam_search_lm.cu.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NBASE = 4;
constexpr double kNegInf = -1e300;

double logaddexp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double mx = a > b ? a : b;
  return mx + std::log1p(std::exp(-std::fabs(a - b)));
}

double safe_log(double x) { return x > 0 ? std::log(x) : kNegInf; }

struct Node {  // labeling arena entry
  int32_t parent;
  int8_t base;
  int32_t length;
};

struct Beam {
  int32_t node;  // -1 = empty labeling
  double pr_b, pr_nb, pr_t;
  int32_t slot;  // insertion-order position for tie-stable sorting
};

struct Candidate {
  int32_t node;
  double pr_b, pr_nb, pr_t;
  bool used;
  bool is_ext;
};

// exact labeling equality: same string, possibly distinct node chains
// (the same labeling can be re-derived later through different parents);
// identical node ids short-circuit immediately
bool chains_equal(const std::vector<Node>& arena, int32_t a, int32_t b) {
  while (a != b) {
    if (a < 0 || b < 0) return false;
    const Node& na = arena[a];
    const Node& nb = arena[b];
    if (na.base != nb.base || na.length != nb.length) return false;
    a = na.parent;
    b = nb.parent;
  }
  return true;
}

// context = last ctx_len bases (exclude_last drops the newest)
uint64_t context_of(const std::vector<Node>& arena, int32_t node, int ctx_len,
                    bool exclude_last, bool* ok) {
  if (exclude_last && node >= 0) node = arena[node].parent;
  // need at least ctx_len bases
  int have = node >= 0 ? arena[node].length : 0;
  if (have < ctx_len) {
    *ok = false;
    return 0;
  }
  *ok = true;
  uint64_t v = 0;
  uint64_t mult = 1;
  int32_t cur = node;
  for (int i = 0; i < ctx_len; i++) {
    v += uint64_t(arena[cur].base) * mult;
    mult *= NBASE;
    cur = arena[cur].parent;
  }
  return v;
}

void decode_one(const float* mat, long t_len, int beam_width,
                const float* lm_probs, const float* lm_ent, int ctx_len,
                double s_thr, double r_thr, int8_t* out_rev, long* out_len,
                double* out_score) {
  std::vector<Node> arena;
  arena.reserve(4096);

  std::vector<Beam> beams;
  beams.push_back({-1, 0.0, kNegInf, 0.0, 0});

  std::vector<Candidate> cands;
  std::vector<double> s_entropies(t_len);
  for (long t = 0; t < t_len; t++) {
    const float* row = mat + t * 5;
    double s = 0;
    for (int c = 0; c < NBASE; c++) s += row[c];
    double ent = 0;
    if (s > 0) {
      for (int c = 0; c < NBASE; c++) {
        double p = row[c] / s;
        if (p > 0) ent -= p * std::log(p);
      }
    }
    s_entropies[t] = ent;
  }

  const bool lm_on = lm_probs != nullptr;
  double fused[NBASE];

  auto lm_dist = [&](const float* row, uint64_t ctx, double s_ent) -> const double* {
    // fused base distribution, or nullptr meaning "use raw row"
    double r_entropy = lm_ent[ctx];
    if (!(r_entropy < r_thr && s_ent > s_thr)) return nullptr;
    double s_base = 0;
    for (int c = 0; c < NBASE; c++) s_base += row[c];
    if (s_base <= 0) return nullptr;
    const float* r = lm_probs + ctx * NBASE;
    for (int c = 0; c < NBASE; c++) {
      fused[c] = (double(r[c]) + double(row[c]) / s_base) * 0.5 * s_base;
    }
    return fused;
  };

  for (long t = 0; t < t_len; t++) {
    const float* row = mat + t * 5;
    double blank_lp = safe_log(row[NBASE]);
    cands.clear();
    size_t n_beams = beams.size();
    // pass 1 — push all candidates unmerged, insertion order:
    // copy(b), ext(b, 0..3) per beam (slot of copy(b) = 5b)
    for (size_t b = 0; b < n_beams; b++) {
      Beam& bm = beams[b];
      // COPY
      double pr_nb = kNegInf;
      if (bm.node >= 0) {
        const double* dist = nullptr;
        if (lm_on) {
          bool ok;
          uint64_t ctx = context_of(arena, bm.node, ctx_len, true, &ok);
          if (ok) dist = lm_dist(row, ctx, s_entropies[t]);
        }
        double p = dist ? dist[arena[bm.node].base]
                        : double(row[arena[bm.node].base]);
        pr_nb = bm.pr_nb + safe_log(p);
      }
      double pr_b = bm.pr_t + blank_lp;
      cands.push_back(
          {bm.node, pr_b, pr_nb, logaddexp(pr_b, pr_nb), true, false});

      // EXTEND
      const double* dist = nullptr;
      if (lm_on) {
        bool ok;
        uint64_t ctx = context_of(arena, bm.node, ctx_len, false, &ok);
        if (ok) dist = lm_dist(row, ctx, s_entropies[t]);
      }
      for (int c = 0; c < NBASE; c++) {
        double p = dist ? dist[c] : double(row[c]);
        double base_lp =
            (bm.node >= 0 && arena[bm.node].base == c) ? bm.pr_b : bm.pr_t;
        double pr_nb_e = base_lp + safe_log(p);
        int32_t node = int32_t(arena.size());
        arena.push_back({bm.node, int8_t(c),
                         bm.node >= 0 ? arena[bm.node].length + 1 : 1});
        cands.push_back({node, kNegInf, pr_nb_e, pr_nb_e, true, true});
      }
    }
    // pass 2 — merge EXTEND(b1, c) into COPY(b2) where the labelings are
    // equal (beams hold distinct labelings, so this is the only merge
    // shape); the earlier slot keeps the mass
    for (size_t e = 0; e < cands.size(); e++) {
      if (!cands[e].is_ext) continue;
      for (size_t b2 = 0; b2 < n_beams; b2++) {
        int32_t n2 = beams[b2].node;
        if (n2 < 0 || !chains_equal(arena, n2, cands[e].node)) continue;
        size_t s2 = b2 * 5;
        if (s2 < e) {  // copy slot earlier: absorbs the extend
          cands[s2].pr_nb = logaddexp(cands[s2].pr_nb, cands[e].pr_nb);
          cands[s2].pr_t = logaddexp(cands[s2].pr_t, cands[e].pr_nb);
          cands[e].used = false;
          cands[e].pr_t = kNegInf;
        } else {  // extend slot earlier: absorbs the copy
          cands[e].pr_b = cands[s2].pr_b;
          double nb_e = cands[e].pr_nb;
          cands[e].pr_nb = logaddexp(nb_e, cands[s2].pr_nb);
          cands[e].pr_t = logaddexp(cands[s2].pr_t, nb_e);
          cands[e].node = n2;
          cands[s2].used = false;
          cands[s2].pr_t = kNegInf;
        }
        break;
      }
    }
    // stable top-W by pr_t (slot order breaks ties)
    std::vector<int> order(cands.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = int(i);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return cands[a].pr_t > cands[b].pr_t;
    });
    beams.clear();
    for (size_t i = 0; i < order.size() && beams.size() < size_t(beam_width);
         i++) {
      Candidate& c = cands[order[i]];
      if (!c.used) continue;
      beams.push_back({c.node, c.pr_b, c.pr_nb, c.pr_t,
                       int32_t(beams.size())});
    }
    if (beams.empty()) beams.push_back({-1, 0.0, kNegInf, 0.0, 0});
  }

  // best beam = first (sorted); emit bases reversed (5'->3')
  int32_t node = beams[0].node;
  long n = 0;
  while (node >= 0) {
    out_rev[n++] = arena[node].base;
    node = arena[node].parent;
  }
  *out_len = n;
  *out_score = beams[0].pr_t;
}

}  // namespace

extern "C" {

// mats: [n, t, 5] float32; lengths: [n]; out_rev: [n, t] int8 (reversed
// labels); out_lens: [n]; out_scores: [n].  lm_probs/lm_ent may be null.
void BeamSearchBatch(const float* mats, long n, long t, const int* lengths,
                     int beam_width, const float* lm_probs,
                     const float* lm_ent, int ctx_len, double s_thr,
                     double r_thr, int8_t* out_rev, long* out_lens,
                     double* out_scores) {
#pragma omp parallel for schedule(dynamic)
  for (long i = 0; i < n; i++) {
    decode_one(mats + i * t * 5, lengths[i], beam_width, lm_probs, lm_ent,
               ctx_len, s_thr, r_thr, out_rev + i * t, &out_lens[i],
               &out_scores[i]);
  }
}

}  // extern "C"
