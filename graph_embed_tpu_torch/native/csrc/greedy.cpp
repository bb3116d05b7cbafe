// One-sided greedy coarsener -- the partitionBase / partitionBase2
// semantics of the reference benchmark harness (src/partitioner.cpp:
// 436-694, :696-966), reimplemented as a host-native backend.
//
// This algorithm is inherently sequential (the commit pass walks the
// ``used`` array in its swap-erase-permuted order and each commit blocks
// both endpoints for the rest of the round, :563-592), which is exactly why
// the production device coarsener uses the order-independent mutual rule
// instead (SURVEY.md SS7 hard part #2).  It exists so the quality harness
// can run the reference's own A/B (run-tests.cpp:199,285-300): greedy
// one-sided vs mutual matching, modularity and wall-clock.
//
// Arithmetic is float (the reference's partitionBase uses float
// accumulators, :441-455) and the build uses -ffp-contract=off, so results
// are bit-identical to the pure-Python transcription
// (partition/greedy.py::greedy_partition_py) -- tested in
// tests/test_partition.py.
//
// variant 0 ('base'):  commit only while scanning the smaller id (i < j,
//                      :570); neighbors scanned in sorted order (std::map).
// variant 1 ('base2'): no i<j gate (:836-858) -- commit at whichever
//                      endpoint the used order reaches first.  (The
//                      reference's parallel-array neighbor order is a cache
//                      layout A/B, not a semantic choice; we keep sorted
//                      order.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Nbr {
  int32_t j;
  float w;
};

inline std::vector<Nbr>::iterator find_nbr(std::vector<Nbr>& v, int32_t j) {
  return std::lower_bound(
      v.begin(), v.end(), j,
      [](const Nbr& a, int32_t b) { return a.j < b; });
}

}  // namespace

extern "C" int64_t ge_greedy_run(int64_t n, int64_t e, const int32_t* S,
                                 const int32_t* R, const void* W, int is_f64,
                                 double stall, int variant,
                                 int32_t* assign_out, double* q_out) {
  if (n <= 0) return 0;
  const float NEG_INF = -std::numeric_limits<float>::infinity();

  // ---- CSR bucketing + per-row sort by column (the reference reads a
  // sorted-CSR linalgcpp matrix; accumulation order must match)
  std::vector<int64_t> rowptr(n + 1, 0);
  for (int64_t k = 0; k < e; k++) rowptr[S[k] + 1]++;
  for (int64_t i = 0; i < n; i++) rowptr[i + 1] += rowptr[i];
  std::vector<std::vector<Nbr>> a(n);
  std::vector<float> alpha(n, 0.0f);
  float T = 0.0f, d_sum = 0.0f;
  {
    std::vector<std::vector<Nbr>> rows(n);
    for (int64_t i = 0; i < n; i++)
      rows[i].reserve(rowptr[i + 1] - rowptr[i]);
    for (int64_t k = 0; k < e; k++) {
      float w = is_f64 ? (float)((const double*)W)[k]
                       : ((const float*)W)[k];
      rows[S[k]].push_back({R[k], w});
    }
    for (int64_t i = 0; i < n; i++) {
      std::sort(rows[i].begin(), rows[i].end(),
                [](const Nbr& x, const Nbr& y) { return x.j < y.j; });
      float alpha_i = 0.0f;
      a[i].reserve(rows[i].size());
      for (const Nbr& nb : rows[i]) {
        if (nb.j != (int32_t)i) {
          a[i].push_back(nb);
        } else {
          d_sum += nb.w;
        }
        alpha_i += nb.w;
        T += nb.w;
      }
      alpha[i] = alpha_i;
    }
  }
  for (int64_t i = 0; i < n; i++) alpha[i] /= T;
  float Q = d_sum / T;
  for (int64_t i = 0; i < n; i++) Q -= alpha[i] * alpha[i];

  std::vector<float> max_eta(n, NEG_INF);
  std::vector<int64_t> max_ind(n, -1);
  std::vector<char> notouch(n, 0);
  std::vector<int64_t> used(n), pointer(n), id(n);
  for (int64_t i = 0; i < n; i++) {
    used[i] = i;
    pointer[i] = i;
    id[i] = i;
  }
  int64_t M = n;

  std::vector<std::pair<int64_t, int64_t>> merged;
  while (true) {
    // ---- match-find: every live vertex rescans its sorted neighbors
    // (partitioner.cpp:537-560; all live vertices recompute each round)
    for (int64_t x = 0; x < (int64_t)used.size(); x++) {
      int64_t i = used[x];
      float best = NEG_INF;
      int64_t best_j = -1;
      float ai = alpha[i];
      for (const Nbr& nb : a[i]) {
        float eta = 2.0f * (nb.w / T - ai * alpha[nb.j]);
        if (eta > best) {
          best = eta;
          best_j = nb.j;
        }
      }
      max_eta[i] = best;
      max_ind[i] = best_j;
    }
    // ---- sequential one-sided commit in used order (:563-592)
    merged.clear();
    float dq_round = 0.0f;
    for (int64_t x = 0; x < (int64_t)used.size(); x++) {
      int64_t i = used[x];
      if (notouch[i]) continue;
      int64_t j = max_ind[i];
      if (j == -1 || notouch[j]) continue;
      if (!(max_eta[i] >= max_eta[j])) continue;
      if (!(max_eta[i] > 0.0f)) continue;
      if (variant == 0 && !(i < j)) continue;
      int64_t i_p, j_p;
      if (a[i].size() < a[j].size()) {
        i_p = j;
        j_p = i;
      } else {
        i_p = i;
        j_p = j;
      }
      merged.emplace_back(i_p, j_p);
      notouch[i] = 1;
      notouch[j] = 1;
      dq_round += max_eta[i];
    }
    // ---- contraction: fold j' into i' (:596-616)
    for (const auto& pr : merged) {
      int64_t i_p = pr.first, j_p = pr.second;
      for (const Nbr& nb : a[j_p]) {
        int64_t k = nb.j;
        auto itk = find_nbr(a[k], (int32_t)j_p);
        a[k].erase(itk);
        if (k == i_p) {
          alpha[i_p] += alpha[j_p];
        } else {
          auto iti = find_nbr(a[i_p], (int32_t)k);
          if (iti != a[i_p].end() && iti->j == (int32_t)k)
            iti->w += nb.w;
          else
            a[i_p].insert(iti, {(int32_t)k, nb.w});
          auto itr = find_nbr(a[k], (int32_t)i_p);
          if (itr != a[k].end() && itr->j == (int32_t)i_p)
            itr->w += nb.w;
          else
            a[k].insert(itr, {(int32_t)i_p, nb.w});
        }
      }
      std::vector<Nbr>().swap(a[j_p]);
    }
    // ---- Q, swap-erase compaction, union-find link (:630-652)
    Q += dq_round;
    int64_t M_prev = M;
    for (const auto& pr : merged) {
      int64_t i_p = pr.first, j_p = pr.second;
      int64_t idx = pointer[j_p];
      int64_t klast = used.back();
      std::swap(used[idx], used.back());
      used.pop_back();
      pointer[klast] = idx;
      id[j_p] = i_p;
      notouch[i_p] = 0;
    }
    M -= (int64_t)merged.size();
    if ((double)M / (double)M_prev >= stall) break;
  }

  // ---- union-find flatten; aggregate index = position in final used
  for (int64_t v = 0; v < n; v++) {
    int64_t root = v;
    while (id[root] != root) root = id[root];
    int64_t i = v;
    while (id[i] != root) {
      int64_t nxt = id[i];
      id[i] = root;
      i = nxt;
    }
    assign_out[v] = (int32_t)pointer[root];
  }
  *q_out = (double)Q;
  return M;
}
