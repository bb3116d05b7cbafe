// Native ball-growing first-collision sweep (the radii computation of
// embedMultilevel -- /root/reference/src/embed.cpp:616-678 semantics as
// re-specified by embed/radii._sweep_host, whose Python heap this mirrors
// BIT-IDENTICALLY: pop the alive pair with minimal (tau, pair-index);
// assign unassigned endpoints tau; bump alive pairs touching newly-assigned
// vertices to 2*tau - tau_popped (each at most once per pop); lazy heap
// entries are revalidated against the current tau.
//
// The Python heap costs ~50s/Mpair (every pop and touch is interpreter
// work); hub grandparents at LiveJournal scale carry ~10^5 pairs each and a
// truncated-hierarchy top sweep can carry 2*10^7 -- this sweep runs those in
// seconds.  Single-threaded: the sweep is inherently sequential (each pop
// depends on all prior assignments); per-grandparent independence is the
// parallel axis and lives in the caller.
//
// Arithmetic: templated on float/double; the tau update is computed in T
// (T(2) * cur - tpop), matching numpy's dtype arithmetic, and heap
// comparisons order by the same T values, so results are bit-identical to
// the Python reference for both f32 and f64 candidate lists (pinned by
// tests/test_embed.py::test_native_sweep_matches_python).

#include <atomic>
#include <cstdint>
#include <functional>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

namespace {

template <typename T>
int64_t sweep_run(int64_t P, int64_t S, const T* tau0, const int32_t* pi,
                  const int32_t* pj, T* r) {
  for (int64_t v = 0; v < S; ++v) r[v] = T(0);
  if (P <= 0) return 0;
  std::vector<T> cur(tau0, tau0 + P);
  std::vector<uint8_t> alive(static_cast<size_t>(P), 1);
  std::vector<uint8_t> assigned(static_cast<size_t>(S), 0);

  // CSR of incident pairs per vertex: for vertex v, pairs where v is the
  // first endpoint (ascending k), then pairs where v is the second --
  // the order radii.py's stable argsort of concat(pi, pj) produces.
  std::vector<int64_t> starts(static_cast<size_t>(S) + 1, 0);
  for (int64_t k = 0; k < P; ++k) {
    ++starts[static_cast<size_t>(pi[k]) + 1];
    ++starts[static_cast<size_t>(pj[k]) + 1];
  }
  for (int64_t v = 0; v < S; ++v) starts[v + 1] += starts[v];
  std::vector<int64_t> inc(static_cast<size_t>(2) * P);
  {
    std::vector<int64_t> fill(starts.begin(), starts.end() - 1);
    for (int64_t k = 0; k < P; ++k) inc[fill[pi[k]]++] = k;
    for (int64_t k = 0; k < P; ++k) inc[fill[pj[k]]++] = k;
  }

  using Ent = std::pair<T, int64_t>;  // min by (tau, pair index)
  std::vector<Ent> init(static_cast<size_t>(P));
  for (int64_t k = 0; k < P; ++k) init[k] = {tau0[k], k};
  std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> heap(
      std::greater<Ent>(), std::move(init));

  // per-pop dedup of touched pairs (np.unique in the Python reference):
  // a pair incident to BOTH newly-assigned endpoints is bumped once
  std::vector<int64_t> stamp(static_cast<size_t>(P), -1);
  int64_t pop_id = 0;

  // vertices that can still RECEIVE a radius: unassigned with >= 1
  // incident pair.  Once zero, every remaining pop is a discard -- break
  // instead of draining the heap.  (Output-identical: discards never
  // touch r.)
  int64_t open = 0;
  for (int64_t v = 0; v < S; ++v)
    if (starts[v + 1] > starts[v]) ++open;

  while (!heap.empty() && open > 0) {
    const Ent top = heap.top();
    heap.pop();
    const int64_t k = top.second;
    if (!alive[k] || top.first != cur[k]) continue;  // stale lazy entry
    alive[k] = 0;
    const int32_t i = pi[k];
    const int32_t j = pj[k];
    const T tpop = cur[k];
    int32_t newly[2];
    int nv = 0;
    if (!assigned[i]) {
      r[i] = tpop;
      assigned[i] = 1;
      --open;
      newly[nv++] = i;
    }
    if (!assigned[j]) {
      r[j] = tpop;
      assigned[j] = 1;
      --open;
      newly[nv++] = j;
    }
    if (nv == 0) continue;
    ++pop_id;
    for (int a = 0; a < nv; ++a) {
      const int32_t v = newly[a];
      for (int64_t q = starts[v]; q < starts[v + 1]; ++q) {
        const int64_t kk = inc[q];
        if (stamp[kk] == pop_id) continue;
        stamp[kk] = pop_id;
        if (!alive[kk]) continue;
        // both endpoints assigned -> the pair can never assign anyone:
        // kill it instead of re-pushing (its future pop is a discard in
        // the Python reference -- outputs identical, ~2x fewer pushes)
        if (assigned[pi[kk]] && assigned[pj[kk]]) {
          alive[kk] = 0;
          continue;
        }
        cur[kk] = T(2) * cur[kk] - tpop;
        heap.push({cur[kk], kk});
      }
    }
  }
  return 0;
}

}  // namespace

namespace {

// Batched per-row sweeps: row b owns pairs [p_starts[b], p_starts[b+1])
// over the local vertex space [0, v_starts[b+1] - v_starts[b]), writing
// r[v_starts[b] : v_starts[b+1]].  Rows are the independent-parallel axis
// (per-grandparent sweeps in embed's radii, embed.cpp:685's OpenMP role);
// two worker threads chase an atomic row counter.
template <typename T>
int64_t sweep_batch(int64_t R, const int64_t* p_starts,
                    const int64_t* v_starts, const T* tau0,
                    const int32_t* pi, const int32_t* pj, T* r) {
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> bad{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= R) return;
      const int64_t p0 = p_starts[b];
      const int64_t v0 = v_starts[b];
      if (sweep_run<T>(p_starts[b + 1] - p0, v_starts[b + 1] - v0,
                       tau0 + p0, pi + p0, pj + p0, r + v0) != 0)
        bad.store(1);
    }
  };
  std::thread t2(worker);
  worker();
  t2.join();
  return bad.load();
}

}  // namespace

extern "C" {

int64_t ge_sweep_run_f32(int64_t P, int64_t S, const float* tau0,
                         const int32_t* pi, const int32_t* pj, float* r) {
  return sweep_run<float>(P, S, tau0, pi, pj, r);
}

int64_t ge_sweep_run_f64(int64_t P, int64_t S, const double* tau0,
                         const int32_t* pi, const int32_t* pj, double* r) {
  return sweep_run<double>(P, S, tau0, pi, pj, r);
}

int64_t ge_sweep_batch_f32(int64_t R, const int64_t* p_starts,
                           const int64_t* v_starts, const float* tau0,
                           const int32_t* pi, const int32_t* pj, float* r) {
  return sweep_batch<float>(R, p_starts, v_starts, tau0, pi, pj, r);
}

int64_t ge_sweep_batch_f64(int64_t R, const int64_t* p_starts,
                           const int64_t* v_starts, const double* tau0,
                           const int32_t* pi, const int32_t* pj, double* r) {
  return sweep_batch<double>(R, p_starts, v_starts, tau0, pi, pj, r);
}

}  // extern "C"
