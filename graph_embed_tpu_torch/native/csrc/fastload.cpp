// Native graph edge-list loader.
//
// Role: the framework's data-loading runtime piece (the reference links
// linalgcpp's C++ readers, e.g. ReadCooList used at examples/embed.cpp:81-91;
// here the equivalent is a standalone C++ parser exposed over a C ABI and
// bound with ctypes -- no pybind11 in the image).
//
// Parses whitespace-separated edge files ("i j" or "i j w" per line, '#'/'%'
// comments) with one pass per thread over disjoint byte ranges aligned to
// line boundaries.  Throughput target: memory-bandwidth-bound parsing for
// billion-edge files, far beyond numpy.loadtxt.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ChunkResult {
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
  std::vector<double> w;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out,
                             bool* ok) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = *p == '-';
    ++p;
  }
  int64_t v = 0;
  const char* start = p;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *ok = p != start;
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out,
                             bool* ok) {
  p = skip_ws(p, end);
  char* q = nullptr;
  // strtod needs NUL-terminated-ish input; the buffer is padded by caller
  *out = strtod(p, &q);
  *ok = q != p;
  return q ? q : p;
}

void parse_chunk(const char* base, size_t begin, size_t stop, size_t size,
                 int cols, ChunkResult* res) {
  const char* end = base + size;
  const char* p = base + begin;
  // advance to the start of the next full line unless at file start
  if (begin != 0) p = skip_line(p, end);
  const char* limit = base + stop;
  while (p < end && p <= limit) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (*p == '#' || *p == '%') {
      p = skip_line(p, end);
      continue;
    }
    int64_t a = 0, b = 0;
    double w = 1.0;
    bool ok1 = false, ok2 = false;
    p = parse_i64(p, end, &a, &ok1);
    p = parse_i64(p, end, &b, &ok2);
    if (cols >= 3) {
      bool ok3 = false;
      const char* p2 = parse_f64(p, end, &w, &ok3);
      if (ok3) p = p2; else w = 1.0;
    }
    if (ok1 && ok2) {
      res->src.push_back(a);
      res->dst.push_back(b);
      res->w.push_back(w);
    }
    p = skip_line(p, end);
  }
}

}  // namespace

extern "C" {

// Parses the file; returns number of edges, or -1 on error.  Caller then
// copies results out via fastload_fill and frees with fastload_free.
struct ParseState {
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
  std::vector<double> w;
};

void* fastload_parse(const char* path, int cols, int64_t* count_out) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    *count_out = -1;
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  // pad with NULs so strtod never runs off the end
  std::vector<char> buf(static_cast<size_t>(fsize) + 16, '\0');
  size_t got = fread(buf.data(), 1, static_cast<size_t>(fsize), f);
  fclose(f);
  if (got != static_cast<size_t>(fsize)) {
    *count_out = -1;
    return nullptr;
  }

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? hw : 4;
  if (static_cast<size_t>(fsize) < (1u << 20)) nthreads = 1;
  std::vector<ChunkResult> results(nthreads);
  std::vector<std::thread> threads;
  size_t chunk = static_cast<size_t>(fsize) / nthreads + 1;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t begin = t * chunk;
    size_t stop = (t + 1) * chunk;
    if (begin >= static_cast<size_t>(fsize)) break;
    threads.emplace_back(parse_chunk, buf.data(), begin, stop,
                         static_cast<size_t>(fsize), cols, &results[t]);
  }
  for (auto& th : threads) th.join();

  auto* st = new ParseState();
  size_t total = 0;
  for (auto& r : results) total += r.src.size();
  st->src.reserve(total);
  st->dst.reserve(total);
  st->w.reserve(total);
  for (auto& r : results) {
    st->src.insert(st->src.end(), r.src.begin(), r.src.end());
    st->dst.insert(st->dst.end(), r.dst.begin(), r.dst.end());
    st->w.insert(st->w.end(), r.w.begin(), r.w.end());
  }
  *count_out = static_cast<int64_t>(total);
  return st;
}

void fastload_fill(void* handle, int64_t* src, int64_t* dst, double* w) {
  auto* st = static_cast<ParseState*>(handle);
  memcpy(src, st->src.data(), st->src.size() * sizeof(int64_t));
  memcpy(dst, st->dst.data(), st->dst.size() * sizeof(int64_t));
  memcpy(w, st->w.data(), st->w.size() * sizeof(double));
}

void fastload_free(void* handle) {
  delete static_cast<ParseState*>(handle);
}

// Sort-free CSR degree count helper used by the tile builder: counts edges
// per (sender_block, receiver_window) pair key in parallel.
void fastload_pair_hist(const int64_t* s, const int64_t* r, int64_t m,
                        int64_t block, int64_t window, int64_t nwin,
                        int64_t* keys_out) {
  for (int64_t i = 0; i < m; ++i) {
    keys_out[i] = (s[i] / block) * nwin + (r[i] / window);
  }
}

}  // extern "C"
