// graphcore — native graph construction/parsing core.
//
// Re-design of the reference's host-side graph layer
// (reference: serial/lib/adjMatrix.cc:18-52 set-based .mtx reader,
// serial/lib/make_graph.cc:19-113 generators).  The reference built graphs
// with std::set<Edge> insertion (O(E log E) with poor constants); this core
// uses flat arrays + one sort + linear dedup, and is exposed to Python via
// a plain C ABI consumed with ctypes (no pybind11 dependency).
//
// All functions are single-call, handle-based: build returns an opaque
// handle whose array sizes can be queried and copied out into
// caller-allocated (numpy) buffers.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct CSRHandle {
  int64_t n = 0;
  std::vector<int64_t> indptr;  // n+1
  std::vector<int32_t> indices; // nnz
};

struct EdgeListHandle {
  int64_t n = 0;
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
};

// Build value-free CSR from an undirected edge list: insert both
// orientations, drop self-loops, sort, dedup (the reference's std::set
// semantics, adjMatrix.cc:21-46, done as sort+unique).
CSRHandle *build_csr(int64_t n, int64_t e, const int64_t *src,
                     const int64_t *dst) {
  std::vector<uint64_t> keys;
  keys.reserve(2 * static_cast<size_t>(e));
  const uint64_t un = static_cast<uint64_t>(n);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t a = src[i], b = dst[i];
    if (a == b) continue;  // self-loops dropped (reference semantics)
    // out-of-range endpoints are an error, matching the numpy oracle
    // CSRGraph.from_edges (silent dropping hid corrupt inputs)
    if (a < 0 || b < 0 || a >= n || b >= n) return nullptr;
    keys.push_back(static_cast<uint64_t>(a) * un + static_cast<uint64_t>(b));
    keys.push_back(static_cast<uint64_t>(b) * un + static_cast<uint64_t>(a));
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());

  auto *h = new CSRHandle;
  h->n = n;
  h->indptr.assign(static_cast<size_t>(n) + 1, 0);
  h->indices.resize(keys.size());
  for (size_t i = 0; i < keys.size(); ++i) {
    h->indptr[keys[i] / un + 1]++;
    h->indices[i] = static_cast<int32_t>(keys[i] % un);
  }
  for (int64_t i = 0; i < n; ++i) h->indptr[i + 1] += h->indptr[i];
  return h;
}

} // namespace

extern "C" {

// ---------------------------------------------------------------- CSR API

void *gc_csr_from_edges(int64_t n, int64_t e, const int64_t *src,
                        const int64_t *dst) {
  try {
    return build_csr(n, e, src, dst);
  } catch (...) {  // bad_alloc etc. must not unwind through ctypes
    return nullptr;
  }
}

int64_t gc_csr_n(void *h) { return static_cast<CSRHandle *>(h)->n; }
int64_t gc_csr_nnz(void *h) {
  return static_cast<int64_t>(static_cast<CSRHandle *>(h)->indices.size());
}
void gc_csr_fill(void *h, int64_t *indptr, int32_t *indices) {
  auto *c = static_cast<CSRHandle *>(h);
  std::memcpy(indptr, c->indptr.data(), c->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, c->indices.data(), c->indices.size() * sizeof(int32_t));
}
void gc_csr_free(void *h) { delete static_cast<CSRHandle *>(h); }

// ---------------------------------------------------------- .mtx parsing

// Reads the reference's .mtx dialect (parallel-final/lib/adjMatrix.cc:21-46):
// '%' comments, an "n n E" header, then E lines of 1-indexed pairs (a third
// column, if present, is ignored).  Returns an edge-list handle (0-indexed,
// unsymmetrized — CSR construction symmetrizes), or nullptr on error.
static void *parse_mtx_impl(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  const char *p = buf.data();
  const char *end = p + size;
  auto skip_ws = [&] {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  };
  auto skip_line = [&] {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  };
  auto parse_int = [&]() -> int64_t {
    skip_ws();
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    // swallow a fractional part / exponent if the file carries float weights
    if (p < end && *p == '.') { ++p; while (p < end && *p >= '0' && *p <= '9') ++p; }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p; if (p < end && (*p == '+' || *p == '-')) ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    return neg ? -v : v;
  };

  auto skip_token = [&] {  // any non-ws run (float/nan/inf weights)
    skip_ws();
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
      ++p;
  };

  // comments
  skip_ws();
  while (p < end && *p == '%') { skip_line(); skip_ws(); }
  const int64_t n = parse_int();
  const int64_t n2 = parse_int();
  const int64_t declared_e = parse_int();
  // a data line needs >= 4 bytes, so a sane count is bounded by the
  // file size — this also stops a corrupt header's reserve() from
  // throwing bad_alloc (or a >int64 count wrapping negative)
  if (n <= 0 || n != n2 || declared_e < 0 || declared_e > size)
    return nullptr;
  skip_line();

  // detect tokens-per-line from the first data line (2 = pattern, 3 = weighted)
  int cols = 0;
  {
    const char *q = p;
    while (q < end && *q != '\n') {
      while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q < end && *q != '\n') {
        ++cols;
        while (q < end && *q != ' ' && *q != '\t' && *q != '\r' && *q != '\n')
          ++q;
      }
    }
    if (cols < 2) cols = 2;
  }

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.reserve(static_cast<size_t>(declared_e));
  h->dst.reserve(static_cast<size_t>(declared_e));
  while (true) {
    skip_ws();
    if (p >= end) break;
    if (!(*p >= '0' && *p <= '9')) {
      // malformed token (incl. mid-file '%' comments, which the numpy
      // fallback also rejects): ERROR, never a silently truncated list
      delete h;
      return nullptr;
    }
    const int64_t a = parse_int();
    const int64_t b = parse_int();
    for (int c = 2; c < cols; ++c) skip_token();
    if (a < 1 || b < 1 || a > n || b > n) {  // 1-indexed on disk
      delete h;
      return nullptr;
    }
    h->src.push_back(a - 1);
    h->dst.push_back(b - 1);
  }
  return h;
}

void *gc_parse_mtx(const char *path) {
  try {
    return parse_mtx_impl(path);
  } catch (...) {  // bad_alloc etc. must not unwind through ctypes
    return nullptr;
  }
}

int64_t gc_edges_n(void *h) { return static_cast<EdgeListHandle *>(h)->n; }
int64_t gc_edges_count(void *h) {
  return static_cast<int64_t>(static_cast<EdgeListHandle *>(h)->src.size());
}
void gc_edges_fill(void *h, int64_t *src, int64_t *dst) {
  auto *e = static_cast<EdgeListHandle *>(h);
  std::memcpy(src, e->src.data(), e->src.size() * sizeof(int64_t));
  std::memcpy(dst, e->dst.data(), e->dst.size() * sizeof(int64_t));
}
void gc_edges_free(void *h) { delete static_cast<EdgeListHandle *>(h); }

// ------------------------------------------------------------- generators

// Barabasi-Albert preferential attachment (reference:
// serial/lib/make_graph.cc "barabasi"): complete seed graph on m+1 nodes,
// then each new node attaches m edges to distinct existing nodes with
// probability proportional to degree, via the endpoint-pool trick.
void *gc_barabasi(int64_t n, int64_t m, uint64_t seed) {
  if (m < 1 || n < m + 1) return nullptr;
  std::mt19937_64 rng(seed);
  const int64_t seed_nodes = m + 1;
  const int64_t seed_edges = m * (m + 1) / 2;
  const int64_t total = seed_edges + (n - seed_nodes) * m;

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.resize(static_cast<size_t>(total));
  h->dst.resize(static_cast<size_t>(total));
  std::vector<int64_t> pool(2 * static_cast<size_t>(total));

  int64_t e = 0;
  for (int64_t i = 0; i < seed_nodes; ++i)
    for (int64_t j = i + 1; j < seed_nodes; ++j) {
      h->src[e] = i; h->dst[e] = j;
      pool[2 * e] = i; pool[2 * e + 1] = j;
      ++e;
    }

  std::vector<int64_t> targets;
  targets.reserve(static_cast<size_t>(m));
  for (int64_t v = seed_nodes; v < n; ++v) {
    targets.clear();
    while (static_cast<int64_t>(targets.size()) < m) {
      const int64_t t = pool[rng() % static_cast<uint64_t>(2 * e)];
      if (std::find(targets.begin(), targets.end(), t) == targets.end())
        targets.push_back(t);
    }
    for (int64_t i = 0; i < m; ++i) {
      h->src[e] = v; h->dst[e] = targets[static_cast<size_t>(i)];
      pool[2 * e] = v; pool[2 * e + 1] = targets[static_cast<size_t>(i)];
      ++e;
    }
  }
  return h;
}

// Uniform-random graph with exactly num_edges distinct undirected edges
// (reference: serial/lib/make_graph.cc "random_adj").
void *gc_uniform(int64_t n, int64_t num_edges, uint64_t seed) {
  if (n < 2 || num_edges < 0 || num_edges > n * (n - 1) / 2) return nullptr;
  std::mt19937_64 rng(seed);
  const uint64_t un = static_cast<uint64_t>(n);
  std::vector<uint64_t> keys;
  keys.reserve(static_cast<size_t>(num_edges) * 2);
  while (true) {
    const int64_t need = num_edges - static_cast<int64_t>(keys.size());
    if (need <= 0) break;
    for (int64_t i = 0; i < need + need / 2 + 16; ++i) {
      const uint64_t a = rng() % un, b = rng() % un;
      if (a == b) continue;
      const uint64_t lo = a < b ? a : b, hi = a < b ? b : a;
      keys.push_back(lo * un + hi);
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  }
  // deterministic truncation to exactly num_edges via shuffle of the tail
  std::shuffle(keys.begin(), keys.end(), rng);
  keys.resize(static_cast<size_t>(num_edges));

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.resize(keys.size());
  h->dst.resize(keys.size());
  for (size_t i = 0; i < keys.size(); ++i) {
    h->src[i] = static_cast<int64_t>(keys[i] / un);
    h->dst[i] = static_cast<int64_t>(keys[i] % un);
  }
  return h;
}

} // extern "C"
