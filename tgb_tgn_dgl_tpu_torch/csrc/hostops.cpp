// Native host-side preprocessing ops (libhostops-<hash>.so, built by
// ops/_build.py).  The port's copy of tgb_tgn_dgl_tpu/csrc/hostops.cpp:
// only the comments that name paths differ.
//
// The reference depends on an external Cython/C++/OpenMP "TGL" sampler for
// its host hot loops (reference README.md:1-2: `python setup.py build_ext
// --inplace`; the `num_thread: 32` knob at config/TGN.yml:9) and an absent
// t-CSR generator (`tgb_gen_graph.py`, consumed at utils.py:73).  This
// file is the framework's equivalent: multithreaded C++ for the O(E)
// pointer-chasing preprocessing that feeds the static-shape arrays the
// device consumes.  Python bindings: data/hostops.py (ctypes).
//
// Exported C ABI:
//   dependency_blocks  — per-batch event leveling (dependencyGraph.py:8-28)
//   build_tcsr         — undirected temporal CSR (TGL ext_full.npz layout)
//   sample_recent      — last-K-before-t neighbor sampling ('recent'
//                        strategy, config/TGN.yml:7)
//   sample_uniform     — K uniform draws from the history before t
//                        ('uniform' strategy), splitmix64 keyed by
//                        (seed, query index)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over up to num_threads workers.
template <typename F>
void parallel_for(int64_t n, int32_t num_threads, F fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int32_t t = static_cast<int32_t>(
      std::min<int64_t>(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int32_t k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Level each batch's events into dependency blocks: an event's block id is
// 1 + max(last block touching its src, its dst), per-node state reset at
// each batch boundary.  Batches are independent -> one task per batch.
void dependency_blocks(const int32_t* src, const int32_t* dst, int64_t n,
                       int64_t batch_size, int32_t num_threads,
                       int32_t* out) {
  if (batch_size <= 0) batch_size = n;
  int64_t num_batches = (n + batch_size - 1) / batch_size;
  parallel_for(num_batches, num_threads, [&](int64_t b) {
    int64_t lo = b * batch_size;
    int64_t hi = std::min(n, lo + batch_size);
    std::unordered_map<int32_t, int32_t> last;
    last.reserve(static_cast<size_t>(2 * (hi - lo)));
    for (int64_t i = lo; i < hi; ++i) {
      int32_t s = src[i], d = dst[i];
      auto is = last.find(s);
      auto id = last.find(d);
      int32_t bs = (is == last.end()) ? -1 : is->second;
      int32_t bd = (id == last.end()) ? -1 : id->second;
      int32_t blk = std::max(bs, bd) + 1;
      out[i] = blk;
      last[s] = blk;
      last[d] = blk;
    }
  });
}

// Build the undirected temporal CSR ("t-CSR", TGL ext_full.npz layout:
// indptr/indices/ts/eid).  Events must be in chronological order; each
// node's adjacency list is then time-sorted by construction.
void build_tcsr(const int32_t* src, const int32_t* dst, const float* t,
                int64_t num_edges, int64_t num_nodes, int64_t* indptr,
                int32_t* indices, int32_t* eid, float* ts) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) {
    ++indptr[src[e] + 1];
    ++indptr[dst[e] + 1];
  }
  for (int64_t v = 0; v < num_nodes; ++v) indptr[v + 1] += indptr[v];
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t cs = cursor[src[e]]++;
    indices[cs] = dst[e];
    eid[cs] = static_cast<int32_t>(e);
    ts[cs] = t[e];
    int64_t cd = cursor[dst[e]]++;
    indices[cd] = src[e];
    eid[cd] = static_cast<int32_t>(e);
    ts[cd] = t[e];
  }
}

// For each (node, time) query return its K most recent neighbors with
// edge time strictly before the query time ('recent' strategy).  Slots
// beyond the available history get eid = -1.
void sample_recent(const int64_t* indptr, const int32_t* indices,
                   const int32_t* eid, const float* ts,
                   const int32_t* nodes, const float* times, int64_t n,
                   int32_t k, int32_t num_threads, int32_t* out_nbr,
                   int32_t* out_eid, float* out_ts) {
  parallel_for(n, num_threads, [&](int64_t q) {
    int32_t v = nodes[q];
    float tq = times[q];
    int64_t lo = indptr[v], hi = indptr[v + 1];
    // upper bound: first index with ts >= tq (adjacency time-sorted)
    const float* beg = ts + lo;
    const float* end = ts + hi;
    int64_t cut = lo + (std::lower_bound(beg, end, tq) - beg);
    int64_t take = std::min<int64_t>(k, cut - lo);
    int64_t start = cut - take;
    for (int64_t j = 0; j < k; ++j) {
      int64_t o = q * k + j;
      if (j < take) {
        int64_t src_i = start + j;
        out_nbr[o] = indices[src_i];
        out_eid[o] = eid[src_i];
        out_ts[o] = ts[src_i];
      } else {
        out_nbr[o] = 0;
        out_eid[o] = -1;
        out_ts[o] = 0.0f;
      }
    }
  });
}

// For each (node, time) query sample K uniform neighbors among those with
// edge time strictly before the query time ('uniform' strategy,
// config/TGN.yml:7 alternative).  Deterministic per (seed, query index).
void sample_uniform(const int64_t* indptr, const int32_t* indices,
                    const int32_t* eid, const float* ts,
                    const int32_t* nodes, const float* times, int64_t n,
                    int32_t k, uint64_t seed, int32_t num_threads,
                    int32_t* out_nbr, int32_t* out_eid, float* out_ts) {
  parallel_for(n, num_threads, [&](int64_t q) {
    int32_t v = nodes[q];
    float tq = times[q];
    int64_t lo = indptr[v], hi = indptr[v + 1];
    const float* beg = ts + lo;
    const float* end = ts + hi;
    int64_t cut = lo + (std::lower_bound(beg, end, tq) - beg);
    int64_t avail = cut - lo;
    // splitmix64 stream keyed by (seed, q)
    uint64_t x = seed + 0x9E3779B97f4A7C15ULL * (uint64_t)(q + 1);
    auto rnd = [&x]() {
      x += 0x9E3779B97f4A7C15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    for (int64_t j = 0; j < k; ++j) {
      int64_t o = q * k + j;
      if (avail > 0 && j < std::min<int64_t>(k, avail)) {
        int64_t pick = lo + static_cast<int64_t>(rnd() % (uint64_t)avail);
        out_nbr[o] = indices[pick];
        out_eid[o] = eid[pick];
        out_ts[o] = ts[pick];
      } else {
        out_nbr[o] = 0;
        out_eid[o] = -1;
        out_ts[o] = 0.0f;
      }
    }
  });
}

}  // extern "C"
