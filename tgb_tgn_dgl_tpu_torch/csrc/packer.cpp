// Native stream-state emulator + batch packer (libpacker-<hash>.so, built
// by ops/_build.py).  The port's copy of tgb_tgn_dgl_tpu/csrc/packer.cpp:
// the comments that name paths differ, and the port adds the per-event
// history mode (packer_pack_history) of DyGFormer.
//
// C++ twin of data/packer.py::StreamPacker — the host-side runtime that
// resolves everything ragged about a batch (recency-cache neighborhoods,
// dependency-block root sets, intra-batch graph growth, Δt resolution,
// mailbox write plans) into the fixed-shape dense grids the TPU consumes.
// This is the framework's equivalent of the reference's native sampler
// dependency (the external TGL Cython/C++ sampler, reference README.md:1-2)
// plus its GPU neighbor cache (reference neighbor_loader.py) — profiled at
// ~100 ms/batch in numpy vs ~3 ms of TPU compute, so the host path is the
// throughput ceiling and lives in C++.
//
// Exact-parity contract: every output array must match the numpy packer
// bit-for-bit (tests/test_torch_native_packer.py).  Ordering rules replicated:
//   * roots per block = sorted unique(src ∪ dst ∪ neg)         (np.unique)
//   * cache insert: per node keep top-K by (e_id desc, cache-before-new,
//     dst-half-before-src-half)                     (argsort(-eid, stable))
//   * clock updates: neg → dst → src, last-write-wins in flat order
//   * eval mode: global clock wipe to the block max-time
//
// Usage (ctypes, data/native_packer.py):
//   h = packer_new(N, K, S); packer_pack_begin(...) -> sizes;
//   packer_pack_fill(...) writes into numpy-allocated buckets.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct CacheEntry {
  int64_t eid;
  int32_t nbr;
  float t;
};

struct PendingBatch {
  // inputs copied
  std::vector<int32_t> src, dst, neg;  // neg is (braw * M) row-major
  std::vector<float> t;
  std::vector<int64_t> ev_idx;
  std::vector<int32_t> blocks;
  int64_t braw = 0, M = 1;
  int32_t eval_mode = 0;
  int32_t k = 0;  // number of blocks
  // per-block root sets (sorted unique node ids), flat + offsets
  std::vector<int32_t> root_nid;       // concatenated
  std::vector<int64_t> offsets;        // k+1
  // slot maps
  std::vector<int64_t> ev_src_slot, ev_pos_slot;
  std::vector<int64_t> ev_neg_slot;    // (braw * M)
  // per-node intra-batch event positions (asc), via sorted arrays
  std::vector<int64_t> run_pos;        // event position per (node,dir) entry
  std::vector<int32_t> run_partner;
  std::vector<int32_t> run_block;
  std::vector<int32_t> intra_counts;   // per root slot
  std::vector<int32_t> uniq;           // sorted unique memory read set
  // events grouped by block: ev_by_block[blk_ptr[i]..blk_ptr[i+1])
  std::vector<int64_t> blk_ptr;
  std::vector<int64_t> ev_by_block;
  int64_t total_roots = 0;
  int64_t p_exact = 0;
};

// Staging buffers for one asynchronously-packed DedupWire batch: the
// worker thread fills these; the (cheap) main-thread read copies them
// into numpy buffers with the dtype narrowing the python oracle applies.
struct DedupStaging {
  std::vector<int32_t> ev_src, ev_dst, ev_idx_out, ev_neg;
  std::vector<float> ev_t;
  std::vector<uint8_t> ev_valid;
  std::vector<int32_t> ev_src_slot, ev_pos_slot, ev_neg_slot;
  std::vector<int32_t> uniq_nid, root_loc, root_cr, cr_loc, cr_feat;
  std::vector<float> cache_dt, self_dt, ia_dt;
  std::vector<int32_t> ne_ent, intra_lo, intra_cnt, intra_start, mw_slot;
};

// One-deep pack-ahead pipeline (VERDICT r3 item 2): the host pack is
// ~40% of a warm epoch and fully native, so batch i+1 packs on a C++
// worker thread while python dispatches batch i.  Exactly ONE job may be
// outstanding (the packer is a sequential state machine); every other
// entry point waits for the worker via wait_idle, so the pipeline is
// invisible to synchronous callers.
struct AsyncState {
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  bool busy = false;      // worker is executing a job
  bool ready = false;     // results staged, waiting for read
  bool stop = false;
  // job inputs (copied at submit)
  std::vector<int32_t> src, dst, blocks, neg;
  std::vector<float> t;
  std::vector<int64_t> ev_idx;
  int64_t braw = 0, M = 1, B = 0, root_lo = 128, cap_p = -1;
  int32_t eval_mode = 0, insert = 1, write_mail = 1;
  int64_t st_P = 0, st_R = 0, st_Ub = 0, st_Ur = 0, st_Ei = 0;  // sticky in
  // job outputs
  int64_t P = 0, R = 0, Ub = 0, Ur = 0, Ei = 0;
  int32_t fallback = 0;   // P > 255: state untouched, caller repacks sync
  DedupStaging out;
};

struct Packer {
  int64_t N;
  int32_t K;
  int32_t S;
  std::vector<int32_t> cache_nbr;   // (N, K)
  std::vector<int64_t> cache_eid;   // (N, K)
  std::vector<float> cache_t;       // (N, K)
  std::vector<float> clock;         // (N,)
  std::vector<int64_t> mail_ptr;    // (N,)
  int64_t cur_e_id = 0;
  PendingBatch pending;
  std::vector<int32_t> loc_of;      // (N,) scratch: node -> uniq index,
                                    // -1 outside pack; reset after use
  // (N,) scratch head of a per-node singly-linked entry list used by
  // insert() — allocation-free grouping; -1 outside insert, cleared for
  // touched nodes on exit
  std::vector<int32_t> ins_head;
  // (N,) per-node run extents into pending.run_pos for the CURRENT
  // pending batch; run_lo = -1 means no run.  Reset with loc_of.
  std::vector<int64_t> run_lo, run_hi;
  std::unique_ptr<AsyncState> async;
};

// Block until no async pack job is RUNNING (results may still be staged
// awaiting read — that state is equivalent to "the pack already ran"
// for every synchronous caller).  Called at the top of every entry
// point that touches packer state.
void wait_idle(Packer* p) {
  if (!p->async) return;
  std::unique_lock<std::mutex> lk(p->async->mu);
  p->async->cv.wait(lk, [&] { return !p->async->busy; });
}

// Shape-bucket formulas — EXACT twins of data/packer.py::_bucket_pow2 /
// _bucket_p (the async worker must choose the same jit shape buckets the
// python sticky tables would).
int64_t bucket_pow2(int64_t n, int64_t lo) {
  int64_t b = lo;
  while (b < n) b *= 2;
  if (b > lo && b % 8 == 0) {
    for (int64_t q = 5; q <= 7; ++q) {
      int64_t c = b / 8 * q;
      if (c >= n) return c;
    }
  }
  return b;
}

int64_t bucket_p(int64_t p_exact) {
  if (p_exact <= 0) return 0;
  int64_t b = 1;
  while (b < p_exact) b *= 2;
  return b;
}

}  // namespace

extern "C" {

void* packer_new(int64_t num_nodes, int32_t k, int32_t s) {
  auto* p = new Packer();
  p->N = num_nodes;
  p->K = k;
  p->S = s;
  p->cache_nbr.assign(num_nodes * k, 0);
  p->cache_eid.assign(num_nodes * k, -1);
  p->cache_t.assign(num_nodes * k, -1.0f);
  p->clock.assign(num_nodes, 0.0f);
  p->mail_ptr.assign(num_nodes, 0);
  p->loc_of.assign(num_nodes, -1);
  p->ins_head.assign(num_nodes, -1);
  p->run_lo.assign(num_nodes, -1);
  p->run_hi.assign(num_nodes, 0);
  return p;
}

void packer_free(void* h) {
  auto* p = static_cast<Packer*>(h);
  if (p->async) {
    {
      std::unique_lock<std::mutex> lk(p->async->mu);
      p->async->cv.wait(lk, [&] { return !p->async->busy; });
      p->async->stop = true;
    }
    p->async->cv.notify_all();
    if (p->async->worker.joinable()) p->async->worker.join();
  }
  delete p;
}

void packer_reset(void* h) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  std::fill(p->cache_eid.begin(), p->cache_eid.end(), int64_t{-1});
  std::fill(p->cache_t.begin(), p->cache_t.end(), -1.0f);
  std::fill(p->mail_ptr.begin(), p->mail_ptr.end(), int64_t{0});
  p->cur_e_id = 0;
}

// State accessors for snapshot/restore and python-side inspection.
void packer_get_state(void* h, int32_t* nbr, int64_t* eid, float* t,
                      float* clock, int64_t* mail_ptr, int64_t* cur_e_id) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  std::memcpy(nbr, p->cache_nbr.data(), p->cache_nbr.size() * 4);
  std::memcpy(eid, p->cache_eid.data(), p->cache_eid.size() * 8);
  std::memcpy(t, p->cache_t.data(), p->cache_t.size() * 4);
  std::memcpy(clock, p->clock.data(), p->clock.size() * 4);
  std::memcpy(mail_ptr, p->mail_ptr.data(), p->mail_ptr.size() * 8);
  *cur_e_id = p->cur_e_id;
}

// Clock-only snapshot: the train-lean wire needs the (N,) pre-batch
// clock EVERY batch (tgb_tgn_dgl_tpu/engine/train.py::_prefetch); packer_get_state
// would materialize the whole (N, K) cache state (~16K bytes/node)
// just to read it — on the large-N slow-link hosts train-lean exists
// for, that copy would dwarf the pack itself.
void packer_get_clock(void* h, float* clock) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  std::memcpy(clock, p->clock.data(), p->clock.size() * 4);
}

void packer_set_state(void* h, const int32_t* nbr, const int64_t* eid,
                      const float* t, const float* clock,
                      const int64_t* mail_ptr, int64_t cur_e_id) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  std::memcpy(p->cache_nbr.data(), nbr, p->cache_nbr.size() * 4);
  std::memcpy(p->cache_eid.data(), eid, p->cache_eid.size() * 8);
  std::memcpy(p->cache_t.data(), t, p->cache_t.size() * 4);
  std::memcpy(p->clock.data(), clock, p->clock.size() * 4);
  std::memcpy(p->mail_ptr.data(), mail_ptr, p->mail_ptr.size() * 8);
  p->cur_e_id = cur_e_id;
}

// Row-level state surgery for the owned-state scratch pack
// (tgb_tgn_dgl_tpu/parallel/owned_state.py::pack_with_gathered_state): a multi-host
// range pack fills ONLY the rows the pack will read (boundary-gathered
// from the node-range owners), packs with insert=0, then clears the
// dirtied rows back to defaults — O(gathered) per pack instead of the
// O(N) full set_state copy.

void packer_set_rows(void* h, const int64_t* nodes, int64_t n,
                     const int32_t* nbr, const int64_t* eid,
                     const float* t, const float* clock) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  const int32_t K = p->K;
  for (int64_t i = 0; i < n; ++i) {
    int64_t u = nodes[i];
    std::memcpy(p->cache_nbr.data() + u * K, nbr + i * K, K * 4);
    std::memcpy(p->cache_eid.data() + u * K, eid + i * K, K * 8);
    std::memcpy(p->cache_t.data() + u * K, t + i * K, K * 4);
    p->clock[u] = clock[i];
  }
}

void packer_set_clock_rows(void* h, const int64_t* nodes, int64_t n,
                           const float* clock) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  for (int64_t i = 0; i < n; ++i) p->clock[nodes[i]] = clock[i];
}

void packer_set_mail_rows(void* h, const int64_t* nodes, int64_t n,
                          const int64_t* ptr) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  for (int64_t i = 0; i < n; ++i) p->mail_ptr[nodes[i]] = ptr[i];
}

// Reset the given rows to construction defaults (cache empty, clock 0,
// mail ptr 0).  ``zero_all_clocks`` additionally wipes EVERY clock —
// needed after an eval-mode scratch pack, whose clock wipe dirties all
// N rows (data/packer.py:365-366).
void packer_clear_rows(void* h, const int64_t* nodes, int64_t n,
                       int32_t zero_all_clocks) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  const int32_t K = p->K;
  for (int64_t i = 0; i < n; ++i) {
    int64_t u = nodes[i];
    std::fill_n(p->cache_nbr.data() + u * K, K, 0);
    std::fill_n(p->cache_eid.data() + u * K, K, int64_t{-1});
    std::fill_n(p->cache_t.data() + u * K, K, -1.0f);
    p->clock[u] = 0.0f;
    p->mail_ptr[u] = 0;
  }
  if (zero_all_clocks)
    std::fill(p->clock.begin(), p->clock.end(), 0.0f);
}

// Undirected recency insert, last-K per node by (eid desc, cache-first,
// dst-half-first) — parity with StreamPacker.insert / reference
// neighbor_loader.py:52-104.
static void insert_impl(Packer* p, const int32_t* src, const int32_t* dst,
                        const float* t, const int64_t* e_id, int64_t b) {
  if (b == 0) return;
  // Contract: e_id must be NON-DECREASING within a call — the O(K)
  // two-way merge below relies on the per-node new-entry list being
  // eid-desc, which holds only then.  The numpy oracle lexsorts and
  // accepts any order; on violation, degrade to per-event calls (each
  // trivially ordered), which reproduces the oracle bit-for-bit: on
  // equal eids the earlier-inserted entry wins the stable merge, the
  // same earlier-position-wins rule as the oracle's stable argsort.
  if (e_id) {
    for (int64_t i = 1; i < b; ++i) {
      if (e_id[i] < e_id[i - 1]) {
        for (int64_t j = 0; j < b; ++j)
          insert_impl(p, src + j, dst + j, t + j, e_id + j, 1);
        return;
      }
    }
  }
  const int32_t K = p->K;
  // Semantics (bit-parity with StreamPacker.insert / reference
  // neighbor_loader.py:52-104): per node, stable-desc-sort by eid of
  // [current cache row, new entries in (eid asc, dst-half-before-
  // src-half) order], keep first K.  The cache row is ALREADY eid-desc
  // (the fixpoint of this very merge), so the sort collapses to an
  // O(K) two-way merge — cache entry wins ties (stable: cache precedes
  // new in the candidate list).  Per-node grouping is an allocation-
  // free linked list over a persistent (N,) head scratch: prepending
  // src-half then dst-half while walking events FORWARD yields each
  // node's new entries in eid-DESC, dst-half-first order — exactly the
  // reversal of the numpy construction, which is what the merge needs.
  std::vector<int32_t> next(2 * b);
  std::vector<int32_t> touched;
  touched.reserve(2 * b);
  int64_t max_eid = p->cur_e_id - 1;
  auto prepend = [&](int32_t u, int32_t ent) {
    if (p->ins_head[u] < 0) touched.push_back(u);
    next[ent] = p->ins_head[u];
    p->ins_head[u] = ent;
  };
  for (int64_t i = 0; i < b; ++i) {
    // entry id 2i = dst-half (node dst, nbr src), 2i+1 = src-half
    prepend(src[i], (int32_t)(2 * i + 1));
    prepend(dst[i], (int32_t)(2 * i));
    int64_t e = e_id ? e_id[i] : p->cur_e_id + i;
    max_eid = std::max(max_eid, e);
  }
  std::vector<CacheEntry> tmp(K);
  for (int32_t u : touched) {
    const int64_t base = (int64_t)u * K;
    for (int32_t j = 0; j < K; ++j)
      tmp[j] = {p->cache_eid[base + j], p->cache_nbr[base + j],
                p->cache_t[base + j]};
    int32_t c = 0;               // cursor into the old cache row
    int32_t ent = p->ins_head[u];
    int32_t taken_new = 0;       // new entries are truncated to K
    for (int32_t j = 0; j < K; ++j) {
      int64_t ne = -1;
      if (ent >= 0 && taken_new < K) {
        int64_t i = ent >> 1;
        ne = e_id ? e_id[i] : p->cur_e_id + i;
      }
      if (ne > tmp[c].eid) {
        int64_t i = ent >> 1;
        int32_t nbr = (ent & 1) ? dst[i] : src[i];
        p->cache_eid[base + j] = ne;
        p->cache_nbr[base + j] = nbr;
        p->cache_t[base + j] = t[i];
        ent = next[ent];
        ++taken_new;
      } else {
        p->cache_eid[base + j] = tmp[c].eid;
        p->cache_nbr[base + j] = tmp[c].nbr;
        p->cache_t[base + j] = tmp[c].t;
        ++c;
      }
    }
    p->ins_head[u] = -1;
  }
  p->cur_e_id = std::max(p->cur_e_id, max_eid + 1);
}

void packer_insert(void* h, const int32_t* src, const int32_t* dst,
                   const float* t, const int64_t* e_id, int64_t b) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  insert_impl(p, src, dst, t, e_id, b);
}

// Per-event history mode (models/dygformer.py; numpy oracle
// data/packer.py::StreamPacker.pack_history).  For each event in stream
// order, each of its E = 2 + M ends (src, dst, then its M negatives)
// reads its K latest cache entries, oldest first: (neighbor, edge row,
// t_event - t_edge), padded with (-1, -1, 0) past its length; then the
// event is inserted, so a later event of the batch sees it.  Rows
// braw..B-1 are padding (valid 0, end 0, length 0).  insert == 0 puts
// every cache row the batch wrote, and the event cursor, back as they
// were (an eval column chunk that is not the batch's last).  Clocks and
// mail pointers are not touched.  Outputs: end (B, E), valid (B,),
// nid/eid/dt (B, E, K), len (B, E).
void packer_pack_history(void* h, const int32_t* src, const int32_t* dst,
                         const float* t, const int64_t* e_id,
                         const int32_t* neg, int64_t braw, int64_t M,
                         int64_t B, int32_t insert, int32_t* out_end,
                         uint8_t* out_valid, int32_t* out_nid,
                         int32_t* out_eid, float* out_dt, int32_t* out_len) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  const int32_t K = p->K;
  const int64_t E = 2 + M;
  std::vector<CacheEntry> saved;
  const int64_t saved_cur = p->cur_e_id;
  if (!insert) {
    saved.resize(2 * braw * K);
    for (int64_t i = 0; i < 2 * braw; ++i) {
      const int64_t base = (int64_t)(i < braw ? src[i] : dst[i - braw]) * K;
      for (int32_t j = 0; j < K; ++j)
        saved[i * K + j] = {p->cache_eid[base + j], p->cache_nbr[base + j],
                            p->cache_t[base + j]};
    }
  }
  for (int64_t i = 0; i < B; ++i) {
    const bool real = i < braw;
    out_valid[i] = real ? 1 : 0;
    for (int64_t e = 0; e < E; ++e) {
      const int64_t o = i * E + e;
      int32_t* nid = out_nid + o * K;
      int32_t* eid = out_eid + o * K;
      float* dt = out_dt + o * K;
      int32_t n = 0;
      int32_t w = 0;
      if (real) {
        w = e == 0 ? src[i] : e == 1 ? dst[i] : neg[i * M + e - 2];
        const int64_t base = (int64_t)w * K;
        // the row is eid-descending with its empty (-1) entries last
        while (n < K && p->cache_eid[base + n] >= 0) ++n;
        for (int32_t j = 0; j < n; ++j) {
          const int64_t c = base + n - 1 - j;
          nid[j] = p->cache_nbr[c];
          eid[j] = (int32_t)p->cache_eid[c];
          dt[j] = t[i] - p->cache_t[c];
        }
      }
      for (int32_t j = n; j < K; ++j) {
        nid[j] = -1;
        eid[j] = -1;
        dt[j] = 0.0f;
      }
      out_end[o] = w;
      out_len[o] = n;
    }
    if (real) insert_impl(p, src + i, dst + i, t + i, e_id + i, 1);
  }
  if (!insert) {
    for (int64_t i = 0; i < 2 * braw; ++i) {
      const int64_t base = (int64_t)(i < braw ? src[i] : dst[i - braw]) * K;
      for (int32_t j = 0; j < K; ++j) {
        const CacheEntry& c = saved[i * K + j];
        p->cache_eid[base + j] = c.eid;
        p->cache_nbr[base + j] = c.nbr;
        p->cache_t[base + j] = c.t;
      }
    }
    p->cur_e_id = saved_cur;
  }
}

// Phase 1: compute sizes.  out_sizes = {total_roots, p_exact}.
static void begin_impl(Packer* p, const int32_t* src, const int32_t* dst,
                       const float* t, const int64_t* ev_idx,
                       const int32_t* blocks, const int32_t* neg,
                       int64_t braw, int64_t m, int32_t eval_mode,
                       int64_t cap_p, int64_t* out_sizes) {
  auto& pb = p->pending;
  // a previous begin whose fill never ran (pack_wire_dedup P>255
  // fallback) leaves the scratch markers set — release them first
  for (int32_t v : pb.uniq) { p->loc_of[v] = -1; p->run_lo[v] = -1; }
  pb = PendingBatch();
  pb.src.assign(src, src + braw);
  pb.dst.assign(dst, dst + braw);
  pb.t.assign(t, t + braw);
  pb.ev_idx.assign(ev_idx, ev_idx + braw);
  pb.blocks.assign(blocks, blocks + braw);
  pb.neg.assign(neg, neg + braw * m);
  pb.braw = braw;
  pb.M = m;
  pb.eval_mode = eval_mode;
  int32_t k = 0;
  for (int64_t i = 0; i < braw; ++i) k = std::max(k, blocks[i] + 1);
  pb.k = k;

  // events grouped by block (counting sort — event order preserved)
  pb.blk_ptr.assign(k + 1, 0);
  for (int64_t i = 0; i < braw; ++i) ++pb.blk_ptr[blocks[i] + 1];
  for (int32_t i = 0; i < k; ++i) pb.blk_ptr[i + 1] += pb.blk_ptr[i];
  pb.ev_by_block.resize(braw);
  {
    std::vector<int64_t> cur(pb.blk_ptr.begin(), pb.blk_ptr.end() - 1);
    for (int64_t i = 0; i < braw; ++i)
      pb.ev_by_block[cur[blocks[i]]++] = i;
  }

  // --- per-node intra-batch runs: entries (node, partner, pos) sorted by
  // (node, pos).  One stable sort of the flat (node, pos) pairs replaces
  // the per-node vector map (python lexsort key is (pos, node) ->
  // primary node asc, secondary pos asc; pos order is append order:
  // src-half before dst-half per event).  Run extents live in (N,)
  // scratch arrays (run_lo/run_hi, reset with loc_of at fill end).
  {
    std::vector<std::pair<int32_t, int32_t>> ents(2 * braw);
    for (int64_t i = 0; i < braw; ++i) {
      ents[2 * i] = {src[i], (int32_t)i};
      ents[2 * i + 1] = {dst[i], (int32_t)i};
    }
    std::stable_sort(ents.begin(), ents.end(),
                     [](const std::pair<int32_t, int32_t>& a,
                        const std::pair<int32_t, int32_t>& b) {
                       return a.first < b.first;
                     });
    pb.run_pos.reserve(2 * braw);
    pb.run_partner.reserve(2 * braw);
    pb.run_block.reserve(2 * braw);
    for (int64_t q = 0; q < (int64_t)ents.size(); ++q) {
      int32_t u = ents[q].first;
      int64_t pos = ents[q].second;
      if (q == 0 || ents[q - 1].first != u)
        p->run_lo[u] = (int64_t)pb.run_pos.size();
      p->run_hi[u] = (int64_t)pb.run_pos.size() + 1;
      pb.run_pos.push_back(pos);
      pb.run_partner.push_back(src[pos] == u ? dst[pos] : src[pos]);
      pb.run_block.push_back(blocks[pos]);
    }
  }

  // --- per-block sorted-unique root sets + slot maps
  pb.ev_src_slot.assign(braw, 0);
  pb.ev_pos_slot.assign(braw, 0);
  pb.ev_neg_slot.assign(braw * m, 0);
  pb.offsets.assign(1, 0);
  std::vector<int32_t> scratch;
  for (int32_t blk = 0; blk < k; ++blk) {
    scratch.clear();
    for (int64_t q = pb.blk_ptr[blk]; q < pb.blk_ptr[blk + 1]; ++q) {
      int64_t i = pb.ev_by_block[q];
      scratch.push_back(src[i]);
      scratch.push_back(dst[i]);
      for (int64_t j = 0; j < m; ++j) scratch.push_back(neg[i * m + j]);
    }
    std::sort(scratch.begin(), scratch.end());
    scratch.erase(std::unique(scratch.begin(), scratch.end()),
                  scratch.end());
    int64_t off = pb.offsets.back();
    for (int64_t q = pb.blk_ptr[blk]; q < pb.blk_ptr[blk + 1]; ++q) {
      int64_t i = pb.ev_by_block[q];
      pb.ev_src_slot[i] =
          off + (std::lower_bound(scratch.begin(), scratch.end(), src[i]) -
                 scratch.begin());
      pb.ev_pos_slot[i] =
          off + (std::lower_bound(scratch.begin(), scratch.end(), dst[i]) -
                 scratch.begin());
      for (int64_t j = 0; j < m; ++j) {
        pb.ev_neg_slot[i * m + j] =
            off + (std::lower_bound(scratch.begin(), scratch.end(),
                                    neg[i * m + j]) -
                   scratch.begin());
      }
    }
    pb.root_nid.insert(pb.root_nid.end(), scratch.begin(), scratch.end());
    pb.offsets.push_back(off + (int64_t)scratch.size());
  }
  pb.total_roots = pb.offsets.back();

  // --- intra counts per root slot
  pb.intra_counts.assign(pb.total_roots, 0);
  int64_t p_exact = 0;
  for (int32_t blk = 0; blk < k; ++blk) {
    for (int64_t s2 = pb.offsets[blk]; s2 < pb.offsets[blk + 1]; ++s2) {
      if (p->run_lo[pb.root_nid[s2]] < 0) continue;
      int64_t a = p->run_lo[pb.root_nid[s2]];
      int64_t b2 = p->run_hi[pb.root_nid[s2]];
      // count entries with block < blk (blocks asc within the run)
      const int32_t* beg = pb.run_block.data() + a;
      const int32_t* end = pb.run_block.data() + b2;
      int64_t cnt = std::lower_bound(beg, end, blk) - beg;
      pb.intra_counts[s2] = (int32_t)cnt;
      p_exact = std::max(p_exact, cnt);
    }
  }
  if (cap_p >= 0) p_exact = std::min(p_exact, cap_p);
  pb.p_exact = p_exact;
  // intra nnz AFTER the cap: raw (COO wire size) and 4-aligned (DedupWire
  // prefix-list size — each window is padded to a multiple of 4 so the
  // device can read it as f32[4] ROW gathers instead of element gathers)
  int64_t nnz = 0, nnz4 = 0;
  for (int64_t s2 = 0; s2 < pb.total_roots; ++s2) {
    int64_t c = std::min<int64_t>(pb.intra_counts[s2], p_exact);
    nnz += c;
    nnz4 += (c + 3) & ~int64_t{3};
  }

  // --- memory read set: roots ∪ valid cache neighbors of roots (cache is
  // still pre-batch state here: inserts happen at the end of fill).
  // Dedup via the loc_of marker array before sorting (roots repeat across
  // blocks; cache neighbors repeat heavily).
  pb.uniq.clear();
  auto mark = [&](int32_t v) {
    if (p->loc_of[v] < 0) {
      p->loc_of[v] = 0;
      pb.uniq.push_back(v);
    }
  };
  for (int32_t v : pb.root_nid) mark(v);
  for (int64_t s2 = 0; s2 < pb.total_roots; ++s2) {
    const int64_t base = (int64_t)pb.root_nid[s2] * p->K;
    for (int32_t j = 0; j < p->K; ++j)
      if (p->cache_eid[base + j] >= 0)
        mark(p->cache_nbr[base + j]);
  }
  std::sort(pb.uniq.begin(), pb.uniq.end());
  // loc_of now maps node -> uniq index until pack_fill resets it
  for (int64_t i = 0; i < (int64_t)pb.uniq.size(); ++i)
    p->loc_of[pb.uniq[i]] = (int32_t)i;

  out_sizes[0] = pb.total_roots;
  out_sizes[1] = p_exact;
  out_sizes[2] = (int64_t)pb.uniq.size();
  out_sizes[3] = nnz;
  // unique ROOT nodes (DedupWire cr-table height) + block count
  {
    std::vector<int32_t> ur(pb.root_nid);
    std::sort(ur.begin(), ur.end());
    ur.erase(std::unique(ur.begin(), ur.end()), ur.end());
    out_sizes[4] = (int64_t)ur.size();
  }
  out_sizes[5] = pb.k;
  out_sizes[6] = nnz4;
}

void packer_pack_begin(void* h, const int32_t* src, const int32_t* dst,
                       const float* t, const int64_t* ev_idx,
                       const int32_t* blocks, const int32_t* neg,
                       int64_t braw, int64_t m, int32_t eval_mode,
                       int64_t cap_p, int64_t* out_sizes) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  begin_impl(p, src, dst, t, ev_idx, blocks, neg, braw, m, eval_mode,
             cap_p, out_sizes);
}

// Phase 2: fill python-allocated output buffers (bucketed shapes) and
// advance state (clocks during fill; cache/mail_ptr if insert != 0).
void packer_pack_fill(
    void* h, int64_t b_bucket, int64_t r_bucket, int64_t p_bucket,
    int32_t insert, int32_t write_mail,
    // event outputs (B,)
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    // root outputs (R,)
    int32_t* root_nid, uint8_t* root_valid,
    // grid outputs (R, Kp)
    int32_t* nbr_nid, float* nbr_dt, int8_t* nbr_kind, int32_t* nbr_feat,
    // slot maps
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    // memory support
    int64_t u_bucket, int32_t* uniq_nid, int32_t* root_loc,
    int32_t* nbr_loc,
    int32_t* mw_node, int32_t* mw_slot, int32_t* mw_partner, float* mw_t,
    int32_t* mw_eid) {
  auto* p = static_cast<Packer*>(h);
  auto& pb = p->pending;
  const int32_t K = p->K;
  const int64_t braw = pb.braw, M = pb.M;
  const int64_t Kp = K + 1 + p_bucket;
  const int64_t P = pb.p_exact;  // capped exact, <= p_bucket

  constexpr int8_t KIND_INVALID = 0, KIND_CACHE = 1, KIND_INTRA = 2,
                   KIND_SELF = 3;

  // zero/initialize outputs
  std::memset(nbr_nid, 0, sizeof(int32_t) * r_bucket * Kp);
  std::memset(nbr_dt, 0, sizeof(float) * r_bucket * Kp);
  std::memset(nbr_kind, 0, sizeof(int8_t) * r_bucket * Kp);
  std::memset(nbr_feat, 0, sizeof(int32_t) * r_bucket * Kp);
  std::memset(root_nid, 0, sizeof(int32_t) * r_bucket);
  std::memset(root_valid, 0, sizeof(uint8_t) * r_bucket);

  // --- per-block clock updates + grid fill
  for (int32_t blk = 0; blk < pb.k; ++blk) {
    // clocks: neg -> dst -> src, last-write-wins in flat order
    const int64_t qlo = pb.blk_ptr[blk], qhi = pb.blk_ptr[blk + 1];
    if (pb.eval_mode) {
      float mx = -1e30f;
      for (int64_t q = qlo; q < qhi; ++q)
        mx = std::max(mx, pb.t[pb.ev_by_block[q]]);
      if (qhi > qlo) std::fill(p->clock.begin(), p->clock.end(), mx);
    } else {
      for (int64_t q = qlo; q < qhi; ++q) {
        int64_t i = pb.ev_by_block[q];
        for (int64_t j = 0; j < M; ++j)
          p->clock[pb.neg[i * M + j]] = pb.t[i];
      }
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.dst[i]] = pb.t[i];
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.src[i]] = pb.t[i];
    }

    for (int64_t s2 = pb.offsets[blk]; s2 < pb.offsets[blk + 1]; ++s2) {
      int32_t u = pb.root_nid[s2];
      int64_t row = s2 * Kp;
      const int64_t base = (int64_t)u * K;
      for (int32_t j = 0; j < K; ++j) {
        int64_t e = p->cache_eid[base + j];
        if (e >= 0) {
          int32_t nb = p->cache_nbr[base + j];
          nbr_nid[row + j] = nb;
          nbr_kind[row + j] = KIND_CACHE;
          nbr_feat[row + j] = (int32_t)e;
          nbr_dt[row + j] = p->cache_t[base + j] - p->clock[nb];
        }
      }
      // self loop
      nbr_nid[row + K] = u;
      nbr_kind[row + K] = KIND_SELF;
      nbr_dt[row + K] = 0.0f - p->clock[u];
      // intra-batch predecessors (most recent P when capped)
      int64_t full = pb.intra_counts[s2];
      if (full > 0 && P > 0) {
        int64_t a = p->run_lo[u], b2 = p->run_hi[u];
        int64_t take = std::min<int64_t>(full, P);
        int64_t lo = a + full - take;
        for (int64_t q = 0; q < take; ++q) {
          int64_t pos = pb.run_pos[lo + q];
          int32_t partner = pb.run_partner[lo + q];
          int64_t col = K + 1 + q;
          nbr_nid[row + col] = partner;
          nbr_kind[row + col] = KIND_INTRA;
          nbr_feat[row + col] = (int32_t)pb.ev_idx[pos];
          nbr_dt[row + col] = pb.t[pos] - p->clock[partner];
        }
      }
      root_nid[s2] = u;
      root_valid[s2] = 1;
    }
  }

  // --- event padding
  for (int64_t i = 0; i < b_bucket; ++i) {
    bool v = i < braw;
    ev_src[i] = v ? pb.src[i] : 0;
    ev_dst[i] = v ? pb.dst[i] : 0;
    ev_t[i] = v ? pb.t[i] : 0.0f;
    ev_idx_out[i] = v ? (int32_t)pb.ev_idx[i] : 0;
    ev_valid[i] = v ? 1 : 0;
    ev_src_slot[i] = v ? (int32_t)pb.ev_src_slot[i] : 0;
    ev_pos_slot[i] = v ? (int32_t)pb.ev_pos_slot[i] : 0;
    for (int64_t j = 0; j < M; ++j) {
      ev_neg[i * M + j] = v ? pb.neg[i * M + j] : 0;
      ev_neg_slot[i * M + j] = v ? (int32_t)pb.ev_neg_slot[i * M + j] : 0;
    }
  }

  // --- uniq set + loc maps (uniq + loc_of prepared in pack_begin)
  {
    const std::vector<int32_t>& uniq = pb.uniq;
    int64_t U = (int64_t)uniq.size();
    for (int64_t i = 0; i < u_bucket; ++i)
      uniq_nid[i] = i < U ? uniq[i] : (int32_t)p->N;
    const int32_t pad_loc = (int32_t)(u_bucket - 1);
    for (int64_t i = 0; i < r_bucket * Kp; ++i) nbr_loc[i] = pad_loc;
    for (int64_t r = 0; r < r_bucket; ++r)
      root_loc[r] = r < pb.total_roots ? p->loc_of[pb.root_nid[r]]
                                       : pad_loc;
    for (int64_t r = 0; r < pb.total_roots; ++r) {
      int64_t row = r * Kp;
      for (int64_t c = 0; c < Kp; ++c)
        if (nbr_kind[row + c] != KIND_INVALID)
          nbr_loc[row + c] = p->loc_of[nbr_nid[row + c]];
    }
    // release the scratch marker
    for (int32_t v : uniq) { p->loc_of[v] = -1; p->run_lo[v] = -1; }
  }

  // --- mailbox write plan: per node last-S event-direction writes
  {
    const int32_t S = p->S;
    const int64_t W = 2 * b_bucket;
    for (int64_t i = 0; i < W; ++i) {
      mw_node[i] = (int32_t)p->N;
      mw_slot[i] = 0;
      mw_partner[i] = 0;
      mw_t[i] = 0.0f;
      mw_eid[i] = 0;
    }
    std::unordered_map<int32_t, std::vector<int64_t>> writes;  // positions
    writes.reserve(2 * braw);
    for (int64_t i = 0; write_mail && i < braw; ++i) {
      writes[pb.src[i]].push_back(2 * i);
      writes[pb.dst[i]].push_back(2 * i + 1);
    }
    for (auto& kv : writes) {
      int32_t u = kv.first;
      auto& v = kv.second;
      int64_t kept = std::min<int64_t>((int64_t)v.size(), S);
      int64_t start = (int64_t)v.size() - kept;
      int64_t ptr = p->mail_ptr[u];
      for (int64_t q = 0; q < kept; ++q) {
        int64_t w = v[start + q];
        int64_t ev = w / 2;
        mw_node[w] = u;
        mw_slot[w] = (int32_t)((ptr + q) % S);
        mw_partner[w] = (w % 2 == 0) ? pb.dst[ev] : pb.src[ev];
        mw_t[w] = pb.t[ev];
        mw_eid[w] = (int32_t)pb.ev_idx[ev];
      }
      if (insert) p->mail_ptr[u] = (ptr + kept) % S;
    }
  }

  if (insert) {
    insert_impl(p, pb.src.data(), pb.dst.data(), pb.t.data(),
                pb.ev_idx.data(), braw);
  }
  pb = PendingBatch();
}

// Phase 2 (wire): emit the compact WirePack arrays directly — no full
// (R, Kp) grids are materialized on the host at all.  Pad conventions
// match tgb_tgn_dgl_tpu/ops/wire.py::pack_to_wire exactly
// (tests/test_torch_native_packer.py).
static void fill_wire_impl(
    void* h, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    // event outputs (B,)
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    // uniq + roots
    int64_t u_bucket, int32_t* uniq_nid, int32_t* root_loc,
    // cache part (R, K) + self loop (R,)
    int32_t* cache_loc, int32_t* cache_feat, float* cache_dt,
    float* self_dt,
    // intra COO (Ei,)
    int64_t ei_bucket, int32_t* ia_row, int32_t* ia_col, int32_t* ia_loc,
    int32_t* ia_feat, float* ia_dt,
    // write plan
    int32_t* mw_node, int32_t* mw_slot, int32_t* mw_partner, float* mw_t,
    int32_t* mw_eid,
    // multi-layer rslot outputs (nullable; tgb_tgn_dgl_tpu/data/packer.py nbr_rslot):
    // same-block root-slot per in-edge, -1 when the source is not rooted
    // in the row's dependency block
    int32_t* cache_rslot, int32_t* ia_rslot) {
  auto* p = static_cast<Packer*>(h);
  auto& pb = p->pending;
  const int32_t K = p->K;
  const int64_t braw = pb.braw, M = pb.M;
  const int64_t P = pb.p_exact;
  const int32_t pad_loc = (int32_t)(u_bucket - 1);

  // pads
  for (int64_t i = 0; i < r_bucket; ++i) {
    root_loc[i] = pad_loc;
    self_dt[i] = 0.0f;
  }
  for (int64_t i = 0; i < r_bucket * K; ++i) {
    cache_loc[i] = pad_loc;
    cache_feat[i] = -1;
    cache_dt[i] = 0.0f;
  }
  for (int64_t i = 0; i < ei_bucket; ++i) {
    ia_row[i] = (int32_t)r_bucket;
    ia_col[i] = 0;
    ia_loc[i] = 0;
    ia_feat[i] = 0;
    ia_dt[i] = 0.0f;
  }
  if (cache_rslot)
    for (int64_t i = 0; i < r_bucket * K; ++i) cache_rslot[i] = -1;
  if (ia_rslot)
    for (int64_t i = 0; i < ei_bucket; ++i) ia_rslot[i] = -1;
  {
    const std::vector<int32_t>& uniq = pb.uniq;
    int64_t U = (int64_t)uniq.size();
    for (int64_t i = 0; i < u_bucket; ++i)
      uniq_nid[i] = i < U ? uniq[i] : (int32_t)p->N;
  }

  int64_t ia_cursor = 0;
  for (int32_t blk = 0; blk < pb.k; ++blk) {
    const int64_t qlo = pb.blk_ptr[blk], qhi = pb.blk_ptr[blk + 1];
    if (pb.eval_mode) {
      float mx = -1e30f;
      for (int64_t q = qlo; q < qhi; ++q)
        mx = std::max(mx, pb.t[pb.ev_by_block[q]]);
      if (qhi > qlo) std::fill(p->clock.begin(), p->clock.end(), mx);
    } else {
      for (int64_t q = qlo; q < qhi; ++q) {
        int64_t i = pb.ev_by_block[q];
        for (int64_t j = 0; j < M; ++j)
          p->clock[pb.neg[i * M + j]] = pb.t[i];
      }
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.dst[i]] = pb.t[i];
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.src[i]] = pb.t[i];
    }

    // same-block root lookup (sorted-unique roots of this block)
    const int32_t* rbeg = pb.root_nid.data() + pb.offsets[blk];
    const int32_t* rend = pb.root_nid.data() + pb.offsets[blk + 1];
    auto rslot_of = [&](int32_t node) -> int32_t {
      const int32_t* it = std::lower_bound(rbeg, rend, node);
      if (it != rend && *it == node)
        return (int32_t)(pb.offsets[blk] + (it - rbeg));
      return -1;
    };

    for (int64_t s2 = pb.offsets[blk]; s2 < pb.offsets[blk + 1]; ++s2) {
      int32_t u = pb.root_nid[s2];
      root_loc[s2] = p->loc_of[u];
      const int64_t base = (int64_t)u * K;
      const int64_t row = s2 * K;
      for (int32_t j = 0; j < K; ++j) {
        int64_t e = p->cache_eid[base + j];
        if (e >= 0) {
          int32_t nb = p->cache_nbr[base + j];
          cache_loc[row + j] = p->loc_of[nb];
          cache_feat[row + j] = (int32_t)e;
          cache_dt[row + j] = p->cache_t[base + j] - p->clock[nb];
          if (cache_rslot) cache_rslot[row + j] = rslot_of(nb);
        }
      }
      self_dt[s2] = 0.0f - p->clock[u];
      int64_t full = pb.intra_counts[s2];
      if (full > 0 && P > 0) {
        int64_t a = p->run_lo[u], b2 = p->run_hi[u];
        int64_t take = std::min<int64_t>(full, P);
        int64_t lo = a + full - take;
        for (int64_t q2 = 0; q2 < take; ++q2) {
          int64_t pos = pb.run_pos[lo + q2];
          int32_t partner = pb.run_partner[lo + q2];
          ia_row[ia_cursor] = (int32_t)s2;
          ia_col[ia_cursor] = (int32_t)q2;
          ia_loc[ia_cursor] = p->loc_of[partner];
          ia_feat[ia_cursor] = (int32_t)pb.ev_idx[pos];
          ia_dt[ia_cursor] = pb.t[pos] - p->clock[partner];
          if (ia_rslot) ia_rslot[ia_cursor] = rslot_of(partner);
          ++ia_cursor;
        }
      }
    }
  }

  for (int64_t i = 0; i < b_bucket; ++i) {
    bool v = i < braw;
    ev_src[i] = v ? pb.src[i] : 0;
    ev_dst[i] = v ? pb.dst[i] : 0;
    ev_t[i] = v ? pb.t[i] : 0.0f;
    ev_idx_out[i] = v ? (int32_t)pb.ev_idx[i] : 0;
    ev_valid[i] = v ? 1 : 0;
    ev_src_slot[i] = v ? (int32_t)pb.ev_src_slot[i] : 0;
    ev_pos_slot[i] = v ? (int32_t)pb.ev_pos_slot[i] : 0;
    for (int64_t j = 0; j < M; ++j) {
      ev_neg[i * M + j] = v ? pb.neg[i * M + j] : 0;
      ev_neg_slot[i * M + j] = v ? (int32_t)pb.ev_neg_slot[i * M + j] : 0;
    }
  }

  // mailbox write plan (same as packer_pack_fill)
  {
    const int32_t S = p->S;
    const int64_t W = 2 * b_bucket;
    for (int64_t i = 0; i < W; ++i) {
      mw_node[i] = (int32_t)p->N;
      mw_slot[i] = 0;
      mw_partner[i] = 0;
      mw_t[i] = 0.0f;
      mw_eid[i] = 0;
    }
    std::unordered_map<int32_t, std::vector<int64_t>> writes;
    writes.reserve(2 * braw);
    for (int64_t i = 0; write_mail && i < braw; ++i) {
      writes[pb.src[i]].push_back(2 * i);
      writes[pb.dst[i]].push_back(2 * i + 1);
    }
    for (auto& kv : writes) {
      int32_t u = kv.first;
      auto& v = kv.second;
      int64_t kept = std::min<int64_t>((int64_t)v.size(), S);
      int64_t start = (int64_t)v.size() - kept;
      int64_t ptr = p->mail_ptr[u];
      for (int64_t q = 0; q < kept; ++q) {
        int64_t w = v[start + q];
        int64_t ev = w / 2;
        mw_node[w] = u;
        mw_slot[w] = (int32_t)((ptr + q) % S);
        mw_partner[w] = (w % 2 == 0) ? pb.dst[ev] : pb.src[ev];
        mw_t[w] = pb.t[ev];
        mw_eid[w] = (int32_t)pb.ev_idx[ev];
      }
      if (insert) p->mail_ptr[u] = (ptr + kept) % S;
    }
  }

  // release the loc_of / run scratch markers
  for (int32_t v : pb.uniq) { p->loc_of[v] = -1; p->run_lo[v] = -1; }

  if (insert) {
    insert_impl(p, pb.src.data(), pb.dst.data(), pb.t.data(),
                pb.ev_idx.data(), braw);
  }
  pb = PendingBatch();
}

// Lean emission for device-cache mode (tgb_tgn_dgl_tpu/ops/lean_wire.py): event-only
// wire — NO cache grids, NO clock reads, NO uniq table; the device owns
// that state.  Must be bit-identical to tgb_tgn_dgl_tpu/data/lean_packer.py
// (the numpy oracle, tests/test_lean.py).
void packer_pack_fill_lean(
    void* h, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    // events (B,)
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    // roots (R,)
    int32_t* root_nid, int32_t* root_blk,
    // intra COO (Ei,) sorted by (row, col)
    int64_t ei_bucket, int32_t* ia_row, int32_t* ia_pos, int32_t* ia_side,
    // mailbox write plan (2B,)
    int32_t* mw_node, int32_t* mw_slot, int32_t* mw_partner, float* mw_t,
    int32_t* mw_eid,
    // resolved clock updates (Q,) sorted by (node, block)
    int64_t q_bucket, int32_t* upd_node, int32_t* upd_blk, float* upd_t,
    uint8_t* upd_last,
    // eval wipe values (Kb,) + final
    int64_t kb_bucket, float* wipe_t, float* wipe_final) {
  auto* p = static_cast<Packer*>(h);
  auto& pb = p->pending;
  const int64_t braw = pb.braw, M = pb.M;
  const int64_t P = pb.p_exact;
  const int32_t N32 = (int32_t)p->N;

  for (int64_t i = 0; i < r_bucket; ++i) {
    root_nid[i] = N32;
    root_blk[i] = 0;
  }
  for (int64_t i = 0; i < ei_bucket; ++i) {
    ia_row[i] = (int32_t)r_bucket;
    ia_pos[i] = 0;
    ia_side[i] = 0;
  }

  int64_t ia_cursor = 0;
  for (int32_t blk = 0; blk < pb.k; ++blk) {
    for (int64_t s2 = pb.offsets[blk]; s2 < pb.offsets[blk + 1]; ++s2) {
      int32_t u = pb.root_nid[s2];
      root_nid[s2] = u;
      root_blk[s2] = blk;
      int64_t full = pb.intra_counts[s2];
      if (full > 0 && P > 0) {
        int64_t a = p->run_lo[u], b2 = p->run_hi[u];
        int64_t take = std::min<int64_t>(full, P);
        int64_t lo = a + full - take;
        for (int64_t q2 = 0; q2 < take; ++q2) {
          int64_t idx = lo + q2;
          int64_t pos = pb.run_pos[idx];
          ia_row[ia_cursor] = (int32_t)s2;
          ia_pos[ia_cursor] = (int32_t)pos;
          // side 1 → the run entry was keyed on dst (partner is src).
          // Self-loop events (src == dst) contribute two consecutive
          // run entries: src-keyed (side 0) then dst-keyed (side 1).
          int32_t side;
          if (pb.src[pos] == pb.dst[pos]) {
            side = (idx > a && pb.run_pos[idx - 1] == pos) ? 1 : 0;
          } else {
            side = (u == pb.dst[pos]) ? 1 : 0;
          }
          ia_side[ia_cursor] = side;
          ++ia_cursor;
        }
      }
    }
  }

  // --- resolved clock updates: last write per (node, block); write
  // order within a block = phase (neg 0 < dst 1 < src 2), event pos.
  {
    struct W { int64_t node; int32_t blk; float t; int64_t seq; };
    std::vector<W> ws;
    ws.reserve((pb.eval_mode ? 2 : 2 + M) * braw);
    int64_t seq = 0;
    for (int32_t blk = 0; blk < pb.k; ++blk) {
      const int64_t qlo = pb.blk_ptr[blk], qhi = pb.blk_ptr[blk + 1];
      float mx = -1e30f;
      if (!pb.eval_mode) {
        for (int64_t q = qlo; q < qhi; ++q) {
          int64_t i = pb.ev_by_block[q];
          for (int64_t j = 0; j < M; ++j)
            ws.push_back({pb.neg[i * M + j], blk, pb.t[i], seq++});
        }
      }
      for (int64_t q = qlo; q < qhi; ++q) {
        int64_t i = pb.ev_by_block[q];
        ws.push_back({pb.dst[i], blk, pb.t[i], seq++});
        mx = std::max(mx, pb.t[i]);
      }
      for (int64_t q = qlo; q < qhi; ++q) {
        int64_t i = pb.ev_by_block[q];
        ws.push_back({pb.src[i], blk, pb.t[i], seq++});
      }
      if (blk < kb_bucket)
        wipe_t[blk] = (pb.eval_mode && qhi > qlo) ? mx : 0.0f;
    }
    for (int64_t i = pb.k; i < kb_bucket; ++i) wipe_t[i] = 0.0f;
    *wipe_final = (pb.eval_mode && pb.k > 0) ? wipe_t[pb.k - 1] : 0.0f;
    std::sort(ws.begin(), ws.end(), [](const W& a, const W& b) {
      if (a.node != b.node) return a.node < b.node;
      if (a.blk != b.blk) return a.blk < b.blk;
      return a.seq < b.seq;
    });
    int64_t qn = 0;
    for (int64_t i = 0; i < (int64_t)ws.size(); ++i) {
      bool last_of_key = i + 1 == (int64_t)ws.size() ||
                         ws[i + 1].node != ws[i].node ||
                         ws[i + 1].blk != ws[i].blk;
      if (!last_of_key) continue;
      if (qn < q_bucket) {
        upd_node[qn] = (int32_t)ws[i].node;
        upd_blk[qn] = ws[i].blk;
        upd_t[qn] = ws[i].t;
        bool node_last = i + 1 == (int64_t)ws.size() ||
                         ws[i + 1].node != ws[i].node;
        if (pb.eval_mode) node_last = node_last && ws[i].blk == pb.k - 1;
        upd_last[qn] = node_last ? 1 : 0;
      }
      ++qn;
    }
    for (int64_t i = qn; i < q_bucket; ++i) {
      upd_node[i] = N32;
      upd_blk[i] = 0;
      upd_t[i] = 0.0f;
      upd_last[i] = 0;
    }
  }

  // --- events + slot maps (same as fill_wire)
  for (int64_t i = 0; i < b_bucket; ++i) {
    bool v = i < braw;
    ev_src[i] = v ? pb.src[i] : 0;
    ev_dst[i] = v ? pb.dst[i] : 0;
    ev_t[i] = v ? pb.t[i] : 0.0f;
    ev_idx_out[i] = v ? (int32_t)pb.ev_idx[i] : 0;
    ev_valid[i] = v ? 1 : 0;
    ev_src_slot[i] = v ? (int32_t)pb.ev_src_slot[i] : 0;
    ev_pos_slot[i] = v ? (int32_t)pb.ev_pos_slot[i] : 0;
    for (int64_t j = 0; j < M; ++j) {
      ev_neg[i * M + j] = v ? pb.neg[i * M + j] : 0;
      ev_neg_slot[i * M + j] = v ? (int32_t)pb.ev_neg_slot[i * M + j] : 0;
    }
  }

  // --- mailbox write plan (same as fill_wire)
  {
    const int32_t S = p->S;
    const int64_t W2 = 2 * b_bucket;
    for (int64_t i = 0; i < W2; ++i) {
      mw_node[i] = N32;
      mw_slot[i] = 0;
      mw_partner[i] = 0;
      mw_t[i] = 0.0f;
      mw_eid[i] = 0;
    }
    std::unordered_map<int32_t, std::vector<int64_t>> writes;
    writes.reserve(2 * braw);
    for (int64_t i = 0; write_mail && i < braw; ++i) {
      writes[pb.src[i]].push_back(2 * i);
      writes[pb.dst[i]].push_back(2 * i + 1);
    }
    for (auto& kv : writes) {
      int32_t u = kv.first;
      auto& v = kv.second;
      int64_t kept = std::min<int64_t>((int64_t)v.size(), S);
      int64_t start = (int64_t)v.size() - kept;
      int64_t ptr = p->mail_ptr[u];
      for (int64_t q = 0; q < kept; ++q) {
        int64_t w = v[start + q];
        int64_t ev = w / 2;
        mw_node[w] = u;
        mw_slot[w] = (int32_t)((ptr + q) % S);
        mw_partner[w] = (w % 2 == 0) ? pb.dst[ev] : pb.src[ev];
        mw_t[w] = pb.t[ev];
        mw_eid[w] = (int32_t)pb.ev_idx[ev];
      }
      if (insert) p->mail_ptr[u] = (ptr + kept) % S;
    }
  }

  // release scratch markers; do NOT touch clock or cache (device-owned)
  for (int32_t v : pb.uniq) { p->loc_of[v] = -1; p->run_lo[v] = -1; }
  pb = PendingBatch();
}

// DedupWire emission (ops/wire.DedupWire; numpy oracle
// tgb_tgn_dgl_tpu/data/packer.py::StreamPacker.pack_wire_dedup — must match it bit-for-bit,
// tests/test_torch_native_packer.py).  Cache rows ship once per unique root
// node; the intra COO collapses to per-slot ranges into the node-major
// event-position list plus a prefix-layout Δt list.  All outputs are
// int32/float32 staging buffers; python narrows dtypes.
static void fill3_impl(
    Packer* p, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    // events (B,)
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    // uniq (Ub,)
    int64_t u_bucket, int32_t* uniq_nid,
    // roots (R,)
    int32_t* root_loc, int32_t* root_cr,
    // cr tables (Ur, K)
    int64_t ur_bucket, int32_t* cr_loc, int32_t* cr_feat,
    // Δt outputs: cache (R, K), self (R,), intra prefix list (Ei,)
    float* cache_dt, float* self_dt, int64_t ei_bucket, float* ia_dt,
    // intra entries: ne_ent (2B, 2) = [partner uniq-loc, global event
    // row] per node-major event entry — shipping both directly lets the
    // device expansion do ONE row gather instead of an element gather
    // plus a packed (R, P, 4) event-table gather (profiler, BASELINE.md);
    // lo/cnt/start (R,)
    int32_t* ne_ent, int32_t* intra_lo, int32_t* intra_cnt,
    int32_t* intra_start,
    // mailbox plan, slots only (2B,), -1 = no write
    int32_t* mw_slot) {
  auto& pb = p->pending;
  const int32_t K = p->K;
  const int64_t braw = pb.braw, M = pb.M;
  const int64_t P = pb.p_exact;
  const int32_t pad_loc = (int32_t)(u_bucket - 1);

  // --- uniq table -----------------------------------------------------
  {
    const std::vector<int32_t>& uniq = pb.uniq;
    int64_t U = (int64_t)uniq.size();
    for (int64_t i = 0; i < u_bucket; ++i)
      uniq_nid[i] = i < U ? uniq[i] : (int32_t)p->N;
  }

  // --- unique root nodes (sorted) + cr tables (pre-insert cache) ------
  {
    std::vector<int32_t> ur(pb.root_nid);
    std::sort(ur.begin(), ur.end());
    ur.erase(std::unique(ur.begin(), ur.end()), ur.end());
    const int64_t n_ur = (int64_t)ur.size();
    for (int64_t r = 0; r < ur_bucket; ++r) {
      const int64_t row = r * K;
      if (r < n_ur) {
        const int64_t base = (int64_t)ur[r] * K;
        for (int32_t j = 0; j < K; ++j) {
          int64_t e = p->cache_eid[base + j];
          if (e >= 0) {
            cr_feat[row + j] = (int32_t)e;
            cr_loc[row + j] = p->loc_of[p->cache_nbr[base + j]];
          } else {
            cr_feat[row + j] = -1;
            cr_loc[row + j] = pad_loc;
          }
        }
      } else {
        for (int32_t j = 0; j < K; ++j) {
          cr_feat[row + j] = -1;
          cr_loc[row + j] = pad_loc;
        }
      }
    }
    for (int64_t s2 = 0; s2 < r_bucket; ++s2) {
      if (s2 < pb.total_roots) {
        root_cr[s2] = (int32_t)(std::lower_bound(ur.begin(), ur.end(),
                                                 pb.root_nid[s2]) -
                                ur.begin());
      } else {
        root_cr[s2] = (int32_t)(ur_bucket - 1);
      }
    }
  }

  // --- pads ------------------------------------------------------------
  for (int64_t s2 = 0; s2 < r_bucket; ++s2) {
    root_loc[s2] = pad_loc;
    self_dt[s2] = 0.0f;
    intra_lo[s2] = 0;
    intra_cnt[s2] = 0;
    intra_start[s2] = 0;
  }
  std::memset(cache_dt, 0, sizeof(float) * r_bucket * K);
  for (int64_t i = 0; i < ei_bucket; ++i) ia_dt[i] = 0.0f;
  for (int64_t i = 0; i < 2 * b_bucket; ++i) {
    if (i < (int64_t)pb.run_pos.size()) {
      ne_ent[2 * i] = p->loc_of[pb.run_partner[i]];
      ne_ent[2 * i + 1] = (int32_t)pb.ev_idx[pb.run_pos[i]];
    } else {
      ne_ent[2 * i] = 0;
      ne_ent[2 * i + 1] = 0;
    }
  }

  // --- per-block clock advance + Δt emission ----------------------------
  int64_t dt_cursor = 0;
  for (int32_t blk = 0; blk < pb.k; ++blk) {
    const int64_t qlo = pb.blk_ptr[blk], qhi = pb.blk_ptr[blk + 1];
    if (pb.eval_mode) {
      float mx = -1e30f;
      for (int64_t q = qlo; q < qhi; ++q)
        mx = std::max(mx, pb.t[pb.ev_by_block[q]]);
      if (qhi > qlo) std::fill(p->clock.begin(), p->clock.end(), mx);
    } else {
      for (int64_t q = qlo; q < qhi; ++q) {
        int64_t i = pb.ev_by_block[q];
        for (int64_t j = 0; j < M; ++j)
          p->clock[pb.neg[i * M + j]] = pb.t[i];
      }
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.dst[i]] = pb.t[i];
    }
    for (int64_t q = qlo; q < qhi; ++q) {
      int64_t i = pb.ev_by_block[q];
      p->clock[pb.src[i]] = pb.t[i];
    }

    for (int64_t s2 = pb.offsets[blk]; s2 < pb.offsets[blk + 1]; ++s2) {
      int32_t u = pb.root_nid[s2];
      root_loc[s2] = p->loc_of[u];
      const int64_t base = (int64_t)u * K;
      const int64_t row = s2 * K;
      for (int32_t j = 0; j < K; ++j) {
        int64_t e = p->cache_eid[base + j];
        if (e >= 0)
          cache_dt[row + j] =
              p->cache_t[base + j] - p->clock[p->cache_nbr[base + j]];
      }
      self_dt[s2] = 0.0f - p->clock[u];
      int64_t full = pb.intra_counts[s2];
      if (full > 0 && P > 0) {
        int64_t a = p->run_lo[u], b2 = p->run_hi[u];
        int64_t take = std::min<int64_t>(full, P);
        int64_t lo = a + full - take;
        intra_lo[s2] = (int32_t)lo;
        intra_cnt[s2] = (int32_t)take;
        intra_start[s2] = (int32_t)dt_cursor;
        for (int64_t q2 = 0; q2 < take; ++q2) {
          int64_t pos = pb.run_pos[lo + q2];
          int32_t partner = pb.run_partner[lo + q2];
          ia_dt[dt_cursor + q2] = pb.t[pos] - p->clock[partner];
        }
        // windows start 4-aligned: the device reads the prefix list as
        // f32[4] row gathers (ops/wire.expand_dedup)
        dt_cursor += (take + 3) & ~int64_t{3};
      }
    }
  }

  // --- events + slot maps ------------------------------------------------
  for (int64_t i = 0; i < b_bucket; ++i) {
    bool v = i < braw;
    ev_src[i] = v ? pb.src[i] : 0;
    ev_dst[i] = v ? pb.dst[i] : 0;
    ev_t[i] = v ? pb.t[i] : 0.0f;
    ev_idx_out[i] = v ? (int32_t)pb.ev_idx[i] : 0;
    ev_valid[i] = v ? 1 : 0;
    ev_src_slot[i] = v ? (int32_t)pb.ev_src_slot[i] : 0;
    ev_pos_slot[i] = v ? (int32_t)pb.ev_pos_slot[i] : 0;
    for (int64_t j = 0; j < M; ++j) {
      ev_neg[i * M + j] = v ? pb.neg[i * M + j] : 0;
      ev_neg_slot[i * M + j] = v ? (int32_t)pb.ev_neg_slot[i * M + j] : 0;
    }
  }

  // --- mailbox write plan, slots only (identity-indexed) -----------------
  {
    const int32_t S = p->S;
    const int64_t W2 = 2 * b_bucket;
    for (int64_t i = 0; i < W2; ++i) mw_slot[i] = -1;
    std::unordered_map<int32_t, std::vector<int64_t>> writes;
    writes.reserve(2 * braw);
    for (int64_t i = 0; write_mail && i < braw; ++i) {
      writes[pb.src[i]].push_back(2 * i);
      writes[pb.dst[i]].push_back(2 * i + 1);
    }
    for (auto& kv : writes) {
      int32_t u = kv.first;
      auto& v = kv.second;
      int64_t kept = std::min<int64_t>((int64_t)v.size(), S);
      int64_t start = (int64_t)v.size() - kept;
      int64_t ptr = p->mail_ptr[u];
      for (int64_t q = 0; q < kept; ++q)
        mw_slot[v[start + q]] = (int32_t)((ptr + q) % S);
      if (insert) p->mail_ptr[u] = (ptr + kept) % S;
    }
  }

  // release the loc_of / run scratch markers
  for (int32_t v : pb.uniq) { p->loc_of[v] = -1; p->run_lo[v] = -1; }

  if (insert) {
    insert_impl(p, pb.src.data(), pb.dst.data(), pb.t.data(),
                pb.ev_idx.data(), braw);
  }
  pb = PendingBatch();
}

void packer_pack_fill_wire3(
    void* h, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    int64_t u_bucket, int32_t* uniq_nid,
    int32_t* root_loc, int32_t* root_cr,
    int64_t ur_bucket, int32_t* cr_loc, int32_t* cr_feat,
    float* cache_dt, float* self_dt, int64_t ei_bucket, float* ia_dt,
    int32_t* ne_ent, int32_t* intra_lo, int32_t* intra_cnt,
    int32_t* intra_start,
    int32_t* mw_slot) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  fill3_impl(p, b_bucket, r_bucket, insert, write_mail, ev_src, ev_dst,
             ev_t, ev_idx_out, ev_valid, ev_neg, ev_src_slot, ev_pos_slot,
             ev_neg_slot, u_bucket, uniq_nid, root_loc, root_cr,
             ur_bucket, cr_loc, cr_feat, cache_dt, self_dt, ei_bucket,
             ia_dt, ne_ent, intra_lo, intra_cnt, intra_start, mw_slot);
}

void packer_pack_fill_wire(
    void* h, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    int64_t u_bucket, int32_t* uniq_nid, int32_t* root_loc,
    int32_t* cache_loc, int32_t* cache_feat, float* cache_dt,
    float* self_dt,
    int64_t ei_bucket, int32_t* ia_row, int32_t* ia_col, int32_t* ia_loc,
    int32_t* ia_feat, float* ia_dt,
    int32_t* mw_node, int32_t* mw_slot, int32_t* mw_partner, float* mw_t,
    int32_t* mw_eid) {
  fill_wire_impl(h, b_bucket, r_bucket, insert, write_mail, ev_src, ev_dst,
                 ev_t, ev_idx_out, ev_valid, ev_neg, ev_src_slot,
                 ev_pos_slot, ev_neg_slot, u_bucket, uniq_nid, root_loc,
                 cache_loc, cache_feat, cache_dt, self_dt, ei_bucket,
                 ia_row, ia_col, ia_loc, ia_feat, ia_dt, mw_node, mw_slot,
                 mw_partner, mw_t, mw_eid, nullptr, nullptr);
}

// layers > 1 variant: also emits the same-block root-slot indices
void packer_pack_fill_wire2(
    void* h, int64_t b_bucket, int64_t r_bucket, int32_t insert,
    int32_t write_mail,
    int32_t* ev_src, int32_t* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, int32_t* ev_neg,
    int32_t* ev_src_slot, int32_t* ev_pos_slot, int32_t* ev_neg_slot,
    int64_t u_bucket, int32_t* uniq_nid, int32_t* root_loc,
    int32_t* cache_loc, int32_t* cache_feat, float* cache_dt,
    float* self_dt,
    int64_t ei_bucket, int32_t* ia_row, int32_t* ia_col, int32_t* ia_loc,
    int32_t* ia_feat, float* ia_dt,
    int32_t* mw_node, int32_t* mw_slot, int32_t* mw_partner, float* mw_t,
    int32_t* mw_eid, int32_t* cache_rslot, int32_t* ia_rslot) {
  fill_wire_impl(h, b_bucket, r_bucket, insert, write_mail, ev_src, ev_dst,
                 ev_t, ev_idx_out, ev_valid, ev_neg, ev_src_slot,
                 ev_pos_slot, ev_neg_slot, u_bucket, uniq_nid, root_loc,
                 cache_loc, cache_feat, cache_dt, self_dt, ei_bucket,
                 ia_row, ia_col, ia_loc, ia_feat, ia_dt, mw_node, mw_slot,
                 mw_partner, mw_t, mw_eid, cache_rslot, ia_rslot);
}

}  // extern "C"

// ---------------------------------------------------------------- async
// One-deep DedupWire pack-ahead (see AsyncState).  Protocol:
//   submit(events, sticky buckets) -> worker runs begin + bucket ratchet
//   + fill into C++ staging (advancing packer state);
//   wait() -> blocks, returns {fallback, P, R, Ub, Ur, Ei};
//   read() -> copies staging into numpy buffers with the oracle's dtype
//   narrowing (u16_mask bits chosen by python with the same rules).
// Exactly one job may be outstanding; all other entry points wait_idle.

static void run_async_job(Packer* p) {
  AsyncState& a = *p->async;
  int64_t sizes[7] = {0, 0, 0, 0, 0, 0, 0};
  begin_impl(p, a.src.data(), a.dst.data(), a.t.data(), a.ev_idx.data(),
             a.blocks.data(), a.neg.data(), a.braw, a.M, a.eval_mode,
             a.cap_p, sizes);
  const int64_t total_roots = sizes[0], p_exact = sizes[1], U = sizes[2];
  const int64_t n_ur = sizes[4], nnz4 = sizes[6];
  int64_t P = a.cap_p >= 0 ? a.cap_p
                           : std::max(a.st_P, bucket_p(p_exact));
  if (P > 255) {
    // not representable (intra_cnt ships as u8): state untouched, the
    // pending scratch is released by the caller's synchronous re-begin
    a.fallback = 1;
    return;
  }
  a.fallback = 0;
  a.P = P;
  a.R = std::max(a.st_R,
                 bucket_pow2(std::max<int64_t>(total_roots, 1), a.root_lo));
  a.Ub = std::max(a.st_Ub, bucket_pow2(U + 1, a.root_lo));
  a.Ur = std::max(a.st_Ur, bucket_pow2(n_ur + 1, a.root_lo));
  a.Ei = std::max(a.st_Ei,
                  bucket_pow2(std::max<int64_t>(nnz4, 4), 2 * a.B));
  const int64_t B = a.B, M = a.M;
  const int32_t K = p->K;
  DedupStaging& o = a.out;
  o.ev_src.resize(B);
  o.ev_dst.resize(B);
  o.ev_t.resize(B);
  o.ev_idx_out.resize(B);
  o.ev_valid.resize(B);
  o.ev_neg.resize(B * M);
  o.ev_src_slot.resize(B);
  o.ev_pos_slot.resize(B);
  o.ev_neg_slot.resize(B * M);
  o.uniq_nid.resize(a.Ub);
  o.root_loc.resize(a.R);
  o.root_cr.resize(a.R);
  o.cr_loc.resize(a.Ur * K);
  o.cr_feat.resize(a.Ur * K);
  o.cache_dt.resize(a.R * K);
  o.self_dt.resize(a.R);
  o.ia_dt.resize(a.Ei);
  o.ne_ent.resize(2 * B * 2);
  o.intra_lo.resize(a.R);
  o.intra_cnt.resize(a.R);
  o.intra_start.resize(a.R);
  o.mw_slot.resize(2 * B);
  fill3_impl(p, B, a.R, a.insert, a.write_mail,
             o.ev_src.data(), o.ev_dst.data(), o.ev_t.data(),
             o.ev_idx_out.data(), o.ev_valid.data(), o.ev_neg.data(),
             o.ev_src_slot.data(), o.ev_pos_slot.data(),
             o.ev_neg_slot.data(),
             a.Ub, o.uniq_nid.data(), o.root_loc.data(), o.root_cr.data(),
             a.Ur, o.cr_loc.data(), o.cr_feat.data(),
             o.cache_dt.data(), o.self_dt.data(), a.Ei, o.ia_dt.data(),
             o.ne_ent.data(), o.intra_lo.data(), o.intra_cnt.data(),
             o.intra_start.data(), o.mw_slot.data());
}

static void async_worker_main(Packer* p) {
  AsyncState& a = *p->async;
  std::unique_lock<std::mutex> lk(a.mu);
  for (;;) {
    a.cv.wait(lk, [&] { return a.stop || a.busy; });
    if (a.stop) return;
    lk.unlock();
    run_async_job(p);
    lk.lock();
    a.busy = false;
    a.ready = true;
    a.cv.notify_all();
  }
}

extern "C" {

int32_t packer_dedup_submit(
    void* h, const int32_t* src, const int32_t* dst, const float* t,
    const int64_t* ev_idx, const int32_t* blocks, const int32_t* neg,
    int64_t braw, int64_t m, int32_t eval_mode, int64_t cap_p,
    int32_t insert, int32_t write_mail, int64_t b_bucket,
    int64_t root_lo, const int64_t* sticky5) {
  auto* p = static_cast<Packer*>(h);
  wait_idle(p);
  if (!p->async) {
    p->async.reset(new AsyncState());
    p->async->worker = std::thread(async_worker_main, p);
  }
  AsyncState& a = *p->async;
  a.src.assign(src, src + braw);
  a.dst.assign(dst, dst + braw);
  a.t.assign(t, t + braw);
  a.ev_idx.assign(ev_idx, ev_idx + braw);
  a.blocks.assign(blocks, blocks + braw);
  a.neg.assign(neg, neg + braw * m);
  a.braw = braw;
  a.M = m;
  a.eval_mode = eval_mode;
  a.cap_p = cap_p;
  a.insert = insert;
  a.write_mail = write_mail;
  a.B = b_bucket;
  a.root_lo = root_lo;
  a.st_P = sticky5[0];
  a.st_R = sticky5[1];
  a.st_Ub = sticky5[2];
  a.st_Ur = sticky5[3];
  a.st_Ei = sticky5[4];
  {
    std::lock_guard<std::mutex> lk(a.mu);
    a.busy = true;
    a.ready = false;
  }
  a.cv.notify_all();
  return 1;
}

// Blocks until the submitted job completes.  dims = {fallback, P, R,
// Ub, Ur, Ei}.  A fallback result is self-consuming (nothing to read).
// Called with no job outstanding (no submit, or the result already
// consumed), reports fallback instead of dereferencing null /
// blocking forever (ADVICE r4) — the caller then packs synchronously.
void packer_dedup_wait(void* h, int64_t* dims) {
  auto* p = static_cast<Packer*>(h);
  if (!p->async) {
    dims[0] = 1;
    return;
  }
  AsyncState& a = *p->async;
  std::unique_lock<std::mutex> lk(a.mu);
  if (!a.busy && !a.ready) {
    dims[0] = 1;
    return;
  }
  a.cv.wait(lk, [&] { return a.ready; });
  dims[0] = a.fallback;
  dims[1] = a.P;
  dims[2] = a.R;
  dims[3] = a.Ub;
  dims[4] = a.Ur;
  dims[5] = a.Ei;
  if (a.fallback) a.ready = false;
}

static void cp_narrow(const std::vector<int32_t>& src, void* dst,
                      bool u16) {
  if (u16) {
    auto* d = static_cast<uint16_t*>(dst);
    for (size_t i = 0; i < src.size(); ++i) d[i] = (uint16_t)src[i];
  } else {
    std::memcpy(dst, src.data(), src.size() * 4);
  }
}

// u16_mask bits (python chooses with the exact enc() rules of the numpy
// oracle): 0 node ids (ev_src/ev_dst/ev_neg), 1 root slots, 2 uniq_nid,
// 3 root_loc, 4 root_cr, 5 cr_loc, 6 intra_lo, 7 intra_start,
// 8 mw_slot-as-u8 (S <= 254; -1 encodes as 255).
void packer_dedup_read(
    void* h, int64_t u16_mask,
    void* ev_src, void* ev_dst, float* ev_t, int32_t* ev_idx_out,
    uint8_t* ev_valid, void* ev_neg,
    void* ev_src_slot, void* ev_pos_slot, void* ev_neg_slot,
    void* uniq_nid, void* root_loc, void* root_cr, void* cr_loc,
    int32_t* cr_feat, float* cache_dt, float* self_dt, float* ia_dt,
    int32_t* ne_ent, void* intra_lo, uint8_t* intra_cnt,
    void* intra_start, void* mw_slot) {
  auto* p = static_cast<Packer*>(h);
  if (!p->async) return;  // no job ever submitted (ADVICE r4)
  AsyncState& a = *p->async;
  DedupStaging& o = a.out;
  const bool bn = u16_mask & 1, bs = u16_mask & 2;
  cp_narrow(o.ev_src, ev_src, bn);
  cp_narrow(o.ev_dst, ev_dst, bn);
  cp_narrow(o.ev_neg, ev_neg, bn);
  cp_narrow(o.ev_src_slot, ev_src_slot, bs);
  cp_narrow(o.ev_pos_slot, ev_pos_slot, bs);
  cp_narrow(o.ev_neg_slot, ev_neg_slot, bs);
  cp_narrow(o.uniq_nid, uniq_nid, u16_mask & 4);
  cp_narrow(o.root_loc, root_loc, u16_mask & 8);
  cp_narrow(o.root_cr, root_cr, u16_mask & 16);
  cp_narrow(o.cr_loc, cr_loc, u16_mask & 32);
  cp_narrow(o.intra_lo, intra_lo, u16_mask & 64);
  cp_narrow(o.intra_start, intra_start, u16_mask & 128);
  std::memcpy(ev_t, o.ev_t.data(), o.ev_t.size() * 4);
  std::memcpy(ev_idx_out, o.ev_idx_out.data(), o.ev_idx_out.size() * 4);
  std::memcpy(ev_valid, o.ev_valid.data(), o.ev_valid.size());
  std::memcpy(cr_feat, o.cr_feat.data(), o.cr_feat.size() * 4);
  std::memcpy(cache_dt, o.cache_dt.data(), o.cache_dt.size() * 4);
  std::memcpy(self_dt, o.self_dt.data(), o.self_dt.size() * 4);
  std::memcpy(ia_dt, o.ia_dt.data(), o.ia_dt.size() * 4);
  std::memcpy(ne_ent, o.ne_ent.data(), o.ne_ent.size() * 4);
  for (size_t i = 0; i < o.intra_cnt.size(); ++i)
    intra_cnt[i] = (uint8_t)o.intra_cnt[i];
  if (u16_mask & 256) {
    auto* d = static_cast<uint8_t*>(mw_slot);
    for (size_t i = 0; i < o.mw_slot.size(); ++i)
      d[i] = o.mw_slot[i] >= 0 ? (uint8_t)o.mw_slot[i] : (uint8_t)255;
  } else {
    std::memcpy(mw_slot, o.mw_slot.data(), o.mw_slot.size() * 4);
  }
  std::lock_guard<std::mutex> lk(a.mu);
  a.ready = false;
}

}  // extern "C"
