// Node-range-owned streaming state — native backend (libowned_state-<hash>.so,
// built by ops/_build.py).  The port's copy of
// tgb_tgn_dgl_tpu/csrc/owned_state.cpp: only the comments that name paths
// differ.
//
// C++ twin of parallel/owned_state.py::NodeRangeOwnedState, the scalable
// multi-host state-maintenance design (SURVEY.md §7 phase 5): host h
// maintains recency-cache/clock/mailbox rows ONLY for its node range
// [lo, hi), so per-host heavy work is O(owned touches) ≈ total/N_hosts
// instead of the replicated exchange's O(total events) replay
// (parallel/multihost.py).  The numpy class remains the oracle
// (tests/test_torch_multihost.py holds it row-equal to the serial packer);
// this port exists because the numpy apply loop measured ~10x the C++
// replay constant (tgb_tgn_dgl_tpu's BASELINE.md "multi-host host-work
// scaling"), burying
// the design's asymptotic win under interpreter overhead.
//
// Parity contract: owned rows must match the serial packer's rows
// bit-for-bit after every batch.  The cache merge mirrors
// packer.cpp::insert_impl exactly (eid-desc two-way merge, cache wins
// ties, dst-half before src-half per event), filtered to owned
// endpoints; clocks replay the serial per-block write order
// (negatives -> dst -> src, reference model_utils.py:77-83; eval mode:
// global wipe to the block max time); mail ring pointers advance by
// min(touches, S) per owned node per batch.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct OwnedState {
  int64_t N;        // global node count (for reference only)
  int64_t lo, hi;   // owned node range
  int32_t K, S;
  std::vector<int32_t> cache_nbr;  // (n_own, K)
  std::vector<int64_t> cache_eid;  // (n_own, K)
  std::vector<float> cache_t;      // (n_own, K)
  std::vector<float> clock;        // (n_own,)
  std::vector<int64_t> mail_ptr;   // (n_own,)
  // scratch: per-owned-node linked-list head into the current batch's
  // entry array (-1 outside apply), plus per-node touch counts
  std::vector<int32_t> ins_head;
  std::vector<int32_t> touch_cnt;
  int64_t merge_entries = 0;  // heavy-work meter (owned merge inputs)

  bool owns(int64_t u) const { return u >= lo && u < hi; }
};

// Owned-filtered twin of packer.cpp::insert_impl.  Requires e_id
// non-decreasing within the call (stream order); violations degrade to
// per-event calls, which are trivially ordered.
void owned_insert(OwnedState* o, const int32_t* src, const int32_t* dst,
                  const float* t, const int64_t* e_id, int64_t b) {
  if (b == 0) return;
  for (int64_t i = 1; i < b; ++i) {
    if (e_id[i] < e_id[i - 1]) {
      for (int64_t j = 0; j < b; ++j)
        owned_insert(o, src + j, dst + j, t + j, e_id + j, 1);
      return;
    }
  }
  const int32_t K = o->K;
  std::vector<int32_t> next(2 * b);
  std::vector<int32_t> touched;
  touched.reserve(2 * b);
  auto prepend = [&](int64_t u, int32_t ent) {
    if (!o->owns(u)) return;
    int64_t r = u - o->lo;
    if (o->ins_head[r] < 0) touched.push_back((int32_t)r);
    next[ent] = o->ins_head[r];
    o->ins_head[r] = ent;
    ++o->merge_entries;
  };
  // prepend src-half then dst-half walking events FORWARD: each owned
  // node's list comes out eid-DESC with dst-half first on equal eid —
  // the exact candidate order insert_impl documents.
  for (int64_t i = 0; i < b; ++i) {
    prepend(src[i], (int32_t)(2 * i + 1));
    prepend(dst[i], (int32_t)(2 * i));
  }
  std::vector<int64_t> tmp_eid(K);
  std::vector<int32_t> tmp_nbr(K);
  std::vector<float> tmp_t(K);
  for (int32_t r : touched) {
    const int64_t base = (int64_t)r * K;
    for (int32_t j = 0; j < K; ++j) {
      tmp_eid[j] = o->cache_eid[base + j];
      tmp_nbr[j] = o->cache_nbr[base + j];
      tmp_t[j] = o->cache_t[base + j];
    }
    int32_t c = 0;
    int32_t ent = o->ins_head[r];
    int32_t taken_new = 0;
    for (int32_t j = 0; j < K; ++j) {
      int64_t ne = -1;
      if (ent >= 0 && taken_new < K) ne = e_id[ent >> 1];
      if (ne > tmp_eid[c]) {
        int64_t i = ent >> 1;
        o->cache_eid[base + j] = ne;
        o->cache_nbr[base + j] = (ent & 1) ? dst[i] : src[i];
        o->cache_t[base + j] = t[i];
        ent = next[ent];
        ++taken_new;
      } else {
        o->cache_eid[base + j] = tmp_eid[c];
        o->cache_nbr[base + j] = tmp_nbr[c];
        o->cache_t[base + j] = tmp_t[c];
        ++c;
      }
    }
    o->ins_head[r] = -1;
  }
}

}  // namespace

extern "C" {

void* owned_new(int64_t num_nodes, int64_t lo, int64_t hi, int32_t k,
                int32_t s) {
  auto* o = new OwnedState();
  o->N = num_nodes;
  o->lo = lo;
  o->hi = hi;
  o->K = k;
  o->S = s;
  int64_t n_own = hi - lo;
  o->cache_nbr.assign(n_own * k, 0);
  o->cache_eid.assign(n_own * k, -1);
  o->cache_t.assign(n_own * k, -1.0f);
  o->clock.assign(n_own, 0.0f);
  o->mail_ptr.assign(n_own, 0);
  o->ins_head.assign(n_own, -1);
  o->touch_cnt.assign(n_own, 0);
  return o;
}

void owned_free(void* h) { delete static_cast<OwnedState*>(h); }

// Train-epoch-start reset: cache + mail ring clear, clocks persist
// (packer.cpp packer_reset semantics — reference neighbor_loader.py:
// 106-109, time_assoc never reset).
void owned_reset_cache(void* h) {
  auto* o = static_cast<OwnedState*>(h);
  std::fill(o->cache_eid.begin(), o->cache_eid.end(), int64_t{-1});
  std::fill(o->cache_t.begin(), o->cache_t.end(), -1.0f);
  std::fill(o->mail_ptr.begin(), o->mail_ptr.end(), int64_t{0});
}

// Load the owned range's rows from a serial packer's full-N state
// (arrays are the FULL (N, K)/(N,) serial arrays; this copies the
// [lo, hi) slice) — used to re-seed owners after a serially-executed
// phase (e.g. the inherited eval protocol advanced the serial packer).
void owned_load_from_serial(void* h, const int32_t* nbr,
                            const int64_t* eid, const float* t,
                            const float* clock, const int64_t* mail_ptr) {
  auto* o = static_cast<OwnedState*>(h);
  const int32_t K = o->K;
  int64_t n_own = o->hi - o->lo;
  std::memcpy(o->cache_nbr.data(), nbr + o->lo * K, n_own * K * 4);
  std::memcpy(o->cache_eid.data(), eid + o->lo * K, n_own * K * 8);
  std::memcpy(o->cache_t.data(), t + o->lo * K, n_own * K * 4);
  std::memcpy(o->clock.data(), clock + o->lo, n_own * 4);
  std::memcpy(o->mail_ptr.data(), mail_ptr + o->lo, n_own * 8);
}

// Consume one batch of the GLOBAL stream in serial semantics, updating
// owned rows only.  neg is (braw, m) row-major; e_id is the global
// event id per event (stream order).
void owned_apply_batch(void* h, const int32_t* src, const int32_t* dst,
                       const float* t, const int64_t* e_id,
                       const int32_t* blocks, const int32_t* neg,
                       int64_t braw, int64_t m, int32_t eval_mode) {
  auto* o = static_cast<OwnedState*>(h);
  if (braw == 0) return;

  // ---- clocks: serial per-block write order (neg -> dst -> src per
  // block; fancy-assignment = last-occurrence-wins, which a forward
  // walk reproduces).  Events within a block keep stream order.
  int32_t k = 0;
  for (int64_t i = 0; i < braw; ++i) k = std::max(k, blocks[i] + 1);
  std::vector<int64_t> blk_ptr(k + 1, 0);
  for (int64_t i = 0; i < braw; ++i) ++blk_ptr[blocks[i] + 1];
  for (int32_t i = 0; i < k; ++i) blk_ptr[i + 1] += blk_ptr[i];
  std::vector<int64_t> ev_by_block(braw);
  {
    std::vector<int64_t> cur(blk_ptr.begin(), blk_ptr.end() - 1);
    for (int64_t i = 0; i < braw; ++i) ev_by_block[cur[blocks[i]]++] = i;
  }
  auto wr = [&](int64_t u, float v) {
    if (o->owns(u)) o->clock[u - o->lo] = v;
  };
  for (int32_t bi = 0; bi < k; ++bi) {
    int64_t a = blk_ptr[bi], e = blk_ptr[bi + 1];
    if (a == e) continue;
    if (eval_mode) {
      float mx = t[ev_by_block[a]];
      for (int64_t j = a; j < e; ++j)
        mx = std::max(mx, t[ev_by_block[j]]);
      std::fill(o->clock.begin(), o->clock.end(), mx);
    } else {
      for (int64_t j = a; j < e; ++j) {
        int64_t i = ev_by_block[j];
        for (int64_t q = 0; q < m; ++q) wr(neg[i * m + q], t[i]);
      }
    }
    for (int64_t j = a; j < e; ++j) {
      int64_t i = ev_by_block[j];
      wr(dst[i], t[i]);
    }
    for (int64_t j = a; j < e; ++j) {
      int64_t i = ev_by_block[j];
      wr(src[i], t[i]);
    }
  }

  // ---- mail ring pointers: advance min(#touches, S) per owned node
  // (touch = appearing as either endpoint anywhere in the batch)
  std::vector<int32_t> seen;
  seen.reserve(2 * braw);
  auto touch = [&](int64_t u) {
    if (!o->owns(u)) return;
    int64_t r = u - o->lo;
    if (o->touch_cnt[r] == 0) seen.push_back((int32_t)r);
    ++o->touch_cnt[r];
  };
  for (int64_t i = 0; i < braw; ++i) {
    touch(src[i]);
    touch(dst[i]);
  }
  for (int32_t r : seen) {
    int64_t kept = std::min<int64_t>(o->touch_cnt[r], o->S);
    o->mail_ptr[r] = (o->mail_ptr[r] + kept) % o->S;
    o->touch_cnt[r] = 0;
  }

  // ---- cache rows: owned-endpoint last-K-by-eid merge
  owned_insert(o, src, dst, t, e_id, braw);
}

// Gather owned rows for the pack-time boundary exchange.  Rows whose
// node falls outside [lo, hi) are left untouched and flagged 0 in
// out_owned — the caller overlays each owner's contribution.
void owned_get_rows(void* h, const int64_t* nodes, int64_t n,
                    int32_t* out_nbr, int64_t* out_eid, float* out_t,
                    float* out_clock, uint8_t* out_owned) {
  auto* o = static_cast<OwnedState*>(h);
  const int32_t K = o->K;
  for (int64_t i = 0; i < n; ++i) {
    int64_t u = nodes[i];
    if (!o->owns(u)) {
      out_owned[i] = 0;
      continue;
    }
    out_owned[i] = 1;
    int64_t r = u - o->lo;
    std::memcpy(out_nbr + i * K, o->cache_nbr.data() + r * K, K * 4);
    std::memcpy(out_eid + i * K, o->cache_eid.data() + r * K, K * 8);
    std::memcpy(out_t + i * K, o->cache_t.data() + r * K, K * 4);
    out_clock[i] = o->clock[r];
  }
}

// Mail ring pointers for an arbitrary node set (pack-time gather for
// the scratch pack's write plan).
void owned_get_mail(void* h, const int64_t* nodes, int64_t n,
                    int64_t* out_ptr, uint8_t* out_owned) {
  auto* o = static_cast<OwnedState*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t u = nodes[i];
    if (!o->owns(u)) {
      out_owned[i] = 0;
      continue;
    }
    out_owned[i] = 1;
    out_ptr[i] = o->mail_ptr[u - o->lo];
  }
}

// Full owned-state dump for tests/snapshots (arrays sized n_own).
void owned_get_state(void* h, int32_t* nbr, int64_t* eid, float* t,
                     float* clock, int64_t* mail_ptr,
                     int64_t* merge_entries) {
  auto* o = static_cast<OwnedState*>(h);
  std::memcpy(nbr, o->cache_nbr.data(), o->cache_nbr.size() * 4);
  std::memcpy(eid, o->cache_eid.data(), o->cache_eid.size() * 8);
  std::memcpy(t, o->cache_t.data(), o->cache_t.size() * 4);
  std::memcpy(clock, o->clock.data(), o->clock.size() * 4);
  std::memcpy(mail_ptr, o->mail_ptr.data(), o->mail_ptr.size() * 8);
  *merge_entries = o->merge_entries;
}

}  // extern "C"
