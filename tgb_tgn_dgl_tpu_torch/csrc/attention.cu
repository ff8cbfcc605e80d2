// Fused masked row attention (scalar-message mode) for Hopper, sm_90a.
//
// For every root slot r and head h over its Kp in-edge columns k:
//
//     x[r,k,h]   = leaky_relu(el'[r,k,h] + er[r,h], slope)
//     a[r,k,h]   = softmax over the valid k (mask[r,k]); 0 where masked
//     out[r,h]   = sum_k a[r,k,h] * dm[r,k,h] * el'[r,k,h]     (dm = 1 without dropout)
//
// Entry points and the TPU kernels they replace
// (tgb_tgn_dgl_tpu/ops/pallas_attention.py):
//
//   attention_fwd        _fwd_kernel       :52  (launched by _run_fwd       :132)
//   attention_fwd_infer  _fwd_kernel       :52  (the same, without the residual a)
//   attention_bwd        _bwd_kernel       :68  (launched by _run_bwd       :160)
//   attention_fwd_drop   _fwd_kernel_drop  :88  (launched by _run_fwd_drop  :189)
//   attention_bwd_drop   _bwd_kernel_drop  :112 (launched by _run_bwd_drop  :218)
//
// Bound: every entry point is a row reduction of about 10-15 float ops per
// element of el' against 4-12 bytes moved per element, so bytes bound it on
// the H100 (3.35 TB/s).  Each input read once and each output written once,
// at the main path's shapes:
//
//   attention_fwd_infer  eval chunk (40960, 43, 8): el' 56.36 MB, er, mask
//                        and out 4.38 MB -> 60.7 MB, 18.1 us
//   attention_fwd        eval chunk: the above plus a 56.36 MB -> 117.1 MB,
//                        35.0 us; train batch (6144, 43, 8): 17.6 MB, 5.2 us
//   attention_fwd_drop   train batch: el', dm, a 8.45 MB each -> 26.0 MB, 7.8 us
//   attention_bwd        train batch: el', a, d_el' -> 26.2 MB, 7.8 us
//   attention_bwd_drop   train batch: plus dm -> 34.7 MB, 10.4 us
//
// Forward design.  Root r's row el'[r, :, :] is Kp*H contiguous floats
// (1,376 B at Kp=43, H=8); it is read from memory once, into registers.
// - Loads.  When H % 4 == 0 and the float pointers are 16-byte aligned a
//   lane reads float4s, else single floats (the same template, chosen at
//   launch).  With W = H/4 (or H) vectors per column, a row is given the
//   fewest lanes (a power of two, `lanes`) that hold it in one chunk of 48
//   floats a lane (24 with dm); lane l of the row holds head vector l % W
//   at columns l/W, l/W + G, l/W + 2G, ... (G = lanes/W), so a lane keeps
//   its heads and each load instruction covers contiguous spans.  At
//   (Kp, H) = (43, 8): 8 lanes a row, 4 rows a warp, 11 float4s a lane
//   (with dm: 16 lanes, 2 rows, 6 float4s of each).  Every load of a lane
//   is issued before any value is used and none is guarded (out-of-range
//   lanes re-read the last column or root slot, masked out), so a warp
//   has 5.5 KB in flight at once, against the ~15 KB per SM that Little's
//   law asks of 3.35 TB/s.
// - Math, on values held in registers, in the TPU kernel's three steps:
//   the max (leaky is monotone on each side of 0, so the largest logit is
//   that of the largest or the smallest valid el' of the row, the same
//   bits without a pass of leaky over the row); then exp and sum, one
//   ex2.approx a value; then a = p * (1 / sum) and out.  Reductions
//   across the lanes of a head vector are xor shuffles (2 levels at H=8,
//   3 with dm), each shared by the rows of a warp.
// - Stores.  a is written with the same float4 pattern; out[r, :] by the
//   first lane of each head vector.
// - A row too long for one chunk (Kp*H above 32 lanes x 48 floats, as
//   train.max_intra_block: None allows) is taken in chunks with a running
//   (max, sum, out) per lane, merged across lanes at the end; only a
//   second read of the row for a.
// - H is at most 32 (kMaxHeads), so a row's head vectors fit one warp;
//   every entry point refuses a larger H with cudaErrorInvalidValue.
// Instruction count is the second limit at these shapes: about 12
// instructions per element, so branches, guarded loads, expf and the
// select of leaky are all kept out of the inner loops.
// A persistent variant that stages each row group in a shared-memory ring
// (one cp.async.bulk per tensor, an mbarrier per stage) was slower on the
// H100 at every footprint tried: its registers and stages leave 8 warps
// an SM, against 16 here, and each warp's reductions then sit between
// its copies (PERF.md, PR 2).
//
// attention_fwd_infer is the same kernel without the store of a: at an
// eval chunk that halves the bytes moved.
//
// Backward design.  With gd = g * dm (dm = 1 without dropout):
//
//     s[r,h]      = sum_k a gd el'
//     dx[r,k,h]   = leaky'(el' + er) * a * (gd el' - s), 0 where masked
//     d_el'[r,k,h] = dx + a gd,        d_er[r,h] = sum_k dx
//
// It reads el', a (and dm) once and writes d_el' once: 26.2 MB at the train
// batch, 34.7 MB with dm, so bytes bound it (7.8 and 10.4 us at
// 3.35 TB/s), at about 14 float ops an element.  It takes the forward's
// seats: a row on the fewest lanes that hold its el', a (and dm) in
// bwd_lane_floats floats of each a lane, head vector l % W of lane l at
// columns t, t + G, ..., float4s when H % 4 == 0 and every float pointer
// is 16-byte aligned.  Every load of the lane is issued first, unguarded
// and clamped; the lane's partial s is finished by the xor shuffles of its
// head vector; then dx and d_el' are formed in registers, d_el' stored
// with the forward's float4 pattern, and the partial sums of dx reduced
// the same way for d_er.  One pass over memory; no max or exp is needed.
// A row longer than 32 lanes of one chunk is swept twice: the chunks for
// s, then each chunk again (from L2) for d_el' and d_er; s is a plain sum,
// so no running merge.  With dm a lane holds three tensors, and s must be
// reduced before any d_el' exists, so the row stays live across the
// shuffles: bwd_lane_floats keeps the float4 variants under 96 registers,
// more than 16 warps an SM.  At (Kp, H) = (43, 8): 16 lanes a row (32
// with dm), 6 float4s of each tensor a lane (4 with dm).
//
// Fully masked rows (padded root slots) give out = 0, a = 0 and zero
// gradients, as on the TPU: the max stays at -1e30, the sum at 0, and the
// clamp max(sum, 1e-30) keeps the quotient 0.  The (R, Kp) bool mask is
// read directly (no int32 broadcast over H) and any Kp is taken.
//
// The dropout multiplier dm is drawn by the caller (torch.Generator),
// pre-scaled to 1/keep or 0, and passed in as an (R, Kp, H) float tensor.
//
// C interface for ctypes: pointers and the stream are void*, every entry
// point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeads = 32;  // the forward's largest H: a warp's lanes

// Floats of el' a lane holds in registers per chunk.  With dm a lane holds
// two registers per float, and 48 would halve the drop variant's warps an
// SM.  Chosen by timing 16, 24, 32 and 48 on the H100.
__host__ __device__ constexpr int lane_floats(bool drop) {
  return drop ? 24 : 48;
}

// Floats of each of el', a (and dm) a lane holds in registers per chunk in
// the backward.  Chosen by timing 12 to 48 at the train batch on the H100
// (sweep_attention_bwd.py, PERF.md): the times differ by at most 7%, and
// 48 spills in the float template; 16 and 24 spill in no variant.
__host__ __device__ constexpr int bwd_lane_floats(bool drop) {
  return drop ? 16 : 24;
}

// x >= 0 ? x : x * slope, as one min/max: for slope <= 1 (up) the larger
// of x and x * slope, for slope > 1 the smaller
__device__ __forceinline__ float leaky(float x, float slope, bool up) {
  const float y = x * slope;
  return up ? fmaxf(x, y) : fminf(x, y);
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; results below 2^-126
// flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&d)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else {
    d[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    p[0] = d[0];
  }
}

// Where a lane sits in its row's segment of the warp: the segment has
// `lanes` lanes (a power of two), G lanes hold each of its `width` head
// vectors, the lane is the t-th of its head vector's, and `src` is the
// lane with t == 0 of the same head vector, the hv-th of the column.
struct Seat {
  int lanes, width, G, t, src, hv;
};

// The seat of `lane` (0-31) in a segment of `lanes` lanes that holds
// `width` head vectors of a column
__device__ __forceinline__ Seat take_seat(int lane, int lanes, int width) {
  const int lr = lane % lanes;
  Seat s;
  s.lanes = lanes;
  s.width = width;  // <= lanes
  s.G = lanes / width;
  s.t = lr / width;
  s.hv = lr % width;
  s.src = lane - lr + s.hv;
  return s;
}

// The first root slot of this thread's warp, when 32 / lanes share it
__device__ __forceinline__ long long warp_first_row(int lanes) {
  return ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * (32 / lanes);
}

// Max (MAX) or sum of v over the G lanes of each head vector; every lane
// gets the result.  A butterfly when the G lanes fill the segment (G and
// width are then powers of two), else a tree into t == 0 and a broadcast.
template <bool MAX, int V>
__device__ __forceinline__ void group_reduce(float (&v)[V], const Seat& s) {
  if (s.G * s.width == s.lanes) {
    for (int off = s.width; off < s.lanes; off *= 2) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = __shfl_xor_sync(kFull, v[j], off);
        v[j] = MAX ? fmaxf(v[j], o) : v[j] + o;
      }
    }
    return;
  }
  int half = 1;
  while (2 * half < s.G) half *= 2;
  for (int off = half; off > 0; off /= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float o = __shfl_down_sync(kFull, v[j], off * s.width);
      if (s.t + off < s.G) v[j] = MAX ? fmaxf(v[j], o) : v[j] + o;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __shfl_sync(kFull, v[j], s.src);
}

// V = 4: float4 loads and stores; V = 1: floats.  DROP: read dm.
// STORE_A: write the residual a.  `lanes` (chosen at launch) is the
// number of lanes per root slot: 32 / lanes root slots share a warp.
template <int V, bool DROP, bool STORE_A>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ el, const float* __restrict__ er,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ dm, float* __restrict__ out,
                     float* __restrict__ a, int R, int Kp, int H, int lanes,
                     float slope) {
  constexpr int NV = lane_floats(DROP) / V;  // vectors a lane holds per chunk
  const int lane = threadIdx.x % 32;
  const long long first = warp_first_row(lanes);
  if (first >= R) return;  // the whole warp leaves
  const long long r = first + lane / lanes;
  const Seat seat = take_seat(lane, lanes, H / V);
  const int G = seat.G, t = seat.t;  // lanes per head vector, rank in it
  const bool active = r < R && t < G;
  const int h = seat.hv * V;  // first head of this lane
  const int cols = G * NV;                    // columns per chunk
  const int chunks = (Kp + cols - 1) / cols;
  const bool up = slope <= 1.f;
  if (Kp == 0) {  // no column: out = 0 (and a is empty)
    if (active && t == 0) {
      float z[V] = {};
      store<V>(out + r * H + h, z);
    }
    return;
  }
  // Loads are not guarded (a guard costs a branch per load): a lane past
  // the last root slot reads the last one, a column past Kp the last
  // column, and ok[] keeps them out of every sum.
  const long long rl = r < R ? r : R - 1;
  const long long row = rl * Kp * H + h;  // el'[rl, 0, h]
  const uint8_t* m = mask + rl * Kp;

  float erv[V];
  load<V>(er + rl * H + h, erv);

  // lane's columns of chunk c: k = c * cols + t + G * i, i < NV
  float e[NV][V], d[NV][V], p[NV][V];
  bool ok[NV];
  // all loads of a chunk are issued before any is used
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = c * cols + t + G * i;
      const int kc = min(k, Kp - 1);
      load<V>(el + row + (long long)kc * H, e[i]);
      if (DROP) load<V>(dm + row + (long long)kc * H, d[i]);
      ok[i] = (__ldg(m + kc) != 0) & active & (k < Kp);
    }
  };
  // raises mx to the largest logit of the chunk's valid columns: leaky is
  // monotone on each side of 0, so that is the logit of the largest or of
  // the smallest el' (the same float ops, so the same bits).  Masked
  // columns enter as NaN, which fmaxf and fminf pass over.
  auto chunk_max = [&](float(&mx)[V]) {
    float hi[V], lo[V];
#pragma unroll
    for (int j = 0; j < V; ++j) hi[j] = lo[j] = __int_as_float(0x7fffffff);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float em = ok[i] ? e[i][j] : __int_as_float(0x7fffffff);
        hi[j] = fmaxf(hi[j], em);
        lo[j] = fminf(lo[j], em);
      }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (hi[j] == hi[j])  // not NaN: the chunk has a valid column
        mx[j] = fmaxf(mx[j], fmaxf(leaky(hi[j] + erv[j], slope, up),
                                   leaky(lo[j] + erv[j], slope, up)));
  };
  // p = exp(x - mx) on the valid columns, 0 elsewhere; s += p,
  // acc += p dm e
  auto exps = [&](const float(&mx)[V], float(&s)[V], float(&acc)[V]) {
    float nm[V];
#pragma unroll
    for (int j = 0; j < V; ++j) nm[j] = -mx[j] * kLog2e;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = leaky(e[i][j] + erv[j], slope, up);
        const float q = ok[i] ? ex2(fmaf(x, kLog2e, nm[j])) : 0.f;
        p[i][j] = q;
        s[j] += q;
        acc[j] = fmaf(DROP ? q * d[i][j] : q, e[i][j], acc[j]);
      }
  };
  auto store_a = [&](int c, const float(&inv)[V]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = c * cols + t + G * i;
      if (active && k < Kp) {
        float av[V];
#pragma unroll
        for (int j = 0; j < V; ++j) av[j] = p[i][j] * inv[j];
        store<V>(a + row + (long long)k * H, av);
      }
    }
  };

  float mx[V], s[V], acc[V], inv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mx[j] = kNegInf;
    s[j] = 0.f;
    acc[j] = 0.f;
  }
  if (chunks <= 1) {
    // the row is in registers: the max, then exp and sum, then a and out
    load_chunk(0);
    chunk_max(mx);
    group_reduce<true>(mx, seat);
    exps(mx, s, acc);
  } else {
    // a long row: a running (max, sum, acc) per lane over the chunks,
    // merged across lanes
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c);
      float cm[V];
#pragma unroll
      for (int j = 0; j < V; ++j) cm[j] = mx[j];
      chunk_max(cm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ex2((mx[j] - cm[j]) * kLog2e);
        s[j] *= f;
        acc[j] *= f;
        mx[j] = cm[j];
      }
      exps(mx, s, acc);
    }
    float g[V];
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = mx[j];
    group_reduce<true>(g, seat);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = ex2((mx[j] - g[j]) * kLog2e);
      s[j] *= f;
      acc[j] *= f;
      mx[j] = g[j];
    }
  }
  group_reduce<false>(s, seat);
  group_reduce<false>(acc, seat);
#pragma unroll
  for (int j = 0; j < V; ++j) inv[j] = 1.f / fmaxf(s[j], 1e-30f);
  if (STORE_A) {
    if (chunks <= 1) {
      store_a(0, inv);
    } else {
      // a second read of the long row for a
      for (int c = 0; c < chunks; ++c) {
        float s2[V] = {}, acc2[V] = {};
        load_chunk(c);
        exps(mx, s2, acc2);
        store_a(c, inv);
      }
    }
  }
  if (active && t == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] *= inv[j];
    store<V>(out + r * H + h, acc);
  }
}

// V and DROP as in the forward; `lanes` as there, from bwd_lane_floats.
template <int V, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ el, const float* __restrict__ er,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ dm, const float* __restrict__ a,
                     const float* __restrict__ g, float* __restrict__ d_el,
                     float* __restrict__ d_er, int R, int Kp, int H, int lanes,
                     float slope) {
  constexpr int NV = bwd_lane_floats(DROP) / V;  // vectors per tensor
  const int lane = threadIdx.x % 32;
  const long long first = warp_first_row(lanes);
  if (first >= R) return;  // the whole warp leaves
  const long long r = first + lane / lanes;
  const Seat seat = take_seat(lane, lanes, H / V);
  const int G = seat.G, t = seat.t;
  const bool active = r < R && t < G;
  const int h = seat.hv * V;
  const int cols = G * NV;
  const int chunks = (Kp + cols - 1) / cols;
  if (Kp == 0) {  // no column: d_er = 0 (and d_el' is empty)
    if (active && t == 0) {
      float z[V] = {};
      store<V>(d_er + r * H + h, z);
    }
    return;
  }
  // unguarded loads, as in the forward: past the last root slot or column
  // a lane re-reads the last one, and in[] keeps it out of s and the stores
  const long long rl = r < R ? r : R - 1;
  const long long row = rl * Kp * H + h;
  const uint8_t* m = mask + rl * Kp;

  float erv[V], gv[V];
  load<V>(er + rl * H + h, erv);
  load<V>(g + rl * H + h, gv);

  // lane's columns of chunk c: k = c * cols + t + G * i, i < NV
  float e[NV][V], p[NV][V], d[NV][V];  // el', a, dm
  bool in[NV], ok[NV];                 // in the row; and not masked
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = c * cols + t + G * i;
      const long long o = row + (long long)min(k, Kp - 1) * H;
      load<V>(el + o, e[i]);
      load<V>(a + o, p[i]);
      if (DROP) load<V>(dm + o, d[i]);
      in[i] = active & (k < Kp);
      ok[i] = in[i] & (__ldg(m + min(k, Kp - 1)) != 0);
    }
  };
  // the lane's part of s = sum_k a gd el'
  auto chunk_s = [&](float(&s)[V]) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gd = DROP ? gv[j] * d[i][j] : gv[j];
        s[j] = fmaf(in[i] ? p[i][j] : 0.f, gd * e[i][j], s[j]);
      }
  };
  // dx and d_el' of the chunk's columns; der += dx
  auto chunk_grad = [&](int c, const float(&s)[V], float(&der)[V]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float de[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gd = DROP ? gv[j] * d[i][j] : gv[j];
        const float dl = p[i][j] * fmaf(gd, e[i][j], -s[j]);
        const float dx = e[i][j] + erv[j] >= 0.f ? dl : dl * slope;
        const float dxm = ok[i] ? dx : 0.f;
        der[j] += dxm;
        de[j] = fmaf(p[i][j], gd, dxm);
      }
      if (in[i]) store<V>(d_el + row + (long long)(c * cols + t + G * i) * H,
                          de);
    }
  };

  float s[V], der[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = der[j] = 0.f;
  if (chunks <= 1) {
    // the row is in registers: s, then d_el' and the parts of d_er
    load_chunk(0);
    chunk_s(s);
    group_reduce<false>(s, seat);
    chunk_grad(0, s, der);
  } else {
    // a long row: a sweep for s, a second (from L2) for the gradients
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c);
      chunk_s(s);
    }
    group_reduce<false>(s, seat);
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c);
      chunk_grad(c, s, der);
    }
  }
  group_reduce<false>(der, seat);
  if (active && t == 0) store<V>(d_er + r * H + h, der);
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Lanes per root slot: the fewest (a power of two, at most 32) that hold a
// row of Kp columns of HV head vectors at per_lane vectors a lane, so that
// the reductions take the fewest shuffles
inline int lanes_for(int per_lane, int HV, int Kp) {
  const int need = HV * (Kp > per_lane ? (Kp + per_lane - 1) / per_lane : 1);
  int lanes = 1;
  while (lanes < need && lanes < 32) lanes *= 2;
  return lanes;
}

// Blocks of kThreads for R root slots, 32 / lanes a warp
inline int blocks_for(int R, int lanes) {
  const long long warps = ((long long)R + 32 / lanes - 1) / (32 / lanes);
  return (int)((warps + kWarps - 1) / kWarps);
}

template <bool DROP, bool STORE_A>
inline int launch_fwd(const void* el, const void* er, const void* mask,
                      const void* dm, void* out, void* a, int R, int Kp,
                      int H, float slope, void* stream) {
  if (H < 1 || H > kMaxHeads) return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && aligned16(el) && aligned16(er) &&
                   aligned16(out) && (!DROP || aligned16(dm)) &&
                   (!STORE_A || aligned16(a));
  const int V = vec ? 4 : 1;
  const int lanes = lanes_for(lane_floats(DROP) / V, H / V, Kp);
  const int blocks = blocks_for(R, lanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    attention_fwd_kernel<4, DROP, STORE_A><<<blocks, kThreads, 0, s>>>(
        (const float*)el, (const float*)er, (const uint8_t*)mask,
        (const float*)dm, (float*)out, (float*)a, R, Kp, H, lanes, slope);
  } else {
    attention_fwd_kernel<1, DROP, STORE_A><<<blocks, kThreads, 0, s>>>(
        (const float*)el, (const float*)er, (const uint8_t*)mask,
        (const float*)dm, (float*)out, (float*)a, R, Kp, H, lanes, slope);
  }
  return (int)cudaGetLastError();
}

template <bool DROP>
inline int launch_bwd(const void* el, const void* er, const void* mask,
                      const void* dm, const void* a, const void* g,
                      void* d_el, void* d_er, int R, int Kp, int H,
                      float slope, void* stream) {
  if (H < 1 || H > kMaxHeads) return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && aligned16(el) && aligned16(er) &&
                   (!DROP || aligned16(dm)) && aligned16(a) && aligned16(g) &&
                   aligned16(d_el) && aligned16(d_er);
  const int V = vec ? 4 : 1;
  const int lanes = lanes_for(bwd_lane_floats(DROP) / V, H / V, Kp);
  const int blocks = blocks_for(R, lanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    attention_bwd_kernel<4, DROP><<<blocks, kThreads, 0, s>>>(
        (const float*)el, (const float*)er, (const uint8_t*)mask,
        (const float*)dm, (const float*)a, (const float*)g, (float*)d_el,
        (float*)d_er, R, Kp, H, lanes, slope);
  } else {
    attention_bwd_kernel<1, DROP><<<blocks, kThreads, 0, s>>>(
        (const float*)el, (const float*)er, (const uint8_t*)mask,
        (const float*)dm, (const float*)a, (const float*)g, (float*)d_el,
        (float*)d_er, R, Kp, H, lanes, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int attention_fwd(const void* el, const void* er, const void* mask, void* out,
                  void* a, int R, int Kp, int H, float slope, void* stream) {
  return launch_fwd<false, true>(el, er, mask, nullptr, out, a, R, Kp, H,
                                 slope, stream);
}

int attention_fwd_infer(const void* el, const void* er, const void* mask,
                        void* out, int R, int Kp, int H, float slope,
                        void* stream) {
  return launch_fwd<false, false>(el, er, mask, nullptr, out, nullptr, R, Kp,
                                  H, slope, stream);
}

int attention_fwd_drop(const void* el, const void* er, const void* mask,
                       const void* dm, void* out, void* a, int R, int Kp,
                       int H, float slope, void* stream) {
  return launch_fwd<true, true>(el, er, mask, dm, out, a, R, Kp, H, slope,
                                stream);
}

int attention_bwd(const void* el, const void* er, const void* mask,
                  const void* a, const void* g, void* d_el, void* d_er, int R,
                  int Kp, int H, float slope, void* stream) {
  return launch_bwd<false>(el, er, mask, nullptr, a, g, d_el, d_er, R, Kp, H,
                           slope, stream);
}

int attention_bwd_drop(const void* el, const void* er, const void* mask,
                       const void* dm, const void* a, const void* g,
                       void* d_el, void* d_er, int R, int Kp, int H,
                       float slope, void* stream) {
  return launch_bwd<true>(el, er, mask, dm, a, g, d_el, d_er, R, Kp, H, slope,
                          stream);
}

}  // extern "C"
