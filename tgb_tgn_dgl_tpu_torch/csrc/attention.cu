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
//   the entry points refuse a larger H with cudaErrorInvalidValue.
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
// Backward: one thread per (r, h) reads el' in its (R, Kp, H) layout, so
// the 8 heads of a root are 8 neighbouring floats and a warp reads whole
// 32-byte sectors at each k; two passes over the row (the second from
// L1/L2).
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
// lane with t == 0 of the same head vector.
struct Seat {
  int lanes, width, G, t, src;
};

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
  const long long first =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * (32 / lanes);
  if (first >= R) return;  // the whole warp leaves
  const long long r = first + lane / lanes;
  const int lr = lane % lanes;
  Seat seat;
  seat.lanes = lanes;
  seat.width = H / V;          // head vectors per column (<= lanes)
  seat.G = lanes / seat.width;  // lanes per head vector
  seat.t = lr / seat.width;
  seat.src = lane - lr + lr % seat.width;
  const int G = seat.G, t = seat.t;
  const bool active = r < R && t < G;
  const int h = (lr % seat.width) * V;  // first head of this lane
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

template <bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ el, const float* __restrict__ er,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ dm, const float* __restrict__ a,
                     const float* __restrict__ g, float* __restrict__ d_el,
                     float* __restrict__ d_er, int R, int Kp, int H,
                     float slope) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * H) return;
  const long long r = idx / H;
  const long long base = r * Kp * H + (idx - r * H);
  const uint8_t* m = mask + r * Kp;
  const float erv = er[idx];
  const float gv = g[idx];

  // out = sum_k a_k dm_k e_k:  da_k = g dm_k e_k;  softmax backward needs
  // s = sum_k a_k da_k
  float s = 0.f;
  for (int k = 0; k < Kp; ++k) {
    const long long o = base + (long long)k * H;
    const float gd = DROP ? gv * dm[o] : gv;
    s += a[o] * gd * el[o];
  }

  // dl_k = a_k (da_k - s); leaky backward on x = e + er; masked columns get
  // no logit gradient; the direct term of d e_k is a_k dm_k g
  float der = 0.f;
  for (int k = 0; k < Kp; ++k) {
    const long long o = base + (long long)k * H;
    const float e = el[o];
    const float ak = a[o];
    const float gd = DROP ? gv * dm[o] : gv;
    float dx = 0.f;
    if (m[k]) {
      const float dl = ak * (gd * e - s);
      dx = (e + erv) >= 0.f ? dl : dl * slope;
    }
    d_el[o] = dx + ak * gd;
    der += dx;
  }
  d_er[idx] = der;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
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
  const int HV = H / V;
  // lanes per root slot: the fewest (a power of two) that hold the row in
  // one chunk, so that the reductions take the fewest shuffles
  const int per_lane = lane_floats(DROP) / V;
  const int need = HV * (Kp > per_lane ? (Kp + per_lane - 1) / per_lane : 1);
  int lanes = 1;
  while (lanes < need && lanes < 32) lanes *= 2;
  const long long warps = ((long long)R + 32 / lanes - 1) / (32 / lanes);
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
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

inline int blocks_for(int R, int H) {
  return (int)(((long long)R * H + kThreads - 1) / kThreads);
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
  attention_bwd_kernel<false>
      <<<blocks_for(R, H), kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)el, (const float*)er, (const uint8_t*)mask, nullptr,
          (const float*)a, (const float*)g, (float*)d_el, (float*)d_er, R, Kp,
          H, slope);
  return (int)cudaGetLastError();
}

int attention_bwd_drop(const void* el, const void* er, const void* mask,
                       const void* dm, const void* a, const void* g,
                       void* d_el, void* d_er, int R, int Kp, int H,
                       float slope, void* stream) {
  attention_bwd_kernel<true>
      <<<blocks_for(R, H), kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)el, (const float*)er, (const uint8_t*)mask,
          (const float*)dm, (const float*)a, (const float*)g, (float*)d_el,
          (float*)d_er, R, Kp, H, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
