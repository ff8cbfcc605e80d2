// Backward of the memory-row gather for Hopper, sm_90a.
//
// The forward (ops/gather.py::gather_rows) is out[s, :] = table[idx[s], :]
// over S slots; its backward is a sum by key:
//
//     d_table[u, :] = sum over the slots s with idx[s] == u of g[s, :]
//
// It replaces no TPU kernel: the JAX package leaves this transpose to
// XLA's scatter-add.  On the card, aten's embedding_dense_backward sorts
// the indices, cuts each run into partial sums of 10 slots, and then gives
// each (row, feature) pair one thread that adds all of its row's partials
// one after another.  The packer points every padded column at one trash
// row (57-79% of a train batch's 1,056,768 slots), so that single chain
// paced the whole op (PERF.md §6).
//
// Bound: bytes.  Each slot's gradient row is read once (S x D x 4 B:
// 423 MB at the train batch of 1,056,768 slots, D = 100, fp32) and each
// table row written once (U x D x 4 B, at most 2.9 MB); about one add per
// element read, far below the card's operations per byte.  At 3.35 TB/s
// that is 127 us, the wrapper's sort of the keys aside.
//
// Design.  The wrapper sorts the slots by row with a stable sort, so each
// row's slots stay in slot order, and launches one kernel on the sorted
// keys `key` and the slot of each sorted position `slot`:
// - Chunks.  A warp sums kChunk consecutive sorted slots.  Lanes cover the
//   D features, V at a time (float4 for fp32, four bf16 in 8 bytes, when
//   D % 4 == 0 and the rows are aligned; else one), and a lane has kGroup
//   gradient rows in flight before it adds any.  While the key stays the
//   same the sum stays in registers.  A row that begins and ends inside the
//   chunk is written to the table directly; the chunk's first row (if it
//   began in an earlier chunk) and its last (if it goes on into the next)
//   are written as fp32 partials, part[2c] and part[2c + 1].
// - Tiles.  A block is kWarps chunks.  After its warps' chunks, each row
//   that crosses a chunk boundary but stays inside the tile is summed from
//   its partials by one warp, at most kWarps of them, and written.
// - Across tiles.  A row that crosses a tile boundary (the tile's first
//   row, carried in, and its last, leaving) gets the tile's piece, summed
//   by the whole block: piece[2t] for the carried row, piece[2t + 1] for
//   the leaving one.  After a fence the block counts the piece on the
//   counter of the tile where the row begins; the block that brings the
//   last piece sums them all, in tile order, with the whole block, and
//   writes the row.  A row's finish thus reads its pieces in a fixed order
//   whichever block finishes it.
// So no thread adds more than kChunk values in a chain, whatever the
// largest row's count, save the finish: a row's slots over kChunk kWarps^2
// pieces a lane (102 for the train batch's largest trash row of 830,914
// slots, one for a row below 8,192).  Every sum is taken in an order fixed
// by the keys alone, so two runs give the same bits; no slot is skipped for
// its key or its value.  Sums are fp32 for fp32 and bf16 gradients; the
// table is written in the gradient's type.  The wrapper zeroes the table
// first (rows with no slot stay 0) and the tiles' counters.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// chosen on the H100 at the train batch, kernel alone: 0.225 ms, against
// 0.241-0.357 ms for chunks of 64-256, 4-16 warps, 4-16 rows in flight
// (a sweep of the three on the H100, PERF.md §6)
constexpr int kChunk = 128;  // sorted slots a warp sums
constexpr int kWarps = 8;    // chunks (warps) a block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;    // gradient rows a lane loads before adding
constexpr int kKeysPerLane = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk % 32 == 0 && 32 % kGroup == 0, "chunk layout");

// V values of a row at p, as floats, and back
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Io<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&a);
    x.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

// a piece written by another block: read from L2, past this SM's L1
template <int V>
__device__ inline void load_cg(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// first position in [lo, hi) whose key is >= r (> r with UPPER)
template <bool UPPER>
__device__ inline int bound(const int* key, int lo, int hi, int r) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int k = key[mid];
    if (UPPER ? k <= r : k < r) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Chunk c's sums: rows inside it to `out`, its open first and last rows to
// `part`
template <typename T, int V>
__device__ void chunk_pass(const int* __restrict__ key,
                           const long long* __restrict__ slot,
                           const T* __restrict__ g, T* __restrict__ out,
                           float* __restrict__ part, int S, int D, int c,
                           int lane) {
  const int lo = c * kChunk;
  const int n = min(kChunk, S - lo);
  int k[kKeysPerLane];
  long long sl[kKeysPerLane];
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int q = j * 32 + lane;
    k[j] = q < n ? key[lo + q] : -1;
    sl[j] = q < n ? slot[lo + q] : 0;
  }
  const int kprev = lo > 0 ? key[lo - 1] : -1;
  const int knext = lo + kChunk < S ? key[lo + kChunk] : -1;
  for (int f = lane * V; f - lane * V < D; f += 32 * V) {
    const bool on = f < D;
    float acc[V];
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = 0.f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      for (int t0 = 0; t0 < 32 && j * 32 + t0 < n; t0 += kGroup) {
        float v[kGroup][V];
        int kk[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          kk[i] = __shfl_sync(kFull, k[j], t0 + i);
          const long long s = __shfl_sync(kFull, sl[j], t0 + i);
          if (on && kk[i] >= 0) {
            Io<T, V>::load(g + s * D + f, v[i]);
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x) v[i][x] = 0.f;
          }
        }
        // the key after the group's last position
        const int after = t0 + kGroup < 32
                              ? __shfl_sync(kFull, k[j], (t0 + kGroup) & 31)
                              : (j + 1 < kKeysPerLane
                                     ? __shfl_sync(kFull, k[(j + 1) %
                                                             kKeysPerLane], 0)
                                     : knext);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int r = kk[i];
          if (r < 0) break;  // past the last slot
#pragma unroll
          for (int x = 0; x < V; ++x) acc[x] += v[i][x];
          const int nk = i + 1 < kGroup ? kk[i + 1] : after;
          if (nk == r && j * 32 + t0 + i < kChunk - 1) continue;
          // the row ends here, or the chunk does
          const bool open = (first && kprev == r) || nk == r;
          if (on) {
            if (open)
              Io<float, V>::store(part + (2LL * c + (first ? 0 : 1)) * D + f,
                                  acc);
            else
              Io<T, V>::store(out + (long long)r * D + f, acc);
          }
#pragma unroll
          for (int x = 0; x < V; ++x) acc[x] = 0.f;
          first = false;
        }
      }
    }
  }
}

// The block's sum, into warp 0's lanes, of n rows of fp32 at
// row(i) * D + f: warp w takes rows w, w + kWarps, ..., then warp 0 adds
// the warps' sums in order.  Every thread of the block calls it.
template <int V, bool CG, typename Row>
__device__ void block_sum(const float* base, Row row, int n, int D, int f,
                          bool on, float (*red)[32 * V], float* acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[V];
#pragma unroll
  for (int x = 0; x < V; ++x) s[x] = 0.f;
  if (on) {
#pragma unroll 4
    for (int i = warp; i < n; i += kWarps) {
      float v[V];
      const float* p = base + (long long)row(i) * D + f;
      if (CG) load_cg<V>(p, v); else Io<float, V>::load(p, v);
#pragma unroll
      for (int x = 0; x < V; ++x) s[x] += v[x];
    }
  }
#pragma unroll
  for (int x = 0; x < V; ++x) red[warp][lane * V + x] = s[x];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = 0.f;
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int x = 0; x < V; ++x) acc[x] += red[w][lane * V + x];
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_bwd_kernel(const int* __restrict__ key,
                           const long long* __restrict__ slot,
                           const T* __restrict__ g, T* __restrict__ out,
                           float* part, float* piece, int* done, int S,
                           int D) {
  __shared__ float red[kWarps][32 * V];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const int nch = (S + kChunk - 1) / kChunk;
  const int c_lo = t * kWarps, c_hi = min(nch, c_lo + kWarps);
  const int s_lo = c_lo * kChunk, s_hi = min(S, c_hi * kChunk);

  if (c_lo + warp < c_hi)
    chunk_pass<T, V>(key, slot, g, out, part, S, D, c_lo + warp, lane);
  __syncthreads();

  // rows that cross a chunk boundary and stay in the tile: a warp each
  for (int c = c_lo + warp; c < c_hi; c += kWarps) {
    const int e = (c + 1) * kChunk;
    if (e >= s_hi) continue;  // the tile's end: below
    const int r = key[e];
    if (key[e - 1] != r || (c > 0 && key[c * kChunk - 1] == r)) continue;
    const int hi = bound<true>(key, e, S, r);
    const int c1 = (hi - 1) / kChunk;
    if (c1 >= c_hi) continue;  // the leaving row: below
    const int lo = bound<false>(key, c * kChunk, e, r);
    const int first = 2 * c + (lo % kChunk != 0);
    for (int f = lane * V; f - lane * V < D; f += 32 * V) {
      if (f >= D) continue;
      float acc[V], v[V];
      Io<float, V>::load(part + (long long)first * D + f, acc);
      for (int cc = c + 1; cc <= c1; ++cc) {
        Io<float, V>::load(part + 2LL * cc * D + f, v);
#pragma unroll
        for (int x = 0; x < V; ++x) acc[x] += v[x];
      }
      Io<T, V>::store(out + (long long)r * D + f, acc);
    }
  }

  // rows that cross a tile boundary: the carried one and the leaving one
  const int rc = (s_lo > 0 && key[s_lo - 1] == key[s_lo]) ? key[s_lo] : -1;
  const int rl = (s_hi < S && key[s_hi - 1] == key[s_hi]) ? key[s_hi] : -1;
  for (int which = 0; which < 2; ++which) {
    const int r = which == 0 ? rc : rl;
    if (r < 0 || (which == 1 && rl == rc)) continue;
    // the row's slots [lo, hi) and the tile's entries of it
    const int lo = which == 0 ? bound<false>(key, 0, s_lo, r)
                              : bound<false>(key, s_lo, s_hi, r);
    const int hi = (which == 1 || rl == rc) ? bound<true>(key, s_hi, S, r)
                                            : bound<true>(key, s_lo, s_hi, r);
    const int c0 = max(lo / kChunk, c_lo);
    const int c1 = min((hi - 1) / kChunk, c_hi - 1);
    const int head = 2 * c0 + (which == 1 && lo % kChunk != 0);
    const int b0 = lo / kChunk / kWarps, b1 = (hi - 1) / kChunk / kWarps;
    float* mine = piece + (2LL * t + which) * D;
    for (int f0 = 0; f0 < D; f0 += 32 * V) {
      const int f = f0 + lane * V;
      float acc[V];
      block_sum<V, false>(
          part, [&](int i) { return i == 0 ? head : 2 * (c0 + i); },
          c1 - c0 + 1, D, f, f < D, red, acc);
      if (warp == 0 && f < D) Io<float, V>::store(mine + f, acc);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done + b0, 1) == b1 - b0;
    __syncthreads();
    if (!last) continue;
    __threadfence();
    for (int f0 = 0; f0 < D; f0 += 32 * V) {
      const int f = f0 + lane * V;
      float acc[V];
      block_sum<V, true>(
          piece, [&](int i) { return i == 0 ? 2 * b0 + 1 : 2 * (b0 + i); },
          b1 - b0 + 1, D, f, f < D, red, acc);
      if (warp == 0 && f < D) Io<T, V>::store(out + (long long)r * D + f, acc);
    }
  }
}

inline bool aligned(const void* p, unsigned bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

template <typename T>
inline int launch(const void* key, const void* slot, const void* g,
                  void* out, void* part, void* piece, void* done, int S,
                  int D, cudaStream_t stream) {
  const int nch = (S + kChunk - 1) / kChunk;
  const int tiles = (nch + kWarps - 1) / kWarps;
  const unsigned vb = 4 * sizeof(T);
  const bool vec = D % 4 == 0 && aligned(g, vb) && aligned(out, vb) &&
                   aligned(part, 16) && aligned(piece, 16);
  if (vec) {
    gather_rows_bwd_kernel<T, 4><<<tiles, kThreads, 0, stream>>>(
        (const int*)key, (const long long*)slot, (const T*)g, (T*)out,
        (float*)part, (float*)piece, (int*)done, S, D);
  } else {
    gather_rows_bwd_kernel<T, 1><<<tiles, kThreads, 0, stream>>>(
        (const int*)key, (const long long*)slot, (const T*)g, (T*)out,
        (float*)part, (float*)piece, (int*)done, S, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout the wrapper allocates: part holds 2 x chunks rows of D fp32,
// piece 2 x tiles rows, done `tiles` int32 zeroed
int gather_bwd_chunk_slots() { return kChunk; }
int gather_bwd_tile_chunks() { return kWarps; }

// key (S,) int32 sorted, slot (S,) int64, g (S, D) and out (U, D) of one
// type: fp32 (bf16 = 0) or bf16 (bf16 = 1); out zeroed
int gather_bwd(const void* key, const void* slot, const void* g, void* out,
               void* part, void* piece, void* done, int S, int D, int bf16,
               void* stream) {
  if (S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(key, slot, g, out, part, piece, done,
                                      S, D, s)
              : launch<float>(key, slot, g, out, part, piece, done, S, D, s);
}

}  // extern "C"
