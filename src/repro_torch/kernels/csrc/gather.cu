// Gather + distance for candidate verification on Hopper (sm_90a), and the
// verify's top-k fused behind it: one templated block scan for fp32 rows
// (gather_l2) and int8 rows with a per-row scale (gather_q), with two
// epilogues.
//
// Replaces: src/repro/kernels/gather_l2/gather_l2.py, gather_dist_pallas, and
// src/repro/kernels/gather_q/gather_q.py, gather_dist_q_pallas; the fused
// entries also replace their consumer, `lax.top_k` after the scan
// (src/repro/exec/stages.py:144-188, exact_topk and survivors).  Plain torch
// versions beside them: src/repro_torch/kernels/gather_l2/ref.py and
// src/repro_torch/kernels/gather_q/ref.py.
//
// dist(b, l) = the squared L2 of row(ids[b, l]) and queries[b], or
// 1 - rq / (sqrt(rr) * sqrt(qq)) with unclamped norms (NaN on a zero row),
// where row() is the fp32 row, or the int8 code row times its scale.
//
//   * the scan entries (gather_l2_launch, gather_q_launch) write dist (B, L),
//     negative ids reading row 0 (the wrapper masks them);
//   * the fused entries (gather_l2_topk_launch, gather_q_topk_launch) write
//     the k smallest per query of v = +inf where ids < 0, else sqrt(max(dist,
//     0)) (Euclidean; NaN stays NaN) or dist with NaN -> 1 (angular), ties to
//     the lower slot, as a stable sort orders them: -0.0 equals +0.0, NaN
//     sorts after +inf.  Out: the values (a NaN as the canonical NaN) and
//     report[b, slot]; exact mode maps a non-finite value's id to -1 and pads
//     columns past L with -1 / +inf (`topk_ids`), survivors mode does
//     neither (`_smallest` + gather).  Both entries compute dist with the
//     same device code, so the fused output equals the scan + the plain
//     torch epilogue bit for bit.
//
// What bounds it: device-memory bytes.  Each (query, candidate) pair reads
// one random row (4d bytes fp32, d + 4 bytes int8) and does 3d flops; at one
// verify batch (1,000 x 100, d 128) that is ~48 MB fp32 and ~12 MB int8, so
// the time is set by how many row loads are in flight, i.e. by memory-level
// parallelism, and for int8 by latency.
//
// Design:
//   * one block a query (a tile of its candidates), the query row staged once
//     in shared memory and the tile's ids read in one coalesced load;
//   * G lanes a candidate, G sized to the row so that each lane holds up to
//     kChunks 16-byte chunks (d 128: 8 lanes of four float4, or 2 lanes of
//     four int4 codes): no idle lanes, and a warp scans 32 / G candidates;
//   * every row load (and scale load) of a group's candidate is issued
//     before any arithmetic, and a thread holds one candidate's chunks only,
//     so registers stay few enough for a verify batch's blocks (one a
//     query) to be resident, and their loads in flight, at once;
//   * the metric is a template parameter: the Euclidean scan keeps one
//     accumulator, the angular two (the query's norm is summed once);
//   * fused entries: each slot's value becomes a 64-bit key (ordered value
//     bits << 32 | slot) in shared memory; up to kRankMax keys each key's
//     rank (the count of smaller keys, read as shared-memory broadcasts) is
//     its output column, above that a bitonic sort of pow2 >= L keys orders
//     them; only the first k are written: (B, k) out, no (B, L) pass.  Above
//     kMaxTile keys the tiles are sorted in turn, merged by a bitonic merge
//     across tiles (global and shared-memory stages), and emitted.
//
// Rows are read as 16-byte chunks when d and the base pointer allow aligned
// rows (d % 4 == 0 fp32, d % 16 == 0 int8), else element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a block
constexpr int kChunks = 4;         // chunk loads a lane holds a candidate
constexpr int kScanTile = 512;     // slots a block of the scan entries
constexpr int kMaxTile = 8192;     // keys a block of the fused entries
constexpr int kRankMax = 1024;     // up to this many keys, ranked by counting
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kPadKey = ~0ull;

// ---- rows --------------------------------------------------------------

struct F32Vec {  // fp32 rows in float4 chunks
  static constexpr int kElems = 4;
  using Chunk = float4;
  const float* data;
  __device__ __forceinline__ float scale(int) const { return 1.f; }
  __device__ __forceinline__ Chunk load(int id, int d, int c) const {
    return __ldg(reinterpret_cast<const float4*>(data + (long long)id * d) + c);
  }
  template <class Acc>
  __device__ __forceinline__ void add(Acc& acc, const Chunk& r, float, const float* qs,
                                      int c) const {
    float4 q = reinterpret_cast<const float4*>(qs)[c];
    acc.add(r.x, q.x); acc.add(r.y, q.y); acc.add(r.z, q.z); acc.add(r.w, q.w);
  }
};

struct F32Elem {  // fp32 rows element by element
  static constexpr int kElems = 1;
  using Chunk = float;
  const float* data;
  __device__ __forceinline__ float scale(int) const { return 1.f; }
  __device__ __forceinline__ Chunk load(int id, int d, int c) const {
    return __ldg(data + (long long)id * d + c);
  }
  template <class Acc>
  __device__ __forceinline__ void add(Acc& acc, const Chunk& r, float, const float* qs,
                                      int c) const {
    acc.add(r, qs[c]);
  }
};

// int8 codes times the row's scale, dequantized in registers: a rounded
// product, then the distance (no contraction into the subtraction)
__device__ __forceinline__ float deq(int c, float s) { return __fmul_rn((float)c, s); }

struct I8Vec {  // int8 rows in int4 chunks of 16 codes
  static constexpr int kElems = 16;
  using Chunk = int4;
  const int8_t* codes;
  const float* scales;
  __device__ __forceinline__ float scale(int id) const { return __ldg(scales + id); }
  __device__ __forceinline__ Chunk load(int id, int d, int c) const {
    return __ldg(reinterpret_cast<const int4*>(codes + (long long)id * d) + c);
  }
  template <class Acc>
  __device__ __forceinline__ void add(Acc& acc, const Chunk& r, float s, const float* qs,
                                      int c) const {
    const float4* q4 = reinterpret_cast<const float4*>(qs) + 4 * c;
    const int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 q = q4[u];
      acc.add(deq((int8_t)(w[u]), s), q.x);
      acc.add(deq((int8_t)(w[u] >> 8), s), q.y);
      acc.add(deq((int8_t)(w[u] >> 16), s), q.z);
      acc.add(deq((int8_t)(w[u] >> 24), s), q.w);
    }
  }
};

struct I8Elem {  // int8 rows code by code
  static constexpr int kElems = 1;
  using Chunk = int8_t;
  const int8_t* codes;
  const float* scales;
  __device__ __forceinline__ float scale(int id) const { return __ldg(scales + id); }
  __device__ __forceinline__ Chunk load(int id, int d, int c) const {
    return __ldg(codes + (long long)id * d + c);
  }
  template <class Acc>
  __device__ __forceinline__ void add(Acc& acc, const Chunk& r, float s, const float* qs,
                                      int c) const {
    acc.add(deq(r, s), qs[c]);
  }
};

// ---- metrics -----------------------------------------------------------

__device__ __forceinline__ float group_sum(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

struct L2 {
  static constexpr bool kNeedsNorm = false;
  float dd = 0.f;
  __device__ __forceinline__ void add(float r, float q) {
    float t = r - q;
    dd = fmaf(t, t, dd);
  }
  __device__ __forceinline__ float finish(int G, float) const { return group_sum(dd, G); }
  // Euclidean: sqrt(clamp(d, min=0)), the clamp as a compare so NaN stays NaN
  static __device__ __forceinline__ float fix(float d) { return sqrtf(d < 0.f ? 0.f : d); }
};

struct Cos {
  static constexpr bool kNeedsNorm = true;
  float rq = 0.f, rr = 0.f;
  __device__ __forceinline__ void add(float r, float q) {
    rq = fmaf(r, q, rq);
    rr = fmaf(r, r, rr);
  }
  __device__ __forceinline__ float finish(int G, float qq) const {
    float a = group_sum(rq, G), b = group_sum(rr, G);
    return 1.f - a / (sqrtf(b) * sqrtf(qq));
  }
  // angular: a zero row's NaN -> 1
  static __device__ __forceinline__ float fix(float d) { return d != d ? 1.f : d; }
};

// ---- keys --------------------------------------------------------------

// float -> uint32 in the float order, -0.0 folded into +0.0 and every NaN
// made the canonical NaN (above +inf); and back
__device__ __forceinline__ uint32_t ordered(float v) {
  if (v != v) v = __int_as_float(0x7fc00000);
  if (v == 0.f) v = 0.f;
  uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the bitonic network's stages (size kk from k_lo to k_hi, strides j from
// min(kk / 2, j_hi) down to 1) over s[0, n) of the block, n a power of two;
// `base` is s[0]'s index in the whole row, which sets each pair's direction
__device__ void bitonic(uint64_t* s, int n, long long base, int k_lo, int k_hi, int j_hi) {
  for (int kk = k_lo; kk <= k_hi; kk <<= 1) {
    for (int j = min(kk >> 1, j_hi); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
        int i = 2 * j * (p / j) + p % j;
        bool up = ((base + i) & kk) == 0;
        uint64_t a = s[i], b = s[i + j];
        if ((a > b) == up) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

struct Out {  // the fused entries' outputs
  const int32_t* report;  // (B, L): the id written for slot l
  int32_t* ids;           // (B, k)
  float* vals;            // (B, k)
  int k;
  bool exact;             // topk_ids' -1 for a non-finite value
};

// column r of query b's output from its r-th smallest key; rep: the row's
// report ids (in shared memory, or the row of o.report)
__device__ __forceinline__ void emit(const Out& o, int b, int L, int r, uint64_t key,
                                     const int32_t* rep) {
  int32_t id = -1;
  float v = __int_as_float(0x7f800000);  // +inf padding past L
  if (r < L) {
    v = unordered((uint32_t)(key >> 32));
    id = rep[(uint32_t)key];
    if (o.exact && !isfinite(v)) id = -1;
  }
  o.ids[(long long)b * o.k + r] = id;
  o.vals[(long long)b * o.k + r] = v;
}

// ---- the block scan ----------------------------------------------------

struct Args {
  const int32_t* ids;      // (B, L)
  const float* queries;    // (B, d)
  float* dist;             // scan entries: (B, L)
  Out out;                 // fused entries
  uint64_t* keys;          // fused entries above one tile: (B, Lp) scratch
  int d, L, tile, tiles, G_log2;
};

// One block: query b's slots [s0, s0 + n).  Group g of G lanes scans slots
// g, g + NG, ... of the tile, each lane's chunk loads (and the scale load)
// issued before any arithmetic; the distance of each slot goes to its
// group's lane 0, which calls put(slot - s0, live, dist).
template <class Rows, class Acc, class Put>
__device__ void scan_tile(const Rows& rows, const Args& a, const float* qs,
                          const int32_t* ids_s, int n, bool skip_negative, Put put) {
  const int G = 1 << a.G_log2;
  const int NG = blockDim.x >> a.G_log2;
  const int group = threadIdx.x >> a.G_log2, lane = threadIdx.x & (G - 1);
  const int C = a.d / Rows::kElems;  // chunks a row

  float qq = 0.f;  // the query's squared norm, summed as rr is
  if constexpr (Acc::kNeedsNorm) {
    Cos q;
    for (int c0 = 0; c0 < C; c0 += G * kChunks)
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int c = c0 + j * G + lane;
        if (c < C) {
          const float* qc = qs + c * Rows::kElems;
#pragma unroll
          for (int e = 0; e < Rows::kElems; ++e) q.add(qc[e], qc[e]);
        }
      }
    qq = group_sum(q.rr, G);
  }

  for (int base = 0; base < n; base += NG) {  // the same count on every lane
    int slot = base + group;
    int id = slot < n ? ids_s[slot] : -1;
    bool live = slot < n && (id >= 0 || !skip_negative);
    if (id < 0) id = 0;  // negative ids read row 0
    float s = live ? rows.scale(id) : 0.f;
    Acc acc;
    for (int c0 = 0; c0 < C; c0 += G * kChunks) {
      typename Rows::Chunk r[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int c = c0 + j * G + lane;
        if (live && c < C) r[j] = rows.load(id, a.d, c);
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int c = c0 + j * G + lane;
        if (live && c < C) rows.add(acc, r[j], s, qs, c);
      }
    }
    float v = acc.finish(G, qq);  // every lane joins the shuffles
    if (lane == 0 && slot < n) put(slot, live, v);
  }
}

// stage the query row and the tile's ids (and, given rep_s, its report ids)
// in shared memory; returns n
__device__ int stage(const Args& a, int b, int s0, float* qs, int32_t* ids_s,
                     int32_t* rep_s = nullptr) {
  const float* q = a.queries + (long long)b * a.d;
  for (int k = threadIdx.x; k < a.d; k += blockDim.x) qs[k] = q[k];
  int n = min(a.tile, a.L - s0);
  long long row = (long long)b * a.L + s0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ids_s[i] = a.ids[row + i];
    if (rep_s) rep_s[i] = a.out.report[row + i];
  }
  __syncthreads();
  return n;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <class Rows, class Acc>
__global__ void __launch_bounds__(kThreads)
gather_scan_kernel(Rows rows, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  int32_t* ids_s = reinterpret_cast<int32_t*>(smem + align16(a.d * sizeof(float)));
  int b = blockIdx.x / a.tiles, s0 = (blockIdx.x % a.tiles) * a.tile;
  int n = stage(a, b, s0, qs, ids_s);
  float* out = a.dist + (long long)b * a.L + s0;
  scan_tile<Rows, Acc>(rows, a, qs, ids_s, n, false,
                       [&](int i, bool, float v) { out[i] = v; });
}

// Fused: tile t of query b sorts its keys (pow2 >= L of them when one tile
// holds the row) and either writes the first k (one tile) or stores the
// sorted tile into the (B, Lp) scratch, for the merge stages.
template <class Rows, class Acc>
__global__ void __launch_bounds__(kThreads)
gather_topk_kernel(Rows rows, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  size_t off = align16(a.d * sizeof(float)), ints = align16(a.tile * sizeof(int32_t));
  int32_t* ids_s = reinterpret_cast<int32_t*>(smem + off);
  int32_t* rep_s = reinterpret_cast<int32_t*>(smem + off + ints);  // one tile: report ids
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + off + 2 * ints);
  int b = blockIdx.x / a.tiles, s0 = (blockIdx.x % a.tiles) * a.tile;
  int n = s0 < a.L ? stage(a, b, s0, qs, ids_s, a.tiles == 1 ? rep_s : nullptr) : 0;
  scan_tile<Rows, Acc>(rows, a, qs, ids_s, n, true, [&](int i, bool live, float v) {
    float w = live ? Acc::fix(v) : __int_as_float(0x7f800000);
    keys[i] = ((uint64_t)ordered(w) << 32) | (uint32_t)(s0 + i);
  });
  __syncthreads();
  if (a.tiles == 1 && n <= kRankMax) {
    // the key's rank among the row's n distinct keys is its output column
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint64_t key = keys[i];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < n; ++j) rank += keys[j] < key;
      if (rank < a.out.k) emit(a.out, b, a.L, rank, key, rep_s);
    }
    for (int r = n + threadIdx.x; r < a.out.k; r += blockDim.x)
      emit(a.out, b, a.L, r, kPadKey, rep_s);
    return;
  }
  for (int i = n + threadIdx.x; i < a.tile; i += blockDim.x) keys[i] = kPadKey;
  __syncthreads();
  bitonic(keys, a.tile, s0, 2, a.tile, a.tile);
  if (a.tiles == 1) {
    for (int r = threadIdx.x; r < a.out.k; r += blockDim.x)
      emit(a.out, b, a.L, r, r < a.L ? keys[r] : kPadKey, rep_s);
  } else {
    uint64_t* dst = a.keys + (long long)b * a.tiles * a.tile + s0;
    for (int i = threadIdx.x; i < a.tile; i += blockDim.x) dst[i] = keys[i];
  }
}

// merge stages of size kk across tiles: one stride j >= tile (global) ...
__global__ void gather_merge_global_kernel(uint64_t* keys, int B, int Lp, int kk, int j) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * (Lp / 2)) return;
  uint64_t* row = keys + (t / (Lp / 2)) * Lp;
  int p = (int)(t % (Lp / 2));
  int i = 2 * j * (p / j) + p % j;
  bool up = (i & kk) == 0;
  uint64_t x = row[i], y = row[i + j];
  if ((x > y) == up) {
    row[i] = y;
    row[i + j] = x;
  }
}

// ... and every stride below the tile, in shared memory
__global__ void __launch_bounds__(kThreads)
gather_merge_tile_kernel(uint64_t* keys, int tiles, int tile, int kk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);
  long long s0 = (long long)(blockIdx.x % tiles) * tile;
  uint64_t* src = keys + (long long)(blockIdx.x / tiles) * tiles * tile + s0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  bitonic(s, tile, s0, kk, kk, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) src[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
gather_emit_kernel(const uint64_t* keys, int Lp, int L, Out o) {
  int b = blockIdx.x;
  for (int r = threadIdx.x; r < o.k; r += blockDim.x)
    emit(o, b, L, r, r < L ? keys[(long long)b * Lp + r] : kPadKey,
         o.report + (long long)b * L);
}

// ---- host --------------------------------------------------------------

int pow2_at_least(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// lanes a candidate: a power of two, so that a lane holds up to kChunks chunks
int lanes_log2(int chunks) {
  int g = 0;
  while ((1 << g) < 32 && (1 << g) * kChunks < chunks) ++g;
  return g;
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <class Rows, class Acc>
int run_scan(Rows rows, Args a, int B, cudaStream_t st) {
  a.tile = min(a.L, kScanTile);
  a.tiles = (a.L + a.tile - 1) / a.tile;
  size_t smem = align16(a.d * sizeof(float)) + a.tile * sizeof(int32_t);
  int err = set_smem(gather_scan_kernel<Rows, Acc>, smem);
  if (err) return err;
  long long blocks = (long long)B * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_scan_kernel<Rows, Acc><<<(unsigned)blocks, kThreads, smem, st>>>(rows, a);
  return (int)cudaGetLastError();
}

template <class Rows, class Acc>
int run_topk(Rows rows, Args a, int B, int max_tile, cudaStream_t st) {
  int Lp = pow2_at_least(a.L);
  a.tile = min(Lp, max_tile);
  a.tiles = Lp / a.tile;
  if (a.tiles > 1 && a.keys == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = align16(a.d * sizeof(float)) + 2 * align16(a.tile * sizeof(int32_t)) +
                (size_t)a.tile * sizeof(uint64_t);
  int err = set_smem(gather_topk_kernel<Rows, Acc>, smem);
  if (err) return err;
  long long blocks = (long long)B * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_topk_kernel<Rows, Acc><<<(unsigned)blocks, kThreads, smem, st>>>(rows, a);
  if (a.tiles == 1) return (int)cudaGetLastError();
  size_t tile_smem = (size_t)a.tile * sizeof(uint64_t);
  if ((err = set_smem(gather_merge_tile_kernel, tile_smem))) return err;
  long long pairs = (long long)B * (Lp / 2);
  for (int kk = 2 * a.tile; kk <= Lp; kk <<= 1) {
    for (int j = kk >> 1; j >= a.tile; j >>= 1)
      gather_merge_global_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
          a.keys, B, Lp, kk, j);
    gather_merge_tile_kernel<<<(unsigned)blocks, kThreads, tile_smem, st>>>(
        a.keys, a.tiles, a.tile, kk);
  }
  gather_emit_kernel<<<B, kThreads, 0, st>>>(a.keys, Lp, a.L, a.out);
  return (int)cudaGetLastError();
}

template <class Rows, class Acc>
int run(Rows rows, Args a, int B, int max_tile, bool topk, cudaStream_t st) {
  return topk ? run_topk<Rows, Acc>(rows, a, B, max_tile, st) : run_scan<Rows, Acc>(rows, a, B, st);
}

template <class Rows>
int dispatch(Rows rows, Args a, int B, int max_tile, bool topk, int angular, void* stream) {
  a.G_log2 = lanes_log2(a.d / Rows::kElems);
  cudaStream_t st = (cudaStream_t)stream;
  return angular ? run<Rows, Cos>(rows, a, B, max_tile, topk, st)
                 : run<Rows, L2>(rows, a, B, max_tile, topk, st);
}

int check(int d, int B, int L, int k, int max_tile) {
  if (d < 1 || B < 0 || L < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (max_tile < 2 || max_tile > kMaxTile || (max_tile & (max_tile - 1)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

Args make_args(const void* ids, const void* queries, int d, int L) {
  Args a{};
  a.ids = (const int32_t*)ids;
  a.queries = (const float*)queries;
  a.d = d;
  a.L = L;
  return a;
}

int gather_f32(const void* data, Args a, int B, int max_tile, bool topk, int angular,
               void* stream) {
  if (a.d % 4 == 0 && (uintptr_t)data % 16 == 0)
    return dispatch(F32Vec{(const float*)data}, a, B, max_tile, topk, angular, stream);
  return dispatch(F32Elem{(const float*)data}, a, B, max_tile, topk, angular, stream);
}

int gather_i8(const void* codes, const void* scale, Args a, int B, int max_tile, bool topk,
              int angular, void* stream) {
  const int8_t* c = (const int8_t*)codes;
  const float* s = (const float*)scale;
  if (a.d % 16 == 0 && (uintptr_t)codes % 16 == 0)
    return dispatch(I8Vec{c, s}, a, B, max_tile, topk, angular, stream);
  return dispatch(I8Elem{c, s}, a, B, max_tile, topk, angular, stream);
}

}  // namespace

extern "C" int gather_l2_launch(const void* data, const void* ids, const void* queries,
                                void* out, int n, int d, int B, int Lc, int angular,
                                void* stream) {
  (void)n;
  if (int err = check(d, B, Lc, 0, kMaxTile)) return err;
  if (B == 0 || Lc == 0) return (int)cudaSuccess;
  Args a = make_args(ids, queries, d, Lc);
  a.dist = (float*)out;
  return gather_f32(data, a, B, kMaxTile, false, angular, stream);
}

extern "C" int gather_q_launch(const void* codes, const void* scale, const void* ids,
                               const void* queries, void* out, int n, int d, int B, int Lc,
                               int angular, void* stream) {
  (void)n;
  if (int err = check(d, B, Lc, 0, kMaxTile)) return err;
  if (B == 0 || Lc == 0) return (int)cudaSuccess;
  Args a = make_args(ids, queries, d, Lc);
  a.dist = (float*)out;
  return gather_i8(codes, scale, a, B, kMaxTile, false, angular, stream);
}

// out_ids, out_vals (B, k); keys: a (B, pow2 >= L) int64 scratch when that
// exceeds `tile` keys, else null; exact 1 for exact_topk, 0 for survivors
extern "C" int gather_l2_topk_launch(const void* data, const void* ids, const void* report,
                                     const void* queries, void* out_ids, void* out_vals,
                                     void* keys, int n, int d, int B, int L, int k, int tile,
                                     int angular, int exact, void* stream) {
  (void)n;
  if (int err = check(d, B, L, k, tile)) return err;
  if (B == 0 || L == 0 || k == 0) return (int)cudaSuccess;
  Args a = make_args(ids, queries, d, L);
  a.out = Out{(const int32_t*)report, (int32_t*)out_ids, (float*)out_vals, k, exact != 0};
  a.keys = (uint64_t*)keys;
  return gather_f32(data, a, B, tile, true, angular, stream);
}

extern "C" int gather_q_topk_launch(const void* codes, const void* scale, const void* ids,
                                    const void* report, const void* queries, void* out_ids,
                                    void* out_vals, void* keys, int n, int d, int B, int L,
                                    int k, int tile, int angular, int exact, void* stream) {
  (void)n;
  if (int err = check(d, B, L, k, tile)) return err;
  if (B == 0 || L == 0 || k == 0) return (int)cudaSuccess;
  Args a = make_args(ids, queries, d, L);
  a.out = Out{(const int32_t*)report, (int32_t*)out_ids, (float*)out_vals, k, exact != 0};
  a.keys = (uint64_t*)keys;
  return gather_i8(codes, scale, a, B, tile, true, angular, stream);
}
