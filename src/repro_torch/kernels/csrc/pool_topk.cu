// Pool top-lambda for Hopper (sm_90a): the CSA probe's dedupe.
//
// Replaces: src/repro/kernels/csa_probe/ref.py:114, dedupe_topk_scatter (jnp
// outside the Pallas kernel, the second half of csa_probe_search,
// src/repro/kernels/csa_probe/ops.py:66-81).  Plain torch version beside it:
// src/repro_torch/kernels/csa_probe/ref.py, pool_topk_plain.
//
// For each row b of a probe pool, ids and lcps (B, pool) int32: drop the
// entries whose id or lcp is < 0, keep each id's largest lcp, and write the
// first k ids ranked by (lcp descending, id ascending) with their lcps, -1 in
// both past the distinct ids, up to `out_cols` columns.
//
// Tiles.  One block takes `chunk` consecutive entries of one row (a tile) and
// writes that tile's own deduped top-k.  This is exact: let x be an id of the
// row's top-k whose max lcp lies in tile t.  Every id that ranks above x
// inside t (by its max lcp inside t) ranks above x in the whole row too,
// because its max over the row is at least its max inside t.  Fewer than k
// ids rank above x in the row, so fewer than k do inside t: x is in t's top-k,
// with its true value.  The union of the tiles' lists therefore holds the
// row's top-k with their true values, and the wrapper runs this kernel again
// over the (B, tiles * k) union until one tile holds it (one merge launch for
// the lccs pool and, at lam up to 480, a 17-probe multiprobe-skip pool).
// chunk >= 2k, so each launch at least halves the pool.
//
// What bounds it: the bytes are one read of the pool and one write of the
// lists, (B pool + B out_cols) * 8 (0.031 ms for 1,000 x 12,800 at 3.35
// TB/s).  A sort of the tile passes over it log2(T) (log2(T) + 1) / 2 times
// in shared memory (105 for T = 16,384: the first version of this kernel,
// a bitonic sort of the tile, took about 0.96 ms there on an H100); the design
// below passes over its table about six times, so shared memory's rate, the
// latency of its atomics and the block barriers between the passes set the
// time.  Tiles of 8,192 entries (the wrapper's default) let two blocks of
// 1,024 threads share an SM.
//
// Design:
//   * the tile is deduped into an open-addressing hash table in shared memory
//     of S = pow2 >= 2 len slots (at most half full), one packed key a slot,
//     (id << 9) | lcp: 4 bytes where every id is below 2^23, else 8 (and
//     tiles of at most 8,192 entries); an atomicCAS claims an empty slot for
//     an id and an atomicMax keeps its largest lcp, so the order of the
//     inserts does not matter.  The pool is read with coalesced 16-byte loads
//     where the rows allow them, and each thread's four inserts of a load
//     advance together;
//   * a histogram of the table over the 257 lcp values, scanned by one warp,
//     gives the lcp of the k-th ranked id (the cut) and how many ids of that
//     lcp the first k hold (take);
//   * a radix select, 8 bits of the id a pass from the top, finds the take-th
//     smallest id of the cut's lcp, so the ties go to the smaller ids without
//     a sort of the tile;
//   * the k chosen keys, repacked as ((256 - lcp) << id_bits) | id, are
//     written in that order: each at the count of chosen keys below it where
//     k <= the block's threads, else after a bitonic sort of P = pow2 >= k.
// lcps above 256 rank as 256 (the probe kernel takes m <= 256).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"  // DeviceOnce

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTile = 16384;  // entries of a tile (8,192 with 8-byte keys)
constexpr int kMaxK = 4096;      // ids kept a tile
constexpr int kMaxLcp = 256;
constexpr int kLcpBits = 9;      // lcp in [0, 256]
constexpr int kPerLane = 9;      // 32 lanes x 9 >= the 257 lcp bins
constexpr int kBinsPad = 32 * kPerLane;
constexpr int kDigits = 256;     // radix of the select
constexpr int kNarrowIds = 1 << 23;  // 4-byte keys below this id bound
constexpr unsigned kFull = 0xffffffffu;

template <class K>
struct Key {
  static constexpr int kIdBits = 8 * (int)sizeof(K) - kLcpBits;
  static constexpr K kNone = ~K(0);  // an empty slot; sorts last by rank
  static constexpr K kIdMask = (K(1) << kIdBits) - 1;
  // the table's slots: at most 128 KB
  static constexpr int kMaxSlots = (int)(128 * 1024 / sizeof(K));
  // the select's first pass: ids below 2^23 (4-byte keys) or 2^31
  static constexpr int kTopShift = sizeof(K) == 4 ? 16 : 24;

  // kNone for a dropped entry
  __device__ static K pack(int32_t id, int32_t lcp) {
    if (id < 0 || lcp < 0) return kNone;
    return (K(id) << kLcpBits) | K(min(lcp, kMaxLcp));
  }
  __device__ static long long id(K key) { return (long long)(key >> kLcpBits); }
  __device__ static int lcp(K key) { return (int)(key & ((K(1) << kLcpBits) - 1)); }
  // (lcp descending, id ascending) order
  __device__ static K by_rank(long long id, int lcp) {
    return (K(kMaxLcp - lcp) << kIdBits) | K(id);
  }
};

template <class K>
size_t smem_bytes(int S, int P) {
  return (size_t)(S + P) * sizeof(K) + (size_t)(kBinsPad + kDigits + 8) * sizeof(int);
}

// Claim a slot of the table tab (2^log2s slots) for each key's id, or raise
// the lcp its slot holds (kNone: nothing to insert).  The U probe sequences
// advance together, so the latencies of their atomics overlap; an atomicCAS
// on an empty slot claims it, on a taken one reads it.
template <class K, int U>
__device__ __forceinline__ void insert(K* tab, int log2s, const K (&key)[U]) {
  using KK = Key<K>;
  const unsigned mask = (1u << log2s) - 1;
  unsigned slot[U];
  bool pending[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    pending[u] = key[u] != KK::kNone;
    slot[u] = ((unsigned)(key[u] >> kLcpBits) * 2654435761u) >> (32 - log2s);
  }
  for (bool any = true; any;) {
    K old[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (pending[u]) old[u] = atomicCAS(&tab[slot[u]], KK::kNone, key[u]);
    any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!pending[u]) continue;
      if (old[u] == KK::kNone) {
        pending[u] = false;
      } else if ((old[u] >> kLcpBits) == (key[u] >> kLcpBits)) {
        if (old[u] < key[u]) atomicMax(&tab[slot[u]], key[u]);
        pending[u] = false;
      } else {
        slot[u] = (slot[u] + 1) & mask;
        any = true;
      }
    }
  }
}

// ascending bitonic sort of s[0, T), T a power of two; starts and ends at a
// block barrier
template <class K>
__device__ void bitonic_sort(K* s, int T) {
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < T / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const K a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One warp over the bins h[0, 32 per): the bin where the running count
// reaches `need` -> out[0], and how many of that bin it takes -> out[1]; out
// is left as it is when need < 1 or the bins hold fewer.
__device__ __forceinline__ void find_bin(const int* h, int per, int need, int lane, int* out) {
  int s = 0;
  for (int c = 0; c < per; ++c) s += h[lane * per + c];
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int before = incl - s;
  if (before < need && need <= incl) {
    for (int c = 0; c < per; ++c) {
      const int v = h[lane * per + c];
      if (before + v >= need) {
        out[0] = lane * per + c;
        out[1] = need - before;
        return;
      }
      before += v;
    }
  }
}

// block blk = b * tiles + t: tile t of row b -> out[blk * out_cols, + out_cols)
template <class K>
__global__ void __launch_bounds__(kThreads, 2)
    pool_topk_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ lcps,
                     int32_t* __restrict__ out_ids, int32_t* __restrict__ out_vals, int pool,
                     int chunk, int tiles, int k, int out_cols, int log2s, int P, int vec) {
  using KK = Key<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << log2s;
  K* tab = reinterpret_cast<K*>(smem);          // S
  K* sel = tab + S;                             // P
  int* hist = reinterpret_cast<int*>(sel + P);  // ids by 256 - lcp, kBinsPad
  int* digits = hist + kBinsPad;                // kDigits
  // [0] the cut's bin (256 - lcp), [1] its ids to take, [2] ids chosen,
  // [3] [4] the select's digit and its count
  int* meta = digits + kDigits;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long blk = blockIdx.x;
  const long long b = blk / tiles;
  const int start = (int)(blk % tiles) * chunk;
  const int len = min(chunk, pool - start);
  const int32_t* row_i = ids + b * pool + start;
  const int32_t* row_l = lcps + b * pool + start;

  for (int j = tid; j < S; j += nt) tab[j] = KK::kNone;
  for (int j = tid; j < P; j += nt) sel[j] = KK::kNone;
  for (int j = tid; j < kBinsPad; j += nt) hist[j] = 0;
  if (tid == 0) {
    meta[0] = -1;
    meta[1] = 0;
    meta[2] = 0;
  }
  __syncthreads();

  // 1. dedupe the tile into the table, four entries a thread at a time
  if (vec) {
    for (int j = 4 * tid; j < len; j += 4 * nt) {
      int4 iv = make_int4(-1, -1, -1, -1), lv = iv;
      if (j + 4 <= len) {
        iv = __ldg(reinterpret_cast<const int4*>(row_i + j));
        lv = __ldg(reinterpret_cast<const int4*>(row_l + j));
      } else {
        iv.x = row_i[j], lv.x = row_l[j];
        if (j + 1 < len) iv.y = row_i[j + 1], lv.y = row_l[j + 1];
        if (j + 2 < len) iv.z = row_i[j + 2], lv.z = row_l[j + 2];
      }
      const K key[4] = {KK::pack(iv.x, lv.x), KK::pack(iv.y, lv.y), KK::pack(iv.z, lv.z),
                        KK::pack(iv.w, lv.w)};
      insert(tab, log2s, key);
    }
  } else {
    for (int j0 = tid; j0 < len; j0 += 4 * nt) {
      K key[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * nt;
        key[u] = j < len ? KK::pack(row_i[j], row_l[j]) : KK::kNone;
      }
      insert(tab, log2s, key);
    }
  }
  __syncthreads();

  // 2. count the table's ids by lcp; 3. the cut: the bin of the k-th ranked
  // id and how many ids of that bin the first k hold (no id: no cut)
  for (int j = tid; j < S; j += nt) {
    const K key = tab[j];
    if (key != KK::kNone) atomicAdd(&hist[kMaxLcp - KK::lcp(key)], 1);
  }
  __syncthreads();
  if (tid < 32) {
    int s = 0;
    for (int c = 0; c < kPerLane; ++c) s += hist[tid * kPerLane + c];
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    find_bin(hist, kPerLane, min(k, s), tid, meta);
  }
  __syncthreads();
  const int cut = meta[0], take = meta[1];
  const int cut_lcp = kMaxLcp - cut;  // 257 without a cut: no lcp reaches it

  // 4. the take-th smallest id of the cut's lcp (no select when all are taken)
  long long last = 0x7fffffffffffffffLL;
  if (cut >= 0 && take < hist[cut]) {
    long long prefix = 0;
    int need = take;
    for (int shift = KK::kTopShift; shift >= 0; shift -= 8) {
      for (int j = tid; j < kDigits; j += nt) digits[j] = 0;
      __syncthreads();
      for (int j = tid; j < S; j += nt) {
        const K key = tab[j];
        if (key == KK::kNone || KK::lcp(key) != cut_lcp) continue;
        const long long id = KK::id(key);
        if ((id >> (shift + 8)) == prefix) atomicAdd(&digits[(id >> shift) & 255], 1);
      }
      __syncthreads();
      if (tid < 32) find_bin(digits, kDigits / 32, need, tid, meta + 3);
      __syncthreads();
      prefix = (prefix << 8) | meta[3];
      need = meta[4];
      __syncthreads();  // all have read meta[3], meta[4] before the next pass
    }
    last = prefix;
  }

  // 5. choose every id above the cut's lcp and the cut's ids up to `last`;
  // write them in rank order, -1 past them
  for (int j = tid; j < S; j += nt) {
    const K key = tab[j];
    if (key == KK::kNone) continue;
    const int l = KK::lcp(key);
    if (l > cut_lcp || (l == cut_lcp && KK::id(key) <= last))
      sel[atomicAdd(&meta[2], 1)] = KK::by_rank(KK::id(key), l);
  }
  __syncthreads();
  const int n_chosen = meta[2];
  int32_t* oi = out_ids + blk * out_cols;
  int32_t* ov = out_vals + blk * out_cols;
  if (n_chosen <= nt) {
    // a chosen key's place is the number of chosen keys below it (the keys
    // are distinct); every thread reads the same key at once
    if (tid < n_chosen) {
      const K key = sel[tid];
      int place = 0;
      for (int j = 0; j < n_chosen; ++j) place += sel[j] < key;
      oi[place] = (int)(key & KK::kIdMask);
      ov[place] = kMaxLcp - (int)(key >> KK::kIdBits);
    }
  } else {
    bitonic_sort(sel, P);
    for (int i = tid; i < n_chosen; i += nt) {
      const K key = sel[i];
      oi[i] = (int)(key & KK::kIdMask);
      ov[i] = kMaxLcp - (int)(key >> KK::kIdBits);
    }
  }
  for (int i = n_chosen + tid; i < out_cols; i += nt) {
    oi[i] = -1;
    ov[i] = -1;
  }
}

int log2_at_least(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class K>
cudaError_t launch(const int32_t* ids, const int32_t* lcps, int32_t* out_ids, int32_t* out_vals,
                   int B, int pool, int chunk, int k, int out_cols, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        return cudaFuncSetAttribute(pool_topk_kernel<K>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem_bytes<K>(Key<K>::kMaxSlots, kMaxK));
      },
      &sms);
  if (err != cudaSuccess) return err;
  const int tiles = (pool + chunk - 1) / chunk;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int len = pool < chunk ? pool : chunk;
  if (2 * len > Key<K>::kMaxSlots) return cudaErrorInvalidValue;  // a table over half full
  int log2s = log2_at_least(2 * len);
  if (log2s < 6) log2s = 6;
  const int P = 1 << log2_at_least(k);
  const int nt = (1 << log2s) / 2 < kThreads ? (1 << log2s) / 2 : kThreads;
  const int vec = pool % 4 == 0 && chunk % 4 == 0 && aligned16(ids) && aligned16(lcps);
  pool_topk_kernel<K><<<(unsigned)blocks, nt, smem_bytes<K>(1 << log2s, P), stream>>>(
      ids, lcps, out_ids, out_vals, pool, chunk, tiles, k, out_cols, log2s, P, vec);
  return cudaGetLastError();
}

}  // namespace

// ids, lcps (B, pool) -> out_ids, out_vals (B, ceil(pool / chunk), out_cols):
// each chunk's top-k.  Ids lie in [-1, n).
extern "C" int pool_topk_launch(const void* ids, const void* lcps, void* out_ids,
                                void* out_vals, int B, int pool, int n, int chunk, int k,
                                int out_cols, void* stream) {
  if (B < 0 || pool < 0 || n < 1 || chunk < 1 || chunk > kMaxTile || k < 1 || k > kMaxK ||
      out_cols < k)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || pool == 0) return (int)cudaSuccess;
  auto i = static_cast<const int32_t*>(ids);
  auto l = static_cast<const int32_t*>(lcps);
  auto oi = static_cast<int32_t*>(out_ids);
  auto ov = static_cast<int32_t*>(out_vals);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowIds)
    return (int)launch<unsigned int>(i, l, oi, ov, B, pool, chunk, k, out_cols, s);
  return (int)launch<unsigned long long>(i, l, oi, ov, B, pool, chunk, k, out_cols, s);
}
