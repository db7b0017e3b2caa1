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
// both past the distinct ids, up to `out_cols` columns.  lcps above 256 rank
// as 256 (the probe kernel takes m <= 256).
//
// Tiles.  One block takes `chunk` consecutive entries of one row (a tile) and
// writes that tile's own deduped top-k.  This is exact: let x be an id of the
// row's top-k whose max lcp lies in tile t.  Every id that ranks above x
// inside t (by its max lcp inside t) ranks above x in the whole row too,
// because its max over the row is at least its max inside t.  Fewer than k
// ids rank above x in the row, so fewer than k do inside t: x is in t's top-k,
// with its true value.  The union of the tiles' lists therefore holds the
// row's top-k with their true values, and the wrapper runs this kernel again
// over the (B, tiles * k) union until one tile holds it.  A tile holds up to
// 16,384 entries (8,192 where ids reach 2^23 and take 8-byte keys): one
// launch for the lccs pool (12,800 entries at m 64, W 100) and the serving
// pool (4,096), a tile pass and one merge for a multiprobe-skip pool.
// chunk >= 2k, so each launch at least halves the pool.
//
// Bands.  Within a tile, only the entries whose lcp reaches the cut decide
// the output.  Let c* be the lcp of the tile's k-th ranked distinct id.  Each
// of the k ids ranked first has an entry with lcp >= c*, so at least k
// entries have lcp >= c*: c* <= t0 = max{t : #entries with lcp >= t >= k}.
// After every entry with lcp >= t is deduped into a table, the table holds
// exactly the ids whose max lcp is >= t, each with its true max.  Once it
// holds >= k ids, every id outside it (max < t) ranks below all of them, so
// the tile's top-k is the table's.  The kernel therefore dedupes the entries
// with lcp >= t0 first and, while the table holds fewer than k ids and some
// entry is left out, lowers t to the largest t' whose entries >= t' are at
// least twice those >= t and one more for each missing id, and dedupes the
// entries >= t' into a fresh table.  A histogram of the tile's lcps, taken
// as the tile is read, gives t0 and each band's entries before they go in,
// so each table is sized for what it gets (kGrow slots an entry).  A tile
// whose cut lies at lcp 0 dedupes all its entries, in its last pass: the
// work of a design without bands, and its one table of the whole tile.
//
// What bounds it: the bytes are one read of the pool and one write of the
// lists, (B pool + B out_cols) * 8 (0.031 ms for 1,000 x 12,800 at 3.35
// TB/s).  The tile is read from device memory once, into registers (E
// entries a thread), and everything after works in shared memory on tables
// of twice a band's entries (at the lccs pool of n 10^6 the cut lies at lcp
// 6-9 and ~310 of the 12,800 entries reach it), so the read and the
// histogram take half the time and the band passes, the block barriers
// between the passes and the selection the rest (tools/pool_variants.py
// times each phase on an H100).
//
// Design:
//   * each thread loads its E entries with coalesced 16-byte loads where the
//     rows allow them, as packed keys (id << 9) | lcp (4 bytes where every
//     id is below 2^23, else 8), and adds their lcps to its warp's own
//     histogram in shared memory (no atomic shared across warps); the warps'
//     histograms are summed and one warp scans them into the counts of
//     entries >= t and t0;
//   * a band pass inserts the keys >= t into a table of S slots (a multiple
//     of 32, kGrow x the entries >= t, within a capacity above the tile's
//     entries) by open addressing (slot = the high half of a multiplicative
//     hash times S): an atomicCAS claims an empty slot for an id and an
//     atomicMax raises its lcp; where a thread holds more than 8 keys, each
//     warp first gathers its keys in the band into a ring in shared memory
//     (a ballot a key), a key a lane; the claims, counted (one add a warp),
//     give the table's distinct ids;
//   * a table of at most kRankMax ids is ranked by counting: each id's place
//     is the number of the table's ids that rank above it, and the first k
//     are written;
//   * over a larger table: its ids by lcp, scanned by one warp, give the
//     lcp of the k-th ranked id (the cut) and how many ids of that lcp the
//     first k hold (take); a radix select, 8 bits of the id a pass from the
//     top bits n needs, finds the take-th smallest id of the cut's lcp, so
//     the ties go to the smaller ids without a sort; the k chosen keys,
//     repacked as ((256 - lcp) << id_bits) | id, are written in that order:
//     each at the count of chosen keys below it where k <= the block's
//     threads, else after a bitonic sort of P = pow2 >= k.
// Blocks take 512 threads (two an SM) or, where the grid has fewer blocks
// than the card has SMs, 1,024.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"  // DeviceOnce

namespace {

// the most threads a block: 512, two blocks an SM; 1,024 where the grid
// has fewer blocks than the card has SMs (the serving pool's 32 rows)
constexpr int kThreads = 512, kWideThreads = 1024;
constexpr int kRing = 64;       // a warp's keys waiting to go into the table
constexpr int kMaxK = 4096;     // ids kept a tile
constexpr int kMaxLcp = 256;
constexpr int kBins = kMaxLcp + 1;  // lcp in [0, 256]
constexpr int kLcpBits = 9;
constexpr int kPerLane = 9;     // 32 lanes x 9 >= the 257 lcp bins
constexpr int kBinsPad = 32 * kPerLane;
constexpr int kDigits = 256;    // radix of the select
constexpr int kPasses = 4;      // select passes: ids below 2^31
constexpr int kMinSlots = 64;
constexpr int kGrow = 2;        // a table's slots for each entry it takes
constexpr int kRankMax = 256;   // the most ids ranked by counting, not selected
constexpr int kNarrowIds = 1 << 23;  // 4-byte keys below this id bound
constexpr unsigned kFull = 0xffffffffu;
// meta: the first band's floor, two pass counters, the cut's bin (256 - lcp)
// and its ids to take, ids chosen, and the select's digit and count a pass
enum { kT0 = 0, kCount = 1, kCut = 3, kChosen = 5, kSel = 6, kMeta = kSel + 2 * kPasses };

template <class K>
struct Key {
  static constexpr int kIdBits = 8 * (int)sizeof(K) - kLcpBits;
  static constexpr K kNone = ~K(0);  // an empty slot or a dropped entry
  static constexpr K kIdMask = (K(1) << kIdBits) - 1;
  static constexpr int kMaxTile = sizeof(K) == 4 ? 16384 : 8192;  // entries of a tile

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

__host__ __device__ constexpr int round32(int x) { return (x + 31) & ~31; }

// table slots for a tile of len entries: more than its entries (each may be
// a distinct id), at most 4/5 full, at most half for tiles up to 4,096
__host__ __device__ constexpr int table_cap(int len) {
  const int spare = len / 4 > (len < 4096 ? len : 4096) ? len / 4 : (len < 4096 ? len : 4096);
  return round32(len + spare + 1) > kMinSlots ? round32(len + spare + 1) : kMinSlots;
}

// the table (the warps' histograms before it), the chosen keys, the warps'
// rings, then the ints: hist, ge, thist, the select's digits, meta
template <class K, int T>
__host__ __device__ constexpr size_t tab_bytes(int cap) {
  return (size_t)cap * sizeof(K) > (size_t)(T / 32) * kBinsPad * sizeof(int)
             ? (size_t)cap * sizeof(K)
             : (size_t)(T / 32) * kBinsPad * sizeof(int);
}

template <class K, int T>
size_t smem_bytes(int cap, int P) {
  const int ints = 3 * kBinsPad + 1 + kPasses * kDigits + kMeta;
  return tab_bytes<K, T>(cap) + (size_t)(P + T / 32 * kRing) * sizeof(K) +
         (size_t)ints * sizeof(int);
}

// Claim a slot of the table tab (S slots) for the key's id, or raise the
// lcp its slot holds; returns 1 where it claimed one.  An atomicCAS on an
// empty slot claims it, on a taken one reads it; an atomicMax keeps an id's
// largest lcp, so the order of the inserts does not matter.
template <class K>
__device__ __forceinline__ int insert(K* tab, unsigned S, K key) {
  using KK = Key<K>;
  unsigned slot = __umulhi((unsigned)(key >> kLcpBits) * 2654435761u, S);
  for (;;) {
    const K old = atomicCAS(&tab[slot], KK::kNone, key);
    if (old == KK::kNone) return 1;
    if ((old >> kLcpBits) == (key >> kLcpBits)) {
      if (old < key) atomicMax(&tab[slot], key);
      return 0;
    }
    slot = slot + 1 == S ? 0 : slot + 1;
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

// block blk = b * tiles + t: tile t of row b -> out[blk * out_cols, + out_cols).
// blockDim.x is a multiple of 32 and E * blockDim.x >= the tile's entries.
template <class K, int E, int T>
__global__ void __launch_bounds__(T, kWideThreads / T)
    pool_topk_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ lcps,
                     int32_t* __restrict__ out_ids, int32_t* __restrict__ out_vals, int pool,
                     int chunk, int tiles, int k, int out_cols, int cap, int P, int vec,
                     int top_shift) {
  using KK = Key<K>;
  static_assert(E % 4 == 0, "16-byte loads of four entries");
  extern __shared__ __align__(16) unsigned char smem[];
  K* tab = reinterpret_cast<K*>(smem);                // cap slots
  int* sub = reinterpret_cast<int*>(smem);            // the warps' histograms, before the table
  K* sel = reinterpret_cast<K*>(smem + tab_bytes<K, T>(cap));  // P
  K* rings = sel + P;                                 // T / 32 x kRing
  int* hist = reinterpret_cast<int*>(rings + T / 32 * kRing);  // entries by lcp
  int* ge = hist + kBinsPad;                          // entries with lcp >= t, [0, 257]
  int* thist = ge + kBinsPad + 1;                     // the table's ids by 256 - lcp
  int* digits = thist + kBinsPad;                     // kPasses x kDigits
  int* meta = digits + kPasses * kDigits;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const long long blk = blockIdx.x;
  const long long b = blk / tiles;
  const int start = (int)(blk % tiles) * chunk;
  const int len = min(chunk, pool - start);
  const int32_t* row_i = ids + b * pool + start;
  const int32_t* row_l = lcps + b * pool + start;

  // 1. the tile's entries into registers, its one read from device memory
  K key[E];
  if (vec) {
#pragma unroll
    for (int g = 0; g < E / 4; ++g) {
      const int j = 4 * (g * nt + tid);
      int4 iv = make_int4(-1, -1, -1, -1), lv = iv;
      if (j + 4 <= len) {
        iv = __ldg(reinterpret_cast<const int4*>(row_i + j));
        lv = __ldg(reinterpret_cast<const int4*>(row_l + j));
      } else if (j < len) {
        iv.x = row_i[j], lv.x = row_l[j];
        if (j + 1 < len) iv.y = row_i[j + 1], lv.y = row_l[j + 1];
        if (j + 2 < len) iv.z = row_i[j + 2], lv.z = row_l[j + 2];
      }
      key[4 * g] = KK::pack(iv.x, lv.x);
      key[4 * g + 1] = KK::pack(iv.y, lv.y);
      key[4 * g + 2] = KK::pack(iv.z, lv.z);
      key[4 * g + 3] = KK::pack(iv.w, lv.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * nt + tid;
      key[e] = j < len ? KK::pack(row_i[j], row_l[j]) : KK::kNone;
    }
  }
  for (int j = tid; j < (nt >> 5) * kBinsPad; j += nt) sub[j] = 0;
  for (int j = tid; j < kBinsPad; j += nt) thist[j] = 0;
  for (int j = tid; j < kPasses * kDigits; j += nt) digits[j] = 0;
  if (tid < kMeta) meta[tid] = tid == kCut ? -1 : 0;
  __syncthreads();

  // 2. the entries by lcp, a histogram a warp, then summed
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (key[e] != KK::kNone) atomicAdd(&sub[warp * kBinsPad + KK::lcp(key[e])], 1);
  __syncthreads();
  for (int j = tid; j < kBins; j += nt) {
    int s = 0;
    for (int w = 0; w < (nt >> 5); ++w) s += sub[w * kBinsPad + j];
    hist[j] = s;
  }
  __syncthreads();

  // 3. ge[t] = entries with lcp >= t (one warp, 9 bins a lane), and the
  // first band's floor t0 = max{t : ge[t] >= k} (0 when there is none)
  if (warp == 0) {
    int s = 0;
    for (int c = 0; c < kPerLane; ++c) {
      const int t = lane * kPerLane + c;
      s += t < kBins ? hist[t] : 0;
    }
    int incl = s;  // the entries of this lane's bins and the bins above
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_down_sync(kFull, incl, d);
      if (lane + d < 32) incl += y;
    }
    int run = incl - s, best = 0;
    for (int c = kPerLane - 1; c >= 0; --c) {
      const int t = lane * kPerLane + c;
      if (t >= kBins) continue;
      run += hist[t];
      ge[t] = run;
      if (run >= k && t > best) best = t;
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) {
      ge[kBins] = 0;
      meta[kT0] = best;
    }
  }
  __syncthreads();

  // 4. band passes: dedupe the entries with lcp >= t into a fresh table of
  // kGrow slots an entry until it holds k ids or every entry
  const int total = ge[0];
  int t = meta[kT0], distinct = 0;
  unsigned S;
  for (int pass = 0;; ++pass) {
    const int band = ge[t];
    S = (unsigned)min(cap, max(kMinSlots, round32(kGrow * band)));
    for (int j = tid; j < (int)S; j += nt) tab[j] = KK::kNone;
    if (tid == 0) meta[kCount + (pass & 1)] = 0;  // the other one was read a pass ago
    __syncthreads();
    int claimed = 0;
    if constexpr (E <= 8) {  // a few keys a thread: each goes in where it lies
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (key[e] != KK::kNone && KK::lcp(key[e]) >= t) claimed += insert(tab, S, key[e]);
    } else {
      // each warp gathers its keys in the band into its ring, and inserts
      // them a key a lane as they come, so that a lane's sparse keys do not
      // each hold its warp in a probe loop
      K* ring = rings + warp * kRing;
      int head = 0, tail = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const K x = key[e];
        const bool in_band = x != KK::kNone && KK::lcp(x) >= t;
        const unsigned m = __ballot_sync(kFull, in_band);
        if (in_band) ring[(tail + __popc(m & ((1u << lane) - 1))) & (kRing - 1)] = x;
        tail += __popc(m);
        if (tail - head >= 32) {
          __syncwarp();
          claimed += insert(tab, S, ring[(head + lane) & (kRing - 1)]);
          head += 32;
          __syncwarp();  // read before the ring's next keys land on these slots
        }
      }
      __syncwarp();
      if (lane < tail - head) claimed += insert(tab, S, ring[(head + lane) & (kRing - 1)]);
    }
    claimed = __reduce_add_sync(kFull, claimed);
    if (lane == 0 && claimed) atomicAdd(&meta[kCount + (pass & 1)], claimed);
    __syncthreads();
    distinct = meta[kCount + (pass & 1)];
    if (distinct >= k || band == total) break;
    // the next floor: at least twice the entries, and one more an id missing
    const int want = max(2 * band, band + k - distinct);
    do --t;
    while (t > 0 && ge[t] < want);
  }
  int32_t* oi = out_ids + blk * out_cols;
  int32_t* ov = out_vals + blk * out_cols;

  // 5. a table of at most kRankMax ids: each id's place is the number of
  // its ids that rank above it, one thread an id reading all of them (the
  // same one at once), and the first k are written
  if (distinct <= min(nt, kRankMax)) {
    K* list = rings;  // T / 32 x kRing >= 2 nt keys, free after the passes
    for (int j = tid; j < (int)S; j += nt) {
      const K x = tab[j];
      const unsigned live = __ballot_sync(kFull, x != KK::kNone);
      int base = 0;
      if (lane == 0 && live) base = atomicAdd(&meta[kChosen], __popc(live));
      base = __shfl_sync(kFull, base, 0);
      if (x != KK::kNone)
        list[base + __popc(live & ((1u << lane) - 1))] = KK::by_rank(KK::id(x), KK::lcp(x));
    }
    __syncthreads();
    if (tid < distinct) {
      const K x = list[tid];
      int place = 0;
#pragma unroll 8
      for (int j = 0; j < distinct; ++j) place += list[j] < x;
      if (place < k) {
        oi[place] = (int)(x & KK::kIdMask);
        ov[place] = kMaxLcp - (int)(x >> KK::kIdBits);
      }
    }
    for (int i = min(distinct, k) + tid; i < out_cols; i += nt) {
      oi[i] = -1;
      ov[i] = -1;
    }
    return;
  }

  // 6. a larger table's ids by lcp; the cut: the bin of the k-th ranked id
  // and how many ids of that bin the first k hold (no id: no cut)
  for (int j = tid; j < (int)S; j += nt) {
    const K x = tab[j];
    if (x != KK::kNone) atomicAdd(&thist[kMaxLcp - KK::lcp(x)], 1);
  }
  __syncthreads();
  if (warp == 0) {
    int s = 0;
    for (int c = 0; c < kPerLane; ++c) s += thist[lane * kPerLane + c];
    s = __reduce_add_sync(kFull, s);
    find_bin(thist, kPerLane, min(k, s), lane, meta + kCut);
  }
  __syncthreads();
  const int cut = meta[kCut], take = meta[kCut + 1];
  const int cut_lcp = kMaxLcp - cut;  // 257 without a cut: no lcp reaches it

  // 7. the take-th smallest id of the cut's lcp (no select when all are
  // taken), 8 bits a pass from the top bits of n - 1
  long long last = 0x7fffffffffffffffLL;
  if (cut >= 0 && take < thist[cut]) {
    long long prefix = 0;
    int need = take;
    for (int shift = top_shift, p = 0; shift >= 0; shift -= 8, ++p) {
      int* dg = digits + p * kDigits;
      for (int j = tid; j < (int)S; j += nt) {
        const K x = tab[j];
        if (x != KK::kNone && KK::lcp(x) == cut_lcp && (KK::id(x) >> (shift + 8)) == prefix)
          atomicAdd(&dg[(KK::id(x) >> shift) & 255], 1);
      }
      __syncthreads();
      if (warp == 0) find_bin(dg, kDigits / 32, need, lane, meta + kSel + 2 * p);
      __syncthreads();
      prefix = (prefix << 8) | meta[kSel + 2 * p];
      need = meta[kSel + 2 * p + 1];
    }
    last = prefix;
  }

  // 8. choose every id above the cut's lcp and the cut's ids up to `last`;
  // write them in rank order, -1 past them
  for (int j = tid; j < (int)S; j += nt) {
    const K x = tab[j];
    if (x == KK::kNone) continue;
    const int l = KK::lcp(x);
    if (l > cut_lcp || (l == cut_lcp && KK::id(x) <= last))
      sel[atomicAdd(&meta[kChosen], 1)] = KK::by_rank(KK::id(x), l);
  }
  __syncthreads();
  const int n_chosen = meta[kChosen];
  if (n_chosen <= nt) {
    // a chosen key's place is the number of chosen keys below it (the keys
    // are distinct); every thread reads the same key at once
    if (tid < n_chosen) {
      const K x = sel[tid];
      int place = 0;
#pragma unroll 8
      for (int j = 0; j < n_chosen; ++j) place += sel[j] < x;
      oi[place] = (int)(x & KK::kIdMask);
      ov[place] = kMaxLcp - (int)(x >> KK::kIdBits);
    }
  } else {
    for (int j = n_chosen + tid; j < P; j += nt) sel[j] = KK::kNone;
    __syncthreads();
    bitonic_sort(sel, P);
    for (int i = tid; i < n_chosen; i += nt) {
      const K x = sel[i];
      oi[i] = (int)(x & KK::kIdMask);
      ov[i] = kMaxLcp - (int)(x >> KK::kIdBits);
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

template <class K, int E, int T>
cudaError_t launch_e(const int32_t* ids, const int32_t* lcps, int32_t* out_ids,
                     int32_t* out_vals, long long blocks, int nt, int pool, int chunk, int tiles,
                     int k, int out_cols, int cap, int P, int vec, int top_shift,
                     cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        return cudaFuncSetAttribute(pool_topk_kernel<K, E, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem_bytes<K, T>(table_cap(Key<K>::kMaxTile), kMaxK));
      },
      &sms);
  if (err != cudaSuccess) return err;
  pool_topk_kernel<K, E, T><<<(unsigned)blocks, nt, smem_bytes<K, T>(cap, P), stream>>>(
      ids, lcps, out_ids, out_vals, pool, chunk, tiles, k, out_cols, cap, P, vec, top_shift);
  return cudaGetLastError();
}

// E entries a thread: the fewest of 4, 8, 16, 32 that T threads hold
template <class K, int T>
cudaError_t launch_t(const int32_t* ids, const int32_t* lcps, int32_t* out_ids,
                     int32_t* out_vals, long long blocks, int len, int pool, int chunk,
                     int tiles, int k, int out_cols, int P, int vec, int top_shift,
                     cudaStream_t stream) {
  int E = 4;
  while (E * T < len) E *= 2;
  const int nt = round32((len + E - 1) / E);
  const int cap = table_cap(len);
#define POOL_TOPK_E(e)                                                                   \
  if constexpr ((e) == 4 || (e) / 2 * T < Key<K>::kMaxTile)                              \
    if (E == (e))                                                                        \
      return launch_e<K, (e), T>(ids, lcps, out_ids, out_vals, blocks, nt, pool, chunk,  \
                                 tiles, k, out_cols, cap, P, vec, top_shift, stream);
  POOL_TOPK_E(4)
  POOL_TOPK_E(8)
  POOL_TOPK_E(16)
  POOL_TOPK_E(32)
#undef POOL_TOPK_E
  return cudaErrorInvalidValue;
}

template <class K>
cudaError_t launch(const int32_t* ids, const int32_t* lcps, int32_t* out_ids, int32_t* out_vals,
                   int B, int pool, int n, int chunk, int k, int out_cols, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  int sms = 0;
  cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = (pool + chunk - 1) / chunk;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int len = pool < chunk ? pool : chunk;
  if (len > Key<K>::kMaxTile) return cudaErrorInvalidValue;
  const int P = 1 << log2_at_least(k);
  const int vec = pool % 4 == 0 && chunk % 4 == 0 && aligned16(ids) && aligned16(lcps);
  int top_shift = 0;  // the select's first digit: the top 8 bits of n - 1's width
  while (((long long)(n - 1) >> (top_shift + 8)) != 0) top_shift += 8;
  if (blocks < sms)
    return launch_t<K, kWideThreads>(ids, lcps, out_ids, out_vals, blocks, len, pool, chunk,
                                      tiles, k, out_cols, P, vec, top_shift, stream);
  return launch_t<K, kThreads>(ids, lcps, out_ids, out_vals, blocks, len, pool, chunk, tiles,
                               k, out_cols, P, vec, top_shift, stream);
}

}  // namespace

// ids, lcps (B, pool) -> out_ids, out_vals (B, ceil(pool / chunk), out_cols):
// each chunk's top-k.  Ids lie in [-1, n).
extern "C" int pool_topk_launch(const void* ids, const void* lcps, void* out_ids,
                                void* out_vals, int B, int pool, int n, int chunk, int k,
                                int out_cols, void* stream) {
  if (B < 0 || pool < 0 || n < 1 || chunk < 1 || chunk > Key<unsigned>::kMaxTile || k < 1 ||
      k > kMaxK || out_cols < k)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || pool == 0) return (int)cudaSuccess;
  auto i = static_cast<const int32_t*>(ids);
  auto l = static_cast<const int32_t*>(lcps);
  auto oi = static_cast<int32_t*>(out_ids);
  auto ov = static_cast<int32_t*>(out_vals);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowIds)
    return (int)launch<unsigned int>(i, l, oi, ov, B, pool, n, chunk, k, out_cols, s);
  return (int)launch<unsigned long long>(i, l, oi, ov, B, pool, n, chunk, k, out_cols, s);
}
