// Longest circular run of matching symbols on Hopper (sm_90a), and the top-k
// of those lengths behind it.
//
//   circrun        out[b, r] = the longest circular run of positions k with
//                  h[r, k] == q[b, k], capped at m: |LCCS(h[r], q[b])|, the
//                  (B, n) lengths as int32.
//   circrun_topk   per query, the k rows of largest length, ranked by (length
//                  descending, row ascending); rows where ok[r] == 0 score -1.
//                  Two kernels a chunk of queries: the scorer above writes
//                  each length + 1 in one byte (two above m = 254) and counts
//                  a histogram of them per query; the select kernel finds the
//                  cut from the histogram and walks the row once.  The (B, n)
//                  int32 lengths and int64 ranking keys are never written.
//
// Replaces: src/repro/kernels/circrun/circrun.py, circrun_pallas (batched
// over queries as src/repro/kernels/circrun/ops.py does), and the lax.top_k
// after it in src/repro/core/bruteforce.py:34 (bruteforce_topk) and
// src/repro/core/segments.py:496 (_buffer_topk).  Plain torch versions beside
// it: src/repro_torch/kernels/circrun/ref.py (circrun_ref,
// circrun_topk_plain).
//
// What bounds it: integer operations.  The least work of any exact scorer is
// one compare a (pair, position): B n m of them (4.2 G at B = 1,000, n =
// 65,536, m = 64: 0.25 ms at 132 SMs x 64 int32 lanes x 1.98 GHz), against
// 4 (n m + B m) bytes of input and B n bytes of stored lengths.
//
// Scorer design (circrun_kernel):
//   * a block scores a window of 32 rows against kQ queries at a time and
//     walks a slice of the windows; a thread takes kRT rows x kQT queries
//     (32 match masks of 32 bits: 2 rows x 8 queries at 32 < m <= 64);
//   * both tiles sit in shared memory, the queries for the whole block, the
//     rows in two buffers that cp.async fills one window ahead; row strides
//     of 32 NW + 4 words put 16-byte loads of neighbouring rows on distinct
//     banks.  Positions past m are 0 in the rows (cp.async's zero fill) and 1
//     in the queries, so they never match;
//   * the compare loop reads 4 positions of each of its rows and queries a
//     16-byte load, and sets bit k of a pair's mask where h == q: one compare
//     and one predicated add a (pair, position) (a warp-vote design, which
//     adds a vote and an owner select a 32-position word, was slower);
//   * each thread then folds a pair's masks word by word, without branches:
//     the ones at the bottom and the top of a word (clz), the longest run
//     inside it (the starts of runs of 2, 4, 8, 16 ones by shifted ANDs,
//     then a binary lifting over them), the run carried across words, and
//     the leading run, which joins the trailing one across the wrap: the
//     circular answer is m when every position matches, else
//     max(best, leading + trailing);
//   * outputs are staged in shared memory and written as whole words, each
//     query's 32 consecutive rows; the grid is (row slices, query groups)
//     with as many slices as fill one wave of resident blocks;
//   * circrun_topk's histogram of the stored values (m + 2 bins a query)
//     lives in shared memory and is added to the (B, m + 2) global one with
//     one atomic a nonzero bin at the end of the block.
//
// Select design (circrun_topk_kernel, a block a query): one warp scans the
// query's histogram from the top for the cut t with count(> t) < k <=
// count(>= t) and take = k - count(> t); the block walks the stored row in
// row order, 16 bytes a thread a step, and keeps every row above t and the
// first `take` rows at t (a block-wide prefix count of the ties); rows are
// unique and already in row order, so no dedupe or radix select is needed.
// The k keys ((m + 1 - value) << 32 | row) are then placed at the count of
// keys below each (k <= 512) or bitonic-sorted.  Symbols are compared as
// plain int32: negative hashes and int32-max sentinel rows need nothing
// special.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"  // DeviceOnce

namespace {

constexpr int kThreads = 256;     // threads of a scorer block
constexpr int kSelThreads = 512;  // threads of a select block
constexpr int kMaxK = 4096;       // rows a select block keeps
constexpr int kMaxM = 512;
constexpr int kNarrowM = 254;  // m up to which a stored value (length + 1) fits a byte
constexpr unsigned kFull = 0xffffffffu;

// The scorer's tiles for NW words of 32 positions (32 NW >= m): a thread
// scores kRT rows x kQT queries (32 mask words), kRTh threads cover the 32
// rows of a window and kQTh threads the kQ queries of a block.
template <int NW>
struct Tiling {
  static constexpr int kRT = NW == 1 ? 4 : (NW == 2 ? 2 : 1);
  static constexpr int kQT = NW <= 4 ? 8 : 32 / NW;
  static constexpr int kRTh = 32 / kRT;
  static constexpr int kQTh = kThreads / kRTh;
  static constexpr int kQ = kQTh * kQT;
  static constexpr int kP = 32 * NW;     // positions a row holds in shared memory
  static constexpr int kS = kP + 4;      // its stride in words
};

// The longest run of ones in w (at most 31: a word of 32 ones is the caller's
// case).  s_k marks the starts of runs of >= k ones; the lifting keeps c = the
// starts of runs of >= len ones and adds k wherever a run of k more starts
// len further on (c & s_k >> len).
__device__ __forceinline__ int longest_run(uint32_t w) {
  const uint32_t s1 = w, s2 = s1 & (s1 >> 1), s4 = s2 & (s2 >> 2), s8 = s4 & (s4 >> 4),
                 s16 = s8 & (s8 >> 8);
  int len = 0;
  uint32_t c = kFull;
#define CIRCRUN_LIFT(k, s)               \
  {                                      \
    const uint32_t t = c & ((s) >> len); \
    c = t ? t : c;                       \
    len += t ? (k) : 0;                  \
  }
  CIRCRUN_LIFT(16, s16)
  CIRCRUN_LIFT(8, s8)
  CIRCRUN_LIFT(4, s4)
  CIRCRUN_LIFT(2, s2)
  CIRCRUN_LIFT(1, s1)
#undef CIRCRUN_LIFT
  return len;
}

// A pair's circular run, folded in one word of match bits at a time.
struct Run {
  int best = 0;      // longest run inside the words so far
  int cur = 0;       // ones at the end of the words so far
  int lead = 0;      // ones from position 0
  bool open = true;  // every position so far matched

  // w: bits [0, v) are positions 32 j .. 32 j + v - 1 (1 = match), bits above v are 0
  __device__ __forceinline__ void add(uint32_t w, int v) {
    const bool full = w == (v == 32 ? kFull : (1u << v) - 1);
    const int lo = __clz(__brev(~w));         // ones at the bottom
    const int hi = __clz(~(w << (32 - v)));  // ones at the top of the v bits
    const int inner = longest_run(w);
    best = full ? best : max(best, max(cur + lo, inner));
    lead += open ? (full ? v : lo) : 0;
    open = open && full;
    cur = full ? cur + v : hi;
  }
  // leading and trailing runs are disjoint where a position mismatched
  __device__ __forceinline__ int length(int m) const {
    return open ? m : max(best, lead + cur);
  }
};

// Stage window w's rows (32 x kP words) in hs: 16-byte copies where m is a
// multiple of 4 and h is 16-byte aligned (vec), else 4-byte ones; positions
// past m and rows past n are zero-filled.
template <int NW>
__device__ __forceinline__ void stage_rows(int32_t* hs, const int32_t* __restrict__ h, int w,
                                           int n, int m, bool vec) {
  using T = Tiling<NW>;
  const long long r0 = 32LL * w;
  if (vec) {
    for (int e = threadIdx.x; e < 32 * T::kP / 4; e += kThreads) {
      const int r = e / (T::kP / 4), k = 4 * (e % (T::kP / 4));
      const bool in = k < m && r0 + r < n;
      hash_tile::copy<16>(reinterpret_cast<float*>(hs + r * T::kS + k),
                          reinterpret_cast<const float*>(in ? h + (r0 + r) * m + k : h),
                          in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 32 * T::kP; e += kThreads) {
      const int r = e / T::kP, k = e % T::kP;
      const bool in = k < m && r0 + r < n;
      hash_tile::copy<4>(reinterpret_cast<float*>(hs + r * T::kS + k),
                         reinterpret_cast<const float*>(in ? h + (r0 + r) * m + k : h),
                         in ? 4 : 0);
    }
  }
  hash_tile::commit();
}

template <int NW, class OUT>
constexpr size_t smem_bytes() {
  using T = Tiling<NW>;
  constexpr size_t kTileStride = 32 / (4 / sizeof(OUT)) + 1;
  return 4 * ((size_t)(T::kQ + 64) * T::kS + T::kQ * kTileStride +
              (sizeof(OUT) < 4 ? (size_t)T::kQ * ((32 * NW + 2) | 1) : 0));
}

// grid (slices, query groups): queries q0 = blockIdx.y kQ .. + kQ - 1 over the
// 32-row windows of slice blockIdx.x.  OUT = int32_t: lengths into out (B,
// ld = n).  OUT = uint8_t or uint16_t: length + 1 (0 where ok[row] == 0) into
// out (B, ld), ld a multiple of 32, and the histogram of those values into
// hist (B, m + 2).
template <int NW, class OUT>
__global__ void __launch_bounds__(kThreads, 2)
    circrun_kernel(const int32_t* __restrict__ h, const int32_t* __restrict__ q,
                   const uint8_t* __restrict__ ok, OUT* __restrict__ out, long long ld,
                   int* __restrict__ hist, int n, int m, int B, int slices, bool vec) {
  using T = Tiling<NW>;
  constexpr int kRT = T::kRT, kQT = T::kQT, kRTh = T::kRTh, kQTh = T::kQTh, kQ = T::kQ;
  constexpr int kS = T::kS, kP = T::kP;
  constexpr bool kTopk = sizeof(OUT) < 4;
  constexpr int kPerWord = 4 / (int)sizeof(OUT);  // outputs a 32-bit word
  constexpr int kWpq = 32 / kPerWord;             // words of a query's 32 outputs
  constexpr int kTileStride = kWpq + 1;           // odd: no bank conflicts
  constexpr int kBinStride = (32 * NW + 2) | 1;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* qs = smem;                   // kQ x kS
  int32_t* hs = qs + kQ * kS;           // 2 x 32 x kS
  uint32_t* tile = reinterpret_cast<uint32_t*>(hs + 64 * kS);  // kQ x kTileStride
  int* shist = reinterpret_cast<int*>(tile + kQ * kTileStride);  // kQ x kBinStride
  OUT* tile_out = reinterpret_cast<OUT*>(tile);
  const int tid = threadIdx.x;
  const int qt = tid % kQTh, rt = tid / kQTh;  // queries qt + kQTh u, rows rt + kRTh i
  const int q0 = blockIdx.y * kQ;

  const long long windows = (n + 31) / 32;
  const int w_begin = (int)(windows * blockIdx.x / slices);
  const int w_end = (int)(windows * (blockIdx.x + 1) / slices);
  if (w_begin < w_end) stage_rows<NW>(hs, h, w_begin, n, m, vec);
  for (int e = tid; e < kQ * kP; e += kThreads) {
    const int b = e / kP, k = e % kP;
    qs[b * kS + k] = k < m && q0 + b < B ? __ldg(q + (long long)(q0 + b) * m + k) : 1;
  }
  if constexpr (kTopk)
    for (int e = tid; e < kQ * kBinStride; e += kThreads) shist[e] = 0;

  for (int w = w_begin; w < w_end; ++w) {
    const int32_t* rows = hs + ((w - w_begin) & 1) * 32 * kS;
    if (w + 1 < w_end) {
      stage_rows<NW>(hs + ((w + 1 - w_begin) & 1) * 32 * kS, h, w + 1, n, m, vec);
      hash_tile::wait<1>();
    } else {
      hash_tile::wait<0>();
    }
    __syncthreads();
    uint32_t mask[kRT][kQT][NW];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int u = 0; u < kQT; ++u)
#pragma unroll
        for (int j = 0; j < NW; ++j) mask[i][u][j] = 0;
#pragma unroll
    for (int c = 0; c < kP / 4; ++c) {
      if (NW <= 2 || 4 * c < m) {
        int4 hv[kRT], qv[kQT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          hv[i] = *reinterpret_cast<const int4*>(rows + (rt + kRTh * i) * kS + 4 * c);
#pragma unroll
        for (int u = 0; u < kQT; ++u)
          qv[u] = *reinterpret_cast<const int4*>(qs + (qt + kQTh * u) * kS + 4 * c);
        // positions 4 c .. 4 c + 3 are bits bit .. bit + 3 of word 4 c / 32
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int u = 0; u < kQT; ++u) {
            uint32_t& mk = mask[i][u][(4 * c) / 32];
            const int bit = (4 * c) % 32;
            if (hv[i].x == qv[u].x) mk |= 1u << bit;
            if (hv[i].y == qv[u].y) mk |= 2u << bit;
            if (hv[i].z == qv[u].z) mk |= 4u << bit;
            if (hv[i].w == qv[u].w) mk |= 8u << bit;
          }
      }
    }
    const int r0 = 32 * w;
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int u = 0; u < kQT; ++u) {
        Run run;
#pragma unroll
        for (int j = 0; j < NW; ++j)
          if (NW <= 2 || 32 * j < m) run.add(mask[i][u][j], min(32, m - 32 * j));
        const int len = run.length(m);
        const int ri = rt + kRTh * i, bi = qt + kQTh * u;
        const int row = r0 + ri;
        OUT val;
        if constexpr (kTopk) {
          const int s = row < n && (ok == nullptr || __ldg(ok + row)) ? len + 1 : 0;
          if (row < n && q0 + bi < B) atomicAdd(&shist[bi * kBinStride + s], 1);
          val = (OUT)s;
        } else {
          val = (OUT)len;
        }
        tile_out[bi * kTileStride * kPerWord + ri] = val;
      }
    __syncthreads();
    // query b's 32 outputs of the window at out[(q0 + b) ld + r0 ...], a word a thread
    for (int e = tid; e < kQ * kWpq; e += kThreads) {
      const int b = e / kWpq, c = e % kWpq;
      const long long col = r0 + (long long)c * kPerWord;
      if (q0 + b < B && (kTopk || col < n))  // narrow rows are padded to a multiple of 32
        *reinterpret_cast<uint32_t*>(out + (long long)(q0 + b) * ld + col) =
            tile[b * kTileStride + c];
    }
  }

  if constexpr (kTopk) {
    __syncthreads();
    const int nb = m + 2;
    for (int e = tid; e < kQ * nb; e += kThreads) {
      const int b = e / nb, s = e % nb;
      const int c = shist[b * kBinStride + s];
      if (c && q0 + b < B) atomicAdd(&hist[(long long)(q0 + b) * nb + s], c);
    }
  }
}

// ascending bitonic sort of s[0, T), T a power of two; starts and ends at a
// block barrier
__device__ void bitonic_sort(unsigned long long* s, int T) {
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < T / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// inclusive sum over the block's threads; `sums` holds kSelThreads / 32 ints.
// Starts and ends at a block barrier.
__device__ __forceinline__ int block_scan(int x, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kSelThreads / 32 ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kSelThreads / 32) sums[lane] = s;
  }
  __syncthreads();
  const int out = x + (warp ? sums[warp - 1] : 0);
  *total = sums[kSelThreads / 32 - 1];
  __syncthreads();
  return out;
}

// block b: query b's stored values (length + 1, 0 for a dropped row), row
// lens + b ld, and its histogram hist + b (m + 2) -> its k rows by (length
// descending, row ascending) and their lengths at out_* + b k
template <class S>
__global__ void __launch_bounds__(kSelThreads)
    circrun_topk_kernel(const S* __restrict__ lens, long long ld, const int* __restrict__ hist,
                        int n, int m, int k, int P, int32_t* __restrict__ out_vals,
                        int32_t* __restrict__ out_rows) {
  extern __shared__ unsigned long long keys[];  // P
  __shared__ int sums[kSelThreads / 32];
  __shared__ int meta[3];  // the cut's value, its rows to take, rows chosen
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const int nb = m + 2;
  const int* hb = hist + b * nb;
  for (int j = tid; j < P; j += kSelThreads) keys[j] = ~0ull;
  if (tid == 0) meta[2] = 0;
  if (tid < 32) {
    // the bins from the largest value down: the one where the count reaches k
    const int per = (nb + 31) / 32;
    int sum = 0;
    for (int c = 0; c < per; ++c) {
      const int i = lane * per + c;
      if (i < nb) sum += hb[nb - 1 - i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int before = incl - sum;
    if (before < k && k <= incl) {
      for (int c = 0; c < per; ++c) {
        const int i = lane * per + c;
        const int v = i < nb ? hb[nb - 1 - i] : 0;
        if (before + v >= k) {
          meta[0] = nb - 1 - i;
          meta[1] = k - before;
          break;
        }
        before += v;
      }
    }
  }
  __syncthreads();
  const int cut = meta[0], take = meta[1];

  // every row above the cut, and the cut's first `take` rows in row order;
  // each step's counts are packed (above << 16 | at), at most 16 a thread
  constexpr int kPer = 16 / (int)sizeof(S);
  const S* row = lens + b * ld;
  int ties = 0, chosen = 0;  // block-uniform: the cut's rows and rows chosen before the step
  for (long long base = 0; base < n && chosen < k; base += (long long)kSelThreads * kPer) {
    const long long j0 = base + (long long)tid * kPer;
    union {
      uint4 raw;
      S v[kPer];
    } u;
    u.raw = j0 < n ? *reinterpret_cast<const uint4*>(row + j0) : make_uint4(0, 0, 0, 0);
    int above = 0, at = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (j0 + e < n) {
        above += u.v[e] > cut;
        at += u.v[e] == cut;
      }
    }
    int total;
    const int packed = (above << 16) | at;
    int rank = ties + ((block_scan(packed, sums, &total) - packed) & 0xffff);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (j0 + e < n) {
        const int s = u.v[e];
        if (s > cut || (s == cut && rank++ < take)) {
          const int slot = atomicAdd(&meta[2], 1);
          keys[slot] = ((unsigned long long)(nb - 1 - s) << 32) | (unsigned long long)(j0 + e);
        }
      }
    }
    const int at_total = total & 0xffff;
    chosen += (total >> 16) + min(at_total, max(0, take - ties));
    ties += at_total;
  }
  __syncthreads();

  int32_t* ov = out_vals + b * k;
  int32_t* orow = out_rows + b * k;
  if (k <= kSelThreads) {
    // a key's place is the number of keys below it (the rows are distinct)
    if (tid < k) {
      const unsigned long long key = keys[tid];
      int place = 0;
      for (int j = 0; j < k; ++j) place += keys[j] < key;
      ov[place] = nb - 2 - (int)(key >> 32);
      orow[place] = (int)(key & 0xffffffffu);
    }
  } else {
    bitonic_sort(keys, P);
    for (int i = tid; i < k; i += kSelThreads) {
      const unsigned long long key = keys[i];
      ov[i] = nb - 2 - (int)(key >> 32);
      orow[i] = (int)(key & 0xffffffffu);
    }
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int NW, class OUT>
cudaError_t score(const int32_t* h, const int32_t* q, const uint8_t* ok, OUT* out, long long ld,
                  int* hist, int n, int m, int B, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  static int per_sm = 1;  // resident blocks an SM
  constexpr size_t kSmem = smem_bytes<NW, OUT>();
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        cudaError_t e = cudaFuncSetAttribute(
            circrun_kernel<NW, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, circrun_kernel<NW, OUT>,
                                                             kThreads, kSmem);
      },
      &sms);
  if (err != cudaSuccess) return err;
  constexpr int kQ = Tiling<NW>::kQ;
  const long long groups = (B + kQ - 1) / kQ;
  const long long windows = (n + 31) / 32;
  if (groups > 65535) return cudaErrorInvalidValue;
  // as many row slices as fill one wave of resident blocks (at least one)
  long long slices = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  slices = slices < 1 ? 1 : (slices > windows ? windows : slices);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  circrun_kernel<NW, OUT><<<dim3((unsigned)slices, (unsigned)groups), kThreads, kSmem, stream>>>(
      h, q, ok, out, ld, hist, n, m, B, (int)slices, vec);
  return cudaGetLastError();
}

template <class S>
cudaError_t select_rows(const S* lens, long long ld, const int* hist, int n, int m, int B, int k,
                   int32_t* vals, int32_t* rows, cudaStream_t stream) {
  const int P = k <= kSelThreads ? k : pow2_at_least(k);
  circrun_topk_kernel<S><<<(unsigned)B, kSelThreads, (size_t)P * 8, stream>>>(
      lens, ld, hist, n, m, k, P, vals, rows);
  return cudaGetLastError();
}

}  // namespace

// h (n, m), q (B, m) int32 -> out (B, n) int32 lengths
extern "C" int circrun_launch(const void* h, const void* q, void* out, int n, int m, int B,
                              void* stream) {
  if (n < 0 || m < 1 || m > kMaxM || B < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaSuccess;
  auto hh = static_cast<const int32_t*>(h);
  auto qq = static_cast<const int32_t*>(q);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int nw = (m + 31) / 32;
  if (nw <= 1) return (int)score<1>(hh, qq, nullptr, o, n, nullptr, n, m, B, s);
  if (nw <= 2) return (int)score<2>(hh, qq, nullptr, o, n, nullptr, n, m, B, s);
  if (nw <= 4) return (int)score<4>(hh, qq, nullptr, o, n, nullptr, n, m, B, s);
  if (nw <= 8) return (int)score<8>(hh, qq, nullptr, o, n, nullptr, n, m, B, s);
  return (int)score<16>(hh, qq, nullptr, o, n, nullptr, n, m, B, s);
}

// h (n, m), q (B, m) int32, ok (n,) bool or null -> lens (B, ld) of length + 1
// (0 where ok is 0), uint8 for m <= 254, else uint16, ld a multiple of 32;
// hist (B, m + 2) int32, zeroed by the caller, += the count of each value
extern "C" int circrun_score_launch(const void* h, const void* q, const void* ok, void* lens,
                                    void* hist, int n, int m, int B, int ld, void* stream) {
  if (n < 0 || m < 1 || m > kMaxM || B < 0 || ld < n || ld % 32) return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaSuccess;
  auto hh = static_cast<const int32_t*>(h);
  auto qq = static_cast<const int32_t*>(q);
  auto okk = static_cast<const uint8_t*>(ok);
  auto hs = static_cast<int*>(hist);
  auto s = static_cast<cudaStream_t>(stream);
  const int nw = (m + 31) / 32;
  if (m <= kNarrowM) {
    auto o = static_cast<uint8_t*>(lens);
    if (nw <= 1) return (int)score<1>(hh, qq, okk, o, ld, hs, n, m, B, s);
    if (nw <= 2) return (int)score<2>(hh, qq, okk, o, ld, hs, n, m, B, s);
    if (nw <= 4) return (int)score<4>(hh, qq, okk, o, ld, hs, n, m, B, s);
    return (int)score<8>(hh, qq, okk, o, ld, hs, n, m, B, s);
  }
  auto o = static_cast<uint16_t*>(lens);
  if (nw <= 8) return (int)score<8>(hh, qq, okk, o, ld, hs, n, m, B, s);
  return (int)score<16>(hh, qq, okk, o, ld, hs, n, m, B, s);
}

// lens (B, ld), hist (B, m + 2) from circrun_score_launch -> vals, rows (B, k)
// int32: each query's k rows by (length descending, row ascending), 1 <= k <=
// min(n, 4096)
extern "C" int circrun_topk_launch(const void* lens, const void* hist, void* vals, void* rows,
                                   int n, int m, int B, int k, int ld, void* stream) {
  if (n < 1 || m < 1 || m > kMaxM || B < 0 || k < 1 || k > n || k > kMaxK || ld < n || ld % 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  auto hs = static_cast<const int*>(hist);
  auto v = static_cast<int32_t*>(vals);
  auto r = static_cast<int32_t*>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= kNarrowM)
    return (int)select_rows(static_cast<const uint8_t*>(lens), ld, hs, n, m, B, k, v, r, s);
  return (int)select_rows(static_cast<const uint16_t*>(lens), ld, hs, n, m, B, k, v, r, s);
}
