// Fused CSA probe for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/csa_probe/csa_probe.py, csa_probe_pallas
// (kernel body _probe_kernel).  Plain torch version beside it:
// src/repro_torch/kernels/csa_probe/ref.py, csa_probe_plain.
//
// Per worklist row r (probe string qd[qidx[r]], shift i = shifts[r]):
//   1. lower-bound binary search over I[i] in bit_length(n) steps, each step
//      comparing the shift-i circular string of one data row in Hd with the
//      probe's;
//   2. the two boundary LCPs at the insertion position;
//   3. the 2W window LCPs as running minima of the adjacent-LCP row L[i]
//      walking away from the insertion point (lcp(a,c) = min(lcp(a,b),
//      lcp(b,c)) for a <= b <= c).
//
// What bounds it: memory latency, then memory traffic.  A search is
// bit_length(n) dependent steps (20 at n = 10^6), each a random read of
// I[i][mid] and of the data row it names in Hd; below the top levels both
// miss the 50 MB L2 (Hd is 512 MB at n = 10^6, m = 64).  The window then
// moves 32 W bytes a row (2W words each of L and I read, 2W ids and 2W
// lcps written), the larger part of the bytes.
//
// Design:
//   * a group of G lanes runs one search, G = the power of two >= m / kSyms,
//     at least 4 (8 at m = 64: four searches a warp); the probe's shift-i
//     string sits in shared memory, m words a group;
//   * each step compares from the common prefix it already knows (Manber and
//     Myers): lcp_lo = lcp(q, row at lo - 1) and lcp_hi = lcp(q, row at hi),
//     0 where the row does not exist.  I[i] is sorted by the shift-i
//     strings and q lies between those two rows, so every row between them
//     shares k = min(lcp_lo, lcp_hi) symbols with q: the compare starts at
//     symbol k and still gives the exact lcp and less-than bit;
//   * the compare reads the G symbols from k, one word a lane (32 bytes at
//     G = 8), and one ballot finds the first mismatch; only where all G
//     match does a second round read the rest of the string.  The first
//     mismatch lies within a few symbols of k in most steps, so one or two
//     32-byte sectors a step suffice where the whole string from k is 8;
//   * one dependent round trip a step: while a step reads its data row it
//     also loads I[i] at both possible next mids, so the next step's row is
//     known when this one decides.  Once lo == hi the remaining fixed steps
//     change nothing (the reference's mid < hi is false) and load nothing;
//   * no boundary compare: the final lo - 1 and hi rows are the last rows the
//     search compared on each side, so the boundary LCPs are lcp_lo and
//     lcp_hi.  A side the search never moved (pos 0 or pos n) is the clipped,
//     unused row: no output reads its LCP (the reference reads up[0] there);
//   * the window in slot order, in registers: a round gives each lane 4
//     consecutive slots, so one 16-byte store a lane writes 4G consecutive
//     words, from a 32-byte boundary where W is a multiple of 4 (stores in
//     chain order start inside sectors and leave them half written from one
//     instruction to the next, which was far slower at W = 100); the
//     running minima are a suffix scan below slot W and a prefix scan from
//     it, each across the group with a carry from round to round, and the
//     loads of kBatch rounds are issued before their scans.
// The fixed step count and the clipping are the reference's, so rows with
// the insertion point at 0 or n match it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kSyms = 8;    // symbols a lane takes in a full compare: G * kSyms >= m
constexpr int kBatch = 2;   // window rounds whose loads are issued together

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
csa_probe_kernel(const int32_t* __restrict__ I, const int32_t* __restrict__ L,
                 const int32_t* __restrict__ Hd, const int32_t* __restrict__ qd,
                 const int32_t* __restrict__ shifts, const int32_t* __restrict__ qidx,
                 int32_t* __restrict__ ids_out, int32_t* __restrict__ lcps_out,
                 int n, int m, int R, int width, int steps) {
  constexpr int kGroups = kThreads / G;
  constexpr unsigned kGroupBits = G == kWarp ? kFull : ((1u << G) - 1u);
  const int lane = threadIdx.x & (kWarp - 1);
  const int j = lane & (G - 1);       // lane within the group
  const int gbase = lane & ~(G - 1);  // the group's first lane in the warp
  const long long r = (long long)blockIdx.x * kGroups + threadIdx.x / G;
  // a group past the worklist loads and stores nothing, but joins every
  // warp-wide vote and shuffle
  const bool valid = r < R;
  const int i = valid ? __ldg(shifts + r) : 0;
  const int qrow = valid ? __ldg(qidx + r) : 0;
  const int32_t* Irow = I + (long long)i * n;
  const int32_t* Lrow = L + (long long)i * n;
  const long long m2 = 2LL * m;

  // the probe's shift-i string, m words a group
  extern __shared__ int32_t probe_smem[];
  int32_t* q = probe_smem + (threadIdx.x / G) * m;
  for (int p = j; p < m; p += G) q[p] = valid ? __ldg(qd + qrow * m2 + i + p) : 0;
  __syncwarp();

  // 1. lower-bound binary search, the reference's fixed steps
  int lo = 0, hi = n, lcp_lo = 0, lcp_hi = 0;
  int t = valid ? __ldg(Irow + (n >> 1)) : 0;  // the data row at the first mid
  for (int s = 0; s < steps; ++s) {
    const bool active = valid && lo < hi;  // then lo <= mid < hi <= n
    const int mid = (lo + hi) >> 1;
    // the row of the next step's mid, either way this step decides
    const int t_less = (active && mid + 1 < hi) ? __ldg(Irow + ((mid + 1 + hi) >> 1)) : 0;
    const int t_geq = (active && lo < mid) ? __ldg(Irow + ((lo + mid) >> 1)) : 0;
    const int k = min(lcp_lo, lcp_hi);  // symbols every row in [lo, hi) shares with q
    const int32_t* row = Hd + t * m2 + i;
    // round 1: the G symbols from k, one a lane (lane j takes the one that is
    // j modulo G); the first mismatch is the first set bit of the group's
    // vote rotated by k
    const int sh = k & (G - 1);
    const int p1 = k + ((j - sh) & (G - 1));
    const int q1 = p1 < m ? q[p1] : 0;
    const int a1 = (active && p1 < m) ? __ldg(row + p1) : q1;
    const unsigned v1 = (__ballot_sync(kFull, a1 != q1) >> gbase) & kGroupBits;
    const unsigned rot = G == kWarp ? __funnelshift_r(v1, v1, sh)
                                    : ((v1 >> sh) | (v1 << (G - sh))) & kGroupBits;
    const int e1 = rot ? __ffs(rot) - 1 : 0;
    const bool less1 = __shfl_sync(kFull, (int)(a1 < q1), gbase + ((sh + e1) & (G - 1)));
    int lcp = rot ? k + e1 : m;
    bool less = rot && less1;
    // round 2, where the G symbols from k all match: the rest of the string,
    // kSyms words a lane (lane j takes symbols j, j + G, ...), one vote a word
    const bool more = active && !rot && k + G < m;
    if (__any_sync(kFull, more)) {
      int a[kSyms], b[kSyms];
#pragma unroll
      for (int c = 0; c < kSyms; ++c) {
        const int p = c * G + j;
        const bool in = more && p >= k + G && p < m;
        b[c] = in ? q[p] : 0;
        a[c] = in ? __ldg(row + p) : 0;
      }
      bool less_j = false;  // at this lane's first mismatch
      unsigned vote[kSyms];
#pragma unroll
      for (int c = kSyms - 1; c >= 0; --c) {
        if (a[c] != b[c]) less_j = a[c] < b[c];
        vote[c] = (__ballot_sync(kFull, a[c] != b[c]) >> gbase) & kGroupBits;
      }
      int first = m;
      unsigned bits = 0;
#pragma unroll
      for (int c = kSyms - 1; c >= 0; --c) {
        if (vote[c]) {
          bits = vote[c];
          first = c * G;
        }
      }
      const int src = bits ? __ffs(bits) - 1 : 0;
      const bool less2 = __shfl_sync(kFull, (int)less_j, gbase + src);
      if (more) {
        lcp = bits ? first + src : m;
        less = bits && less2;
      }
    }
    if (active) {
      if (less) {
        lo = mid + 1;
        lcp_lo = lcp;
        t = t_less;
      } else {
        hi = mid;
        lcp_hi = lcp;
        t = t_geq;
      }
    }
  }
  const int pos = lo;
  // 2. boundary LCPs: the last rows compared below and above pos
  const int bound_dn = lcp_lo, bound_up = lcp_hi;

  // 3. the window, in slot order.  Slot s of the row holds
  // I[clip(pos - W + s)] and the LCP
  //   s <  W:  min(bound_dn, L[pos-W+s], .., L[pos-2])  (a suffix minimum),
  //   s >= W:  min(bound_up, L[pos], .., L[pos-W+s-1])  (a prefix minimum),
  // an L position outside [0, n-2] counting as m; at pos == 0 the slots
  // below W read bound_up and at pos == n the slots from W read bound_dn, as
  // the reference's clipped positions do.  A round covers 4G slots, lane j
  // slots [4j, 4j + 4) of it, so one store writes 4G consecutive words.
  // Rounds run from the one that holds slot W down to 0 (carrying the
  // suffix minimum) and then up from it (carrying the prefix minimum).
  const int span = 2 * width;
  const int rounds = (span + 4 * G - 1) / (4 * G);
  const int c_mid = width / (4 * G);  // the round that holds slot W
  int32_t* ids_row = ids_out + r * span;
  int32_t* lcps_row = lcps_out + r * span;
  const bool vec = (width & 1) == 0;  // every row starts 16-byte aligned
  int carry_dn = m, carry_up = m;  // minima of the rounds already done
  for (int u0 = 0; u0 < rounds; u0 += kBatch) {
    int lv[kBatch][4], id[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = u0 + b;
      const int c = u <= c_mid ? c_mid - u : u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = c * 4 * G + 4 * j + e;
        const int p = pos - width + sl;
        const bool in = valid && u < rounds && sl < span;
        lv[b][e] = (in && p >= 0 && p <= n - 2) ? __ldg(Lrow + p) : m;
        id[b][e] = in ? __ldg(Irow + clampi(p, 0, n - 1)) : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = u0 + b;
      const int c = u <= c_mid ? c_mid - u : u;
      const int s0 = c * 4 * G + 4 * j;
      // suffix minima of the slots up to W-2, prefix minima from W
      int sd[4], pu[4];
      sd[3] = s0 + 3 <= width - 2 ? lv[b][3] : m;
#pragma unroll
      for (int e = 2; e >= 0; --e) sd[e] = min(sd[e + 1], s0 + e <= width - 2 ? lv[b][e] : m);
      pu[0] = m;
#pragma unroll
      for (int e = 1; e < 4; ++e) pu[e] = min(pu[e - 1], s0 + e - 1 >= width ? lv[b][e - 1] : m);
      int dn = sd[0], up = min(pu[3], s0 + 3 >= width ? lv[b][3] : m);
      // -> minima over the group's lanes >= j and <= j
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        const int o_dn = __shfl_down_sync(kFull, dn, off, G);
        const int o_up = __shfl_up_sync(kFull, up, off, G);
        if (j + off < G) dn = min(dn, o_dn);
        if (j >= off) up = min(up, o_up);
      }
      int above = __shfl_down_sync(kFull, dn, 1, G);
      int below = __shfl_up_sync(kFull, up, 1, G);
      if (j == G - 1) above = m;
      if (j == 0) below = m;
      above = min(above, carry_dn);
      below = min(below, carry_up);
      carry_dn = min(carry_dn, __shfl_sync(kFull, dn, 0, G));
      carry_up = min(carry_up, __shfl_sync(kFull, up, G - 1, G));
      int lc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lc[e] = s0 + e < width ? (pos > 0 ? min(bound_dn, min(sd[e], above)) : bound_up)
                               : (pos < n ? min(bound_up, min(pu[e], below)) : bound_dn);
      if (valid && u < rounds && s0 < span) {
        if (vec) {  // span is a multiple of 4: the lane's 4 slots all exist
          *reinterpret_cast<int4*>(ids_row + s0) = make_int4(id[b][0], id[b][1], id[b][2], id[b][3]);
          *reinterpret_cast<int4*>(lcps_row + s0) = make_int4(lc[0], lc[1], lc[2], lc[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (s0 + e < span) {
              ids_row[s0 + e] = id[b][e];
              lcps_row[s0 + e] = lc[e];
            }
          }
        }
      }
    }
  }
}

template <int G>
cudaError_t launch(const void* I, const void* L, const void* Hd, const void* qd,
                   const void* shifts, const void* qidx, void* ids_out, void* lcps_out,
                   int n, int m, int R, int width, int steps, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  unsigned blocks = (unsigned)((R + kGroups - 1) / kGroups);
  size_t smem = (size_t)kGroups * m * sizeof(int32_t);  // G * kSyms >= m: at most 4 KB
  csa_probe_kernel<G><<<blocks, kThreads, smem, stream>>>(
      (const int32_t*)I, (const int32_t*)L, (const int32_t*)Hd, (const int32_t*)qd,
      (const int32_t*)shifts, (const int32_t*)qidx, (int32_t*)ids_out, (int32_t*)lcps_out,
      n, m, R, width, steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int csa_probe_launch(const void* I, const void* L, const void* Hd, const void* qd,
                                const void* shifts, const void* qidx, void* ids_out,
                                void* lcps_out, int n, int m, int R, int width,
                                void* stream) {
  if (m < 1 || m > kSyms * kWarp || n < 1 || width < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  int steps = 0;
  for (unsigned v = (unsigned)n; v; v >>= 1) ++steps;  // n.bit_length()
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (m <= 4 * kSyms)
    err = launch<4>(I, L, Hd, qd, shifts, qidx, ids_out, lcps_out, n, m, R, width, steps, s);
  else if (m <= 8 * kSyms)
    err = launch<8>(I, L, Hd, qd, shifts, qidx, ids_out, lcps_out, n, m, R, width, steps, s);
  else if (m <= 16 * kSyms)
    err = launch<16>(I, L, Hd, qd, shifts, qidx, ids_out, lcps_out, n, m, R, width, steps, s);
  else
    err = launch<32>(I, L, Hd, qd, shifts, qidx, ids_out, lcps_out, n, m, R, width, steps, s);
  return (int)err;
}
