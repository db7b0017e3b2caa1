// Fused CSA probe for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/csa_probe/csa_probe.py, csa_probe_pallas
// (kernel body _probe_kernel).  Plain torch version beside it:
// src/repro_torch/kernels/csa_probe/ref.py, probe_pairs_ref.
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
// What bounds it: memory latency, not bandwidth or arithmetic.  Each row
// makes bit_length(n) dependent steps, and each step is a random read of
// I[i][mid] followed by a random m-word read of Hd[t] -- two round trips to
// device memory per step (about 40 for n = 10^6).  The bytes a row needs
// are small (about 20 * (4 + 4m) + 8W).
//
// Design:
//   * one warp per row, several rows per block, and many blocks in flight,
//     so that the card keeps enough independent searches outstanding to
//     hide the latency of each one;
//   * the probe's shift-i string sits in registers (lane j holds symbols j,
//     j+32, ...); a step's m-symbol comparison is one coalesced read of the
//     data row by the warp, and __ballot_sync + __ffs find the first
//     mismatch (lcp and the less-than bit) without a loop over symbols;
//   * Hd, I and L stay in device memory.  The TPU kernel kept Hd resident in
//     on-chip memory, which capped it at n <= ~31k for m = 64; Hd is 512 MB at
//     n = 10^6, so here it is read through L2 and no n bound applies;
//   * the window walk reads W contiguous L entries per side (coalesced) and
//     takes the running minimum with a warp shuffle scan.
// Positions are clipped exactly as _probe_kernel clips them, so rows with
// the insertion point at 0 or n match the reference bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;        // m <= 256 symbols per string
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Cmp {
  int lcp;
  bool less;
};

// lcp and (data < query) of data row t's shift-i string against the probe
// symbols held in registers (q[c] = probe symbol lane + 32c of shift i).
__device__ __forceinline__ Cmp compare_row(const int32_t* __restrict__ Hd, long long t,
                                           int i, int m, const int (&q)[kMaxChunks],
                                           int chunks, int lane) {
  const int32_t* row = Hd + t * (2LL * m) + i;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {  // unrolled: q stays in registers
    if (c >= chunks) break;
    int j = lane + c * kWarp;
    bool in = j < m;
    int a = in ? __ldg(row + j) : 0;
    bool neq = in && (a != q[c]);
    unsigned bal = __ballot_sync(kFull, neq);
    if (bal) {
      int src = __ffs(bal) - 1;
      int less = __shfl_sync(kFull, (int)(a < q[c]), src);
      return Cmp{c * kWarp + src, less != 0};
    }
  }
  return Cmp{m, false};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Inclusive running min over the 32-wide chunk held one value per lane.
__device__ __forceinline__ int warp_scan_min(int v, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = min(v, o);
  }
  return v;
}

// out[j] = min(bound, min(adj[0..j-1])) for j < width (out[0] = bound), where
// adj[t] = L[start + dir * t] when that position lies in [0, n-2], else m.
__device__ void chain(const int32_t* __restrict__ Lrow, int start, int dir, int bound,
                      int width, int n, int m, int* out, int lane) {
  int carry = m;  // min of adj[0 .. 32c-1]
  for (int base = 0; base < width; base += kWarp) {
    int t = base + lane;
    int p = start + dir * t;
    int adj = (t < width && p >= 0 && p <= n - 2) ? __ldg(Lrow + p) : m;
    int incl = min(warp_scan_min(adj, lane), carry);
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = carry;
    if (t < width) out[t] = min(bound, excl);
    carry = __shfl_sync(kFull, incl, kWarp - 1);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
csa_probe_kernel(const int32_t* __restrict__ I, const int32_t* __restrict__ L,
                 const int32_t* __restrict__ Hd, const int32_t* __restrict__ qd,
                 const int32_t* __restrict__ shifts, const int32_t* __restrict__ qidx,
                 int32_t* __restrict__ ids_out, int32_t* __restrict__ lcps_out,
                 int n, int m, int R, int width, int steps) {
  extern __shared__ int smem[];  // per warp: up[width], down[width]
  int warp = threadIdx.x / kWarp;
  int lane = threadIdx.x % kWarp;
  long long r = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;  // whole warp leaves together
  int* up = smem + warp * 2 * width;
  int* down = up + width;

  int i = shifts[r];
  const int32_t* qrow = qd + (long long)qidx[r] * 2 * m + i;
  const int32_t* Irow = I + (long long)i * n;
  const int32_t* Lrow = L + (long long)i * n;
  int chunks = (m + kWarp - 1) / kWarp;
  int q[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    int j = lane + c * kWarp;
    q[c] = (c < chunks && j < m) ? qrow[j] : 0;
  }

  // 1. lower-bound binary search (fixed steps, as the reference)
  int lo = 0, hi = n;
  for (int s = 0; s < steps; ++s) {
    int mid = (lo + hi) >> 1;  // lo, hi >= 0: floor division
    int t = __ldg(Irow + clampi(mid, 0, n - 1));
    Cmp cmp = compare_row(Hd, t, i, m, q, chunks, lane);
    bool take = (mid < hi) && cmp.less;
    if (take) lo = mid + 1; else hi = min(hi, mid);
  }
  int pos = lo;

  // 2. boundary LCPs (pos == 0 / pos == n read a clipped, unused row)
  int lcp_l = compare_row(Hd, __ldg(Irow + clampi(pos - 1, 0, n - 1)), i, m, q, chunks, lane).lcp;
  int lcp_u = compare_row(Hd, __ldg(Irow + clampi(pos, 0, n - 1)), i, m, q, chunks, lane).lcp;

  // 3. window walk: running minima of L away from the insertion point
  chain(Lrow, pos - 2, -1, lcp_l, width, n, m, down, lane);
  chain(Lrow, pos, +1, lcp_u, width, n, m, up, lane);
  __syncwarp();

  long long o = r * 2 * width;
  for (int s = lane; s < 2 * width; s += kWarp) {
    int p = clampi(pos + s - width, 0, n - 1);
    ids_out[o + s] = __ldg(Irow + p);
    lcps_out[o + s] = (p >= pos) ? up[clampi(p - pos, 0, width - 1)]
                                 : down[clampi(pos - 1 - p, 0, width - 1)];
  }
}

}  // namespace

extern "C" int csa_probe_launch(const void* I, const void* L, const void* Hd, const void* qd,
                                const void* shifts, const void* qidx, void* ids_out,
                                void* lcps_out, int n, int m, int R, int width,
                                void* stream) {
  if (m < 1 || m > kMaxChunks * kWarp || n < 1 || width < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  int steps = 0;
  for (unsigned v = (unsigned)n; v; v >>= 1) ++steps;  // n.bit_length()
  if (steps < 1) steps = 1;
  size_t shmem = (size_t)kWarpsPerBlock * 2 * width * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(csa_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned blocks = (unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  csa_probe_kernel<<<blocks, kWarpsPerBlock * kWarp, shmem, (cudaStream_t)stream>>>(
      (const int32_t*)I, (const int32_t*)L, (const int32_t*)Hd, (const int32_t*)qd,
      (const int32_t*)shifts, (const int32_t*)qidx, (int32_t*)ids_out, (int32_t*)lcps_out,
      n, m, R, width, steps);
  return (int)cudaGetLastError();
}
