// Longest circular run of matching symbols on Hopper (sm_90a):
// out[b, r] = the longest circular run of positions k with h[r, k] == q[b, k],
// capped at m -- |LCCS(h[r], q[b])| of the brute-force source and the delta
// buffer of the dynamic index.
//
// Replaces: src/repro/kernels/circrun/circrun.py, circrun_pallas (batched over
// queries as src/repro/kernels/circrun/ops.py does).  Plain torch version
// beside it: src/repro_torch/kernels/circrun/ref.py.
//
// What bounds it: integer operations.  Counting a compare and a run update
// per position, B n 2m of them (8.4 G at B = 1,000, n = 65,536, m = 64: 0.5 ms
// at 132 SMs x 64 int32 lanes x 1.98 GHz), against 4 (nm + Bm + Bn) bytes
// (0.28 GB, 0.08 ms), most of them the (B, n) output.
//
// Design:
//   * a block covers 64 rows and 32 queries; both tiles are staged in shared
//     memory.  The row stride is odd (m | 1 words), so the 32 lanes of a warp,
//     on 32 consecutive rows, read 32 different banks; the query symbol is
//     one broadcast read;
//   * thread t takes row t % 64 and 8 of the queries, and makes one pass over
//     the m positions keeping, per query, the current run, the best run and
//     the leading run (the run before the first mismatch).  The circular
//     answer is m when no position mismatched, else max(best, leading +
//     trailing run): a run that wraps is a trailing run joined to the leading
//     one.  That equals the reference's pass over the 2m doubled positions
//     capped at m, with half the steps;
//   * symbols are compared as plain int32, so negative hashes and the
//     int32-max sentinel rows of segments need nothing special.  Ragged rows
//     and queries are masked by index; there is no pad sentinel;
//   * a warp writes 32 consecutive rows of one query: coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows per block
constexpr int kQueries = 32;   // queries per block
constexpr int kPerThread = 8;  // queries per thread
constexpr int kThreads = kRows * kQueries / kPerThread;  // 256

__global__ void __launch_bounds__(kThreads)
circrun_kernel(const int32_t* __restrict__ h, const int32_t* __restrict__ q,
               int32_t* __restrict__ out, int n, int m, int B) {
  extern __shared__ int32_t smem[];
  const int stride = m | 1;          // odd row stride: conflict-free
  int32_t* hs = smem;                // (kRows, stride)
  int32_t* qs = smem + kRows * stride;  // (kQueries, m)
  const long long row0 = (long long)blockIdx.x * kRows;
  const int q0 = blockIdx.y * kQueries;

  for (int e = threadIdx.x; e < kRows * m; e += kThreads) {
    int r = e / m, k = e % m;
    long long row = row0 + r;
    hs[r * stride + k] = row < n ? h[row * m + k] : 0;
  }
  for (int e = threadIdx.x; e < kQueries * m; e += kThreads) {
    int qq = e / m, k = e % m;
    qs[qq * m + k] = (q0 + qq) < B ? q[(long long)(q0 + qq) * m + k] : 0;
  }
  __syncthreads();

  const int r = threadIdx.x % kRows;
  const int g = threadIdx.x / kRows;  // query group: queries g * 8 .. g * 8 + 7
  const int32_t* hrow = hs + r * stride;
  const int32_t* qrow = qs + g * kPerThread * m;
  int run[kPerThread], best[kPerThread], lead[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    run[u] = 0;
    best[u] = 0;
    lead[u] = -1;  // no mismatch seen yet
  }
  for (int k = 0; k < m; ++k) {
    int32_t hv = hrow[k];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      bool eq = hv == qrow[u * m + k];
      lead[u] = (!eq && lead[u] < 0) ? run[u] : lead[u];
      run[u] = eq ? run[u] + 1 : 0;
      best[u] = max(best[u], run[u]);
    }
  }

  long long row = row0 + r;
  if (row >= n) return;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    int qb = q0 + g * kPerThread + u;
    if (qb >= B) break;
    int res = lead[u] < 0 ? m : max(best[u], lead[u] + run[u]);
    out[(long long)qb * n + row] = res;
  }
}

}  // namespace

extern "C" int circrun_launch(const void* h, const void* q, void* out, int n, int m, int B,
                              void* stream) {
  if (n < 0 || m < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaSuccess;
  size_t shmem = ((size_t)kRows * (m | 1) + (size_t)kQueries * m) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(circrun_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)((B + kQueries - 1) / kQueries));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  circrun_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const int32_t*)h, (const int32_t*)q, (int32_t*)out, n, m, B);
  return (int)cudaGetLastError();
}
