// Cross-polytope LSH hashing with a gaussian rotation on Hopper (sm_90a):
// out[r, j] = argmax over [0, 2 dr) of cat([y, -y]), y = x[r] @ rot[j]
// (paper Eq. 3): index i is +e_i and dr + i is -e_i.  The larger value wins,
// and on an exact tie the lower index, as jnp.argmax does.
//
// Replaces: src/repro/kernels/hash_xp/hash_xp.py, hash_xp_pallas.  Plain torch
// version beside it: src/repro_torch/kernels/hash_xp/ref.py.
//
// What bounds it: operations.  2 n m d dr flops (2.1 TFLOP at n = 10^6,
// m = 64, d = dr = 128: 31 ms at the fp32 rate of 67 TFLOP/s) against
// 4 (nd + m d dr + nm) bytes (0.8 GB: 0.24 ms at 3.35 TB/s).
//
// Design:
//   * fp32 FMAs on the CUDA cores, no tensor cores: TF32 would reorder near
//     ties between vertices;
//   * a block covers 32 rows and one function j.  It walks dr in tiles of 128
//     columns and d in chunks of 32, staging the x chunk and the rot[j] chunk
//     in shared memory (20 KB), so any d and dr fit;
//   * each of the 256 threads holds 4 rows x 4 columns of y in registers.
//     Warp w holds rows w, w + 8, w + 16, w + 24 over all 128 columns of the
//     tile, so a row's argmax is one warp-shuffle reduction; the running best
//     across column tiles stays in registers;
//   * y never reaches device memory: only the (n, m) int32 result is written.
//     The comparison (value, then lower index) is a total order, so the
//     reduction order does not change the result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows per block
constexpr int kCols = 128;     // y columns per tile
constexpr int kTileK = 32;     // d per shared-memory stage
constexpr int kThreads = 256;  // 8 warps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
hash_xp_kernel(const float* __restrict__ x, const float* __restrict__ rot,
               int32_t* __restrict__ out, int n, int d, int m, int dr) {
  __shared__ float xs[kTileK][kRows + 1];  // x chunk, transposed: xs[k][row]
  __shared__ float rs[kTileK][kCols];      // rot[j] chunk: rs[k][col]
  const int lane = threadIdx.x % 32;       // columns lane + 32 c
  const int warp = threadIdx.x / 32;       // rows warp + 8 i
  const long long row0 = (long long)blockIdx.x * kRows;
  const int j = blockIdx.y;
  const float* R = rot + (long long)j * d * dr;

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = -INFINITY;
    best_i[i] = 0x7fffffff;
  }

  for (int e0 = 0; e0 < dr; e0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTileK) {
      for (int e = threadIdx.x; e < kRows * kTileK; e += kThreads) {
        int r = e / kTileK, kk = e % kTileK;
        long long row = row0 + r;
        int k = k0 + kk;
        xs[kk][r] = (row < n && k < d) ? x[row * d + k] : 0.f;
      }
      for (int e = threadIdx.x; e < kTileK * kCols; e += kThreads) {
        int kk = e / kCols, c = e % kCols;
        int k = k0 + kk, col = e0 + c;
        rs[kk][c] = (k < d && col < dr) ? R[(long long)k * dr + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTileK; ++kk) {
        float xv[4], rv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[kk][warp + 8 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) rv[c] = rs[kk][lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[i], rv[c], acc[i][c]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int col = e0 + lane + 32 * c;
        if (col >= dr) continue;
        float y = acc[i][c];
        if (better(y, col, bv, bi)) { bv = y; bi = col; }
        if (better(-y, dr + col, bv, bi)) { bv = -y; bi = dr + col; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(kFull, bv, off);
        int oi = __shfl_xor_sync(kFull, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (better(bv, bi, best_v[i], best_i[i])) { best_v[i] = bv; best_i[i] = bi; }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      long long row = row0 + warp + 8 * i;
      if (row < n) out[row * m + j] = best_i[i];
    }
  }
}

}  // namespace

extern "C" int hash_xp_launch(const void* x, const void* rot, void* out, int n, int d, int m,
                              int dr, void* stream) {
  if (n < 0 || d < 1 || m < 1 || dr < 1 || m > 65535) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)m);
  hash_xp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)rot, (int32_t*)out, n, d, m, dr);
  return (int)cudaGetLastError();
}
