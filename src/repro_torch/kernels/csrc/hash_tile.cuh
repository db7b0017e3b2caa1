// Shared pieces of the two hashing kernels (hash_rp.cu, hash_xp.cu; pool_topk.cu
// takes DeviceOnce): the cp.async copies that fill their rings of shared-memory stages, the
// transposition of a streamed x stage, and the register-blocked fp32
// product of one stage.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_tile {

// A kernel's launch setup that does not change on a device: `setup()` (say,
// raising its shared-memory limit) runs, and the SM count is read, once a
// device; asking the CUDA runtime again on every launch costs about as much
// as a short launch.  Concurrent first launches both run setup(), which is
// idempotent.
struct DeviceOnce {
  static constexpr int kDevices = 64;
  int sms[kDevices] = {};  // 0: not yet

  template <class Setup>
  cudaError_t get(Setup setup, int* sm_count) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && sms[dev] > 0) {
      *sm_count = sms[dev];
      return cudaSuccess;
    }
    if ((err = setup()) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if (dev < kDevices) sms[dev] = *sm_count;
    return cudaSuccess;
  }
};

// copy 16 or 4 bytes from device memory into shared memory, zero-filling the
// bytes past `src_bytes` (0 reads nothing and writes zeros)
template <int kBytes>
__device__ __forceinline__ void copy(float* dst, const float* src, int src_bytes) {
  static_assert(kBytes == 16 || kBytes == 4, "cp.async copies 16 or 4 bytes here");
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Transposition of a row-major x stage that cp.async filled (xs[r][k], row
// stride kXS) into the k-major one the product reads (xt[k][r], row stride
// kRows), in pieces of one float4 a thread: a warp reads one k quad of 32
// rows (kXS = 20 puts a quarter-warp's rows in distinct banks) and writes 32
// consecutive floats a k.
template <int kRows, int kKC, int kXS, int kThreads>
struct Transpose {
  static constexpr int kPieces = kRows * kKC / 4 / kThreads;
  static_assert(kPieces * kThreads * 4 == kRows * kKC, "a whole number of pieces a thread");

  static __device__ __forceinline__ float4 load(const float* xs, int piece) {
    const int e = threadIdx.x + piece * kThreads;
    return lds4(xs + e % kRows * kXS + 4 * (e / kRows));
  }
  static __device__ __forceinline__ void store(float* xt, int piece, float4 v) {
    const int e = threadIdx.x + piece * kThreads;
    float* p = xt + 4 * (e / kRows) * kRows + e % kRows;
    p[0 * kRows] = v.x;
    p[1 * kRows] = v.y;
    p[2 * kRows] = v.z;
    p[3 * kRows] = v.w;
  }
  static __device__ __forceinline__ void all(float* xt, const float* xs) {
#pragma unroll
    for (int piece = 0; piece < kPieces; ++piece) store(xt, piece, load(xs, piece));
  }
};

// acc[i][c] += sum over k < kKC of xt[k][row_i] * ws[k][col_c], one fmaf a
// k in increasing k, for the thread's rows row_i = 4 ty + i and
// kRowHi + 4 ty + i - 4 (i < 4, i >= 4) of the k-major x stage xt (row
// stride kXLd) and columns col_c = 4 tx + c and kColHi + 4 tx + c - 4 of ws
// (row stride kWLd): four 16-byte loads a k for 64 FMAs
template <int kKC, int kXLd, int kRowHi, int kWLd, int kColHi>
__device__ __forceinline__ void fma_stage(float (&acc)[8][8], const float* xt, const float* ws,
                                          int ty, int tx) {
  const float* xp = xt + 4 * ty;
  const float* wp = ws + 4 * tx;
#pragma unroll
  for (int k = 0; k < kKC; ++k) {
    const float4 x0 = lds4(xp + k * kXLd), x1 = lds4(xp + k * kXLd + kRowHi);
    const float4 w0 = lds4(wp + k * kWLd), w1 = lds4(wp + k * kWLd + kColHi);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
  }
}

}  // namespace hash_tile
