// Shared pieces of the flash-attention kernels (flash_attn.cu, flash_attn_bwd.cu):
// the 3xTF32 split and tensor-core product, the bf16 product of their bf16-P
// forms (attn_bf16_probs), the approximate exp2 and reciprocal whose error
// both sources bound, and the cp.async staging of rows padded with zeros to
// DP columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_ftz(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// c += a b on the tensor cores, one m16n8k8 tf32 product with fp32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even, as torch's .to(torch.bfloat16))
// and packed as an MMA operand register: lo, the lower k index, in the low
// half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b on the tensor cores, one m16n8k16 bf16 product with fp32
// accumulation (the products of two bf16 values are exact in fp32).  A
// (16 x 16, row major): a[0] row g, k 2t and 2t + 1; a[1] row g + 8, the
// same k; a[2], a[3] those rows at k + 8.  B (16 x 8): b0 k 2t and 2t + 1,
// b1 k 2t + 8 and 2t + 9, column g.  C as the m16n8k8 product's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage kRows rows of dh floats into shared memory (row stride ld), padded
// with zeros to DP columns; row(r) gives row r's source, nullptr for a row
// to zero-fill.  `any` is a valid address for the zero-filling copies.
template <int DP, int kRows, int kThreads, class Row>
__device__ __forceinline__ void stage(float* dst, int ld, const Row& row, int dh, bool vec,
                                      const float* any) {
  if (vec) {
    constexpr int kC = DP / 4;
    for (int s = threadIdx.x; s < kRows * kC; s += kThreads) {
      const int r = s / kC, c = 4 * (s - r * kC);
      const float* src = row(r);
      const bool in = src != nullptr && c < dh;
      hash_tile::copy<16>(dst + r * ld + c, in ? src + c : any, in ? 16 : 0);
    }
  } else {
    for (int s = threadIdx.x; s < kRows * DP; s += kThreads) {
      const int r = s / DP, c = s - r * DP;
      const float* src = row(r);
      const bool in = src != nullptr && c < dh;
      hash_tile::copy<4>(dst + r * ld + c, in ? src + c : any, in ? 4 : 0);
    }
  }
}

}  // namespace tf32x3
