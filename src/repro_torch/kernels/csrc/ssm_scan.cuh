// The one step of the Mamba-1 recurrence that the scan (ssm_scan.cu) and its
// backward (ssm_scan_bwd.cu) both run, so that the backward's states,
// recomputed from the forward's checkpoints, equal the forward's bit for bit:
//   h_t = exp2(dt_t * (A log2 e)) * h_{t-1} + (dt_t x_t) B_t
// as one FMUL, one SFU ex2 and one FMA a state (dt_t x_t once a channel).
// Also the pieces both kernels use to read dt, x, B and C of either input
// type (float32, or bf16 under the model's ssm_bf16_acts): a bf16 value is
// widened to float32 in registers as it is read from shared memory, and
// everything after that is the float32 kernel's arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"

namespace ssm {

constexpr float kLog2e = 1.4426950408889634f;

// ex2.approx.ftz: at most 2 ulp of error; a subnormal result flushes to 0
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// h_{t-1} -> h_t of one state: a2 = A * kLog2e, dtx = dt_t * x_t, b = B_t;
// a_t = exp2(dt_t a2) to `a` (the backward keeps it for its walk)
__device__ __forceinline__ float step(float h, float dt, float a2, float dtx, float b, float& a) {
  a = exp2_ftz(dt * a2);
  return fmaf(a, h, dtx * b);
}

__device__ __forceinline__ float step(float h, float dt, float a2, float dtx, float b) {
  float a;
  return step(h, dt, a2, dtx, b, a);
}

// an input value widened to float32 (exact for bf16)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// a float32 result stored as T: as it is, or rounded to nearest even (the
// rounding torch's .to(torch.bfloat16) does)
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 consecutive values from shared memory as float32: one 16-byte read of
// float32, one 8-byte read of bf16
__device__ __forceinline__ float4 load4(const float* p) { return hash_tile::lds4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// values of T a 16-byte cp.async piece carries
template <class T>
constexpr int kPiece = 16 / (int)sizeof(T);

// one 16-byte piece of T into shared memory by cp.async (zeros where `in`
// is false: nothing is read)
template <class T>
__device__ __forceinline__ void copy16(T* dst, const T* src, bool in) {
  hash_tile::copy<16>(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
                      in ? 16 : 0);
}

// one value of T into shared memory, 0 where `in` is false: a 4-byte
// cp.async for float32; bf16, below cp.async's smallest piece, by a load and
// a store (before the barrier that publishes the stage, as the copies')
__device__ __forceinline__ void copy1(float* dst, const float* src, bool in) {
  hash_tile::copy<4>(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? *src : __float2bfloat16_rn(0.f);
}

}  // namespace ssm
