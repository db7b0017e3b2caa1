// The one step of the Mamba-1 recurrence that the scan (ssm_scan.cu) and its
// backward (ssm_scan_bwd.cu) both run, so that the backward's states,
// recomputed from the forward's checkpoints, equal the forward's bit for bit:
//   h_t = exp2(dt_t * (A log2 e)) * h_{t-1} + (dt_t x_t) B_t
// as one FMUL, one SFU ex2 and one FMA a state (dt_t x_t once a channel).
#pragma once

#include <cuda_runtime.h>

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

}  // namespace ssm
