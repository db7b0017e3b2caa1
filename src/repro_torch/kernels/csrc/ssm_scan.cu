// Mamba-1 selective scan on Hopper (sm_90a), batched over sequences:
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t ,   y_t = h_t . C_t
// for every (batch row b, channel d), over the time steps [t0, t1) of
// dt, x (B, L, D), Bc, Cc (B, L, N) and A (D, N), starting from h0 (B, D, N);
// writes y (B, L, D) at those steps and the final state to h_out (B, D, N).
// All float32, contiguous.  A sequence longer than one call's chunk is
// scanned by calling again with the next [t0, t1) and h_out as h0.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, ssm_scan_pallas (and the
// batch vmap and sequence chunking of src/repro/kernels/ssm_scan/ops.py).
// Plain torch version beside it: src/repro_torch/kernels/ssm_scan/ref.py.
//
// What bounds it: bytes.  Each step reads dt and x and writes y (12 bytes a
// channel) and does about 7 N float operations on the state (N = 16: 112);
// the H100's 67 TFLOP/s float32 against 3.35 TB/s is 20 operations a byte,
// so reads of dt, x and y bound it, as long as the serial dependence through
// h is hidden by enough channels in flight.
//
// Design:
//   * one thread per (b, channel d): its state h[N] and its row A[d, :] live
//     in registers for the whole time loop (N <= 16 for every Mamba-1
//     configuration);
//   * a block covers 128 consecutive channels of one batch row, so the dt, x
//     and y accesses of a warp are 32 consecutive floats (coalesced), in the
//     (B, L, D) layout the model computes them in: no transpose;
//   * B_t and C_t of 32 steps at a time are staged in shared memory and read
//     as broadcasts;
//   * expf, not __expf (no --use_fast_math), as the reference's exp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kMaxN = 16;      // largest state size
constexpr int kSteps = 32;     // time steps of B and C staged at once

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int L, int D, int N,
                int t0, int t1) {
  __shared__ float bs[kSteps][kMaxN];
  __shared__ float cs[kSteps][kMaxN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;

  float h[kMaxN], a_row[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    bool in = active && n < N;
    h[n] = in ? h0[((long long)b * D + d) * N + n] : 0.f;
    a_row[n] = in ? A[(long long)d * N + n] : 0.f;
  }

  const long long row = (long long)b * L;  // first step of this batch row
  for (int s0 = t0; s0 < t1; s0 += kSteps) {
    const int steps = min(kSteps, t1 - s0);
    __syncthreads();  // the previous steps' B and C are consumed
    for (int e = threadIdx.x; e < steps * N; e += kThreads) {
      int s = e / N, n = e - s * N;
      long long src = (row + s0 + s) * N + n;
      bs[s][n] = Bc[src];
      cs[s][n] = Cc[src];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < steps; ++s) {
      const long long at = (row + s0 + s) * D + d;
      const float dt_t = dt[at];
      const float dtx = dt_t * x[at];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          float a = expf(dt_t * a_row[n]);
          h[n] = a * h[n] + dtx * bs[s][n];
          acc = fmaf(h[n], cs[s][n], acc);
        }
      }
      y[at] = acc;
    }
  }
  if (!active) return;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n)
    if (n < N) h_out[((long long)b * D + d) * N + n] = h[n];
}

}  // namespace

extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* Bc, const void* Cc,
                               const void* A, const void* h0, void* y, void* h_out, int B,
                               int L, int D, int N, int t0, int t1, void* stream) {
  if (B < 0 || L < 0 || D < 0 || N < 1 || N > kMaxN || t0 < 0 || t1 < t0 || t1 > L)
    return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  ssm_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dt, (const float*)x, (const float*)Bc, (const float*)Cc,
      (const float*)A, (const float*)h0, (float*)y, (float*)h_out, L, D, N, t0, t1);
  return (int)cudaGetLastError();
}
