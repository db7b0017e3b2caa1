// Backward of the Mamba-1 selective scan (ssm_scan.cu) on Hopper (sm_90a).
// The forward, for every batch row b and channel d over L steps:
//   a_t = exp(dt_t A),  h_t = a_t * h_{t-1} + (dt_t x_t) B_t,  y_t = h_t . C_t
// Given dy (B, L, D) and dh_fin (B, D, N; nullptr is zero), with g_t the
// gradient of h_t (g_{L-1} = dh_fin + dy_{L-1} C_{L-1}, g_t = a_{t+1} g_{t+1}
// + dy_t C_t), it writes
//   ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t),  dx_t = dt_t sum_n g_t B_t,
//   dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t,
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1},  dh0 = a_0 g_0 (nullptr: not written).
// All float32, contiguous, N <= 16.
//
// Replaces no TPU kernel: the reference trains Mamba-1 by jax.value_and_grad
// through _mamba1_fused (src/repro/models/ssm.py:103) or _mamba1_scan (:74).
// Plain torch version beside it: src/repro_torch/kernels/ssm_scan/ref.py,
// ssm_scan_bwd_ref.
//
// What bounds it: the bytes.  It reads dt, x, dy (12 bytes a channel and
// step), the forward's checkpoints (the state entering each 32-step tile, 64
// bytes a channel and tile at N 16), B and C, and writes ddt and dx (8 bytes
// a channel and step) and dh0: at the training shape (B 8, L 64, D 8192, N
// 16) 97 MB, 0.029 ms at 3.35 TB/s, against 67 M states x steps whose one
// exp each takes 0.016 ms on the SFUs (this design takes two: the recompute
// and the walk).  At B 4, L 2048 the bytes are 1.48 GB (0.44 ms) against
// 1.07 G exps (0.26 ms).  Beside them the dB / dC partials of the channel
// blocks, 2 x 4 N bytes a block and step, are written and read again once by
// the reduce.
//
// Design (a first, simple kernel):
//   * the forward's lane layout: G lanes a channel (G = 1, 2, 4 for N up to
//     4, 8, 16), 4 states a lane, one channel a thread, 32 channels of one
//     batch row a block (32 G threads, G warps); the grid is channel blocks
//     x batch rows, as the forward's;
//   * the tiles go from last to first.  A tile's dt, x, dy, B and C are
//     copied into shared memory (zeros past L, D and N); each thread reloads
//     its states from the tile's checkpoint and recomputes the tile's 32
//     steps with ssm::step, the forward's arithmetic, so that each state
//     equals the forward's bit for bit, keeping the state entering each step
//     in shared memory (a 16-byte vector a thread and step).  No state is
//     recovered by running the recurrence backwards: h_{t-1} = (h_t - b_t) /
//     a_t divides by an a_t that underflows to 0;
//   * then it steps backwards through the tile, g and the sum a_{t+1} g_{t+1}
//     in registers across tiles, a_t recomputed (one ex2 a state and step):
//       - dx and ddt: the lane's sum over its 4 states, then the G lanes'
//         sums by a butterfly (every lane ends with the same bits), staged
//         in shared memory and stored a tile at a time;
//       - dA: accumulated in registers, one batch row a block, written per
//         row to a partial buffer;
//       - dB_t and dC_t (8 values a lane: 4 states each): summed over the
//         warp's channels by a transposed reduce (the lanes exchange half of
//         their values at each level, 4 + 2 + 1 shuffles, after which each
//         lane holds one value), then over the block's G warps in warp order
//         at the tile's end, into the partial buffer (B, channel blocks, L,
//         N);
//   * a second kernel behind the same entry point sums the dB and dC
//     partials over the channel blocks in block order, and dA over the
//     batch rows in row order.  No atomics: reruns give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"
#include "ssm_scan.cuh"

namespace {

constexpr int kMaxN = 16;   // largest state size
constexpr int kS = 4;       // states a lane
constexpr int kCh = 32;     // channels a block
constexpr int kSteps = 32;  // steps a tile: the forward's checkpoint interval

// Shared memory of a block of G lanes a channel, in floats: the state
// entering each step of the tile (a float4 a thread and step), dt, x and dy
// (kSteps x kCh), B and C (kSteps x kMaxN), the tile's ddt and dx, and the
// warps' dB / dC sums (kSteps x G warps x 8 values x G state groups).
template <int G>
struct Smem {
  static constexpr int kThreads = kCh * G;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStates = kSteps * kThreads * kS;
  static constexpr int kInputs = 3 * kSteps * kCh + 2 * kSteps * kMaxN;
  static constexpr int kOut = 2 * kSteps * kCh;
  static constexpr int kRed = kSteps * kWarps * 8 * G;
  static constexpr int kFloats = kStates + kInputs + kOut + kRed;
};

struct BwdArgs {
  const float *dt, *x, *Bc, *Cc, *A, *ckpt, *dy, *dh_fin;
  float *ddt, *dx, *dh0;
  float *pB, *pC, *dA_part;  // partials: (B, blocks, L, N) twice, (B, D, N)
  int L, D, N, blocks;
};

// v[0..7] of every lane summed over the warp's channels (lane bits 2, 3, 4
// and, below 4 lanes a channel, 1 and 0): the lanes exchange half of their
// values at each of the levels 16, 8, 4 (the upper half kept where the bit
// is set), then add by butterfly.  Returns v[(lane >> 2) & 7]'s sum, the
// same on the lanes that differ only in the bits below G's.
template <int G>
__device__ __forceinline__ float warp_channel_sum(float (&v)[8], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int half = 4, m = 16; half >= 1; half >>= 1, m >>= 1) {
    const bool hi = lane & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = hi ? v[half + i] : v[i], send = hi ? v[i] : v[half + i];
      v[i] = keep + __shfl_xor_sync(kAll, send, m);
    }
  }
  float r = v[0];
  if constexpr (G <= 2) r += __shfl_xor_sync(kAll, r, 2);
  if constexpr (G == 1) r += __shfl_xor_sync(kAll, r, 1);
  return r;
}

template <int G>
__global__ void __launch_bounds__(kCh * G) ssm_scan_bwd_kernel(const BwdArgs a) {
  using S = Smem<G>;
  constexpr int kThreads = S::kThreads, kWarps = S::kWarps;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* dts = hs + S::kStates;
  float* xs = dts + kSteps * kCh;
  float* dys = xs + kSteps * kCh;
  float* bs = dys + kSteps * kCh;
  float* cs = bs + kSteps * kMaxN;
  float* ddts = cs + kSteps * kMaxN;
  float* dxs = ddts + kSteps * kCh;
  float* red = dxs + kSteps * kCh;

  const int tid = threadIdx.x, q = tid / G, g = tid % G, lane = tid & 31, w = tid >> 5;
  const int L = a.L, D = a.D, N = a.N;
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kCh, d = d0 + q;
  const bool live = d < D;
  const long long row = (long long)b * L;  // first step of this batch row
  const int tiles = (L + kSteps - 1) / kSteps;

  // this lane's states n = kS g + k: A, A log2(e) (as the forward forms
  // it), the gradient flowing into h from later steps, dA's sum
  float Av[kS] = {}, a2[kS] = {}, gn[kS] = {}, dA[kS] = {};
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int n = kS * g + k;
    if (!live || n >= N) continue;
    Av[k] = a.A[(long long)d * N + n];
    a2[k] = Av[k] * ssm::kLog2e;
    if (a.dh_fin) gn[k] = a.dh_fin[((long long)b * D + d) * N + n];
  }

  for (int t = tiles - 1; t >= 0; --t) {
    const int s0 = t * kSteps, steps = min(kSteps, L - s0);
    __syncthreads();  // the previous tile's reads of the stage are done
    for (int e = tid; e < kSteps * kCh; e += kThreads) {
      const int s = e / kCh, c = e % kCh;
      const bool in = s < steps && d0 + c < D;
      const long long at = (row + s0 + s) * D + d0 + c;
      dts[e] = in ? a.dt[at] : 0.f;
      xs[e] = in ? a.x[at] : 0.f;
      dys[e] = in ? a.dy[at] : 0.f;
    }
    for (int e = tid; e < kSteps * kMaxN; e += kThreads) {
      const int s = e / kMaxN, n = e % kMaxN;
      const bool in = s < steps && n < N;
      const long long at = (row + s0 + s) * N + n;
      bs[e] = in ? a.Bc[at] : 0.f;
      cs[e] = in ? a.Cc[at] : 0.f;
    }
    float h[kS] = {};
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int n = kS * g + k;
      if (live && n < N) h[k] = a.ckpt[(((long long)b * tiles + t) * D + d) * N + n];
    }
    __syncthreads();  // the tile is in shared memory

    // the tile's states from its checkpoint, in the forward's arithmetic
    for (int s = 0; s < steps; ++s) {
      *reinterpret_cast<float4*>(hs + (s * kThreads + tid) * kS) =
          make_float4(h[0], h[1], h[2], h[3]);
      const float dtv = dts[s * kCh + q], xv = xs[s * kCh + q];
      const float4 bv = hash_tile::lds4(bs + s * kMaxN + kS * g);
      const float dtx = dtv * xv;
      h[0] = ssm::step(h[0], dtv, a2[0], dtx, bv.x);
      h[1] = ssm::step(h[1], dtv, a2[1], dtx, bv.y);
      h[2] = ssm::step(h[2], dtv, a2[2], dtx, bv.z);
      h[3] = ssm::step(h[3], dtv, a2[3], dtx, bv.w);
    }

    // backwards through the tile: h holds h_s, hs[s] h_{s-1}
    for (int s = steps - 1; s >= 0; --s) {
      const float dtv = dts[s * kCh + q], xv = xs[s * kCh + q], dyv = dys[s * kCh + q];
      const float4 b4 = hash_tile::lds4(bs + s * kMaxN + kS * g);
      const float4 c4 = hash_tile::lds4(cs + s * kMaxN + kS * g);
      const float4 p4 = hash_tile::lds4(hs + (s * kThreads + tid) * kS);
      const float bv[kS] = {b4.x, b4.y, b4.z, b4.w}, cv[kS] = {c4.x, c4.y, c4.z, c4.w};
      const float hp[kS] = {p4.x, p4.y, p4.z, p4.w};
      const float dtx = dtv * xv;
      float v[8], px = 0.f, pdt = 0.f;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const float e = ssm::exp2_ftz(dtv * a2[k]);  // a_s
        const float gk = fmaf(dyv, cv[k], gn[k]);     // g_s
        const float u = e * hp[k];                    // a_s h_{s-1}
        v[k] = gk * dtx;                              // dB_s's term
        v[kS + k] = dyv * h[k];                       // dC_s's term
        px = fmaf(gk, bv[k], px);
        pdt = fmaf(gk, fmaf(Av[k], u, xv * bv[k]), pdt);
        dA[k] = fmaf(gk * dtv, u, dA[k]);
        gn[k] = e * gk;
        h[k] = hp[k];
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) {
        px += __shfl_xor_sync(kAll, px, m);
        pdt += __shfl_xor_sync(kAll, pdt, m);
      }
      if (g == 0) {
        ddts[s * kCh + q] = pdt;
        dxs[s * kCh + q] = dtv * px;
      }
      const float r = warp_channel_sum<G>(v, lane);
      if ((lane & 3) < G) red[(s * kWarps + w) * 8 * G + ((lane >> 2) & 7) * G + g] = r;
    }
    __syncthreads();  // the tile's ddt, dx and warp sums are in shared memory

    for (int e = tid; e < steps * kCh; e += kThreads) {
      const int s = e / kCh, c = e % kCh;
      if (d0 + c >= D) continue;
      const long long at = (row + s0 + s) * D + d0 + c;
      a.ddt[at] = ddts[e];
      a.dx[at] = dxs[e];
    }
    for (int e = tid; e < steps * N; e += kThreads) {
      const int s = e / N, n = e % N, k = n % kS, gg = n / kS;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        const float* r = red + (s * kWarps + ww) * 8 * G;
        sb += r[k * G + gg];
        sc += r[(kS + k) * G + gg];
      }
      const long long at = (((long long)b * a.blocks + blk) * L + s0 + s) * N + n;
      a.pB[at] = sb;
      a.pC[at] = sc;
    }
  }

#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int n = kS * g + k;
    if (!live || n >= N) continue;
    const long long at = ((long long)b * D + d) * N + n;
    a.dA_part[at] = dA[k];
    if (a.dh0) a.dh0[at] = gn[k];
  }
}

// dB and dC: the channel blocks' partials summed in block order; dA: the
// batch rows' sums in row order.  One thread an output.
__global__ void ssm_scan_bwd_reduce(const float* pB, const float* pC, const float* dA_part,
                                    float* dB, float* dC, float* dA, int B, int L, int D,
                                    int N, int blocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ln = (long long)L * N, nbc = (long long)B * ln, dn = (long long)D * N;
  if (i < 2 * nbc) {
    const bool is_c = i >= nbc;
    const long long j = is_c ? i - nbc : i, b = j / ln;
    const float* p = (is_c ? pC : pB) + b * blocks * ln + j % ln;
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += p[k * ln];
    (is_c ? dC : dB)[j] = s;
  } else if (i < 2 * nbc + dn) {
    const long long e = i - 2 * nbc;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dA_part[b * dn + e];
    dA[e] = s;
  }
}

template <int G>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  constexpr size_t kBytes = Smem<G>::kFloats * sizeof(float);
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        return cudaFuncSetAttribute(ssm_scan_bwd_kernel<G>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
      },
      &sms);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.blocks, (unsigned)B);
  ssm_scan_bwd_kernel<G><<<grid, kCh * G, kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x, const void* Bc,
                                   const void* Cc, const void* A, const void* ckpt,
                                   const void* dy, const void* dh_fin, void* ddt, void* dx,
                                   void* dB, void* dC, void* dA, void* dh0, void* scratch,
                                   int B, int L, int D, int N, void* stream) {
  if (B < 0 || L < 0 || D < 0 || N < 1 || N > kMaxN || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0 || L == 0) return (int)cudaSuccess;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int blocks = (D + kCh - 1) / kCh;
  const long long part = (long long)B * blocks * L * N;
  float* s = o(scratch);
  BwdArgs a{f(dt), f(x), f(Bc), f(Cc), f(A), f(ckpt), f(dy), f(dh_fin), o(ddt), o(dx), o(dh0),
            s, s + part, s + 2 * part, L, D, N, blocks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = N <= kS ? launch<1>(a, B, st) : N <= 2 * kS ? launch<2>(a, B, st)
                                                                : launch<4>(a, B, st);
  if (err != cudaSuccess) return (int)err;
  const long long outputs = 2LL * B * L * N + (long long)D * N;
  constexpr int kReduceThreads = 256;
  ssm_scan_bwd_reduce<<<(unsigned)((outputs + kReduceThreads - 1) / kReduceThreads),
                        kReduceThreads, 0, st>>>(a.pB, a.pC, a.dA_part, o(dB), o(dC), o(dA), B,
                                                 L, D, N, blocks);
  return (int)cudaGetLastError();
}
