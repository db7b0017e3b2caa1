// Mamba-1 selective scan on Hopper (sm_90a), batched over sequences:
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t ,   y_t = h_t . C_t
// for every (batch row b, channel d), over all L steps of dt, x (B, L, D),
// Bc, Cc (B, L, N) and A (D, N), starting from h0 (B, D, N); writes y
// (B, L, D) and the final state to h_out (B, D, N).  All float32,
// contiguous, N <= 16; or, in the bf16 form (ssm_scan_bf16_launch, the
// model's ssm_bf16_acts), dt, x, Bc and Cc in bf16 and the rest float32: the
// input type is a template parameter of the kernel, a bf16 value is widened
// to float32 as it is read from shared memory, and the arithmetic after
// that is the float32 kernel's, so the outputs are bit for bit the float32
// kernel's on the inputs widened first.  One launch scans the whole sequence: the state lives
// in registers for any L.  On the training path (a non-null h_ckpt) it also
// writes the state entering each 32-step tile to h_ckpt (B, ceil(L / 32), D,
// N), from which the backward (ssm_scan_bwd.cu) recomputes a tile's states;
// a null h_ckpt (serving, prefill and decode) changes nothing else.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, ssm_scan_pallas (and the
// batch vmap and sequence chunking of src/repro/kernels/ssm_scan/ops.py).
// Plain torch version beside it: src/repro_torch/kernels/ssm_scan/ref.py.
//
// What bounds it: one exp a state element and step, on the SFU (16 a clock
// an SM on compute capability 9.0), against the bytes of dt, x and y (12 a
// channel and step) and of h0 and h_out.  At N 16 the exps weigh about as
// much as the bytes: 0.032 ms of exps against 0.040 of bytes at 32 x 32
// steps x 8192 channels, 0.257 against 0.242 at 4 x 2048; the bf16 form
// reads half the bytes of dt, x, B and C (0.030 at 32 x 32 x 8192), so there
// the exps bound it.  The recurrence
// itself is one dependent FMA a step; the exps and the loads do not depend
// on h, so they can run ahead of it.  What the card runs out of first,
// though, is shared memory's bandwidth: a lane reads 2 values a state and
// step (B_t, C_t) and 2 a channel and step (dt_t, x_t), at 32 lane-values
// a clock an SM, twice the SFU's rate.
//
// Design:
//   * G lanes a channel (G = 1, 2, 4 for N up to 4, 8, 16), each holding 4
//     states of h and of A * log2(e) in registers; states past N are 0 and
//     stay 0 (their B and C are 0).  A thread covers kC neighbouring
//     channels (the same 4 states of each), a block 32 kC channels of one
//     batch row (32 G threads).  Two channels a thread halve the B_t and C_t
//     reads a state; one gives twice the warps, for short sequences and for
//     a batch too small to fill the SMs (launch_lanes chooses);
//   * a warp's h0, A and h_out accesses are 16-byte vectors (when N is a
//     multiple of 4 and the pointers are 16-byte aligned; else scalar);
//   * tiles of 32 steps of dt, x, B and C are copied into shared memory with
//     cp.async in 16-byte pieces (4 float32 or 8 bf16 values; 4-byte ones
//     of float32, or loads and stores of bf16, where D or N forbid them), in a
//     ring of two stages, or four for a long sequence in a small batch, so
//     that three tiles load while one is scanned; a lane reads dt_t and x_t of its channels as a
//     broadcast and its 4 states of B_t and C_t as one 16-byte broadcast;
//   * y_t sums the G lanes' partial dots: G steps at a time, transposed, so
//     that each lane ends with one step's sum, in a fixed order
//     ((l + l^2) + (l^1 + l^3) for the step held by lane l), with G - 1
//     shuffles for G steps where a butterfly takes log2(G) a step; the lane
//     stores that step's y of its channels, and a warp's store covers whole
//     32-byte sectors;
//   * the exp is exp2(dt * (A log2 e)): one FMUL and one SFU ex2 where expf
//     takes about 8 instructions.  ex2.approx.ftz has at most 2 ulp of
//     error, and it flushes a subnormal result to 0: the term a * h it drops
//     is below 1.2e-38 |h|, far inside the 1e-5 absolute tolerance the
//     kernel is held to against the plain version;
//   * the last tile's steps past L are zero-filled and not applied to h;
//   * the step itself is ssm::step (ssm_scan.cuh), which the backward
//     shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"
#include "ssm_scan.cuh"

namespace {

constexpr int kMaxN = 16;   // largest state size
constexpr int kS = 4;       // states a lane (one 16-byte vector)
constexpr int kGroups = 32; // channel groups (kC channels each) a block: 32 G threads
constexpr int kSteps = 32;  // time steps a tile
using ssm::kLog2e;
static_assert(kSteps % 4 == 0, "a tile holds whole groups of G steps");

// One stage of a block of kC channels a thread, in values of the input type:
// dt and x (kSteps x kChannels each), then B and C (kSteps x kMaxN each).
template <int kC>
struct Stage {
  static constexpr int kChannels = kGroups * kC;
  static constexpr int kValues = 2 * kSteps * kChannels + 2 * kSteps * kMaxN;
};

// The G lanes of a channel hold partial dots p[i] of G consecutive steps i;
// returns the full sum of step g on lane g, in a fixed order.
template <int G>
__device__ __forceinline__ float transpose_sum(const float (&p)[G], int g) {
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (G == 1) {
    return p[0];
  } else if constexpr (G == 2) {
    const float keep = g ? p[1] : p[0], send = g ? p[0] : p[1];
    return keep + __shfl_xor_sync(kAll, send, 1);
  } else {
    static_assert(G == 4, "2 or 4 lanes a channel");
    const bool hi = g & 2, lo = g & 1;
    float k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
    const float s0 = hi ? p[0] : p[2], s1 = hi ? p[1] : p[3];
    k0 += __shfl_xor_sync(kAll, s0, 2);
    k1 += __shfl_xor_sync(kAll, s1, 2);
    const float keep = lo ? k1 : k0, send = lo ? k0 : k1;
    return keep + __shfl_xor_sync(kAll, send, 1);
  }
}

// dt_t or x_t of this thread's kC neighbouring channels, as float32
template <int kC>
__device__ __forceinline__ void load_channels(const float* p, float (&v)[kC]) {
  if constexpr (kC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int kC>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p, float (&v)[kC]) {
  if constexpr (kC == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// The scan of one tile of `steps` steps (kSteps when kFull) from stage `st`
// for the kC channels of this thread; stores y of the steps before
// `steps`.  `y_col` points at y of its first channel at the tile's first
// step; y2: two channels' y as one 8-byte store.
template <int G, int kC, bool kFull, class T>
__device__ __forceinline__ void scan_tile(const T* st, int steps, int q, int g,
                                          float (&h)[kC][kS], const float (&a2)[kC][kS],
                                          float* y_col, long long D, int live, bool y2) {
  constexpr int kCh = Stage<kC>::kChannels;
  const T* dts = st;
  const T* xs = st + kSteps * kCh;
  const T* bs = st + 2 * kSteps * kCh;
  const T* cs = bs + kSteps * kMaxN;
#pragma unroll
  for (int j = 0; j < kSteps; j += G) {
    if (!kFull && j >= steps) break;
    float p[kC][G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int s = j + i;
      float dtv[kC], xv[kC];
      load_channels<kC>(dts + s * kCh + kC * q, dtv);
      load_channels<kC>(xs + s * kCh + kC * q, xv);
      const float4 bv = ssm::load4(bs + s * kMaxN + kS * g);
      const float4 cv = ssm::load4(cs + s * kMaxN + kS * g);
#pragma unroll
      for (int u = 0; u < kC; ++u) {
        const float dtx = dtv[u] * xv[u];
        if (kFull || s < steps) {
          h[u][0] = ssm::step(h[u][0], dtv[u], a2[u][0], dtx, bv.x);
          h[u][1] = ssm::step(h[u][1], dtv[u], a2[u][1], dtx, bv.y);
          h[u][2] = ssm::step(h[u][2], dtv[u], a2[u][2], dtx, bv.z);
          h[u][3] = ssm::step(h[u][3], dtv[u], a2[u][3], dtx, bv.w);
        }
        p[u][i] = fmaf(h[u][3], cv.w, fmaf(h[u][2], cv.z, fmaf(h[u][1], cv.y, h[u][0] * cv.x)));
      }
    }
    float yv[kC];
#pragma unroll
    for (int u = 0; u < kC; ++u) yv[u] = transpose_sum<G>(p[u], g);
    if (kFull || j + g < steps) {
      float* out = y_col + (long long)(j + g) * D;
      if (kC == 2 && y2 && live == kC) {
        *reinterpret_cast<float2*>(out) = make_float2(yv[0], yv[kC - 1]);
      } else {
#pragma unroll
        for (int u = 0; u < kC; ++u)
          if (u < live) out[u] = yv[u];
      }
    }
  }
}

// T: the type of dt, x, Bc and Cc (float or __nv_bfloat16)
template <class T>
struct Args {
  const T *dt, *x, *Bc, *Cc;
  const float *A, *h0;
  float *y, *h_out;
  float* h_ckpt;  // the state entering each tile (B, tiles, D, N), or nullptr
  int L, D, N;
  int stages;   // stages allocated (fewer than kStages when the sequence has fewer tiles)
  bool vec_dx;  // dt and x rows in 16-byte pieces: D a multiple of a piece, both 16-byte aligned
  bool vec_bc;  // B and C steps in 16-byte pieces: N == 16, both 16-byte aligned
  bool vec_h;   // h0, A, h_out (and h_ckpt) in 16-byte pieces: N % 4 == 0, all 16-byte aligned
  bool y2;      // y in 8-byte pieces: D even, y 8-byte aligned
};

// this thread's states of its `live` channels to the rows from `row` on (N
// floats a channel), as 16-byte vectors where `vec`
template <int kC>
__device__ __forceinline__ void store_states(float* row, const float (&h)[kC][kS], int live,
                                             int g, int N, bool vec) {
  if (kS * g >= N) return;
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    if (u >= live) continue;
    float* out = row + (long long)u * N + kS * g;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(h[u][0], h[u][1], h[u][2], h[u][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kS; ++k)
        if (kS * g + k < N) out[k] = h[u][k];
    }
  }
}

// G lanes a channel, kC channels a thread, kStages stages, at most kRegs
// registers a thread (so that 65536 / (kRegs * 32 G) blocks share an SM);
// T the input type of dt, x, Bc and Cc
template <int G, int kC, int kStages, int kRegs, class T>
__global__ void __launch_bounds__(kGroups * G, 65536 / kRegs / (kGroups * G))
ssm_scan_kernel(const Args<T> a) {
  constexpr int kThreads = kGroups * G;
  constexpr int kCh = Stage<kC>::kChannels, kStageFloats = Stage<kC>::kValues;
  constexpr int kP = ssm::kPiece<T>;  // values a 16-byte piece
  extern __shared__ __align__(16) float smem_f[];
  T* smem = reinterpret_cast<T*>(smem_f);
  const int tid = threadIdx.x;
  const int q = tid / G, g = tid % G;
  const int L = a.L, D = a.D, N = a.N;
  const int b = blockIdx.y, d0 = blockIdx.x * kCh, d = d0 + kC * q;
  const int live = max(0, min(kC, D - d));  // this thread's channels inside D
  const long long row = (long long)b * L;   // first step of this batch row
  const int tiles = (L + kSteps - 1) / kSteps;

  // B and C past N stay 0 in every stage: those states never move from 0
  if (N < kMaxN) {
    for (int e = tid; e < a.stages * kSteps * kMaxN; e += kThreads) {
      const int n = e % kMaxN, s = e / kMaxN;
      if (n < N) continue;
      T* bs = smem + (s / kSteps) * kStageFloats + 2 * kSteps * kCh;
      bs[(s % kSteps) * kMaxN + n] = T(0.f);
      bs[kSteps * kMaxN + (s % kSteps) * kMaxN + n] = T(0.f);
    }
  }

  // copy tile t's dt, x, B and C into its stage, zeros past L and past D
  auto issue = [&](int t) {
    T* st = smem + (t % kStages) * kStageFloats;
    const int s0 = t * kSteps, steps = min(kSteps, L - s0);
    if (a.vec_dx) {
      constexpr int kPieces = kCh / kP;  // 16-byte pieces a step
      for (int e = tid; e < kSteps * kPieces; e += kThreads) {
        const int s = e / kPieces, cc = kP * (e % kPieces);
        const bool in = s < steps && d0 + cc < D;
        const long long at = in ? (row + s0 + s) * D + d0 + cc : 0;
        ssm::copy16(st + kP * e, a.dt + at, in);
        ssm::copy16(st + kSteps * kCh + kP * e, a.x + at, in);
      }
    } else {
      for (int e = tid; e < kSteps * kCh; e += kThreads) {
        const int s = e / kCh, cc = e % kCh;
        const bool in = s < steps && d0 + cc < D;
        const long long at = in ? (row + s0 + s) * D + d0 + cc : 0;
        ssm::copy1(st + e, a.dt + at, in);
        ssm::copy1(st + kSteps * kCh + e, a.x + at, in);
      }
    }
    T* bs = st + 2 * kSteps * kCh;
    const long long first = (row + s0) * N;
    if (a.vec_bc) {  // the stage's rows are the steps' rows: one run of 16-byte pieces
      constexpr int kPieces = kSteps * kMaxN / kP;
      for (int e = tid; e < 2 * kPieces; e += kThreads) {
        const bool is_c = e >= kPieces;
        const int p = is_c ? e - kPieces : e;
        const bool in = kP * p < steps * kMaxN;
        ssm::copy16(bs + (is_c ? kSteps * kMaxN : 0) + kP * p,
                    (is_c ? a.Cc : a.Bc) + (in ? first + kP * p : 0), in);
      }
    } else {
      for (int e = tid; e < steps * N; e += kThreads) {
        const int s = e / N, n = e - s * N;
        ssm::copy1(bs + s * kMaxN + n, a.Bc + first + e, true);
        ssm::copy1(bs + kSteps * kMaxN + s * kMaxN + n, a.Cc + first + e, true);
      }
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) issue(t);
    hash_tile::commit();
  }

  // this lane's states n = kS g + k of each of its channels: h and A log2(e)
  // in registers
  float h[kC][kS] = {}, a2[kC][kS] = {};
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    if (u >= live || kS * g >= N) continue;
    const long long hrow = ((long long)b * D + d + u) * N, arow = (long long)(d + u) * N;
    if (a.vec_h) {
      const float4 hv = *reinterpret_cast<const float4*>(a.h0 + hrow + kS * g);
      const float4 av = *reinterpret_cast<const float4*>(a.A + arow + kS * g);
      h[u][0] = hv.x, h[u][1] = hv.y, h[u][2] = hv.z, h[u][3] = hv.w;
      a2[u][0] = av.x * kLog2e, a2[u][1] = av.y * kLog2e, a2[u][2] = av.z * kLog2e,
      a2[u][3] = av.w * kLog2e;
    } else {
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int n = kS * g + k;
        if (n < N) h[u][k] = a.h0[hrow + n], a2[u][k] = a.A[arow + n] * kLog2e;
      }
    }
  }

  float* y_col = a.y + row * D + d;
  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) issue(t + kStages - 1);
    hash_tile::commit();
    hash_tile::wait<kStages - 1>();
    __syncthreads();  // tile t is in its stage for every thread
    if (a.h_ckpt)  // the state entering tile t
      store_states<kC>(a.h_ckpt + (((long long)b * tiles + t) * D + d) * N, h, live, g, N,
                       a.vec_h);
    const T* st = smem + (t % kStages) * kStageFloats;
    const int steps = min(kSteps, L - t * kSteps);
    float* yt = y_col + (long long)t * kSteps * D;
    if (steps == kSteps)
      scan_tile<G, kC, true>(st, steps, q, g, h, a2, yt, D, live, a.y2);
    else
      scan_tile<G, kC, false>(st, steps, q, g, h, a2, yt, D, live, a.y2);
    __syncthreads();  // every read of this stage is done before it is refilled
  }

  store_states<kC>(a.h_out + ((long long)b * D + d) * N, h, live, g, N, a.vec_h);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int G, int kC, int kStages, int kRegs, class T>
cudaError_t launch(Args<T> a, int B, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  constexpr int kCh = Stage<kC>::kChannels;
  constexpr size_t kStageBytes = Stage<kC>::kValues * sizeof(T);
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        return cudaFuncSetAttribute(ssm_scan_kernel<G, kC, kStages, kRegs, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)(kStages * kStageBytes));
      },
      &sms);
  if (err != cudaSuccess) return err;
  const int tiles = (a.L + kSteps - 1) / kSteps;
  a.stages = max(1, min(kStages, tiles));  // a short sequence takes fewer stages
  dim3 grid((unsigned)((a.D + kCh - 1) / kCh), (unsigned)B);
  ssm_scan_kernel<G, kC, kStages, kRegs, T>
      <<<grid, kGroups * G, a.stages * kStageBytes, stream>>>(a);
  return cudaGetLastError();
}

// Which of three configurations scans a call, from its shape (warps an SM
// at N 16 in brackets):
//   * a short sequence (at most two tiles: a served batch of documents,
//     where a block loads a tile, scans it and ends): one channel a thread,
//     two stages, at most 64 registers a thread (32 warps), so that one
//     block's loads overlap another's scan;
//   * a long sequence in a batch of more than two blocks of 64 channels an
//     SM: two channels a thread, so that a B_t and C_t load serves both
//     (shared memory's bandwidth, not the SFU, sets the pace with one), two
//     stages, at most 102 registers (20 warps);
//   * a long sequence in a smaller batch (a single sequence): one channel a
//     thread, for twice the warps, four stages, so that three tiles (96
//     steps) load while one is scanned, at most 128 registers (16 warps).
template <int G, class T>
cudaError_t launch_lanes(const Args<T>& a, int B, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  int sms = 0;
  cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)B * ((a.D + Stage<2>::kChannels - 1) / Stage<2>::kChannels);
  if (a.L <= 2 * kSteps) return launch<G, 1, 2, 64>(a, B, stream);
  if (pairs > 2LL * sms) return launch<G, 2, 2, 96>(a, B, stream);
  return launch<G, 1, 4, 128>(a, B, stream);
}

// the scan with dt, x, Bc and Cc of type T
template <class T>
int scan(const void* dt, const void* x, const void* Bc, const void* Cc, const void* A,
         const void* h0, void* y, void* h_out, void* h_ckpt, int B, int L, int D, int N,
         void* stream) {
  if (B < 0 || L < 0 || D < 0 || N < 1 || N > kMaxN || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaSuccess;
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args<T> a{in(dt), in(x), in(Bc), in(Cc), f(A), f(h0), static_cast<float*>(y),
            static_cast<float*>(h_out), static_cast<float*>(h_ckpt), L, D, N, 1, false, false,
            false, false};
  a.vec_dx = D % ssm::kPiece<T> == 0 && aligned(dt, 16) && aligned(x, 16);
  a.vec_bc = N == kMaxN && aligned(Bc, 16) && aligned(Cc, 16);
  a.vec_h = N % kS == 0 && aligned(A, 16) && aligned(h0, 16) && aligned(h_out, 16) &&
            aligned(h_ckpt, 16);
  a.y2 = D % 2 == 0 && aligned(y, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= kS)
    err = launch_lanes<1>(a, B, s);
  else if (N <= 2 * kS)
    err = launch_lanes<2>(a, B, s);
  else
    err = launch_lanes<4>(a, B, s);
  return (int)err;
}

}  // namespace

extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* Bc, const void* Cc,
                               const void* A, const void* h0, void* y, void* h_out,
                               void* h_ckpt, int B, int L, int D, int N, void* stream) {
  return scan<float>(dt, x, Bc, Cc, A, h0, y, h_out, h_ckpt, B, L, D, N, stream);
}

// the bf16 form: dt, x, Bc and Cc in bf16; A, h0 and the outputs float32
extern "C" int ssm_scan_bf16_launch(const void* dt, const void* x, const void* Bc,
                                    const void* Cc, const void* A, const void* h0, void* y,
                                    void* h_out, void* h_ckpt, int B, int L, int D, int N,
                                    void* stream) {
  return scan<__nv_bfloat16>(dt, x, Bc, Cc, A, h0, y, h_out, h_ckpt, B, L, D, N, stream);
}
