// Backward of the Mamba-1 selective scan (ssm_scan.cu) on Hopper (sm_90a).
// The forward, for every batch row b and channel d over L steps:
//   a_t = exp(dt_t A),  h_t = a_t * h_{t-1} + (dt_t x_t) B_t,  y_t = h_t . C_t
// Given dy (B, L, D) and dh_fin (B, D, N; nullptr is zero), with g_t the
// gradient of h_t (g_{L-1} = dh_fin + dy_{L-1} C_{L-1}, g_t = a_{t+1} g_{t+1}
// + dy_t C_t), it writes
//   ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t),  dx_t = dt_t sum_n g_t B_t,
//   dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t,
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1},  dh0 = a_0 g_0 (nullptr: not written).
// All float32, contiguous, N <= 16; or, in the bf16 form
// (ssm_scan_bwd_bf16_launch, the model's ssm_bf16_acts), dt, x, Bc and Cc in
// bf16 and their gradients ddt, dx, dB and dC written in bf16 (the float32
// sums rounded once, to nearest even), dy, the checkpoints, A, dA and dh0
// float32.  The input type is a template parameter: a bf16 value is widened
// as it is read from shared memory, and the arithmetic after that is the
// float32 kernel's, so the float32 outputs are bit for bit the float32
// kernel's on the inputs widened first, and the bf16 ones its outputs
// rounded.
//
// Replaces no TPU kernel: the reference trains Mamba-1 by jax.value_and_grad
// through _mamba1_fused (src/repro/models/ssm.py:103) or _mamba1_scan (:74).
// Plain torch version beside it: src/repro_torch/kernels/ssm_scan/ref.py,
// ssm_scan_bwd_ref.
//
// What it moves: dt, x, dy read (12 bytes a channel and step), the forward's
// checkpoints (the state entering each 32-step tile, 64 bytes a channel and
// tile at N 16), B, C and A; ddt and dx written (8 bytes a channel and step),
// dA's rows and dh0.  At the training shape (B 8, L 64, D 8192, N 16) 97 MB,
// 0.029 ms at 3.35 TB/s; at B 4, L 2048 1.48 GB (0.44 ms).  Beside them the
// dB / dC partials of the 32-channel blocks, 2 x 4 N bytes a block and step,
// are written and read again by the reduce (16.8 MB each way at the training
// shape, 268 MB at B 4, L 2048).  The exps: one a state and step would take
// 0.016 ms on the SFUs at the training shape; this design takes 1.75 (0.028
// ms).  What bounds it is the issue slots: the walk of one step is ~99 SASS
// instructions a thread for its 4 states (11 FMAs and products a state, the
// 8-value transposed reduce of dB / dC with its selects, the butterflies of
// dx and ddt, the staging stores), ~146 with the recompute, the run to the
// sub-tiles' entering states and the flush: 0.08 ms at the training shape
// with every scheduler issuing each clock at 1.755 GHz, above the bytes.
//
// What held a design that staged a tile's states in shared memory back
// (104 KB a block, 8 warps an SM; the tile's loads, its recompute and its
// walk in strict order; a step's reduces never in flight beside the next
// step's), and what this design does about it:
//   * the forward's lane layout: G lanes a channel (G = 1, 2, 4 for N up to
//     4, 8, 16), 4 states a lane, one channel a thread, 32 channels of one
//     batch row a block (32 G threads, G warps); the grid is channel blocks
//     x batch rows, as the forward's;
//   * no stage of the tile's states.  The tiles go from last to first.  From
//     the tile's checkpoint a thread runs the steps 0-23 once, keeping the
//     states entering steps 8, 16 and 24 (a float4 each, in shared memory:
//     the registers go to the sub-tile); then it takes the tile's kSub-step
//     sub-tiles from last to first: recomputes the sub-tile's steps from its
//     entering state with ssm::step, the forward's arithmetic (each state
//     equals the forward's bit for bit), keeping each step's entering state
//     and a_s in registers, and walks the sub-tile backwards from them with
//     no exp: 1.75 exps a state and step.  No state comes from running the
//     recurrence backwards: h_{t-1} = (h_t - b_t) / a_t divides by an a_t
//     that underflows to 0.  Every register array is indexed at compile
//     time: the steps of a sub-tile are unrolled, a short last sub-tile is
//     predicated;
//   * dt, x, dy, B, C and the tile's checkpoint slice go into shared memory
//     by cp.async in a ring of kStages stages (16-byte pieces where D, N and
//     the pointers allow, 4-byte ones otherwise, zeros past L, D and N):
//     the next tile loads while this one is walked;
//   * the walk unrolled over the sub-tile's steps: only g and dA carry from
//     one step to the next, so the reduces of neighbouring steps are in
//     flight together:
//       - dx and ddt: the lane's sum over its 4 states, then the G lanes'
//         sums by a butterfly (every lane ends with the same bits);
//       - dA: accumulated in registers, one batch row a block, written per
//         row to a partial buffer;
//       - dB_t and dC_t (8 values a lane: 4 states each): summed over the
//         warp's channels by a transposed reduce (the lanes exchange half of
//         their values at each level, 4 + 2 + 1 shuffles, after which each
//         lane holds one value);
//     ddt, dx and the warps' dB / dC sums are staged in shared memory and
//     flushed a sub-tile (kFlush steps) at a time, the warps summed in warp
//     order into the partial buffer (B, channel blocks, L, N), from two
//     buffers in turn (one barrier a flush);
//   * so a block of G 4 takes 54 KB (two 18 KB stages, two 6 KB flush
//     buffers, 6 KB of entering states) and at most 128 registers a thread
//     (no spill): 4 blocks, 16 warps an SM;
//   * a second kernel behind the same entry point sums the dB and dC
//     partials over the channel blocks in block order, and dA over the
//     batch rows in row order.  No atomics: reruns give the same bits.
//     Every sum is taken in the same order as in the design that staged the
//     states, so the outputs are its bits too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_tile.cuh"
#include "ssm_scan.cuh"

namespace {

constexpr int kMaxN = 16;   // largest state size
constexpr int kS = 4;       // states a lane
constexpr int kCh = 32;     // channels a block
constexpr int kSteps = 32;  // steps a tile: the forward's checkpoint interval
constexpr int kSub = 8;     // steps a sub-tile: its states and a_s in registers
constexpr int kStages = 2;  // tiles in the cp.async ring
constexpr int kFlush = kSub;  // steps of ddt, dx, dB, dC staged before a flush
constexpr int kRegs = 128;  // registers a thread at most
constexpr int kSubs = kSteps / kSub;
static_assert(kSteps % kFlush == 0 && kFlush % kSub == 0, "flushes of whole sub-tiles");

// One stage of the ring, in bytes: the float32 dy (kSteps x kCh) and the
// tile's checkpoint slice (kCh channels x N, packed), then dt, x (kSteps x
// kCh) and B, C (kSteps x kMaxN) of the input type T
template <class T>
struct Stage {
  static constexpr int kDy = 0, kCk = kDy + 4 * kSteps * kCh, kDt = kCk + 4 * kCh * kMaxN,
                       kX = kDt + (int)sizeof(T) * kSteps * kCh,
                       kB = kX + (int)sizeof(T) * kSteps * kCh,
                       kC = kB + (int)sizeof(T) * kSteps * kMaxN,
                       kBytes = kC + (int)sizeof(T) * kSteps * kMaxN;
  static_assert(kBytes % 16 == 0, "stages of whole 16-byte pieces");
};

// a stage's arrays
template <class T>
struct StageView {
  const float* dy;
  const float* ck;
  const T *dt, *x, *b, *c;
  __device__ __forceinline__ explicit StageView(const unsigned char* st)
      : dy(reinterpret_cast<const float*>(st + Stage<T>::kDy)),
        ck(reinterpret_cast<const float*>(st + Stage<T>::kCk)),
        dt(reinterpret_cast<const T*>(st + Stage<T>::kDt)),
        x(reinterpret_cast<const T*>(st + Stage<T>::kX)),
        b(reinterpret_cast<const T*>(st + Stage<T>::kB)),
        c(reinterpret_cast<const T*>(st + Stage<T>::kC)) {}
};

// Shared memory of a block of G lanes a channel: the ring (bytes); then, in
// floats, two flush buffers, each ddt and dx (kFlush x kCh) and the warps'
// dB / dC sums (kFlush x G warps x 8 values x G state groups); the states
// entering the sub-tiles after the first (kSubs - 1 x a float4 a thread)
template <int G, class T>
struct Smem {
  static constexpr int kThreads = kCh * G;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kDdt = 0, kDx = kFlush * kCh, kRed = 2 * kFlush * kCh,
                       kOut = kRed + kFlush * kWarps * 8 * G;
  static constexpr int kEnt = (kSubs - 1) * kThreads * kS;
  static constexpr int kRing = kStages * Stage<T>::kBytes;
  static constexpr int kBytes = kRing + (2 * kOut + kEnt) * 4;
};

// T: the type of dt, x, Bc, Cc and of their gradients (float or __nv_bfloat16)
template <class T>
struct BwdArgs {
  const T *dt, *x, *Bc, *Cc;
  const float *A, *ckpt, *dy, *dh_fin;
  T *ddt, *dx;
  float* dh0;
  float *pB, *pC, *dA_part;  // partials: (B, blocks, L, N) twice, (B, D, N)
  int L, D, N, blocks;
  bool vec_dx;  // dt, x, dy in 16-byte pieces: D a multiple of a piece of T, all 16-byte aligned
  bool vec_bc;  // B, C in 16-byte pieces: N == 16, both 16-byte aligned
  bool vec_ck;  // checkpoints in 16-byte pieces: D N % 4 == 0, 16-byte aligned
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

// The sub-tile of steps j0 .. j0 + kSub - 1 of the tile in stage `st` (kFull:
// all before `steps`; else those past it are skipped), entered with state h0:
// recomputed forwards, then walked backwards, carrying gn (the gradient
// flowing into h from later steps) and dA.  Stages ddt, dx and the warps' dB
// / dC sums of its steps in the flush buffer `ob` at the steps' slots.
template <int G, bool kFull, class T>
__device__ __forceinline__ void sub_tile(const StageView<T>& st, float* ob, int j0, int steps,
                                         const float (&h0)[kS], int q, int g, int lane, int w,
                                         const float (&Av)[kS], const float (&a2)[kS],
                                         float (&gn)[kS], float (&dA)[kS]) {
  using S = Smem<G, T>;
  constexpr unsigned kAll = 0xffffffffu;
  const T* dts = st.dt;
  const T* xs = st.x;
  const float* dys = st.dy;
  const T* bs = st.b;
  const T* cs = st.c;

  // hs[j]: the state entering step j0 + j (hs[kSub]: leaving the sub-tile);
  // ea[j]: that step's a_s
  float hs[kSub + 1][kS], ea[kSub][kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) hs[0][k] = h0[k];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int s = j0 + j;
#pragma unroll
    for (int k = 0; k < kS; ++k) hs[j + 1][k] = hs[j][k], ea[j][k] = 1.f;
    if (kFull || s < steps) {
      const float dtv = ssm::to_f(dts[s * kCh + q]), xv = ssm::to_f(xs[s * kCh + q]);
      const float4 b4 = ssm::load4(bs + s * kMaxN + kS * g);
      const float bv[kS] = {b4.x, b4.y, b4.z, b4.w};
      const float dtx = dtv * xv;
#pragma unroll
      for (int k = 0; k < kS; ++k)
        hs[j + 1][k] = ssm::step(hs[j][k], dtv, a2[k], dtx, bv[k], ea[j][k]);
    }
  }

  const int slot0 = j0 % kFlush;
#pragma unroll
  for (int j = kSub - 1; j >= 0; --j) {
    const int s = j0 + j, slot = slot0 + j;
    if (!kFull && s >= steps) continue;
    const float dtv = ssm::to_f(dts[s * kCh + q]), xv = ssm::to_f(xs[s * kCh + q]);
    const float dyv = dys[s * kCh + q];
    const float4 b4 = ssm::load4(bs + s * kMaxN + kS * g);
    const float4 c4 = ssm::load4(cs + s * kMaxN + kS * g);
    const float bv[kS] = {b4.x, b4.y, b4.z, b4.w}, cv[kS] = {c4.x, c4.y, c4.z, c4.w};
    const float dtx = dtv * xv;
    float v[8], px = 0.f, pdt = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const float e = ea[j][k];                   // a_s
      const float gk = fmaf(dyv, cv[k], gn[k]);  // g_s
      const float u = e * hs[j][k];              // a_s h_{s-1}
      v[k] = gk * dtx;                           // dB_s's term
      v[kS + k] = dyv * hs[j + 1][k];            // dC_s's term
      px = fmaf(gk, bv[k], px);
      pdt = fmaf(gk, fmaf(Av[k], u, xv * bv[k]), pdt);
      dA[k] = fmaf(gk * dtv, u, dA[k]);
      gn[k] = e * gk;
    }
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
      px += __shfl_xor_sync(kAll, px, m);
      pdt += __shfl_xor_sync(kAll, pdt, m);
    }
    if (g == 0) {
      ob[S::kDdt + slot * kCh + q] = pdt;
      ob[S::kDx + slot * kCh + q] = dtv * px;
    }
    const float r = warp_channel_sum<G>(v, lane);
    if ((lane & 3) < G)
      ob[S::kRed + (slot * S::kWarps + w) * 8 * G + ((lane >> 2) & 7) * G + g] = r;
  }
}

// this lane's states of the tile's checkpoint in stage `st`: zeros past D
// (the stage's) and past N
__device__ __forceinline__ void checkpoint(const float* ck, int q, int g, int N,
                                           float (&h)[kS]) {
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int n = kS * g + k;
    h[k] = n < N ? ck[q * N + n] : 0.f;
  }
}

// ddt and dx of the n steps from step `first` of the row, staged in `ob`, to
// device memory (as T); the warps' dB / dC sums of those steps added in warp
// order into the block's partials
template <int G, class T>
__device__ __forceinline__ void flush(const BwdArgs<T>& a, const float* ob, int b, int blk,
                                      long long row, int first, int n, int tid) {
  using S = Smem<G, T>;
  const int D = a.D, N = a.N, d0 = blk * kCh;
#pragma unroll 1
  for (int e = tid; e < n * kCh; e += S::kThreads) {
    const int s = e / kCh, c = e % kCh;
    if (d0 + c >= D) continue;
    const long long at = (row + first + s) * D + d0 + c;
    ssm::store_as(a.ddt + at, ob[S::kDdt + e]);
    ssm::store_as(a.dx + at, ob[S::kDx + e]);
  }
  const float* red = ob + S::kRed;
#pragma unroll 1
  for (int e = tid; e < n * N; e += S::kThreads) {
    const int s = e / N, nn = e % N, k = nn % kS, gg = nn / kS;
    float sb = 0.f, sc = 0.f;
#pragma unroll
    for (int ww = 0; ww < S::kWarps; ++ww) {
      const float* r = red + (s * S::kWarps + ww) * 8 * G;
      sb += r[k * G + gg];
      sc += r[(kS + k) * G + gg];
    }
    const long long at = (((long long)b * a.blocks + blk) * a.L + first + s) * N + nn;
    a.pB[at] = sb;
    a.pC[at] = sc;
  }
}

template <int G, class T>
__global__ void __launch_bounds__(kCh * G, 65536 / kRegs / (kCh * G))
ssm_scan_bwd_kernel(const BwdArgs<T> a) {
  using S = Smem<G, T>;
  using St = Stage<T>;
  constexpr int kThreads = S::kThreads;
  constexpr int kP = ssm::kPiece<T>;  // values of T a 16-byte piece
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  float* out = reinterpret_cast<float*>(smem + S::kRing);  // the two flush buffers
  float* ents = out + 2 * S::kOut;                // this thread's at ents + kS tid

  const int tid = threadIdx.x, q = tid / G, g = tid % G, lane = tid & 31, w = tid >> 5;
  const int L = a.L, D = a.D, N = a.N;
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kCh, d = d0 + q;
  const bool live = d < D;
  const long long row = (long long)b * L;  // first step of this batch row
  const int tiles = (L + kSteps - 1) / kSteps;

  // copy tile t's dt, x, dy, B, C and checkpoint slice into stage `slot`,
  // zeros past L, D and N.  Its loops (and the flush's) stay rolled: unrolled,
  // each iteration's indices were hoisted out of the tile loop, past the
  // registers the walk leaves free, into local memory.
  auto issue = [&](int t, int slot) {
    unsigned char* st = smem + slot * St::kBytes;
    float* st_dy = reinterpret_cast<float*>(st + St::kDy);
    float* st_ck = reinterpret_cast<float*>(st + St::kCk);
    T* st_dt = reinterpret_cast<T*>(st + St::kDt);
    T* st_x = reinterpret_cast<T*>(st + St::kX);
    T* st_b = reinterpret_cast<T*>(st + St::kB);
    T* st_c = reinterpret_cast<T*>(st + St::kC);
    const int s0 = t * kSteps, steps = min(kSteps, L - s0);
    if (a.vec_dx) {
      constexpr int kPieces = kCh / kP;  // 16-byte pieces of dt, x a step
#pragma unroll 1
      for (int e = tid; e < kSteps * kPieces; e += kThreads) {
        const int s = e / kPieces, c = kP * (e % kPieces);
        const bool in = s < steps && d0 + c < D;
        const long long at = in ? (row + s0 + s) * D + d0 + c : 0;
        ssm::copy16(st_dt + kP * e, a.dt + at, in);
        ssm::copy16(st_x + kP * e, a.x + at, in);
      }
      constexpr int kDyPieces = kCh / 4;  // of dy
#pragma unroll 1
      for (int e = tid; e < kSteps * kDyPieces; e += kThreads) {
        const int s = e / kDyPieces, c = 4 * (e % kDyPieces);
        const bool in = s < steps && d0 + c < D;
        const long long at = in ? (row + s0 + s) * D + d0 + c : 0;
        ssm::copy16(st_dy + 4 * e, a.dy + at, in);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < kSteps * kCh; e += kThreads) {
        const int s = e / kCh, c = e % kCh;
        const bool in = s < steps && d0 + c < D;
        const long long at = in ? (row + s0 + s) * D + d0 + c : 0;
        ssm::copy1(st_dt + e, a.dt + at, in);
        ssm::copy1(st_x + e, a.x + at, in);
        ssm::copy1(st_dy + e, a.dy + at, in);
      }
    }
    const long long first = (row + s0) * N;
    if (a.vec_bc) {  // the stage's rows are the steps' rows: one run of 16-byte pieces
      constexpr int kPieces = kSteps * kMaxN / kP;
#pragma unroll 1
      for (int e = tid; e < 2 * kPieces; e += kThreads) {
        const bool is_c = e >= kPieces;
        const int p = is_c ? e - kPieces : e;
        const bool in = kP * p < steps * kMaxN;
        ssm::copy16((is_c ? st_c : st_b) + kP * p,
                    (is_c ? a.Cc : a.Bc) + (in ? first + kP * p : 0), in);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < kSteps * kMaxN; e += kThreads) {
        const int s = e / kMaxN, n = e % kMaxN;
        const bool in = s < steps && n < N;
        const long long at = in ? first + s * N + n : 0;
        ssm::copy1(st_b + e, a.Bc + at, in);
        ssm::copy1(st_c + e, a.Cc + at, in);
      }
    }
    // the slice (b, t, d0 .. d0 + 31, :) is one run of (channels in D) x N
    const long long ck = (((long long)b * tiles + t) * D + d0) * N;
    const int count = min(kCh, D - d0) * N;
    if (a.vec_ck) {  // count is a multiple of 4
#pragma unroll 1
      for (int e = tid; e < kCh * kMaxN / 4; e += kThreads) {
        const bool in = 4 * e < count;
        ssm::copy16(st_ck + 4 * e, a.ckpt + (in ? ck + 4 * e : 0), in);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < kCh * kMaxN; e += kThreads) {
        const bool in = e < count;
        ssm::copy1(st_ck + e, a.ckpt + (in ? ck + e : 0), in);
      }
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < tiles) issue(tiles - 1 - i, i);
    hash_tile::commit();
  }

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

  int buf = 0;  // the flush buffer being filled
  for (int i = 0; i < tiles; ++i) {
    const int t = tiles - 1 - i;
    if (i + kStages - 1 < tiles) issue(t - (kStages - 1), (i + kStages - 1) % kStages);
    hash_tile::commit();
    hash_tile::wait<kStages - 1>();
    __syncthreads();  // tile t is in its stage for every thread
    // Every read of a stage comes before the barrier of the tile's last
    // flush (its sub-tile at step 0), so the next iteration may refill it.
    const StageView<T> st(smem + (i % kStages) * St::kBytes);
    const int s0 = t * kSteps, steps = min(kSteps, L - s0);
    const int subs = (steps + kSub - 1) / kSub;

    // the state entering sub-tile u + 1 to ents, from running the sub-tiles
    // before the last one once (all full) from the checkpoint.  Shared
    // memory, not registers: the sub-tile's walk takes all 128.  Each thread
    // reads back only what it wrote: no barrier.
    {
      float h[kS];
      checkpoint(st.ck, q, g, N, h);
#pragma unroll 1
      for (int u = 0; u + 1 < subs; ++u) {
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int s = u * kSub + j;
          const float dtv = ssm::to_f(st.dt[s * kCh + q]), xv = ssm::to_f(st.x[s * kCh + q]);
          const float4 b4 = ssm::load4(st.b + s * kMaxN + kS * g);
          const float dtx = dtv * xv;
          h[0] = ssm::step(h[0], dtv, a2[0], dtx, b4.x);
          h[1] = ssm::step(h[1], dtv, a2[1], dtx, b4.y);
          h[2] = ssm::step(h[2], dtv, a2[2], dtx, b4.z);
          h[3] = ssm::step(h[3], dtv, a2[3], dtx, b4.w);
        }
        *reinterpret_cast<float4*>(ents + (u * kThreads + tid) * kS) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
    }

#pragma unroll 1
    for (int u = subs - 1; u >= 0; --u) {
      float h0[kS];
      if (u == 0) {
        checkpoint(st.ck, q, g, N, h0);
      } else {
        const float4 e = hash_tile::lds4(ents + ((u - 1) * kThreads + tid) * kS);
        h0[0] = e.x, h0[1] = e.y, h0[2] = e.z, h0[3] = e.w;
      }
      const int j0 = u * kSub;
      float* ob = out + buf * S::kOut;
      if (j0 + kSub <= steps)
        sub_tile<G, true>(st, ob, j0, steps, h0, q, g, lane, w, Av, a2, gn, dA);
      else
        sub_tile<G, false>(st, ob, j0, steps, h0, q, g, lane, w, Av, a2, gn, dA);
      if (j0 % kFlush == 0) {
        __syncthreads();  // the flush group's ddt, dx and warp sums are staged
        flush<G, T>(a, ob, b, blk, row, s0 + j0, min(kFlush, steps - j0), tid);
        buf ^= 1;  // the next group fills the other buffer, read after the next barrier
      }
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

// dB and dC: the channel blocks' partials summed in block order (written as
// T); dA: the batch rows' sums in row order.  One thread an output.
template <class T>
__global__ void ssm_scan_bwd_reduce(const float* pB, const float* pC, const float* dA_part,
                                    T* dB, T* dC, float* dA, int B, int L, int D, int N,
                                    int blocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ln = (long long)L * N, nbc = (long long)B * ln, dn = (long long)D * N;
  if (i < 2 * nbc) {
    const bool is_c = i >= nbc;
    const long long j = is_c ? i - nbc : i, b = j / ln;
    const float* p = (is_c ? pC : pB) + b * blocks * ln + j % ln;
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += p[k * ln];
    ssm::store_as((is_c ? dC : dB) + j, s);
  } else if (i < 2 * nbc + dn) {
    const long long e = i - 2 * nbc;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dA_part[b * dn + e];
    dA[e] = s;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int G, class T>
cudaError_t launch(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  constexpr size_t kBytes = Smem<G, T>::kBytes;
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        cudaError_t e = cudaFuncSetAttribute(
            ssm_scan_bwd_kernel<G, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
        if (e != cudaSuccess) return e;
        // 4 blocks of 54 KB an SM at G 4: all of the SM's shared memory
        return cudaFuncSetAttribute(ssm_scan_bwd_kernel<G, T>,
                                    cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
      },
      &sms);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.blocks, (unsigned)B);
  ssm_scan_bwd_kernel<G, T><<<grid, kCh * G, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// the backward with dt, x, Bc, Cc and their gradients of type T
template <class T>
int scan_bwd(const void* dt, const void* x, const void* Bc, const void* Cc, const void* A,
             const void* ckpt, const void* dy, const void* dh_fin, void* ddt, void* dx,
             void* dB, void* dC, void* dA, void* dh0, void* scratch, int B, int L, int D, int N,
             void* stream) {
  if (B < 0 || L < 0 || D < 0 || N < 1 || N > kMaxN || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0 || L == 0) return (int)cudaSuccess;
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int blocks = (D + kCh - 1) / kCh;
  const long long part = (long long)B * blocks * L * N;
  float* s = o(scratch);
  BwdArgs<T> a{in(dt), in(x), in(Bc), in(Cc), f(A), f(ckpt), f(dy), f(dh_fin),
               static_cast<T*>(ddt), static_cast<T*>(dx), o(dh0), s, s + part, s + 2 * part,
               L, D, N, blocks, false, false, false};
  a.vec_dx = D % ssm::kPiece<T> == 0 && aligned(dt, 16) && aligned(x, 16) && aligned(dy, 16);
  a.vec_bc = N == kMaxN && aligned(Bc, 16) && aligned(Cc, 16);
  a.vec_ck = (long long)D * N % 4 == 0 && aligned(ckpt, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = N <= kS       ? launch<1, T>(a, B, st)
                    : N <= 2 * kS ? launch<2, T>(a, B, st)
                                  : launch<4, T>(a, B, st);
  if (err != cudaSuccess) return (int)err;
  const long long outputs = 2LL * B * L * N + (long long)D * N;
  constexpr int kReduceThreads = 256;
  ssm_scan_bwd_reduce<T><<<(unsigned)((outputs + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(a.pB, a.pC, a.dA_part, static_cast<T*>(dB),
                                                    static_cast<T*>(dC), o(dA), B, L, D, N,
                                                    blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x, const void* Bc,
                                   const void* Cc, const void* A, const void* ckpt,
                                   const void* dy, const void* dh_fin, void* ddt, void* dx,
                                   void* dB, void* dC, void* dA, void* dh0, void* scratch,
                                   int B, int L, int D, int N, void* stream) {
  return scan_bwd<float>(dt, x, Bc, Cc, A, ckpt, dy, dh_fin, ddt, dx, dB, dC, dA, dh0, scratch,
                         B, L, D, N, stream);
}

// the bf16 form: dt, x, Bc, Cc and ddt, dx, dB, dC in bf16; the rest float32
extern "C" int ssm_scan_bwd_bf16_launch(const void* dt, const void* x, const void* Bc,
                                        const void* Cc, const void* A, const void* ckpt,
                                        const void* dy, const void* dh_fin, void* ddt,
                                        void* dx, void* dB, void* dC, void* dA, void* dh0,
                                        void* scratch, int B, int L, int D, int N,
                                        void* stream) {
  return scan_bwd<__nv_bfloat16>(dt, x, Bc, Cc, A, ckpt, dy, dh_fin, ddt, dx, dB, dC, dA, dh0,
                                 scratch, B, L, D, N, stream);
}
