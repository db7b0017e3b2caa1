// Cross-polytope LSH hashing with a gaussian rotation on Hopper (sm_90a):
// out[r, j] = argmax over [0, 2 dr) of cat([y, -y]), y = x[r] @ rot[j]
// (paper Eq. 3): index i is +e_i and dr + i is -e_i.  The larger value wins,
// and on an exact tie the lower index, as jnp.argmax does.
//
// Replaces: src/repro/kernels/hash_xp/hash_xp.py, hash_xp_pallas.  Plain torch
// version beside it: src/repro_torch/kernels/hash_xp/ref.py.
//
// What bounds it: operations.  2 n m d dr flops (137 GFLOP at n = 65,536,
// m = 64, d = dr = 128: 2.05 ms at the fp32 rate of 67 TFLOP/s) against
// 4 (nd + m d dr + nm) bytes (53 MB: 0.016 ms at 3.35 TB/s).
//
// Design: a block owns 128 rows and walks all m functions (a share of
// them where there are too few row tiles to fill the card, as in a query
// batch).
//   * fp32 FMAs on the CUDA cores, no tensor cores: TF32 would reorder near
//     ties between vertices;
//   * one FMA chain per y value, from 0.f over increasing k, so y is bit for
//     bit what a plain k loop gives; zero-filled k past d adds exact zeros;
//   * the product reads x k-major, so that a thread's 8 rows at one k are
//     two float4s.  Where 128 rows of x fit in shared memory beside the
//     ring with two blocks an SM (d <= 160), the block stages its x tile
//     once, at full d, transposed on the way in, and only rot streams;
//     otherwise (the paper's msong, d = 420, and GIST, d = 960) x streams
//     beside rot, chunk by chunk, for each function: cp.async copies x rows
//     as they lie, and while chunk t is computed the block turns chunk t + 1
//     k-major.  Both are paths of this kernel, a template chosen by shape;
//   * rot[j] (m d dr floats, 4 MB at the shape above: it stays in L2) goes
//     through a 4-stage ring of 16 x 128 chunks in dynamic shared memory,
//     filled with cp.async; the ring runs on across functions, so no
//     function waits for its first chunk;
//   * each of the 256 threads holds 8 rows x 8 columns of a 128 x 128 tile
//     of y in registers and reads, for each k, its x and rot values as four
//     float4s;
//   * the argmax is fused: a thread takes the best of its 8 columns and
//     their negations, then the 16 threads of a row (one half-warp) finish
//     with __shfl_xor_sync; the comparison (value, then lower index) is a
//     total order, so the reduction order does not change the result.  For
//     dr > 128 the running best of a row carries across column tiles in
//     shared memory.  Pad columns (col >= dr) never take part.  y never
//     reaches device memory: only the (n, m) int32 result is written;
//   * any n, d, m, dr: 16-byte copies when x and rot are 16-byte aligned and
//     d and dr are multiples of 4, 4-byte copies otherwise (a template on
//     the vector width); ragged edges are zero-filled and masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hash_tile.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps; a warp is 2 row groups x 16 column groups
constexpr int kRows = 128;     // rows per block: 4 ty + i and 64 + 4 ty + i, ty < 16, i < 4
constexpr int kCols = 128;     // y columns per tile: 4 tx + c and 64 + 4 tx + c, tx < 16
constexpr int kKC = 16;        // d per ring stage
constexpr int kStages = 4;
constexpr int kBlocksPerSM = 2;  // 128 registers a thread; shared memory kept to fit
constexpr int kXS = kKC + 4;             // row stride of a row-major x stage, floats
constexpr int kRotFloats = kKC * kCols;  // a rot stage
constexpr int kXFloats = kRows * kXS;    // a row-major x stage
constexpr int kXTFloats = kKC * kRows;   // a k-major x stage
using Transpose = hash_tile::Transpose<kRows, kKC, kXS, kThreads>;
constexpr int kBestFloats = 2 * kRows;   // a row's running best (value, index)
// at most this much shared memory a block, so that two blocks share an SM
constexpr size_t kTwoBlockBytes = 113 * 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kKC * kCols / 4 % kThreads == 0, "a stage is a whole number of copies a thread");

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// k of the resident x tile: d up to a whole chunk
__host__ __device__ __forceinline__ int resident_k(int d) { return (d + kKC - 1) / kKC * kKC; }

template <bool kResident>
size_t smem_bytes(int d) {
  const size_t floats = kResident
                            ? (size_t)resident_k(d) * kRows + kStages * kRotFloats
                            : (size_t)kStages * (kXFloats + kRotFloats) + 2 * kXTFloats;
  return (floats + kBestFloats) * sizeof(float);
}

// the resident x tile, k-major: xt[k][r] = x[row0 + r][k] for k < resident_k(d);
// zeros past n and d.  A warp reads 32 rows at one k (quad) and writes 32
// consecutive floats a k.
template <bool kVec>
__device__ __forceinline__ void load_x_resident(float* xt, const float* x, long long row0, int n,
                                                int d) {
  const int kd = resident_k(d);
  if constexpr (kVec) {
    for (int e = threadIdx.x; e < kRows * kd / 4; e += kThreads) {
      const int r = e % kRows, k = 4 * (e / kRows);
      const long long row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && k < d) v = *reinterpret_cast<const float4*>(x + row * d + k);
      xt[(k + 0) * kRows + r] = v.x;
      xt[(k + 1) * kRows + r] = v.y;
      xt[(k + 2) * kRows + r] = v.z;
      xt[(k + 3) * kRows + r] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kd; e += kThreads) {
      const int r = e % kRows, k = e / kRows;
      const long long row = row0 + r;
      xt[k * kRows + r] = row < n && k < d ? x[row * d + k] : 0.f;
    }
  }
}

// a row-major x stage: xs[r][kk] = x[row0 + r][k0 + kk]; zeros past n and d
template <bool kVec>
__device__ __forceinline__ void load_x_stage(float* xs, const float* x, long long row0, int k0,
                                             int n, int d) {
  const int width = kVec ? 4 : 1;
  const int per_row = kKC / width;
#pragma unroll
  for (int it = 0; it < kRows * per_row / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / per_row, k = k0 + width * (e % per_row);
    const long long row = row0 + r;
    const bool in = row < n && k < d;
    hash_tile::copy<4 * width>(xs + r * kXS + (k - k0), in ? x + row * d + k : x,
                               in ? 4 * width : 0);
  }
}

// rot[j] rows [k0, k0 + 16) x columns [e0, e0 + 128) into rs[kk][c]; zeros
// past d and dr
template <bool kVec>
__device__ __forceinline__ void load_rot(float* rs, const float* rot, int j, int e0, int k0,
                                         int d, int dr) {
  const int width = kVec ? 4 : 1;
  const int per_row = kCols / width;
#pragma unroll
  for (int it = 0; it < kKC * per_row / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int kk = e / per_row, col = e0 + width * (e % per_row);
    const bool in = k0 + kk < d && col < dr;
    const float* src = rot + ((long long)j * d + k0 + kk) * dr + col;
    hash_tile::copy<4 * width>(rs + kk * kCols + (col - e0), in ? src : rot,
                               in ? 4 * width : 0);
  }
}

template <bool kResident, bool kVec, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
hash_xp_kernel(const float* __restrict__ x, const float* __restrict__ rot,
               int32_t* __restrict__ out, int n, int d, int m, int dr, int per_block) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = lane % 16;             // columns 4 tx + c, 64 + 4 tx + c
  const int ty = warp * 2 + lane / 16;  // rows 4 ty + i, 64 + 4 ty + i
  const long long row0 = (long long)blockIdx.x * kRows;
  // this block's functions: all m, or (kSplit) [j0, j0 + mb)
  int mb = m;
  if constexpr (kSplit) {
    const int j0 = blockIdx.y * per_block;
    mb = min(per_block, m - j0);
    rot += (long long)j0 * d * dr;
    out += j0;
  }
  const int nk = (d + kKC - 1) / kKC;
  const int ct = (dr + kCols - 1) / kCols;  // column tiles a function
  // resident: [k-major x tile][ring of rot stages]; streamed: [ring of
  // (rot, row-major x) stages][two k-major x stages]
  constexpr int kStage = kResident ? kRotFloats : kRotFloats + kXFloats;
  float* ring = smem + (kResident ? resident_k(d) * kRows : 0);
  float* xt = kResident ? smem : ring + kStages * kStage;
  float* best_v = kResident ? ring + kStages * kStage : xt + 2 * kXTFloats;
  int* best_i = reinterpret_cast<int*>(best_v + kRows);

  // the producer runs kStages - 1 stages ahead of the consumer over
  // (function, column tile, k chunk)
  int p_j = 0, p_e = 0, p_kc = 0, p_slot = 0;
  auto produce = [&]() {
    if (p_j < mb) {
      float* st = ring + p_slot * kStage;
      load_rot<kVec>(st, rot, p_j, p_e * kCols, p_kc * kKC, d, dr);
      if constexpr (!kResident) load_x_stage<kVec>(st + kRotFloats, x, row0, p_kc * kKC, n, d);
      if (++p_kc == nk) {
        p_kc = 0;
        if (++p_e == ct) { p_e = 0; ++p_j; }
      }
    }
    hash_tile::commit();  // an empty group past the end keeps the count uniform
    p_slot = (p_slot + 1) % kStages;
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) produce();
  if constexpr (kResident) {
    load_x_resident<kVec>(xt, x, row0, n, d);  // seen after the loop's first barrier
  } else {
    hash_tile::wait<kStages - 2>();
    __syncthreads();
    Transpose::all(xt, ring + kRotFloats);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  int slot = 0, buf = 0;
#pragma unroll 1
  for (int j = 0; j < mb; ++j) {
#pragma unroll 1
    for (int e = 0; e < ct; ++e) {
#pragma unroll 1
      for (int kc = 0; kc < nk; ++kc) {
        // this thread's copies of the stage (streamed: of the next stage) landed
        hash_tile::wait<kResident ? kStages - 2 : kStages - 3>();
        __syncthreads();  // everyone's did; this stage's x is k-major; slot - 1 is free
        produce();        // refills slot - 1
        const int next = slot + 1 == kStages ? 0 : slot + 1;
        const float* x_k = xt + (kResident ? kc * kKC * kRows : buf * kXTFloats);
        if constexpr (!kResident) {
          Transpose::all(xt + (buf ^ 1) * kXTFloats, ring + next * kStage + kRotFloats);
          buf ^= 1;
        }
        hash_tile::fma_stage<kKC, kRows, kRows / 2, kCols, kCols / 2>(
            acc, x_k, ring + slot * kStage, ty, tx);
        slot = next;
      }

      // epilogue of (function j, column tile e): each row's best vertex
      const int e0 = e * kCols;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = e0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
          // the better of y (index col) and -y (index dr + col) is |y|, at
          // col unless y < 0 (y = +-0 ties, and col is the lower index)
          const float y = acc[i][c];
          const int yi = y < 0.f ? dr + col : col;
          if (col < dr && better(fabsf(y), yi, bv, bi)) { bv = fabsf(y); bi = yi; }
          acc[i][c] = 0.f;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {  // the 16 threads of the row
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
        }
        if (tx == 0) {  // the same thread owns row r in every column tile
          const int r = i < 4 ? 4 * ty + i : kRows / 2 + 4 * ty + i - 4;
          if (e > 0 && better(best_v[r], best_i[r], bv, bi)) { bv = best_v[r]; bi = best_i[r]; }
          if (e + 1 < ct) {
            best_v[r] = bv;
            best_i[r] = bi;
          } else if (row0 + r < n) {
            out[(row0 + r) * m + j] = bi;
          }
        }
      }
    }
  }
  hash_tile::wait<0>();
}

template <bool kResident, bool kVec, bool kSplit>
cudaError_t launch_grid(const float* x, const float* rot, int32_t* out, int n, int d, int m,
                        int dr, int per_block, cudaStream_t stream) {
  // the resident path takes at most kTwoBlockBytes, the streamed one a
  // fixed size
  static hash_tile::DeviceOnce once;
  int sms = 0;
  const cudaError_t err = once.get(
      [] {
        const size_t most = kResident ? kTwoBlockBytes : smem_bytes<false>(1);
        return cudaFuncSetAttribute(hash_xp_kernel<kResident, kVec, kSplit>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      },
      &sms);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(((long long)n + kRows - 1) / kRows),
                  (unsigned)((m + per_block - 1) / per_block));
  hash_xp_kernel<kResident, kVec, kSplit><<<grid, kThreads, smem_bytes<kResident>(d), stream>>>(
      x, rot, out, n, d, m, dr, per_block);
  return cudaGetLastError();
}

// a block a row tile walks all m functions; where the row tiles leave the
// card's block slots idle (a query batch), the functions are split among
// blockIdx.y so that every slot has work
template <bool kResident, bool kVec>
cudaError_t launch(const float* x, const float* rot, int32_t* out, int n, int d, int m, int dr,
                   cudaStream_t stream) {
  static hash_tile::DeviceOnce once;
  int sms = 0;
  const cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return err;
  const long long row_tiles = ((long long)n + kRows - 1) / kRows;
  const long long slots = (long long)kBlocksPerSM * sms;
  const long long groups = std::min<long long>((slots + row_tiles - 1) / row_tiles, m);
  const int per_block = (int)((m + groups - 1) / groups);
  return per_block < m
             ? launch_grid<kResident, kVec, true>(x, rot, out, n, d, m, dr, per_block, stream)
             : launch_grid<kResident, kVec, false>(x, rot, out, n, d, m, dr, m, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int hash_xp_launch(const void* x, const void* rot, void* out, int n, int d, int m,
                              int dr, void* stream) {
  if (n < 0 || d < 1 || m < 1 || dr < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec = d % 4 == 0 && dr % 4 == 0 && aligned16(x) && aligned16(rot);
  const bool resident = smem_bytes<true>(d) <= kTwoBlockBytes;
  const float* xp = (const float*)x;
  const float* rp = (const float*)rot;
  int32_t* op = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (resident)
    err = vec ? launch<true, true>(xp, rp, op, n, d, m, dr, s)
              : launch<true, false>(xp, rp, op, n, d, m, dr, s);
  else
    err = vec ? launch<false, true>(xp, rp, op, n, d, m, dr, s)
              : launch<false, false>(xp, rp, op, n, d, m, dr, s);
  return (int)err;
}
