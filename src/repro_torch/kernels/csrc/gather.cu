// Gather + distance for candidate verification on Hopper (sm_90a): one
// templated kernel for fp32 rows (gather_l2) and int8 rows with a per-row
// scale (gather_q).
//
// Replaces: src/repro/kernels/gather_l2/gather_l2.py, gather_dist_pallas, and
// src/repro/kernels/gather_q/gather_q.py, gather_dist_q_pallas.  Plain torch
// versions beside them: src/repro_torch/kernels/gather_l2/ref.py and
// src/repro_torch/kernels/gather_q/ref.py.
//
// out[b, l] = dist(row(max(ids[b, l], 0)), queries[b]) where row() is the fp32
// row, or the int8 code row times its scale; dist is the squared L2, or
// 1 - cos with unclamped norms (a zero row gives NaN, which the caller maps
// to 1 as the reference does).  Negative ids read row 0; the wrapper masks
// those slots to +inf afterwards.
//
// What bounds it: device-memory bytes.  Each (query, candidate) pair reads
// one random row (4d bytes fp32, d + 4 bytes int8) and does ~3d flops, far
// below the card's ratio of flops to bytes.
//
// Design:
//   * one warp per (query, candidate) pair; a block serves one query and
//     kWarps * kPerWarp of its candidates, so the query row is staged in
//     shared memory once per block;
//   * row loads are 16 bytes per lane (float4 for fp32; four char4, one
//     int4 load, for int8) when d and the base pointer allow aligned rows
//     (d % 4 == 0 fp32, d % 16 == 0 int8); other d take a scalar path over every element;
//   * each lane accumulates in fp32 registers, and a warp shuffle reduces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;    // warps per block
constexpr int kPerWarp = 4;  // candidates per warp
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
  float dd = 0.f, rr = 0.f, qq = 0.f, rq = 0.f;
  __device__ __forceinline__ void add(float r, float q) {
    float diff = r - q;
    dd = fmaf(diff, diff, dd);
    rr = fmaf(r, r, rr);
    qq = fmaf(q, q, qq);
    rq = fmaf(r, q, rq);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// fp32 rows
struct RowsF32 {
  const float* data;
  __device__ __forceinline__ void accumulate(long long id, int d, const float* q, bool vec,
                                             int lane, Acc& acc) const {
    const float* row = data + id * d;
    if (vec) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int k = lane; k < d / 4; k += kWarp) {
        float4 r = __ldg(r4 + k);
        float4 qv = q4[k];
        acc.add(r.x, qv.x); acc.add(r.y, qv.y); acc.add(r.z, qv.z); acc.add(r.w, qv.w);
      }
    } else {
      for (int k = lane; k < d; k += kWarp) acc.add(__ldg(row + k), q[k]);
    }
  }
};

// int8 codes x per-row scale, dequantized in registers
struct RowsI8 {
  const int8_t* codes;
  const float* scale;
  __device__ __forceinline__ void accumulate(long long id, int d, const float* q, bool vec,
                                             int lane, Acc& acc) const {
    const int8_t* row = codes + id * d;
    float s = __ldg(scale + id);
    if (vec) {
      const int4* r16 = reinterpret_cast<const int4*>(row);
      for (int k = lane; k < d / 16; k += kWarp) {
        int4 raw = __ldg(r16 + k);
        const char4* c4 = reinterpret_cast<const char4*>(&raw);
        const float* qk = q + k * 16;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          char4 c = c4[u];
          acc.add((float)c.x * s, qk[4 * u + 0]);
          acc.add((float)c.y * s, qk[4 * u + 1]);
          acc.add((float)c.z * s, qk[4 * u + 2]);
          acc.add((float)c.w * s, qk[4 * u + 3]);
        }
      }
    } else {
      for (int k = lane; k < d; k += kWarp) acc.add((float)row[k] * s, q[k]);
    }
  }
};

template <class Rows>
__global__ void __launch_bounds__(kWarps * kWarp)
gather_dist_kernel(Rows rows, const int32_t* __restrict__ ids,
                   const float* __restrict__ queries, float* __restrict__ out,
                   int d, int Lc, int tiles, bool vec, bool angular) {
  extern __shared__ __align__(16) float qs[];  // the query row, d floats
  int b = blockIdx.x / tiles;
  int tile = blockIdx.x % tiles;
  const float* qrow = queries + (long long)b * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = qrow[k];
  __syncthreads();

  int warp = threadIdx.x / kWarp;
  int lane = threadIdx.x % kWarp;
  int l0 = (tile * kWarps + warp) * kPerWarp;
  for (int l = l0; l < min(l0 + kPerWarp, Lc); ++l) {
    long long slot = (long long)b * Lc + l;
    int id = ids[slot];
    Acc acc;
    rows.accumulate(id < 0 ? 0 : id, d, qs, vec, lane, acc);
    float res;
    if (angular) {
      float rq = warp_sum(acc.rq), rr = warp_sum(acc.rr), qq = warp_sum(acc.qq);
      res = 1.f - rq / (sqrtf(rr) * sqrtf(qq));
    } else {
      res = warp_sum(acc.dd);
    }
    if (lane == 0) out[slot] = res;
  }
}

template <class Rows>
int launch(Rows rows, const void* ids, const void* queries, void* out, int d, int B, int Lc,
           bool vec, int angular, void* stream) {
  if (d < 1 || B < 0 || Lc < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Lc == 0) return (int)cudaSuccess;
  int per_block = kWarps * kPerWarp;
  int tiles = (Lc + per_block - 1) / per_block;
  size_t shmem = (size_t)d * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_dist_kernel<Rows>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_dist_kernel<Rows><<<(unsigned)blocks, kWarps * kWarp, shmem, (cudaStream_t)stream>>>(
      rows, (const int32_t*)ids, (const float*)queries, (float*)out, d, Lc, tiles, vec,
      angular != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_l2_launch(const void* data, const void* ids, const void* queries,
                                void* out, int n, int d, int B, int Lc, int angular,
                                void* stream) {
  (void)n;
  RowsF32 rows{(const float*)data};
  bool vec = d % 4 == 0 && (uintptr_t)data % 16 == 0;
  return launch(rows, ids, queries, out, d, B, Lc, vec, angular, stream);
}

extern "C" int gather_q_launch(const void* codes, const void* scale, const void* ids,
                               const void* queries, void* out, int n, int d, int B, int Lc,
                               int angular, void* stream) {
  (void)n;
  RowsI8 rows{(const int8_t*)codes, (const float*)scale};
  bool vec = d % 16 == 0 && (uintptr_t)codes % 16 == 0;
  return launch(rows, ids, queries, out, d, B, Lc, vec, angular, stream);
}
