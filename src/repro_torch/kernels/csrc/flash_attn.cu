// Blocked FlashAttention-2 forward on Hopper (sm_90a), batched and grouped:
// o[b, i, h] = softmax_j(mask(cap(q[b, i, h] . k[b, j, g] / sqrt(dh)))) v[b, j, g]
// with g = h / (Hq / Hkv), for q (B, Sq, Hq, dh) and k, v (B, Skv, Hkv, dh),
// float32, contiguous.  Masks use the true lengths with the ends aligned:
// query i sits at position i + Skv - Sq; causal keeps keys j <= that position,
// a window w > 0 keeps keys j > position - w; cap(s) = c tanh(s / c) when the
// softcap c > 0.  A row with no key left is written as 0.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py, flash_attn_pallas (and
// the per-(batch, head) vmap of src/repro/kernels/flash_attn/ops.py).  Unlike
// that kernel it masks with the true lengths, not the padded ones, so it
// computes attn_ref's function at every length.  Plain torch version beside
// it: src/repro_torch/kernels/flash_attn/ref.py.
//
// What bounds it: at the serving shape (B = 32, S = 32, Hq = 8, Hkv = 1,
// dh = 256) the bytes of q, k, v and o (19 MB, 6 us at 3.35 TB/s); at long
// sequences the float32 operations, 4 dh for every unmasked (query, key) pair.
// This first version uses no tensor cores (fp32 FMAs from shared memory).
//
// Design:
//   * one block per (32-query tile, q head, batch row); the kv head is
//     h / (Hq / Hkv), so K and V are read in place and never repeated;
//   * the tile's queries, then each 32-key tile of K and V, are staged in
//     shared memory (q and k rows at an odd stride: conflict-free column
//     reads).  At dh = 256 that is 103 KB, above the default 48 KB, so the
//     launch opts in to the larger dynamic shared memory;
//   * only the key tiles that the causal and window masks leave any key in
//     are visited (the range [kv_lo, kv_hi) is computed from the tile's first
//     and last query); partly masked tiles are masked per element;
//   * scores: warp w holds rows 4w .. 4w + 3, lane l holds key l of the
//     tile, so the online-softmax statistics (running max m, normaliser l)
//     reduce with warp shuffles and stay in registers, in float32;
//   * P V: thread t accumulates rows 8 (t / 64) .. + 7 at columns
//     t % 64 + 64 u (u < ceil(dh / 64)) in registers; the probabilities are
//     broadcast from shared memory, V rows are read along consecutive
//     columns.  The output is acc / max(l, 1e-30).
//   * expf and tanhf, not their fast approximations (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // queries per block
constexpr int kBK = 32;        // keys per tile (= warp size)
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);  // 4
constexpr int kRowsPerGroup = kBQ / (kThreads / 64);  // 8

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DCH>  // ceil(dh / 64) column chunks a thread accumulates
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                  int Hq, int Hkv, int dh, int causal, int window, float softcap,
                  float scale) {
  extern __shared__ float smem[];
  const int ld = dh | 1;            // odd row stride of the q and k tiles
  float* qs = smem;                 // (kBQ, ld)
  float* ks = qs + kBQ * ld;        // (kBK, ld)
  float* vs = ks + kBK * ld;        // (kBK, dh)
  float* ps = vs + kBK * dh;        // (kBQ, kBK + 1) probabilities
  float* alpha_s = ps + kBQ * (kBK + 1);  // (kBQ) rescale of the accumulator
  float* l_s = alpha_s + kBQ;             // (kBQ) final normaliser

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int off = Skv - Sq;  // query i sits at key position i + off
  const long long q_row = (long long)Hq * dh;   // stride between positions
  const long long kv_row = (long long)Hkv * dh;
  const float* qb = q + ((long long)b * Sq) * q_row + (long long)h * dh;
  const float* kb = k + ((long long)b * Skv) * kv_row + (long long)g * dh;
  const float* vb = v + ((long long)b * Skv) * kv_row + (long long)g * dh;
  float* ob = o + ((long long)b * Sq) * q_row + (long long)h * dh;

  for (int e = tid; e < kBQ * dh; e += kThreads) {
    int r = e / dh, d = e - r * dh;
    int i = q0 + r;
    qs[r * ld + d] = i < Sq ? qb[(long long)i * q_row + d] : 0.f;
  }

  // the keys any query of the tile may see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q_last + off + 1);
  if (window > 0) kv_lo = max(0, q0 + off - window + 1);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    m_run[u] = -INFINITY;
    l_run[u] = 0.f;
  }
  const int col = tid & 63, rgrp = tid >> 6;
  float acc[kRowsPerGroup][DCH];
#pragma unroll
  for (int r = 0; r < kRowsPerGroup; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += kBK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int e = tid; e < kBK * dh; e += kThreads) {
      int r = e / dh, d = e - r * dh;
      int j = j0 + r;
      bool in = j < kv_hi;
      ks[r * ld + d] = in ? kb[(long long)j * kv_row + d] : 0.f;
      vs[r * dh + d] = in ? vb[(long long)j * kv_row + d] : 0.f;
    }
    __syncthreads();

    // scores of rows 4 warp + u against key lane of the tile
    float s[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) s[u] = 0.f;
    const float* krow = ks + lane * ld;
    const float* qrow = qs + (warp * kRowsPerWarp) * ld;
    for (int d = 0; d < dh; ++d) {
      float kv = krow[d];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) s[u] = fmaf(qrow[u * ld + d], kv, s[u]);
    }
    const int j = j0 + lane;
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = warp * kRowsPerWarp + u;
      const int i = q0 + r;
      const int qp = i + off;
      float x = s[u] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool keep = (i < Sq) && (j < kv_hi);
      if (causal) keep = keep && (j <= qp);
      if (window > 0) keep = keep && (j > qp - window);
      x = keep ? x : -INFINITY;
      // online softmax, the row's statistics identical in every lane
      float m_new = fmaxf(m_run[u], warp_max(x));
      float p, alpha;
      if (m_new == -INFINITY) {  // no key of this row seen yet
        p = 0.f;
        alpha = 1.f;
      } else {
        p = expf(x - m_new);
        alpha = expf(m_run[u] - m_new);
      }
      l_run[u] = l_run[u] * alpha + warp_sum(p);
      m_run[u] = m_new;
      ps[r * (kBK + 1) + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int rr = 0; rr < kRowsPerGroup; ++rr) {
      float a = alpha_s[rgrp * kRowsPerGroup + rr];
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[rr][c] *= a;
    }
    const int jn = min(kBK, kv_hi - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float vv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        int d = col + 64 * c;
        vv[c] = d < dh ? vs[jj * dh + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerGroup; ++rr) {
        float p = ps[(rgrp * kRowsPerGroup + rr) * (kBK + 1) + jj];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[rr][c] = fmaf(p, vv[c], acc[rr][c]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) l_s[warp * kRowsPerWarp + u] = l_run[u];
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < kRowsPerGroup; ++rr) {
    const int r = rgrp * kRowsPerGroup + rr;
    const int i = q0 + r;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      int d = col + 64 * c;
      if (d < dh) ob[(long long)i * q_row + d] = acc[rr][c] * inv;
    }
  }
}

template <int DCH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B, int Sq,
                   int Skv, int Hq, int Hkv, int dh, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const int ld = dh | 1;
  size_t shmem = ((size_t)(kBQ + kBK) * ld + (size_t)kBK * dh + (size_t)kBQ * (kBK + 1) +
                  2 * (size_t)kBQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<DCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  float scale = 1.f / sqrtf((float)dh);
  flash_attn_kernel<DCH><<<grid, kThreads, shmem, stream>>>(
      q, k, v, o, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int Sq, int Skv, int Hq, int Hkv, int dh, int causal,
                                 int window, float softcap, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || Hq > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const float* qp = (const float*)q;
  const float* kp = (const float*)k;
  const float* vp = (const float*)v;
  float* op = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((dh + 63) / 64) {
    case 1: return (int)launch<1>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, st);
    case 2: return (int)launch<2>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, st);
    case 3: return (int)launch<3>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, st);
    default: return (int)launch<4>(qp, kp, vp, op, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, st);
  }
}
