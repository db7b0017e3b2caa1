// FlashAttention-2 backward on Hopper (sm_90a): the exact gradient of the
// function csrc/flash_attn.cu computes,
// o[b, i, h] = softmax_j(mask(cap(q[b, i, h] . k[b, j, g] / sqrt(dh)))) v[b, j, g],
// g = h / (Hq / Hkv), with the same masks (the ends aligned: query i at key
// position i + Skv - Sq; causal keeps keys j <= that position, a window w > 0
// keys j > position - w) and cap(s) = c tanh(s / c) when the softcap c > 0.
// Inputs q, o, dO (B, Sq, Hq, dh), k, v (B, Skv, Hkv, dh) and the forward's
// row statistics lse (B, Sq, Hq), float32, contiguous, dh <= 256.  lse is in
// base 2: lse = log2 sum_j 2^x_j over the row's unmasked keys, x_j the capped
// score times log2(e) (so the probability is 2^(x_j - lse)); a row with no key
// holds +inf, where every probability below is 0.  Outputs dq (as q), dk and
// dv (as k; the GQA group's heads summed), and the scratch delta (B, Sq, Hq).
//
// Replaces no TPU kernel: the reference differentiates its jnp forward
// (src/repro/models/attention.py:72 chunked_attention) through
// jax.value_and_grad (src/repro/train/step.py:47-53), and its Pallas kernel
// (src/repro/kernels/flash_attn/flash_attn.py:88 flash_attn_pallas) has no
// backward.  Added so that a model whose attention runs through the forward
// kernel can take a gradient on the card.  Plain torch version beside it:
// src/repro_torch/kernels/flash_attn/ref.py flash_attention_bwd_ref.
//
// What bounds it: five products of 2 dh operations for every unmasked
// (query, key) pair (S = Q K^T and dP = dO V^T recomputed, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), on the float32 pipe here; at gemma-2b's
// training shape (B 8, S 64, 8 heads of 256 over 1, causal) the bytes of the
// nine tensors instead.  This design spends seven: S and dP are formed once
// in each of the two passes.
//
// Design (plain fp32 FMAs; the tensor cores are a later redesign):
//   * delta = rowsum(dO o), one warp a row (flash_attn_bwd_prep_kernel).
//   * The dK / dV pass: a block per (batch row, kv head, tile of BT keys)
//     stages its K and V once, then walks the group's packed query rows
//     (row r = query r / G of head r % G, as the forward packs them) in
//     tiles of BT, from the first row that can see the tile to the last:
//     S and dP of the tile pair (a thread: one row, BT / 8 keys), p =
//     2^(x - lse) under the forward's masks, dS = p (dP - delta) cap'(s) /
//     sqrt(dh) with cap'(s) = 1 - tanh^2 = 1 - (x / (c log2 e))^2, both
//     through shared memory, then dV += P^T dO and dK += dS^T Q in
//     registers (a thread: one key, dh / 8 columns).
//   * The dQ pass: a block per (batch row, kv head, tile of BT packed rows)
//     walks the key tiles its rows can see, recomputes S, dP, dS the same
//     way, and sums dQ += dS K in registers.
//   * Every sum runs in one fixed order and no atomics are used: two runs
//     give the same bits.
//   * The capped score and its tanh come from the forward's formula (c (1 -
//     2 / (1 + e^{2y})), ex2.approx and rcp.approx), and p from ex2.approx, so
//     the probabilities are the forward's to a few ulps.
//   * BT = 32 keys or rows a tile (256 threads) where the dK / dV pass gives
//     every SM a block, else 16 (128 threads, 69 KB of shared memory at dh
//     256, so that three blocks share an SM).  Rows of Q, dO, K and V are
//     padded to DP = 64, 128, 192 or 256 columns with zeros, row stride DP + 4
//     floats: the 8 lanes of a 16-byte phase read 8 rows at banks 4 apart.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_tile.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* lse;
  const float* dO;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int Sq, Skv, Hq, Hkv, dh;
  int G;     // query heads a kv head
  int rows;  // Sq * G packed rows a (batch row, kv head)
  int causal, window;
  float softcap;
  float scale;    // 1 / sqrt(dh)
  float scale2;   // log2(e) / sqrt(dh)
  float cap_in;   // 2 log2(e) / (sqrt(dh) c)
  float cap_out;  // c log2(e)
  bool vec;       // 16-byte loads: dh % 4 == 0 and every pointer 16-byte aligned
};

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

template <int DP, int BT>
struct Tile {
  static constexpr int kThreads = BT * 8;
  static constexpr int kLd = DP + 4;  // row stride of Q, dO, K, V in shared memory
  static constexpr int kPLd = BT + 1;  // row stride of P and dS
  static constexpr int kNC = BT / 8;   // keys a thread in the score step
  static constexpr int kNW = DP / 32;  // float4 column groups a thread in the sums
  // Q, dO, K, V; P, dS; lse, delta
  static constexpr size_t kSmem =
      ((size_t)4 * BT * kLd + (size_t)2 * BT * kPLd + 2 * BT) * sizeof(float);
};

// Stage kRows rows of dh floats into shared memory (row stride ld), padded with
// zeros to DP columns; row(r) gives row r's source, nullptr for a row to zero.
template <int DP, int kRows, int kThreads, class Row>
__device__ __forceinline__ void stage(float* dst, int ld, const Row& row, int dh, bool vec) {
  if (vec) {
    constexpr int kC = DP / 4;
    for (int s = threadIdx.x; s < kRows * kC; s += kThreads) {
      const int r = s / kC, c = 4 * (s - r * kC);
      const float* src = row(r);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src != nullptr && c < dh) x = *reinterpret_cast<const float4*>(src + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = x;
    }
  } else {
    for (int s = threadIdx.x; s < kRows * DP; s += kThreads) {
      const int r = s / DP, c = s - r * DP;
      const float* src = row(r);
      dst[r * ld + c] = (src != nullptr && c < dh) ? src[c] : 0.f;
    }
  }
}

// The key range [lo, hi) packed row r sees (empty past the rows)
__device__ __forceinline__ void key_range(const BwdArgs& a, int r, int& lo, int& hi) {
  lo = hi = 0;
  if (r < a.rows) {
    const int qp = r / a.G + a.Skv - a.Sq;
    hi = a.causal ? min(qp + 1, a.Skv) : a.Skv;
    lo = a.window > 0 ? max(0, qp - a.window + 1) : 0;
  }
}

// S = Q K^T and dP = dO V^T of a tile pair, then P and dS into shared memory.
// The thread takes row si = tid / 8 and keys sj + 8 c, sj = tid % 8; key j0 +
// jj of the tile is key jj of ks, vs.
template <int DP, int BT>
__device__ __forceinline__ void scores(const BwdArgs& a, const float* qs, const float* dos,
                                       const float* ks, const float* vs, const float* lse_s,
                                       const float* del_s, float* ps, float* dss, int r0,
                                       int j0) {
  using T = Tile<DP, BT>;
  const int si = threadIdx.x / 8, sj = threadIdx.x % 8;
  float s[T::kNC], dp[T::kNC];
#pragma unroll
  for (int c = 0; c < T::kNC; ++c) s[c] = dp[c] = 0.f;
  const float* qrow = qs + si * T::kLd;
  const float* dorow = dos + si * T::kLd;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    const float4 x = hash_tile::lds4(qrow + d), g = hash_tile::lds4(dorow + d);
#pragma unroll
    for (int c = 0; c < T::kNC; ++c) {
      const float4 kk = hash_tile::lds4(ks + (sj + 8 * c) * T::kLd + d);
      const float4 vv = hash_tile::lds4(vs + (sj + 8 * c) * T::kLd + d);
      s[c] = fmaf(x.x, kk.x, s[c]);
      s[c] = fmaf(x.y, kk.y, s[c]);
      s[c] = fmaf(x.z, kk.z, s[c]);
      s[c] = fmaf(x.w, kk.w, s[c]);
      dp[c] = fmaf(g.x, vv.x, dp[c]);
      dp[c] = fmaf(g.y, vv.y, dp[c]);
      dp[c] = fmaf(g.z, vv.z, dp[c]);
      dp[c] = fmaf(g.w, vv.w, dp[c]);
    }
  }
  int lo, hi;
  key_range(a, r0 + si, lo, hi);
  const float L = lse_s[si], D = del_s[si];
#pragma unroll
  for (int c = 0; c < T::kNC; ++c) {
    const int jj = sj + 8 * c, j = j0 + jj;
    float x, dcap;
    if (a.softcap > 0.f) {
      const float th = 1.f - 2.f * rcp_ftz(1.f + exp2_ftz(s[c] * a.cap_in));
      x = th * a.cap_out;
      dcap = (1.f - th * th) * a.scale;
    } else {
      x = s[c] * a.scale2;
      dcap = a.scale;
    }
    const float p = (j >= lo && j < hi) ? exp2_ftz(x - L) : 0.f;
    ps[si * T::kPLd + jj] = p;
    dss[si * T::kPLd + jj] = p * (dp[c] - D) * dcap;
  }
}

// delta = rowsum(dO o): a warp a row of (B Sq Hq) rows of dh
__global__ void __launch_bounds__(256) flash_attn_bwd_prep_kernel(const float* o,
                                                                  const float* dO, float* delta,
                                                                  long long n_rows, int dh) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* x = o + row * dh;
  const float* g = dO + row * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s = fmaf(x[d], g[d], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

// Offsets of a (batch row, kv head): the q / o / dO rows' base, the lse /
// delta base, and packed row r's offsets from them
struct Group {
  long long qo_base, st_base, kv_base, q_pos, kv_pos;
  int G, Hq;
  __device__ Group(const BwdArgs& a, int b, int kvh)
      : qo_base(((long long)b * a.Sq * a.Hq + (long long)kvh * a.G) * a.dh),
        st_base((long long)b * a.Sq * a.Hq + (long long)kvh * a.G),
        kv_base(((long long)b * a.Skv * a.Hkv + kvh) * a.dh),
        q_pos((long long)a.Hq * a.dh),
        kv_pos((long long)a.Hkv * a.dh),
        G(a.G),
        Hq(a.Hq) {}
  // packed row r: query r / G of head r % G, in rows of (B Sq Hq)
  __device__ long long row(int r) const {
    const int i = r / G;
    return (long long)i * Hq + (r - i * G);
  }
};

template <int DP, int BT>
__device__ __forceinline__ void stage_rows(const BwdArgs& a, const Group& gr, float* qs,
                                           float* dos, float* lse_s, float* del_s, int r0) {
  using T = Tile<DP, BT>;
  const float* qb = a.q + gr.qo_base;
  const float* db = a.dO + gr.qo_base;
  auto q_row = [&](int r) -> const float* {
    return r0 + r < a.rows ? qb + gr.row(r0 + r) * a.dh : nullptr;
  };
  auto do_row = [&](int r) -> const float* {
    return r0 + r < a.rows ? db + gr.row(r0 + r) * a.dh : nullptr;
  };
  stage<DP, BT, T::kThreads>(qs, T::kLd, q_row, a.dh, a.vec);
  stage<DP, BT, T::kThreads>(dos, T::kLd, do_row, a.dh, a.vec);
  if (threadIdx.x < BT) {
    const int r = r0 + threadIdx.x;
    const bool in = r < a.rows;
    lse_s[threadIdx.x] = in ? a.lse[gr.st_base + gr.row(r)] : INFINITY;
    del_s[threadIdx.x] = in ? a.delta[gr.st_base + gr.row(r)] : 0.f;
  }
}

template <int DP, int BT>
__device__ __forceinline__ void stage_keys(const BwdArgs& a, const Group& gr, float* ks,
                                           float* vs, int j0, int j_end) {
  using T = Tile<DP, BT>;
  const float* kb = a.k + gr.kv_base;
  const float* vb = a.v + gr.kv_base;
  auto k_row = [&](int r) -> const float* {
    return j0 + r < j_end ? kb + (long long)(j0 + r) * gr.kv_pos : nullptr;
  };
  auto v_row = [&](int r) -> const float* {
    return j0 + r < j_end ? vb + (long long)(j0 + r) * gr.kv_pos : nullptr;
  };
  stage<DP, BT, T::kThreads>(ks, T::kLd, k_row, a.dh, a.vec);
  stage<DP, BT, T::kThreads>(vs, T::kLd, v_row, a.dh, a.vec);
}

// the thread's dh / 8 columns of a row: 4 (tid % 8) + 32 w, w < DP / 32, written
// where below dh
template <int DP>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[DP / 32][4], int dh,
                                          bool vec) {
  const int c0 = 4 * (threadIdx.x % 8);
#pragma unroll
  for (int w = 0; w < DP / 32; ++w) {
    const int c = c0 + 32 * w;
    if (vec && c < dh) {
      *reinterpret_cast<float4*>(dst + c) = make_float4(acc[w][0], acc[w][1], acc[w][2],
                                                        acc[w][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dh) dst[c + e] = acc[w][e];
    }
  }
}

template <int DP, int BT>
__global__ void __launch_bounds__(BT * 8) flash_attn_bwd_dkdv_kernel(const BwdArgs a) {
  using T = Tile<DP, BT>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BT * T::kLd;
  float* qs = vs + BT * T::kLd;
  float* dos = qs + BT * T::kLd;
  float* ps = dos + BT * T::kLd;
  float* dss = ps + BT * T::kPLd;
  float* lse_s = dss + BT * T::kPLd;
  float* del_s = lse_s + BT;

  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const Group gr(a, b, kvh);
  const int j0 = blockIdx.y * BT;
  const int off = a.Skv - a.Sq;
  stage_keys<DP, BT>(a, gr, ks, vs, j0, a.Skv);

  // the packed rows that can see a key of this tile: causal, query position
  // >= j0; window, position - w + 1 <= the tile's last key
  const int j_last = min(j0 + BT, a.Skv) - 1;
  long long r_lo = 0, r_hi = a.rows;
  if (a.causal) r_lo = max(0LL, (long long)(j0 - off)) * a.G;
  if (a.window > 0) r_hi = min(r_hi, max(0LL, (long long)j_last + a.window - off) * a.G);

  const int kj = threadIdx.x / 8;  // this thread's key in the sums
  const int c0 = 4 * (threadIdx.x % 8);
  float acc_k[T::kNW][4], acc_v[T::kNW][4];
#pragma unroll
  for (int w = 0; w < T::kNW; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[w][e] = acc_v[w][e] = 0.f;

  for (long long r0 = r_lo; r0 < r_hi; r0 += BT) {
    __syncthreads();  // the last tile's Q, dO, P and dS are consumed
    stage_rows<DP, BT>(a, gr, qs, dos, lse_s, del_s, (int)r0);
    __syncthreads();
    scores<DP, BT>(a, qs, dos, ks, vs, lse_s, del_s, ps, dss, (int)r0, j0);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < BT; ++i) {
      const float p = ps[i * T::kPLd + kj], ds = dss[i * T::kPLd + kj];
      const float* grow = dos + i * T::kLd + c0;
      const float* xrow = qs + i * T::kLd + c0;
#pragma unroll
      for (int w = 0; w < T::kNW; ++w) {
        const float4 g = hash_tile::lds4(grow + 32 * w), x = hash_tile::lds4(xrow + 32 * w);
        acc_v[w][0] = fmaf(p, g.x, acc_v[w][0]);
        acc_v[w][1] = fmaf(p, g.y, acc_v[w][1]);
        acc_v[w][2] = fmaf(p, g.z, acc_v[w][2]);
        acc_v[w][3] = fmaf(p, g.w, acc_v[w][3]);
        acc_k[w][0] = fmaf(ds, x.x, acc_k[w][0]);
        acc_k[w][1] = fmaf(ds, x.y, acc_k[w][1]);
        acc_k[w][2] = fmaf(ds, x.z, acc_k[w][2]);
        acc_k[w][3] = fmaf(ds, x.w, acc_k[w][3]);
      }
    }
  }
  const int j = j0 + kj;
  if (j < a.Skv) {
    const long long o = gr.kv_base + (long long)j * gr.kv_pos;
    store_row<DP>(a.dk + o, acc_k, a.dh, a.vec);
    store_row<DP>(a.dv + o, acc_v, a.dh, a.vec);
  }
}

template <int DP, int BT>
__global__ void __launch_bounds__(BT * 8) flash_attn_bwd_dq_kernel(const BwdArgs a) {
  using T = Tile<DP, BT>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BT * T::kLd;
  float* qs = vs + BT * T::kLd;
  float* dos = qs + BT * T::kLd;
  float* ps = dos + BT * T::kLd;
  float* dss = ps + BT * T::kPLd;
  float* lse_s = dss + BT * T::kPLd;
  float* del_s = lse_s + BT;

  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const Group gr(a, b, kvh);
  const int r0 = blockIdx.y * BT;
  const int off = a.Skv - a.Sq;
  stage_rows<DP, BT>(a, gr, qs, dos, lse_s, del_s, r0);

  // the keys any row of the tile may see (as the forward's kv_lo, kv_hi)
  const int last = min(r0 + BT, a.rows) - 1;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) kv_hi = min(a.Skv, last / a.G + off + 1);
  if (a.window > 0) kv_lo = max(0, r0 / a.G + off - a.window + 1);

  const int qi = threadIdx.x / 8;  // this thread's row in the sum
  const int c0 = 4 * (threadIdx.x % 8);
  float acc[T::kNW][4];
#pragma unroll
  for (int w = 0; w < T::kNW; ++w) acc[w][0] = acc[w][1] = acc[w][2] = acc[w][3] = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BT) {
    __syncthreads();  // the last tile's K and dS are consumed
    stage_keys<DP, BT>(a, gr, ks, vs, j0, kv_hi);
    __syncthreads();  // (the first time: Q, dO, lse and delta too)
    scores<DP, BT>(a, qs, dos, ks, vs, lse_s, del_s, ps, dss, r0, j0);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < BT; ++jj) {
      const float ds = dss[qi * T::kPLd + jj];
      const float* krow = ks + jj * T::kLd + c0;
#pragma unroll
      for (int w = 0; w < T::kNW; ++w) {
        const float4 kk = hash_tile::lds4(krow + 32 * w);
        acc[w][0] = fmaf(ds, kk.x, acc[w][0]);
        acc[w][1] = fmaf(ds, kk.y, acc[w][1]);
        acc[w][2] = fmaf(ds, kk.z, acc[w][2]);
        acc[w][3] = fmaf(ds, kk.w, acc[w][3]);
      }
    }
  }
  const int r = r0 + qi;
  if (r < a.rows) store_row<DP>(a.dq + gr.qo_base + gr.row(r) * a.dh, acc, a.dh, a.vec);
}

template <int DP, int BT>
cudaError_t launch_tiles(const BwdArgs& a, int B, cudaStream_t stream) {
  using T = Tile<DP, BT>;
  static_assert(T::kSmem <= 232448, "above the 227 KB a block may use");
  static hash_tile::DeviceOnce once;  // the shared-memory limits raised once a device
  int sms = 0;
  cudaError_t err = once.get(
      [] {
        cudaError_t e = cudaFuncSetAttribute(flash_attn_bwd_dkdv_kernel<DP, BT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)T::kSmem);
        if (e != cudaSuccess) return e;
        return cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<DP, BT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
      },
      &sms);
  if (err != cudaSuccess) return err;
  if (a.Skv > 0) {
    dim3 grid((unsigned)(B * a.Hkv), (unsigned)((a.Skv + BT - 1) / BT));
    flash_attn_bwd_dkdv_kernel<DP, BT><<<grid, T::kThreads, T::kSmem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dim3 grid((unsigned)(B * a.Hkv), (unsigned)((a.rows + BT - 1) / BT));
  flash_attn_bwd_dq_kernel<DP, BT><<<grid, T::kThreads, T::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// 32-key tiles where the dK / dV pass gives every SM a block, else 16
template <int DP>
cudaError_t launch(const BwdArgs& a, int B, int sms, cudaStream_t stream) {
  if ((long long)B * a.Hkv * ((a.Skv + 31) / 32) >= sms) return launch_tiles<DP, 32>(a, B, stream);
  return launch_tiles<DP, 16>(a, B, stream);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// dq, dk, dv of the attention whose forward wrote o and lse (flash_attn_launch
// with an lse pointer), given dO; delta is scratch of (B, Sq, Hq) floats.
// Three kernels on `stream`: delta, then dK / dV, then dQ.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* lse, const void* dO, void* dq, void* dk,
                                     void* dv, void* delta, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int dh, int causal, int window, float softcap,
                                     void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)Sq * (Hq / Hkv);
  if ((long long)B * Hkv > 0x7fffffffLL || (rows + 15) / 16 > 65535 || (Skv + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  static hash_tile::DeviceOnce once;
  int sms = 0;
  cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)B * Sq * Hq;
  flash_attn_bwd_prep_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dO), static_cast<float*>(delta),
      n_rows, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)dh);
  const bool vec = dh % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                   aligned(dO, 16) && aligned(dq, 16) && aligned(dk, 16) && aligned(dv, 16);
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(lse),
            static_cast<const float*>(dO), static_cast<const float*>(delta),
            static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
            Sq, Skv, Hq, Hkv, dh, Hq / Hkv, (int)rows, causal, window, softcap, scale,
            scale * kLog2e, softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f,
            softcap * kLog2e, vec};
  switch ((dh + 63) / 64) {
    case 1: return (int)launch<64>(a, B, sms, st);
    case 2: return (int)launch<128>(a, B, sms, st);
    case 3: return (int)launch<192>(a, B, sms, st);
    default: return (int)launch<256>(a, B, sms, st);
  }
}
