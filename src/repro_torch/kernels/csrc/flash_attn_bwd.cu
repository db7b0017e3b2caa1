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
// dv (as k; the GQA group's heads summed), and the scratch
// (flash_attn_bwd_chunks: C > 1 row chunks, then 2 C partial dK / dV of k's
// size, and delta (B, Sq, Hq) after them).
//
// The bf16-P form (flash_attn_bwd_bf16_launch, the models' attn_bf16_probs;
// a compile-time variant, kBf16P) is the gradient of flash_attn.cu's bf16-P
// form, taking each rounding's derivative as 1, as JAX's astype transposes:
// dV = bf16(P)^T bf16(dO) and dP = bf16(dO) bf16(V)^T (dO rounded as the
// reference's cotangent cast rounds it), each one mma.sync m16n8k16 bf16
// product a 16-row or 16-d step; dS = p (dP - delta) of the unrounded p and
// delta = rowsum(dO o) in float32; S, dQ and dK stay 3xTF32.  P^T goes to
// the dV product as bf16 A fragments through shared memory (the n-tiles of
// one 16-row step come from two warps when the score products are split
// over dh), in place of its split TF32 halves; the kernels, grids and row
// chunks are the float32 form's.
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
// dK += dS^T Q, dQ += dS K), at the 3xTF32 rate of the tensor cores (three
// MMAs a product); at gemma-2b's training shape (B 8, S 64, 8 heads of 256
// over 1, causal) the bytes of the nine tensors instead.  This design spends
// seven products: S and dP are formed once in each of the two passes.
//
// Design (times: tools/flash_bwd_variants.py on an H100 80GB HBM3 at
// 700 W, device ms at gemma-2b's training shape and at B 4, S 2048,
// Hq 16 / 8, dh 256, causal: this design 0.0411 and 12.03, the parent's
// plain fp32 FMAs 0.3672 and 44.48):
//   * Every product on the tensor cores as 3xTF32 (mma.sync m16n8k8 from
//     tf32x3.cuh: a_small b_big + a_big b_small + a_big b_big, fp32
//     accumulate), so that the sums keep float32 accuracy; no product is
//     plain TF32 and none runs on the FMA pipe.  The operands are split as
//     they are read from shared memory (bsplit): big rounded to tf32 as
//     cvt.rna.tf32.f32 rounds it, but in two integer operations, small
//     truncated in one.  cvt.rna.tf32.f32 compiles to four instructions
//     on sm_90a (FSETP, VIADD, LOP3, SEL), and the splits are most of the
//     kernel's issue slots: the forward's split costs 0.0480 and 15.14, its
//     bits in integer operations 0.0422 and 12.64; both parts truncated
//     would give 0.0387 and 11.14, at 6.3e-5 of the largest gradient
//     against 5.8e-5.  r / G is a multiply and a shift (div_g): the
//     staging divides once a 16-byte copy.
//   * The dQ pass (first): a block per (batch row, kv head, tile of BM =
//     16 kQSlabs packed rows; row r = query r / G of head r % G, as the
//     forward packs them), the last tiles first.  It stages its Q and dO
//     once, computes delta = rowsum(dO o) of its rows (a warp a row, in the
//     old prep kernel's order) into shared memory and into the scratch for
//     the dK / dV pass, then walks the key tiles its rows can see, kQBK
//     keys a tile, double-buffered by cp.async (tile t + 1 loads while
//     tile t is computed).  A slab of 16 rows is kQKS warps: pairs of them
//     form S and dP for half the tile's keys each, the two warps of a pair
//     each over half of dh, and add the halves through shared memory
//     (add_parts); each turns its whole n-tile into dS in registers and
//     stores it split (big, small) in the MMA's A-fragment order; after the
//     slab's barrier each warp sums dQ += dS K over the tile's keys for its
//     DP / kQKS columns.  dS is recomputed, never written to device memory
//     (1 GB at B 4, S 2048).
//   * The dK / dV pass: a block per (batch row, kv head, tile of BT = 16
//     kKvSlabs keys, row chunk).  It stages its K and V once, then walks
//     its chunk of the packed rows that can see the tile (causal: from the
//     first row at the tile's first key; window: to the last row that
//     still sees its last key), kKvBR rows a tile, double-buffered by
//     cp.async.  A slab of 16 keys is kKvKS warps, paired as in the dQ
//     pass, forming S^T = K Q^T and dP^T = V dO^T (K and V the A operands,
//     so that P^T and dS^T come out with keys as rows; the halves added
//     through the slab's P^T buffer), P^T = 2^(x - lse) under the masks and
//     dS^T = P^T (dP^T - delta) cap'(s) / sqrt(dh) in registers, both
//     stored split in A-fragment order; after the slab's barrier each warp
//     sums dV += P^T dO and dK += dS^T Q for its DP / kKvKS columns.
//     Splitting the columns is what fits dh 256: a warp's 16 keys of dK and
//     dV are 2 x 16 x 64 floats, 64 registers a lane at kKvKS = 4, where
//     one warp for all of dh would need 256.  ptxas at dh 256: the dK / dV
//     kernel 167 registers, the dQ kernel 136, no spill.
//   * Blocks: 2 slabs of 4 warps, 32-row and 32-key tiles, the score
//     products split over 2 halves of dh, in both passes (which halves
//     each warp's share of the operand splits).  Against it: no dh split
//     0.0432 and 13.16; dK / dV with 2 warps a slab 0.0436 and 13.43, one
//     slab 0.0487 and 16.32, 4 slabs of 2 warps over 16-row tiles 0.0532
//     and 11.22; dQ with 2 warps a slab 0.0473 and 12.61, one slab 0.0463
//     and 13.99, 4 slabs of 2 warps over 16-key tiles 0.0532 and 11.56.
//   * Row chunks: where the (batch row, kv head, key tile) blocks are
//     fewer than the SMs (gemma-2b's training shape: 16 blocks of 32 keys),
//     each key tile's row tiles are cut into C = SMs / blocks chunks, one
//     block each (chunk c takes tiles [T c / C, T (c + 1) / C) of the T),
//     which write partial dK and dV to the scratch; flash_attn_bwd_reduce
//     sums the chunks in chunk order.  C = 1 writes dk and dv directly.
//     At the training shape C = 8: 0.0411 against 0.1343 at C = 1 (0.0516
//     at C = 16, two blocks an SM).
//   * Every sum runs in one fixed order and no atomics are used: two runs
//     give the same bits.
//   * The capped score and its tanh come from the forward's formula (c (1 -
//     2 / (1 + e^{2y})), ex2.approx and rcp.approx), and p from ex2.approx, so
//     the probabilities are the forward's to a few ulps.
//   * Shared memory: every staged row (Q, dO, K, V) is padded to DP = 64,
//     128, 192 or 256 columns with zeros, row stride DP + 4 floats (4 mod
//     32): the fragment reads (lane (g, t) reads row g at column t for an A
//     or B operand over d, or row 2 t and 2 t + 1 at column g for a B
//     operand over rows or keys, the k index permuted to match) hit 32
//     distinct banks.  At dh 256 the dK / dV pass holds 216 KB and the dQ
//     pass 224 KB, one block of 8 warps an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hash_tile.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float kLog2e = 1.4426950408889634f;
// the dK / dV pass: slabs of 16 keys a block, warps a slab, parts of dh the
// slab's warps split the score products into, packed rows a tile
constexpr int kKvSlabs = 2, kKvKS = 4, kKvKD = 2, kKvBR = 32;
// the dQ pass: slabs of 16 packed rows a block, warps a slab, parts of dh,
// keys a tile
constexpr int kQSlabs = 2, kQKS = 4, kQKD = 2, kQBK = 32;
// row chunks: dK / dV blocks aimed at an SM where key tiles alone give fewer
constexpr int kKvBlocksPerSM = 1;

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dO;
  float* delta;  // written by the dQ pass, read by the dK / dV pass
  float* dq;
  float* dk;
  float* dv;
  float* part;         // C > 1: (2, C, B, Skv, Hkv, dh) partial dK, then dV
  long long kv_elems;  // B Skv Hkv dh
  int Sq, Skv, Hq, Hkv, dh;
  int G;     // query heads a kv head
  int rows;  // Sq * G packed rows a (batch row, kv head)
  uint32_t g_mul, g_shift;  // r / G as (umulhi(r, g_mul) + r) >> g_shift (fast_div)
  int causal, window;
  float softcap;
  float scale;    // 1 / sqrt(dh)
  float scale2;   // log2(e) / sqrt(dh)
  float cap_in;   // 2 log2(e) / (sqrt(dh) c)
  float cap_out;  // c log2(e)
  bool vec;       // 16-byte copies and 8-byte stores: dh % 4 == 0, pointers 16-byte aligned
};

// r / G for 0 <= r < 2^31 by a multiply and a shift (the integer division
// takes some twenty instructions; the staging divides once a 16-byte copy)
__device__ __forceinline__ int div_g(const BwdArgs& a, int r) {
  return (int)((__umulhi((uint32_t)r, a.g_mul) + (uint32_t)r) >> a.g_shift);
}

// The key range [lo, hi) packed row r sees (empty past the rows)
__device__ __forceinline__ void key_range(const BwdArgs& a, int r, int& lo, int& hi) {
  lo = hi = 0;
  if (r < a.rows) {
    const int qp = div_g(a, r) + a.Skv - a.Sq;
    hi = a.causal ? min(qp + 1, a.Skv) : a.Skv;
    lo = a.window > 0 ? max(0, qp - a.window + 1) : 0;
  }
}

// dS's factor of one score s: p = 2^(x - lse) with x the capped score in
// the log2 domain, and dS = p (dP - delta) dcap, dcap = cap'(s) / sqrt(dh)
// with cap'(s) = 1 - tanh^2 = 1 - (x / (c log2 e))^2
__device__ __forceinline__ float prob(const BwdArgs& a, float s, float lse, bool keep,
                                      float& dcap) {
  float x;
  if (a.softcap > 0.f) {
    const float th = 1.f - 2.f * rcp_ftz(1.f + exp2_ftz(s * a.cap_in));
    x = th * a.cap_out;
    dcap = (1.f - th * th) * a.scale;
  } else {
    x = s * a.scale2;
    dcap = a.scale;
  }
  return keep ? exp2_ftz(x - lse) : 0.f;
}

// Offsets of a (batch row, kv head): the q / o / dO rows' base, the lse /
// delta base, and packed row r's offsets from them
struct Group {
  long long qo_base, st_base, kv_base, kv_pos;
  int G, Hq;
  uint32_t g_mul, g_shift;
  __device__ Group(const BwdArgs& a, int b, int kvh)
      : qo_base(((long long)b * a.Sq * a.Hq + (long long)kvh * a.G) * a.dh),
        st_base((long long)b * a.Sq * a.Hq + (long long)kvh * a.G),
        kv_base(((long long)b * a.Skv * a.Hkv + kvh) * a.dh),
        kv_pos((long long)a.Hkv * a.dh),
        G(a.G),
        Hq(a.Hq),
        g_mul(a.g_mul),
        g_shift(a.g_shift) {}
  // packed row r: query r / G of head r % G, in rows of (B Sq Hq)
  __device__ long long row(int r) const {
    const int i = (int)((__umulhi((uint32_t)r, g_mul) + (uint32_t)r) >> g_shift);
    return (long long)i * Hq + (r - i * G);
  }
};

// The backward's operand split, x = big + small, both tf32: big is x
// rounded to tf32 as cvt.rna.tf32.f32 rounds it (the same bits, in two
// integer operations where the conversion compiles to four on sm_90a),
// small = x - big truncated to tf32 (its error below 2^-21 |x|, as the
// rounded one's 2^-22 is: both far under float32 sums' own)
__device__ __forceinline__ void bsplit(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// The 4 values of a lane's A fragment, split and stored in shared memory:
// big at dst (one uint4 a lane), small 32 uint4 (a warp's fragments) after
__device__ __forceinline__ void put_a(uint32_t* dst, const float (&x)[4]) {
  uint4 big, small;
  bsplit(x[0], big.x, small.x);
  bsplit(x[1], big.y, small.y);
  bsplit(x[2], big.z, small.z);
  bsplit(x[3], big.w, small.w);
  reinterpret_cast<uint4*>(dst)[0] = big;
  reinterpret_cast<uint4*>(dst)[32] = small;
}

__device__ __forceinline__ void get_a(const uint32_t* src, uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
  const uint4 b = reinterpret_cast<const uint4*>(src)[0];
  const uint4 s = reinterpret_cast<const uint4*>(src)[32];
  big[0] = b.x, big[1] = b.y, big[2] = b.z, big[3] = b.w;
  small[0] = s.x, small[1] = s.y, small[2] = s.z, small[3] = s.w;
}

// c += a b in 3xTF32, a split, b = (b0, b1) split here
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  bsplit(b0, bb0, bs0);
  bsplit(b1, bb1, bs1);
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

// the A fragment (rows g, g + 8; k index t, t + 4 = columns d0 + t, + 4) of
// a row-major tile at p = tile + g * ld + t, split
template <int LD>
__device__ __forceinline__ void load_a(const float* p, int d0, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  bsplit(p[d0], big[0], small[0]);
  bsplit(p[8 * LD + d0], big[1], small[1]);
  bsplit(p[d0 + 4], big[2], small[2]);
  bsplit(p[8 * LD + d0 + 4], big[3], small[3]);
}

// A warp's two score products over DP of dh: c1[i] = A1 B1_i^T and c2[i] =
// A2 B2_i^T, for 16 rows of the A tiles (a1, a2 = tile + g LD + t) and the
// n-tiles of 8 rows brow[i] + (0 .. 7) of the B tiles (b1, b2 = tile + t;
// lane (g, t) reads row brow[i] = base + g)
template <int DP, int LD, int N>
__device__ __forceinline__ void two_products(const float* a1, const float* a2, const float* b1,
                                             const float* b2, const int (&brow)[N],
                                             float (&c1)[N][4], float (&c2)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[i][e] = c2[i][e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 8) {
    uint32_t x1b[4], x1s[4], x2b[4], x2s[4];
    load_a<LD>(a1, d, x1b, x1s);
    load_a<LD>(a2, d, x2b, x2s);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mma3(c1[i], x1b, x1s, b1[brow[i] * LD + d], b1[brow[i] * LD + d + 4]);
      mma3(c2[i], x2b, x2s, b2[brow[i] * LD + d], b2[brow[i] * LD + d + 4]);
    }
  }
}

// The bf16-P form's pair: c1 as two_products' (3xTF32), c2[i] = bf16(A2)
// bf16(B2_i)^T on the bf16 tensor cores, the operands rounded as they are
// read.  a2r and b2r point at column 0 of the A2 tile's row g and of the B2
// tile (lane (g, t) reads columns d + 2 t, + 1 and d + 2 t + 8, + 9 of its
// rows as float2s: 8-byte reads, conflict-free at the row stride DP + 4)
template <int DP, int LD, int N>
__device__ __forceinline__ void two_products_bf16(const float* a1, const float* a2r,
                                                  const float* b1, const float* b2r,
                                                  const int (&brow)[N], float (&c1)[N][4],
                                                  float (&c2)[N][4]) {
  const int t = threadIdx.x & 3;
  auto pack2 = [](const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return pack_bf16(v.x, v.y);
  };
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[i][e] = c2[i][e] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 16) {
#pragma unroll
    for (int h = 0; h < 16; h += 8) {  // S's two k steps of 8
      uint32_t xb[4], xs[4];
      load_a<LD>(a1, d + h, xb, xs);
#pragma unroll
      for (int i = 0; i < N; ++i)
        mma3(c1[i], xb, xs, b1[brow[i] * LD + d + h], b1[brow[i] * LD + d + h + 4]);
    }
    const float* ar = a2r + d + 2 * t;
    const uint32_t af[4] = {pack2(ar), pack2(ar + 8 * LD), pack2(ar + 8), pack2(ar + 8 * LD + 8)};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float* br = b2r + brow[i] * LD + d + 2 * t;
      mma_bf16(c2[i], af, pack2(br), pack2(br + 8));
    }
  }
}

__device__ __forceinline__ void slab_sync(int slab, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + slab), "r"(threads) : "memory");
}

// KD > 1: the KD warps of a slab that form the same N n-tiles of the score
// products (n-group grp), each over a part of dh (dpart), add their partial
// sums through the slab's exchange buffer xs ((n-groups, KD, N, 8, 32
// lanes) floats), in d-part order; the warp of part dpart is left with the
// whole sums of its n-tiles i, i % KD == dpart
template <int KD, int N>
__device__ __forceinline__ void add_parts(float* xs, int grp, int dpart, float (&c1)[N][4],
                                          float (&c2)[N][4], int slab, int threads) {
  if constexpr (KD > 1) {
    const int lane = threadIdx.x & 31;
    float* mine = xs + (grp * KD + dpart) * N * 8 * 32 + lane;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(8 * i + e) * 32] = c1[i][e];
        mine[(8 * i + 4 + e) * 32] = c2[i][e];
      }
    slab_sync(slab, threads);
    const float* all = xs + grp * KD * N * 8 * 32 + lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i % KD != dpart) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s1 = all[(8 * i + e) * 32], s2 = all[(8 * i + 4 + e) * 32];
#pragma unroll
        for (int h = 1; h < KD; ++h) {
          s1 += all[(h * N * 8 + 8 * i + e) * 32];
          s2 += all[(h * N * 8 + 8 * i + 4 + e) * 32];
        }
        c1[i][e] = s1;
        c2[i][e] = s2;
      }
    }
  }
}

// Store a warp's accumulator of 16 rows x NT n-tiles: its rows g and g + 8
// to dst_row(g), dst_row(g + 8) (none where null), columns col0 + 8 n + 2 t
// and + 1 below dh
template <int NT, class DstRow>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], const DstRow& dst_row,
                                          int col0, int dh, bool vec) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float* dst = dst_row(g + 8 * u);
    if (dst == nullptr) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col0 + 8 * n + 2 * t;
      const float v0 = acc[n][2 * u], v1 = acc[n][2 * u + 1];
      if (vec && c + 1 < dh) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
      } else {
        if (c < dh) dst[c] = v0;
        if (c + 1 < dh) dst[c + 1] = v1;
      }
    }
  }
}

template <int DP, int kSlabs, int KS, int KD, int BK>
struct QTile {
  static constexpr int kThreads = kSlabs * KS * 32;
  static constexpr int BM = 16 * kSlabs;         // packed rows a block
  static constexpr int NN = BK * KD / (8 * KS);  // n-tiles of 8 keys a warp in S, dP
  static constexpr int NK = BK / 8;              // k steps of dQ += dS K
  static constexpr int DW = DP / KS;             // columns of dQ a warp
  static constexpr int NT = DW / 8;
  static constexpr int LD = DP + 4;
  static constexpr int XS = KD > 1 ? KS * NN * 8 * 32 : 0;  // a slab's exchange floats
  static_assert(NN * 8 * KS == BK * KD && NN % KD == 0 && NT * 8 == DW &&
                (DP / KD) % 8 == 0, "whole n-tiles and k steps a warp");
  // Q, dO; two stages of K, V; dS split (2 arrays of 32 uint4 a k step and
  // slab); the partial scores' exchange; lse, delta
  static constexpr size_t kSmem = ((size_t)2 * BM * LD + (size_t)4 * BK * LD +
                                   (size_t)kSlabs * (NK * 2 * 32 * 4 + XS) + 2 * BM) *
                                  sizeof(float);
};

template <int DP, int kSlabs, int KS, int KD, int BK, bool kBf16P>
__global__ void __launch_bounds__(kSlabs * KS * 32, 1) flash_attn_bwd_dq_kernel(const BwdArgs a) {
  using T = QTile<DP, kSlabs, KS, KD, BK>;
  constexpr int LD = T::LD, BM = T::BM;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BM * LD;
  float* kv = dos + BM * LD;  // stage s: K at kv + 2 s BK LD, V BK LD after
  uint32_t* dsb = reinterpret_cast<uint32_t*>(kv + 4 * BK * LD);  // (slab, k step, 2, lane, 4)
  float* xs0 = reinterpret_cast<float*>(dsb + kSlabs * T::NK * 2 * 32 * 4);  // (slab, T::XS)
  float* lse_s = xs0 + kSlabs * T::XS;
  float* del_s = lse_s + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % kSlabs, part = warp / kSlabs;
  const int dpart = part / (KS / KD), grp = part % (KS / KD);  // dh part, n-group of S, dP
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const Group gr(a, b, kvh);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the last row tiles (the longest) first
  const int off = a.Skv - a.Sq;
  const float* qb = a.q + gr.qo_base;
  const float* db = a.dO + gr.qo_base;
  const float* kb = a.k + gr.kv_base;
  const float* vb = a.v + gr.kv_base;

  auto q_row = [&](int r) -> const float* {
    return r0 + r < a.rows ? qb + gr.row(r0 + r) * a.dh : nullptr;
  };
  auto d_row = [&](int r) -> const float* {
    return r0 + r < a.rows ? db + gr.row(r0 + r) * a.dh : nullptr;
  };
  stage<DP, BM, T::kThreads>(qs, LD, q_row, a.dh, a.vec, qb);
  stage<DP, BM, T::kThreads>(dos, LD, d_row, a.dh, a.vec, db);
  hash_tile::commit();

  // the keys any row of the tile may see (as the forward's kv_lo, kv_hi)
  const int last = min(r0 + BM, a.rows) - 1;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) kv_hi = min(a.Skv, div_g(a, last) + off + 1);
  if (a.window > 0) kv_lo = max(0, div_g(a, r0) + off - a.window + 1);
  const int tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  auto stage_kv = [&](int s, int j0) {
    auto k_row = [&](int r) -> const float* {
      return j0 + r < kv_hi ? kb + (long long)(j0 + r) * gr.kv_pos : nullptr;
    };
    auto v_row = [&](int r) -> const float* {
      return j0 + r < kv_hi ? vb + (long long)(j0 + r) * gr.kv_pos : nullptr;
    };
    stage<DP, BK, T::kThreads>(kv + 2 * s * BK * LD, LD, k_row, a.dh, a.vec, kb);
    stage<DP, BK, T::kThreads>(kv + (2 * s + 1) * BK * LD, LD, v_row, a.dh, a.vec, vb);
    hash_tile::commit();
  };
  if (tiles > 0) stage_kv(0, kv_lo);

  // delta = rowsum(dO o) and lse of the block's rows, while the copies fly;
  // delta also to the scratch, for the dK / dV pass
  for (int rr = warp; rr < BM; rr += T::kThreads / 32) {
    const int r = r0 + rr;
    float sum = 0.f;
    if (r < a.rows) {
      const long long o = gr.qo_base + gr.row(r) * a.dh;
      for (int d = lane; d < a.dh; d += 32) sum = fmaf(a.o[o + d], a.dO[o + d], sum);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) {
      del_s[rr] = sum;
      lse_s[rr] = r < a.rows ? a.lse[gr.st_base + gr.row(r)] : 0.f;
      if (r < a.rows) a.delta[gr.st_base + gr.row(r)] = sum;
    }
  }

  float acc[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the key range of this lane's rows g and g + 8 of the slab
  int lo[2], hi[2];
  key_range(a, r0 + 16 * slab + g, lo[0], hi[0]);
  key_range(a, r0 + 16 * slab + g + 8, lo[1], hi[1]);
  const float* qa = qs + (16 * slab + g) * LD + t;
  const float* da = dos + (16 * slab + g) * LD + t;

  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, j0 = kv_lo + it * BK;
    hash_tile::wait<0>();
    __syncthreads();  // this tile's K, V (the first time Q, dO, lse, delta) landed; the
                      // other stage and dS are consumed
    if (it + 1 < tiles) stage_kv(s ^ 1, j0 + BK);
    const float* ks = kv + 2 * s * BK * LD;
    const float* vs = ks + BK * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x 8 NN keys a warp over its part
    // of DP, then the KD parts added
    float sc[T::NN][4], dp[T::NN][4];
    int brow[T::NN];  // this lane's key in each n-tile
#pragma unroll
    for (int i = 0; i < T::NN; ++i) brow[i] = 8 * (grp * T::NN + i) + g;
    const int d_lo = dpart * (DP / KD);
    if constexpr (kBf16P)  // dP = bf16(dO) bf16(V)^T
      two_products_bf16<DP / KD, LD, T::NN>(qa + d_lo, da - t + d_lo, ks + t + d_lo, vs + d_lo,
                                            brow, sc, dp);
    else
      two_products<DP / KD, LD, T::NN>(qa + d_lo, da + d_lo, ks + t + d_lo, vs + t + d_lo,
                                       brow, sc, dp);
    add_parts<KD, T::NN>(xs0 + slab * T::XS, grp, dpart, sc, dp, slab, 32 * KS);
    // dS of this warp's whole n-tiles, stored as the A fragment of k step kk
    // (keys 8 kk ..): k index t stands for key 8 kk + 2 t and t + 4 for
    // 8 kk + 2 t + 1, so the accumulator's (e0, e1, e2, e3) go as (e0, e2,
    // e1, e3)
#pragma unroll
    for (int i = 0; i < T::NN; ++i) {
      if (i % KD != dpart) continue;
      const int kk = grp * T::NN + i;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, rr = 16 * slab + g + 8 * u, j = j0 + 8 * kk + 2 * t + (e & 1);
        float dcap;
        const float p = prob(a, sc[i][e], lse_s[rr], j >= lo[u] && j < hi[u], dcap);
        ds[e] = p * (dp[i][e] - del_s[rr]) * dcap;
      }
      const float frag[4] = {ds[0], ds[2], ds[1], ds[3]};
      put_a(dsb + ((slab * T::NK + kk) * 2 * 32 + lane) * 4, frag);
    }
    slab_sync(slab, 32 * KS);

    // dQ += dS K over the tile's keys, this warp's DW columns
#pragma unroll
    for (int kk = 0; kk < T::NK; ++kk) {
      uint32_t abig[4], asm_[4];
      get_a(dsb + ((slab * T::NK + kk) * 2 * 32 + lane) * 4, abig, asm_);
      const float* kr = ks + (8 * kk + 2 * t) * LD + part * T::DW + g;
#pragma unroll
      for (int n = 0; n < T::NT; ++n) mma3(acc[n], abig, asm_, kr[8 * n], kr[LD + 8 * n]);
    }
  }
  hash_tile::wait<0>();  // a tile with no key still issued Q's copy

  auto dst_row = [&](int rr) -> float* {
    const int r = r0 + 16 * slab + rr;
    return r < a.rows ? a.dq + gr.qo_base + gr.row(r) * a.dh : nullptr;
  };
  store_acc<T::NT>(acc, dst_row, part * T::DW, a.dh, a.vec);
}

template <int DP, int kSlabs, int KS, int KD, int BR>
struct KvTile {
  static constexpr int kThreads = kSlabs * KS * 32;
  static constexpr int BT = 16 * kSlabs;         // keys a block
  static constexpr int NR = BR * KD / (8 * KS);  // n-tiles of 8 rows a warp in S^T, dP^T
  static constexpr int NK = BR / 8;              // k steps of dV += P^T dO, dK += dS^T Q
  static constexpr int DW = DP / KS;             // columns of dK, dV a warp
  static constexpr int NT = DW / 8;
  static constexpr int LD = DP + 4;
  static_assert(NR * 8 * KS == BR * KD && NR % KD == 0 && NT * 8 == DW &&
                (DP / KD) % 8 == 0, "whole n-tiles and k steps a warp");
  // the partial scores' exchange (KD > 1) reuses a slab's P^T and dS^T
  static_assert(KD == 1 || KS * NR * 8 <= NK * 4 * 4, "the exchange fits the P^T buffer");
  // K, V; two stages of Q, dO; P^T and dS^T split (4 arrays of 32 uint4 a
  // k step and slab); two stages of lse, delta
  static constexpr size_t kSmem =
      ((size_t)2 * BT * LD + (size_t)4 * BR * LD + (size_t)kSlabs * NK * 4 * 32 * 4 + 4 * BR) *
      sizeof(float);
};

template <int DP, int kSlabs, int KS, int KD, int BR, bool kBf16P>
__global__ void __launch_bounds__(kSlabs * KS * 32, 1)
    flash_attn_bwd_dkdv_kernel(const BwdArgs a) {
  using T = KvTile<DP, kSlabs, KS, KD, BR>;
  constexpr int LD = T::LD, BT = T::BT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BT * LD;
  float* rows_s = vs + BT * LD;  // stage s: Q at rows_s + 2 s BR LD, dO BR LD after
  uint32_t* pb = reinterpret_cast<uint32_t*>(rows_s + 4 * BR * LD);  // (slab, k step, 4, lane, 4)
  float* st = reinterpret_cast<float*>(pb + kSlabs * T::NK * 4 * 32 * 4);  // stage s: lse, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % kSlabs, part = warp / kSlabs;
  const int dpart = part / (KS / KD), grp = part % (KS / KD);  // dh part, n-group of S^T, dP^T
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const Group gr(a, b, kvh);
  const int j0 = blockIdx.y * BT;
  const int off = a.Skv - a.Sq;
  const float* qb = a.q + gr.qo_base;
  const float* db = a.dO + gr.qo_base;

  // the packed rows that can see a key of this tile: causal, query position
  // >= j0; window, position - w + 1 <= the tile's last key; then this
  // block's chunk of their row tiles
  const int j_last = min(j0 + BT, a.Skv) - 1;
  long long r_lo = 0, r_hi = a.rows;
  if (a.causal) r_lo = max(0LL, (long long)(j0 - off)) * a.G;
  if (a.window > 0) r_hi = min(r_hi, max(0LL, (long long)j_last + a.window - off) * a.G);
  const long long n_tiles = r_hi > r_lo ? (r_hi - r_lo + BR - 1) / BR : 0;
  const int C = gridDim.z, c = blockIdx.z;
  const int t_begin = (int)(n_tiles * c / C), t_end = (int)(n_tiles * (c + 1) / C);

  auto stage_rows = [&](int s, int r0) {
    auto q_row = [&](int r) -> const float* {
      return r0 + r < a.rows ? qb + gr.row(r0 + r) * a.dh : nullptr;
    };
    auto d_row = [&](int r) -> const float* {
      return r0 + r < a.rows ? db + gr.row(r0 + r) * a.dh : nullptr;
    };
    stage<DP, BR, T::kThreads>(rows_s + 2 * s * BR * LD, LD, q_row, a.dh, a.vec, qb);
    stage<DP, BR, T::kThreads>(rows_s + (2 * s + 1) * BR * LD, LD, d_row, a.dh, a.vec, db);
    if (tid < 2 * BR) {  // lse, then delta; 0 past the rows (masked there)
      const int r = r0 + tid % BR;
      const float* src = (tid < BR ? a.lse : a.delta) + gr.st_base;
      const bool in = r < a.rows;
      hash_tile::copy<4>(st + 2 * s * BR + tid, in ? src + gr.row(r) : src, in ? 4 : 0);
    }
    hash_tile::commit();
  };
  if (t_begin < t_end) {
    auto k_row = [&](int r) -> const float* {
      return j0 + r < a.Skv ? a.k + gr.kv_base + (long long)(j0 + r) * gr.kv_pos : nullptr;
    };
    auto v_row = [&](int r) -> const float* {
      return j0 + r < a.Skv ? a.v + gr.kv_base + (long long)(j0 + r) * gr.kv_pos : nullptr;
    };
    stage<DP, BT, T::kThreads>(ks, LD, k_row, a.dh, a.vec, a.k);
    stage<DP, BT, T::kThreads>(vs, LD, v_row, a.dh, a.vec, a.v);
    stage_rows(0, (int)(r_lo + (long long)t_begin * BR));  // commits K and V with it
  }

  float dk[T::NT][4], dv[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float* ka = ks + (16 * slab + g) * LD + t;  // A: keys g, g + 8 of the slab
  const float* va = vs + (16 * slab + g) * LD + t;
  const int jk[2] = {j0 + 16 * slab + g, j0 + 16 * slab + g + 8};  // this lane's keys

  for (int it = t_begin; it < t_end; ++it) {
    const int s = (it - t_begin) & 1;
    const int r0 = (int)(r_lo + (long long)it * BR);
    hash_tile::wait<0>();
    __syncthreads();  // this tile's rows landed; the other stage, P^T and dS^T are consumed
    if (it + 1 < t_end) stage_rows(s ^ 1, r0 + BR);
    const float* qs = rows_s + 2 * s * BR * LD;
    const float* dos = qs + BR * LD;
    const float* lse_s = st + 2 * s * BR;
    const float* del_s = lse_s + BR;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 8 NR rows a warp over its
    // part of DP, then the KD parts added (through the slab's P^T buffer,
    // free until every warp has read the parts)
    float sc[T::NR][4], dp[T::NR][4];
    int brow[T::NR];  // this lane's row in each n-tile
#pragma unroll
    for (int i = 0; i < T::NR; ++i) brow[i] = 8 * (grp * T::NR + i) + g;
    const int d_lo = dpart * (DP / KD);
    if constexpr (kBf16P)  // dP^T = bf16(V) bf16(dO)^T
      two_products_bf16<DP / KD, LD, T::NR>(ka + d_lo, va - t + d_lo, qs + t + d_lo, dos + d_lo,
                                            brow, sc, dp);
    else
      two_products<DP / KD, LD, T::NR>(ka + d_lo, va + d_lo, qs + t + d_lo, dos + t + d_lo,
                                       brow, sc, dp);
    if constexpr (KD > 1) {
      add_parts<KD, T::NR>(reinterpret_cast<float*>(pb) + slab * T::NK * 4 * 32 * 4, grp, dpart,
                           sc, dp, slab, 32 * KS);
      slab_sync(slab, 32 * KS);
    }
    // P^T and dS^T of this warp's whole n-tiles, stored as the A fragments
    // of k step kk (rows 8 kk ..): k index t stands for row 8 kk + 2 t and
    // t + 4 for 8 kk + 2 t + 1, so the accumulator's (e0, e1, e2, e3) go as
    // (e0, e2, e1, e3)
#pragma unroll
    for (int i = 0; i < T::NR; ++i) {
      if (i % KD != dpart) continue;
      const int kk = grp * T::NR + i;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 8 * kk + 2 * t + (e & 1), j = jk[e >> 1];
        int lo, hi;
        key_range(a, r0 + rr, lo, hi);
        float dcap;
        p[e] = prob(a, sc[i][e], lse_s[rr], j >= lo && j < hi, dcap);
        ds[e] = p[e] * (dp[i][e] - del_s[rr]) * dcap;
      }
      uint32_t* dst = pb + ((slab * T::NK + kk) * 4 * 32 + lane) * 4;
      const float df[4] = {ds[0], ds[2], ds[1], ds[3]};
      if constexpr (kBf16P) {
        // P^T's bf16 A fragment of the 16-row step kk / 2, in the P^T area
        // of its first 8-row step: this n-tile is its half kk % 2 (keys g and
        // g + 8, rows 2 t and 2 t + 1 of the half), its accumulator as it lies
        uint32_t* frag = pb + ((slab * T::NK + (kk & ~1)) * 4 * 32 + lane) * 4 + 2 * (kk & 1);
        *reinterpret_cast<uint2*>(frag) = make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
      } else {
        const float pf[4] = {p[0], p[2], p[1], p[3]};
        put_a(dst, pf);
      }
      put_a(dst + 2 * 32 * 4, df);
    }
    slab_sync(slab, 32 * KS);

    // dV += P^T dO and dK += dS^T Q over the tile's rows, this warp's DW columns
    if constexpr (kBf16P) {  // dV: a bf16 product a 16-row step, dO rounded as read
      static_assert(T::NK % 2 == 0, "whole 16-row steps");
#pragma unroll
      for (int k2 = 0; k2 < T::NK / 2; ++k2) {
        const uint4 f = reinterpret_cast<const uint4*>(pb)[(slab * T::NK + 2 * k2) * 4 * 32 + lane];
        const uint32_t pa[4] = {f.x, f.y, f.z, f.w};
        const float* d0 = dos + (16 * k2 + 2 * t) * LD + part * T::DW + g;
#pragma unroll
        for (int n = 0; n < T::NT; ++n)
          mma_bf16(dv[n], pa, pack_bf16(d0[8 * n], d0[LD + 8 * n]),
                   pack_bf16(d0[8 * LD + 8 * n], d0[9 * LD + 8 * n]));
      }
    }
#pragma unroll
    for (int kk = 0; kk < T::NK; ++kk) {
      const uint32_t* src = pb + ((slab * T::NK + kk) * 4 * 32 + lane) * 4;
      uint32_t dbig[4], dsm[4];
      get_a(src + 2 * 32 * 4, dbig, dsm);
      const int c0 = (8 * kk + 2 * t) * LD + part * T::DW + g;
      if constexpr (!kBf16P) {
        uint32_t pbig[4], psm[4];
        get_a(src, pbig, psm);
#pragma unroll
        for (int n = 0; n < T::NT; ++n) mma3(dv[n], pbig, psm, dos[c0 + 8 * n], dos[c0 + LD + 8 * n]);
      }
#pragma unroll
      for (int n = 0; n < T::NT; ++n) mma3(dk[n], dbig, dsm, qs[c0 + 8 * n], qs[c0 + LD + 8 * n]);
    }
  }
  hash_tile::wait<0>();

  float* dkb = C == 1 ? a.dk : a.part + c * a.kv_elems;
  float* dvb = C == 1 ? a.dv : a.part + (C + c) * a.kv_elems;
  auto row_of = [&](float* base) {
    return [=](int kr) -> float* {
      const int j = j0 + 16 * slab + kr;
      return j < a.Skv ? base + gr.kv_base + (long long)j * gr.kv_pos : nullptr;
    };
  };
  store_acc<T::NT>(dk, row_of(dkb), part * T::DW, a.dh, a.vec);
  store_acc<T::NT>(dv, row_of(dvb), part * T::DW, a.dh, a.vec);
}

// dk (blockIdx.y 0) or dv (1) = the sum of the C chunks' partials, in chunk
// order: n floats each
__global__ void __launch_bounds__(256) flash_attn_bwd_reduce_kernel(const float* part, float* dk,
                                                                    float* dv, long long n,
                                                                    int C, bool vec) {
  const float* src = part + blockIdx.y * C * n;
  float* out = blockIdx.y ? dv : dk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const long long n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(src);
    for (long long e = first; e < n4; e += stride) {
      float4 s = p4[e];
      for (int c = 1; c < C; ++c) {
        const float4 x = p4[c * n4 + e];
        s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
      }
      reinterpret_cast<float4*>(out)[e] = s;
    }
  } else {
    for (long long e = first; e < n; e += stride) {
      float s = src[e];
      for (int c = 1; c < C; ++c) s += src[c * n + e];
      out[e] = s;
    }
  }
}

// the row chunks of the dK / dV pass: 1 where its key tiles give every SM
// kKvBlocksPerSM blocks, else as many as fill them, at most a row tile each
int chunks(long long B, long long Sq, long long Skv, long long Hq, long long Hkv, int sms) {
  using KT = KvTile<64, kKvSlabs, kKvKS, kKvKD, kKvBR>;  // BT and BR do not depend on DP
  const long long blocks = B * Hkv * ((Skv + KT::BT - 1) / KT::BT);
  const long long slots = (long long)sms * kKvBlocksPerSM;
  if (blocks == 0 || blocks >= slots) return 1;
  const long long row_tiles = (Sq * (Hq / Hkv) + kKvBR - 1) / kKvBR;
  return (int)std::max(1LL, std::min({slots / blocks, row_tiles, 65535LL}));
}

template <int DP, bool kBf16P>
cudaError_t launch(const BwdArgs& a, int B, int C, int sms, cudaStream_t stream) {
  using QT = QTile<DP, kQSlabs, kQKS, kQKD, kQBK>;
  using KT = KvTile<DP, kKvSlabs, kKvKS, kKvKD, kKvBR>;
  static_assert(QT::kSmem <= 232448 && KT::kSmem <= 232448, "above the 227 KB a block may use");
  static hash_tile::DeviceOnce once;  // the shared-memory limits raised once a device
  int dev_sms = 0;
  cudaError_t err = once.get(
      [] {
        cudaError_t e = cudaFuncSetAttribute(
            flash_attn_bwd_dq_kernel<DP, kQSlabs, kQKS, kQKD, kQBK, kBf16P>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)QT::kSmem);
        if (e != cudaSuccess) return e;
        return cudaFuncSetAttribute(
            flash_attn_bwd_dkdv_kernel<DP, kKvSlabs, kKvKS, kKvKD, kKvBR, kBf16P>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KT::kSmem);
      },
      &dev_sms);
  if (err != cudaSuccess) return err;
  dim3 qgrid((unsigned)(B * a.Hkv), (unsigned)((a.rows + QT::BM - 1) / QT::BM));
  flash_attn_bwd_dq_kernel<DP, kQSlabs, kQKS, kQKD, kQBK, kBf16P>
      <<<qgrid, QT::kThreads, QT::kSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.Skv == 0) return err;
  dim3 kgrid((unsigned)(B * a.Hkv), (unsigned)((a.Skv + KT::BT - 1) / KT::BT), (unsigned)C);
  flash_attn_bwd_dkdv_kernel<DP, kKvSlabs, kKvKS, kKvKD, kKvBR, kBf16P>
      <<<kgrid, KT::kThreads, KT::kSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || C == 1) return err;
  const long long n = a.kv_elems;
  const long long work = a.vec ? n / 4 : n;
  const dim3 grid((unsigned)std::min<long long>((work + 255) / 256, 4LL * sms), 2);
  flash_attn_bwd_reduce_kernel<<<grid, 256, 0, stream>>>(a.part, a.dk, a.dv, n, C, a.vec);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// (mul, shift) of div_g for the divisor d >= 1: shift = ceil(log2 d), mul =
// 2^32 (2^shift - d) / d + 1 (exact for every dividend below 2^31)
void fast_div(int d, uint32_t& mul, uint32_t& shift) {
  shift = 0;
  while ((1LL << shift) < d) ++shift;
  mul = (uint32_t)(((1ULL << 32) * ((1ULL << shift) - (unsigned long long)d)) / d + 1);
}

bool valid(int B, int Sq, int Skv, int Hq, int Hkv, int dh) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256)
    return false;
  const long long rows = (long long)Sq * (Hq / Hkv);
  return (long long)B * Hkv <= 0x7fffffffLL && (rows + 15) / 16 <= 65535 &&
         (Skv + 15) / 16 <= 65535;
}

int device_sms(int* sms) {
  static hash_tile::DeviceOnce once;
  return (int)once.get([] { return cudaSuccess; }, sms);
}

template <bool kBf16P>
int backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dO, void* dq, void* dk, void* dv, void* scratch, int B, int Sq, int Skv,
             int Hq, int Hkv, int dh, int causal, int window, float softcap, void* stream) {
  if (!valid(B, Sq, Skv, Hq, Hkv, dh)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != (int)cudaSuccess) return err;
  const int C = chunks(B, Sq, Skv, Hq, Hkv, sms);
  const long long kv_elems = (long long)B * Skv * Hkv * dh;
  float* part = static_cast<float*>(scratch);
  float* delta = part + (C > 1 ? 2 * C * kv_elems : 0);
  const float scale = 1.f / sqrtf((float)dh);
  const bool vec = dh % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                   aligned(dO, 16) && aligned(dq, 16) && aligned(dk, 16) && aligned(dv, 16) &&
                   aligned(scratch, 16);
  uint32_t g_mul, g_shift;
  fast_div(Hq / Hkv, g_mul, g_shift);
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(o),
            static_cast<const float*>(lse), static_cast<const float*>(dO), delta,
            static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), part,
            kv_elems, Sq, Skv, Hq, Hkv, dh, Hq / Hkv, (int)((long long)Sq * (Hq / Hkv)), g_mul,
            g_shift, causal, window, softcap, scale, scale * kLog2e,
            softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f, softcap * kLog2e, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 63) / 64) {
    case 1: return (int)launch<64, kBf16P>(a, B, C, sms, st);
    case 2: return (int)launch<128, kBf16P>(a, B, C, sms, st);
    case 3: return (int)launch<192, kBf16P>(a, B, C, sms, st);
    default: return (int)launch<256, kBf16P>(a, B, C, sms, st);
  }
}


}  // namespace

// The row chunks C of the dK / dV pass on the current device (the launch's
// scratch holds 2 C B Skv Hkv dh floats of partial dK and dV ahead of delta
// when C > 1), or a negative cudaError.
extern "C" int flash_attn_bwd_chunks(int B, int Sq, int Skv, int Hq, int Hkv, int dh) {
  if (!valid(B, Sq, Skv, Hq, Hkv, dh)) return -(int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != (int)cudaSuccess) return -err;
  return chunks(B, Sq, Skv, Hq, Hkv, sms);
}

// dq, dk, dv of the attention whose forward wrote o and lse (flash_attn_launch
// with an lse pointer), given dO; `scratch` holds (flash_attn_bwd_chunks C
// > 1) 2 C B Skv Hkv dh floats, then B Sq Hq (delta).  Two kernels on
// `stream`, the dQ pass (with delta) and the dK / dV pass, and the chunks'
// reduce when C > 1.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* lse, const void* dO, void* dq, void* dk,
                                     void* dv, void* scratch, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int dh, int causal, int window, float softcap,
                                     void* stream) {
  return backward<false>(q, k, v, o, lse, dO, dq, dk, dv, scratch, B, Sq, Skv, Hq, Hkv, dh,
                         causal, window, softcap, stream);
}

// the bf16-P form (attn_bf16_probs): the same arguments, all float32, the
// same kernels and scratch
extern "C" int flash_attn_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dO,
                                          void* dq, void* dk, void* dv, void* scratch, int B,
                                          int Sq, int Skv, int Hq, int Hkv, int dh, int causal,
                                          int window, float softcap, void* stream) {
  return backward<true>(q, k, v, o, lse, dO, dq, dk, dv, scratch, B, Sq, Skv, Hq, Hkv, dh,
                        causal, window, softcap, stream);
}

