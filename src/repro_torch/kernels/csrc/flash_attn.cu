// FlashAttention-2 forward on Hopper (sm_90a), batched and grouped, with both
// products on the tensor cores at float32 accuracy:
// o[b, i, h] = softmax_j(mask(cap(q[b, i, h] . k[b, j, g] / sqrt(dh)))) v[b, j, g]
// with g = h / (Hq / Hkv), for q (B, Sq, Hq, dh) and k, v (B, Skv, Hkv, dh),
// float32, contiguous, dh <= 256.  Masks use the true lengths with the ends
// aligned: query i sits at position i + Skv - Sq; causal keeps keys j <= that
// position, a window w > 0 keeps keys j > position - w; cap(s) = c tanh(s / c)
// when the softcap c > 0.  A row with no key left is written as 0.
// Given an lse pointer (B, Sq, Hq) float32 (the backward's, csrc/
// flash_attn_bwd.cu, needs it), the kernel also writes each row's
// log-sum-exp in base 2 of the scores it exponentiates: lse = log2 sum_j
// 2^x_j, x_j = cap(s_j) log2(e), so that the row's probabilities are
// 2^(x_j - lse); a row with no key holds +inf (every 2^(x - lse) is then 0).
// A null lse pointer writes nothing else: the serving and decode launches.
//
// The bf16-P form (flash_attn_bf16_launch, the models' attn_bf16_probs; a
// compile-time variant of the P V step, kBf16P): with p_j = 2^(x_j - m) over
// the row's keys, o = bf16(sum_j bf16(p_j) bf16(v_j)) / max(l, 1e-30), the
// product accumulated in fp32 and l = sum_j p_j of the unrounded p.  This is
// the reference's chunked_attention(bf16_probs=True) wherever the keys fit
// one of its chunks (src/repro/models/attention.py:124-128, kv_chunk 1,024);
// across key tiles the kernel rounds each tile's p against the running max
// and rescales, where a single pass would round p against the row's max:
// the two differ by roundings of the same size as the knob's own, so the
// kernel is held to the plain mirror of its own walk
// (ref.py flash_attention_bf16_tiles_ref, its tiles from flash_attn_tiles).
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py, flash_attn_pallas (and
// the per-(batch, head) vmap of src/repro/kernels/flash_attn/ops.py).  Unlike
// that kernel it masks with the true lengths, not the padded ones, so it
// computes attn_ref's function at every length.  Plain torch version beside
// it: src/repro_torch/kernels/flash_attn/ref.py.
//
// What bounds it: at the serving shape (B = 32, S = 32, Hq = 8, Hkv = 1,
// dh = 256) the bytes of q, k, v and o (19 MB, 6 us at 3.35 TB/s); at long
// sequences the products, 4 dh operations for every unmasked (query, key)
// pair.  On the float32 pipe (67 TFLOP/s) those take 2.05 ms at B 4, S 2048,
// Hq 16, causal; on the TF32 tensor cores (495 TFLOP/s dense) three MMAs a
// product take 0.83 ms.
//
// Design:
//   * 3xTF32: each operand x is split as big = tf32(x) (cvt.rna), small =
//     tf32(x - big), and a product a b is summed as a_small b_big + a_big
//     b_small + a_big b_big by mma.sync m16n8k8 (tf32 in, fp32 accumulate).
//     The dropped a_small b_small and the rounding of the small parts are
//     below 2^-21 |a b|, about the float32 product's own 2^-24 rounding times
//     a few: the kernel stays within FLASH_TOL (rtol = atol = 1e-4) of the
//     float32 plain version (tests/test_torch_flash_attn.py holds a plain
//     mirror of this arithmetic to attn_ref).  No product is plain TF32.
//   * The GQA group is packed: a block takes BM rows of one (batch row, kv
//     head), row r being query r / G of head r % G (G = Hq / Hkv), so K and
//     V are staged once for the group's G heads.  A warp computes the
//     scores of 16 rows (a slab).  Where 128-row tiles give every SM a block,
//     a block is 8 slabs of one warp over 32-key tiles; else (gemma-2b's
//     serving batch: 256 rows a kv head, 32 keys) 2 slabs of KS = 2 warps
//     over 16-key tiles, 73 KB of shared memory at dh 256, so that blocks
//     share an SM and one's loads overlap another's products.  The KS warps of a slab split its
//     work: each sums the scores over DP / KS of dh, the partial sums are
//     added through shared memory in one order (the same bits in every warp
//     of the slab), and each accumulates DP / KS of the output's columns,
//     which cuts the chain of dependent instructions that sets a short
//     block's time (tools/flash_variants.py at the serving shape: 4 slabs of
//     one warp 25 us, of 2 or 4 warps 15, 2 slabs of 2 warps over 16-key
//     tiles 13.6).  The row tiles are launched last first, so under a causal
//     mask the longest run first.
//   * Q (BM x dh), then each key tile of K and V, are staged in shared
//     memory by 16-byte cp.async (4-byte where dh is not a multiple of 4),
//     with dh padded to DP = 64, 128, 192 or 256 by zero-filled columns.  A
//     FlashAttention-2 pipeline: V of tile t loads while S = Q K^T of tile t
//     is computed (the first V with Q and the first K), K of tile t + 1
//     while P V of tile t is: two block barriers a key tile.
//   * The budget at dh 256: with one warp a slab, a warp's output
//     accumulator is 16 rows x 256 fp32, 128 registers a lane, plus 16 for
//     the scores of a 32-key tile (233 registers in all, no spill).  The
//     operands are split when a fragment is read from shared memory, not
//     stored split, so that Q (136 KB at 128 rows), K and V (34 KB each) fit
//     the 227 KB an SM gives one block: 3 ALU operations an
//     element, and every warp splits each K and V element it reads.  Split
//     once a tile into shared memory instead (64-row tiles, to fit), they
//     ran 2 % faster at the long shapes (tools/flash_variants.py, a dropped
//     variant): the split costs registers and latency more than issue
//     slots.
//   * Conflict-free fragment reads: the order of the 8 d within two MMA k
//     steps is permuted so that a lane reads its 4 values of a Q or K row
//     as one 16-byte load (row stride DP + 16 floats); P stays in the
//     accumulator layout of S, with the key order of the P V step permuted
//     to match, and V (row stride DP + 4) is read as 2 floats a lane and
//     n-tile.
//   * Online softmax in the log2 domain: scale log2(e) folded into one
//     multiply, exp2 by ex2.approx.ftz (2 ulp; a result below 2^-126 is
//     flushed to 0, an absolute change below 1.2e-38 of a probability); the
//     row statistics reduce over the 4 lanes of a row with 2 shuffles, the
//     normaliser at the end only.
//   * Softcap: c tanh(y) = c (1 - 2 / (1 + e^{2y})), e^{2y} by ex2.approx and
//     the reciprocal by rcp.approx (1 ulp), not tanh.approx.f32 (2^-11
//     relative, 0.025 of a score at c = 50).  The subtraction from 1 loses
//     at most half an ulp of 1, 6e-8, times c: 3e-6 of a score at c = 50,
//     far inside FLASH_TOL; e^{2y} overflowing to inf gives 1, and
//     flushing to 0 gives -1, as tanh does.
//   * The bf16-P form: the P V step is one mma.sync m16n8k16 bf16 product a
//     16-key step where the float32 form takes three m16n8k8 TF32 ones a
//     k step of 8 keys.  P stays in registers, FlashAttention-2's reuse:
//     the accumulators of S's n-tiles 2 k and 2 k + 1 are the A fragment of
//     key step k as they are (rows g and g + 8, keys 2 t, 2 t + 1 and 8 more),
//     rounded and packed two to a register (cvt.rn.bf16x2.f32, round to
//     nearest even); V is rounded as it is read from shared memory, keys
//     2 t, 2 t + 1 (and + 8) of column g, the B fragment's order, at the
//     same conflict-free addresses as the float32 form's.  Q K^T stays 3xTF32,
//     l keeps the unrounded p, the accumulator is rounded to bf16 after the
//     last key tile, before the division, and lse is the float32 form's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_tile.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kLongBN = 32;  // keys a tile where 128-row tiles give every SM a block
// else: slabs a block, warps a slab, keys a tile
constexpr int kShortSlabs = 2, kShortKS = 2, kShortBN = 16;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // nullptr: no row statistics
  int Sq, Skv, Hq, Hkv, dh;
  int G;     // query heads a kv head
  int rows;  // Sq * G rows a (batch row, kv head)
  int causal, window;
  float softcap;
  float scale2;   // log2(e) / sqrt(dh)
  float cap_in;   // 2 log2(e) / (sqrt(dh) c): e^{2 s / (sqrt(dh) c)} = 2^{s cap_in}
  float cap_out;  // c log2(e)
  bool vec;       // 16-byte copies: dh % 4 == 0 and q, k, v 16-byte aligned
  bool st2;       // 8-byte stores of o: dh even and o 8-byte aligned
};

template <int DP>
struct Ld {
  static constexpr int kQ = DP + 16;  // 16 mod 32: a quarter warp's 16-byte reads hit 32 banks
  static constexpr int kK = DP + 16;
  static constexpr int kV = DP + 4;   // 4 mod 16: rows 2t, 2t + 1 at banks 8t apart
};

// Q, K and V, then (KS > 1) each warp's partial scores, later its
// probabilities, kBN / 2 a lane
template <int DP, int kSlabs, int KS, int kBN>
constexpr size_t smem_bytes() {
  return ((size_t)16 * kSlabs * Ld<DP>::kQ + (size_t)kBN * Ld<DP>::kK +
          (size_t)kBN * Ld<DP>::kV + (KS > 1 ? (size_t)kSlabs * KS * kBN / 2 * 32 : 0)) *
         sizeof(float);
}

// kSlabs slabs of 16 rows a block; KS > 1 splits each slab's work between KS
// warps: each sums the scores over DW = DP / KS of dh, the partial sums are
// added through shared memory, and each accumulates DW of the output's
// columns.
// kBf16P: the bf16-P form of the P V step (attn_bf16_probs).
template <int DP, int kSlabs, int KS, int kBN, bool kBf16P>
__global__ void __launch_bounds__(kSlabs * KS * 32, 1) flash_attn_kernel(const Args a) {
  constexpr int kThreads = kSlabs * KS * 32;
  constexpr int kNS = kBN / 8;     // n-tiles of 8 keys in a tile's scores
  constexpr int BM = 16 * kSlabs;  // rows a block
  constexpr int NT = DP / 8 / KS;  // n-tiles of 8 output columns a warp
  constexpr int DW = DP / KS;      // the d of a warp's partial scores
  constexpr int QLD = Ld<DP>::kQ, KLD = Ld<DP>::kK, VLD = Ld<DP>::kV;
  constexpr int kG = NT % 4 == 0 ? 4 : NT % 2 == 0 ? 2 : 1;  // n-tiles a group of the P V step
  static_assert(NT % kG == 0 && DW % 16 == 0, "a warp's columns in whole steps");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // (BM, QLD)
  float* ks = qs + BM * QLD;   // (kBN, KLD)
  float* vs = ks + kBN * KLD;  // (kBN, VLD)
  float* sx = vs + kBN * VLD;  // KS > 1: (warps, kNS * 4, 32) partial scores
  float* sp = sx;  // KS > 1: then the warp's probabilities, after the slab's barrier
  // KS > 1 (short sequences: a key tile or a few) keeps the code small, its
  // d and key-step loops rolled: a warp runs each instruction about once, so
  // fetching the unrolled code after the model's GEMMs had evicted it took
  // as long as the kernel (4 slabs of KS = 2, unrolled: 25 us a launch in
  // gemma-2b's batch against 14.5 alone; rolled: 17)
  constexpr int kUnrollD = KS > 1 ? 1 : DW / 16;
  constexpr int kUnrollK = KS > 1 ? 1 : kNS;
  constexpr int kUnrollK16 = KS > 1 ? 1 : kNS / 2;  // the bf16-P form's 16-key steps
  static_assert(!kBf16P || kNS % 2 == 0, "whole 16-key steps");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % kSlabs, part = warp / kSlabs;  // rows 16 slab ..; columns DW part ..
  const int g = lane >> 2, t = lane & 3;  // the MMA fragments' group and thread in group
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x - b * a.Hkv;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the last row tiles first
  const int off = a.Skv - a.Sq;                      // query i sits at key i + off
  const long long q_pos = (long long)a.Hq * a.dh;     // q and o: stride between queries
  const long long kv_pos = (long long)a.Hkv * a.dh;
  const long long qo_base = ((long long)b * a.Sq * a.Hq + (long long)kvh * a.G) * a.dh;
  const long long kv_base = ((long long)b * a.Skv * a.Hkv + kvh) * a.dh;
  const float* qb = a.q + qo_base;
  const float* kb = a.k + kv_base;
  const float* vb = a.v + kv_base;
  float* ob = a.o + qo_base;
  // row r of the group: query r / G of head r % G
  auto row_off = [&](int r) {
    const int i = r / a.G;
    return i * q_pos + (long long)(r - i * a.G) * a.dh;
  };

  // the keys any row of the tile may see
  const int last = min(r0 + BM, a.rows) - 1;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.causal) kv_hi = min(a.Skv, last / a.G + off + 1);
  if (a.window > 0) kv_lo = max(0, r0 / a.G + off - a.window + 1);
  const int tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBN - 1) / kBN : 0;

  auto q_row = [&](int r) -> const float* {
    return r0 + r < a.rows ? qb + row_off(r0 + r) : nullptr;
  };
  auto stage_kv = [&](float* dst, int ld, const float* base, int j0) {
    auto kv_row = [&](int r) -> const float* {
      return j0 + r < kv_hi ? base + (long long)(j0 + r) * kv_pos : nullptr;
    };
    stage<DP, kBN, kThreads>(dst, ld, kv_row, a.dh, a.vec, base);
  };
  stage<DP, BM, kThreads>(qs, QLD, q_row, a.dh, a.vec, qb);
  if (tiles > 0) stage_kv(ks, KLD, kb, kv_lo);
  hash_tile::commit();
  if (tiles > 0) stage_kv(vs, VLD, vb, kv_lo);  // the first V in flight with Q and K
  hash_tile::commit();

  // the key range [lo, hi) of this lane's rows g and g + 8 of the warp's 16
  int lo[2], hi[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + 16 * slab + g + 8 * u;
    lo[u] = hi[u] = 0;  // a padding row sees no key
    if (r < a.rows) {
      const int qp = r / a.G + off;
      hi[u] = a.causal ? min(qp + 1, a.Skv) : a.Skv;
      lo[u] = a.window > 0 ? max(0, qp - a.window + 1) : 0;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const float* q0 = qs + (16 * slab + g) * QLD + DW * part + 4 * t;  // rows g and g + 8
  const float* q1 = q0 + 8 * QLD;
  const float* k0 = ks + g * KLD + DW * part + 4 * t;  // key g of each n-tile
  for (int it = 0; it < tiles; ++it) {
    const int j0 = kv_lo + it * kBN;
    if (it == 0) {
      hash_tile::wait<1>();  // Q and the first K landed; the first V may be in flight
      __syncthreads();
    } else {
      hash_tile::wait<0>();
      __syncthreads();  // K of this tile landed; the last tile's V is consumed
      stage_kv(vs, VLD, vb, j0);
      hash_tile::commit();
    }

    // S = Q K^T, 16 rows x 32 keys a warp.  Within two k steps (16 d), k
    // index t stands for d0 + 4t and t + 4 for d0 + 4t + 1 in the first,
    // d0 + 4t + 2 and + 3 in the second, in both operands.
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll kUnrollD
    for (int d0 = 0; d0 < DW; d0 += 16) {
      const float4 x0 = hash_tile::lds4(q0 + d0), x1 = hash_tile::lds4(q1 + d0);
      uint32_t ab[2][4], as[2][4];
      split(x0.x, ab[0][0], as[0][0]);
      split(x1.x, ab[0][1], as[0][1]);
      split(x0.y, ab[0][2], as[0][2]);
      split(x1.y, ab[0][3], as[0][3]);
      split(x0.z, ab[1][0], as[1][0]);
      split(x1.z, ab[1][1], as[1][1]);
      split(x0.w, ab[1][2], as[1][2]);
      split(x1.w, ab[1][3], as[1][3]);
      uint32_t bb[kNS][4], bs[kNS][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        const float4 y = hash_tile::lds4(k0 + 8 * n * KLD + d0);
        split(y.x, bb[n][0], bs[n][0]);
        split(y.y, bb[n][1], bs[n][1]);
        split(y.z, bb[n][2], bs[n][2]);
        split(y.w, bb[n][3], bs[n][3]);
      }
#pragma unroll
      for (int st = 0; st < 2; ++st) {
#pragma unroll
        for (int n = 0; n < kNS; ++n) mma(s[n], as[st], bb[n][2 * st], bb[n][2 * st + 1]);
#pragma unroll
        for (int n = 0; n < kNS; ++n) mma(s[n], ab[st], bs[n][2 * st], bs[n][2 * st + 1]);
#pragma unroll
        for (int n = 0; n < kNS; ++n) mma(s[n], ab[st], bb[n][2 * st], bb[n][2 * st + 1]);
      }
    }

    if constexpr (KS > 1) {  // the slab's KS partial sums, added in the order of the parts
      float* mine = sx + warp * (kNS * 4 * 32) + lane;
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = s[n][e];
      asm volatile("bar.sync %0, %1;" ::"r"(1 + slab), "r"(32 * KS) : "memory");
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int pt = 0; pt < KS; ++pt)
            sum += sx[(slab + pt * kSlabs) * (kNS * 4 * 32) + (4 * n + e) * 32 + lane];
          s[n][e] = sum;  // the same bits in every warp of the slab
        }
      asm volatile("bar.sync %0, %1;" ::"r"(1 + slab), "r"(32 * KS) : "memory");  // sx read
    }

    // scores in the log2 domain, masked; s[n][e] is row g + 8 (e / 2), key
    // j0 + 8 n + 2 t + e % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, j = j0 + 8 * n + 2 * t + (e & 1);
        float x = s[n][e];
        if (a.softcap > 0.f)
          x = (1.f - 2.f * rcp_ftz(1.f + exp2_ftz(x * a.cap_in))) * a.cap_out;
        else
          x *= a.scale2;
        x = (j >= lo[u] && j < hi[u]) ? x : -INFINITY;
        s[n][e] = x;
        mx[u] = fmaxf(mx[u], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m_run[u], mx[u]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key of the row seen yet
      alpha[u] = exp2_ftz(m_run[u] - m_use);
      m_run[u] = m_new;
      mx[u] = m_use;
      l_run[u] *= alpha[u];
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;  // this lane's part of the row's normaliser
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    hash_tile::wait<0>();
    __syncthreads();  // V of this tile landed; every warp is done with its K
    if (it + 1 < tiles) stage_kv(ks, KLD, kb, j0 + kBN);
    hash_tile::commit();

    // O += P V.  P is S's accumulator: in the k step of keys 8 ks .. + 7,
    // k index t stands for key 8 ks + 2 t and t + 4 for 8 ks + 2 t + 1.
    // KS > 1 reads it back from shared memory (this lane's own values), so
    // that the key-step loop can stay rolled.
    float* pw = sp + warp * (kNS * 4 * 32) + lane;
    if constexpr (KS > 1) {
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pw[(4 * n + e) * 32] = s[n][e];
    }
    if constexpr (kBf16P) {
      // one bf16 product a 16-key step: n-tiles 2 kst and 2 kst + 1 of S
      // are its A fragment as they lie
#pragma unroll kUnrollK16
      for (int kst = 0; kst < kNS / 2; ++kst) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (KS > 1) {
            p[e] = pw[(8 * kst + e) * 32];
            p[4 + e] = pw[(8 * kst + 4 + e) * 32];
          } else {
            p[e] = s[2 * kst][e];
            p[4 + e] = s[2 * kst + 1][e];
          }
        }
        const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
        const float* v0 = vs + (16 * kst + 2 * t) * VLD + DW * part + g;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_bf16(o[n], pa, pack_bf16(v0[8 * n], v0[VLD + 8 * n]),
                   pack_bf16(v0[8 * VLD + 8 * n], v0[9 * VLD + 8 * n]));
      }
    } else {
#pragma unroll kUnrollK
      for (int kst = 0; kst < kNS; ++kst) {
        float p[4];
        if constexpr (KS > 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = pw[(4 * kst + e) * 32];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = s[kst][e];
        }
        uint32_t pb[4], ps[4];
        split(p[0], pb[0], ps[0]);
        split(p[2], pb[1], ps[1]);
        split(p[1], pb[2], ps[2]);
        split(p[3], pb[3], ps[3]);
        const float* v0 = vs + (8 * kst + 2 * t) * VLD + DW * part + g;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += kG) {
          uint32_t wb[kG][2], ws[kG][2];
#pragma unroll
          for (int u = 0; u < kG; ++u) {
            split(v0[8 * (n0 + u)], wb[u][0], ws[u][0]);
            split(v0[VLD + 8 * (n0 + u)], wb[u][1], ws[u][1]);
          }
#pragma unroll
          for (int u = 0; u < kG; ++u) mma(o[n0 + u], ps, wb[u][0], wb[u][1]);
#pragma unroll
          for (int u = 0; u < kG; ++u) mma(o[n0 + u], pb, ws[u][0], ws[u][1]);
#pragma unroll
          for (int u = 0; u < kG; ++u) mma(o[n0 + u], pb, wb[u][0], wb[u][1]);
        }
      }
    }
  }
  hash_tile::wait<0>();  // a tile with no key left still issued Q's copy

  // o = acc / max(l, 1e-30): rows g, g + 8, columns 8 n + 2 t, + 1
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float l = l_run[u];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = r0 + 16 * slab + g + 8 * u;
    if (r >= a.rows) continue;
    if (a.lse != nullptr && part == 0 && t == 0) {  // m_run and l: the same in the row's lanes
      const long long i = r / a.G;
      a.lse[(long long)b * a.Sq * a.Hq + (long long)kvh * a.G + i * a.Hq + (r - i * a.G)] =
          m_run[u] == -INFINITY ? INFINITY : m_run[u] + log2f(l);
    }
    float* orow = ob + row_off(r) + DW * part;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t, left = a.dh - DW * part;  // columns left from orow
      float acc0 = o[n][2 * u], acc1 = o[n][2 * u + 1];
      if constexpr (kBf16P) {  // the product's sum rounded once, as the reference's
        acc0 = __bfloat162float(__float2bfloat16_rn(acc0));
        acc1 = __bfloat162float(__float2bfloat16_rn(acc1));
      }
      const float v0 = acc0 * inv, v1 = acc1 * inv;
      if (a.st2 && c + 1 < left) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
      } else {
        if (c < left) orow[c] = v0;
        if (c + 1 < left) orow[c + 1] = v1;
      }
    }
  }
}

template <int DP, int kSlabs, int KS, int kBN, bool kBf16P>
cudaError_t launch_tiles(const Args& a, int B, cudaStream_t stream) {
  constexpr int BM = 16 * kSlabs;
  constexpr size_t kSmem = smem_bytes<DP, kSlabs, KS, kBN>();
  static_assert(kSmem <= 232448, "above the 227 KB a block may use");
  static hash_tile::DeviceOnce once;  // the shared-memory limit raised once a device
  int sms = 0;
  const cudaError_t err = once.get(
      [] {
        return cudaFuncSetAttribute(flash_attn_kernel<DP, kSlabs, KS, kBN, kBf16P>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
      },
      &sms);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * a.Hkv), (unsigned)((a.rows + BM - 1) / BM));
  flash_attn_kernel<DP, kSlabs, KS, kBN, kBf16P><<<grid, kSlabs * KS * 32, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// 8 slabs (128 rows) a block where that gives every SM a block; else 4
// slabs of kShortKS warps each: more warps on the same rows
bool long_tiles(int B, int Hkv, long long rows, int sms) {
  return (long long)B * Hkv * ((rows + 127) / 128) >= sms;
}

template <int DP, bool kBf16P>
cudaError_t launch(const Args& a, int B, int sms, cudaStream_t stream) {
  if (long_tiles(B, a.Hkv, a.rows, sms))
    return launch_tiles<DP, 8, 1, kLongBN, kBf16P>(a, B, stream);
  return launch_tiles<DP, kShortSlabs, kShortKS, kShortBN, kBf16P>(a, B, stream);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <bool kBf16P>
int attend(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
           int Skv, int Hq, int Hkv, int dh, int causal, int window, float softcap,
           void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)Sq * (Hq / Hkv);
  if ((long long)B * Hkv > 0x7fffffffLL || (rows + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  static hash_tile::DeviceOnce once;
  int sms = 0;
  const cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)dh);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), Sq,
         Skv, Hq, Hkv, dh, Hq / Hkv, (int)rows, causal, window, softcap, scale * kLog2e,
         softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f, softcap * kLog2e,
         dh % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16),
         dh % 2 == 0 && aligned(o, 8)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 63) / 64) {
    case 1: return (int)launch<64, kBf16P>(a, B, sms, st);
    case 2: return (int)launch<128, kBf16P>(a, B, sms, st);
    case 3: return (int)launch<192, kBf16P>(a, B, sms, st);
    default: return (int)launch<256, kBf16P>(a, B, sms, st);
  }
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int dh,
                                 int causal, int window, float softcap, void* stream) {
  return attend<false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap,
                       stream);
}

// The tiles a launch walks on the current device, as (rows a block << 16) |
// keys a tile, or a negative cudaError: each block's key tiles start at the
// first key any of its rows may see, so a bf16-P row's roundings depend on
// them (ref.py flash_attention_bf16_tiles_ref mirrors that walk).
extern "C" int flash_attn_tiles(int B, int Sq, int Hq, int Hkv) {
  if (B < 0 || Sq < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0) return -(int)cudaErrorInvalidValue;
  static hash_tile::DeviceOnce once;
  int sms = 0;
  const cudaError_t err = once.get([] { return cudaSuccess; }, &sms);
  if (err != cudaSuccess) return -(int)err;
  if (long_tiles(B, Hkv, (long long)Sq * (Hq / Hkv), sms)) return (16 * 8) << 16 | kLongBN;
  return (16 * kShortSlabs) << 16 | kShortBN;
}

// the bf16-P form (attn_bf16_probs): the same arguments, all float32
extern "C" int flash_attn_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                                      int dh, int causal, int window, float softcap,
                                      void* stream) {
  return attend<true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap,
                      stream);
}
