"""Flash-attention inputs made from a numpy seed, and a plain-torch mirror of
the card kernel's arithmetic: shared by the CPU parity tests
(tests/test_torch_flash_attn.py) and the on-card tests
(tests/test_torch_kernels_cuda.py).  Imports neither JAX nor the reference
package.

The cases aim at what the kernel (src/repro_torch/kernels/csrc/
flash_attn.cu) can get wrong: head widths padded to its 64-column steps and
not a multiple of the MMA's k of 8 (100, 200), lengths off its 32-key,
64-row and 128-row tiles, shapes that take its 128-row tiles (where they
give every SM a block) beside the rest, which take 64-row tiles, Sq > Skv
under the causal mask (the leading rows see no key and are 0), GQA groups
of 1, 2, 5 (not a power of two), 8 and 16 heads packed into a row tile
(qwen3-moe's G 16 and llama4-maverick's G 5 also at their head counts,
causal and at one query; zamba2-7b's G 1 at dh 112, padded to 128 columns,
likewise; whisper-tiny's 6 heads of 64 not causal, at Sq < Skv, over its
encoder's 1,500 frames and at one query over them), a window narrower than a key
tile, the softcap at scores of magnitude ~100, and inputs scaled by 30: q (scores of ~30, so that most exps of a row
flush to 0) or v (a large P V).  q, k and v all scaled by 30 give scores of
~900, where the float32 plain version itself is 0.02 off the float64 result
(150 times FLASH_TOL): no float32 order can be held to another there, and
`test_mirror_is_as_accurate_as_float32_at_large_scores` compares both with
float64 instead."""
import math

import numpy as np
import torch

# name -> (B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, q scale, v scale)
FLASH_CASES = {
    "gemma-2b serving": (32, 32, 32, 8, 1, 256, True, 0, 0.0, 1, 1),
    "odd length": (2, 77, 77, 4, 2, 16, True, 0, 0.0, 1, 1),
    "non-causal": (2, 40, 40, 4, 4, 64, False, 0, 0.0, 1, 1),
    "Sq < Skv": (1, 8, 40, 2, 1, 40, True, 0, 0.0, 1, 1),
    "window + softcap": (2, 100, 100, 6, 3, 256, True, 33, 50.0, 1, 1),
    "non-causal window": (1, 130, 130, 2, 2, 100, False, 17, 0.0, 1, 1),
    "one of each": (1, 1, 1, 1, 1, 1, True, 0, 0.0, 1, 1),
    **{f"dh {dh}": (2, 77, 77, 4, 2, dh, True, 0, 0.0, 1, 1) for dh in (8, 64, 100, 128, 200, 256)},
    "Sq, Skv off the tiles": (2, 97, 131, 4, 1, 64, True, 0, 0.0, 1, 1),
    "Sq > Skv": (2, 150, 70, 4, 2, 64, True, 0, 0.0, 1, 1),
    **{f"group {G}": (1, 65, 65, 2 * G, 2, 128, True, 0, 0.0, 1, 1) for G in (1, 2, 5, 8, 16)},
    # qwen3-moe's heads (64 over 4) and llama4-maverick's (40 over 8) at one
    # query over a longer cache (decode), and at their prefill's causal rows
    "group 16, Sq 1": (4, 1, 300, 64, 4, 128, True, 0, 0.0, 1, 1),
    "group 5, Sq 1": (4, 1, 300, 40, 8, 128, True, 0, 0.0, 1, 1),
    "group 16, causal": (1, 140, 140, 64, 4, 128, True, 0, 0.0, 1, 1),
    "group 5, causal": (1, 140, 140, 40, 8, 128, True, 0, 0.0, 1, 1),
    # zamba2-7b's shared block: 32 heads of 112, MHA
    "dh 112, group 1, Sq 1": (4, 1, 300, 32, 32, 112, True, 0, 0.0, 1, 1),
    "dh 112, group 1, causal": (1, 140, 140, 32, 32, 112, True, 0, 0.0, 1, 1),
    # whisper-tiny's heads (6 of 64, G 1), not causal: the encoder over its
    # 1,500 frames, the cross attention of a prompt over them (Sq < Skv) and
    # of one decode step
    "non-causal, Sq < Skv": (2, 40, 150, 6, 6, 64, False, 0, 0.0, 1, 1),
    "whisper encoder": (1, 1500, 1500, 6, 6, 64, False, 0, 0.0, 1, 1),
    "whisper cross decode, Sq 1": (4, 1, 1500, 6, 6, 64, False, 0, 0.0, 1, 1),
    "window 5": (2, 100, 100, 4, 2, 128, True, 5, 0.0, 1, 1),
    "softcap, scores ~100": (2, 70, 70, 4, 2, 256, True, 0, 50.0, 10, 1),
    "128-row tiles": (4, 300, 300, 16, 8, 256, True, 0, 0.0, 1, 1),
    "128-row tiles, window + softcap": (4, 300, 300, 16, 8, 100, True, 40, 50.0, 1, 1),
    "q x30": (2, 64, 64, 4, 1, 256, True, 0, 0.0, 30, 1),
    "v x30": (2, 64, 64, 4, 1, 256, True, 0, 0.0, 1, 30),
}
LOG2E = 1.4426950408889634
FLT_MIN = 2.0 ** -126  # the smallest normal float32
# the kernel's keys a tile at long sequences (16 at short ones: another
# rounding of the online softmax, the same arithmetic)
KEY_TILE = 32


def make_case(name: str):
    """(q, k, v, kw) of case `name`: float32 numpy arrays, standard normal
    times the case's scales, and the keyword arguments of the call."""
    B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, qs, vs = FLASH_CASES[name]
    rng = np.random.default_rng(Sq * dh + Hq)
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    return (q * np.float32(qs), k, v * np.float32(vs),
            dict(causal=causal, window=window, softcap=softcap))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away from
    zero (add half of the dropped 13 bits' range to the magnitude, then
    clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """x = big + small with big = tf32(x), small = tf32(x - big)."""
    big = tf32(x)
    return big, tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three tensor-core products: a_small b_big +
    a_big b_small + a_big b_big, each summed in float32 (a_small b_small is
    dropped)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return ((as_ @ bb) + (ab @ bs)) + (ab @ bb)


def ex2(x: torch.Tensor) -> torch.Tensor:
    """ex2.approx.ftz: 2^x with a result below the smallest normal float32
    flushed to 0."""
    r = torch.exp2(x)
    return torch.where(r < FLT_MIN, torch.zeros_like(r), r)


def kernel_mirror(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """The card kernel's arithmetic in plain torch: q (B, Sq, Hq, dh), k
    and v (B, Skv, Hkv, dh) float32 CPU tensors -> (B, Sq, Hq, dh).  Row r of
    a kv head's group is query r // G of head r % G; scores by 3xTF32,
    scaled by log2(e) / sqrt(dh) (or capped as c (1 - 2 / (1 + 2^{s
    cap_in})) log2(e)), masked, an online softmax in base 2 over tiles of 32
    keys with exps flushed to 0 below 2^-126, P V by 3xTF32, and the output
    acc * (1 / max(l, 1e-30)).  The order of the sums inside a product is
    torch's, not the tensor cores'."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, R = Hq // Hkv, Sq * (Hq // Hkv)
    f = np.float32
    scale = f(1) / f(np.sqrt(f(dh)))
    scale2 = f(scale * f(LOG2E))
    cap_in = f(f(f(2) * f(LOG2E)) * scale) / f(softcap) if softcap > 0 else f(0)
    cap_out = f(f(softcap) * f(LOG2E))
    qg = q.reshape(B, Sq, Hkv, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, dh)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    qp = torch.arange(R) // G + (Skv - Sq)
    hi = torch.clamp(qp + 1, max=Skv) if causal else torch.full_like(qp, Skv)
    lo = torch.clamp(qp - window + 1, min=0) if window > 0 else torch.zeros_like(qp)
    m = torch.full((B, Hkv, R, 1), -math.inf)
    l = torch.zeros((B, Hkv, R, 1))
    o = torch.zeros((B, Hkv, R, dh))
    for j0 in range(0, Skv, KEY_TILE):
        j = torch.arange(j0, min(Skv, j0 + KEY_TILE))
        s = mm_3xtf32(qg, kt[:, :, j0:j0 + KEY_TILE].transpose(-1, -2))
        if softcap > 0:
            x = (1 - 2 * (1 / (1 + ex2(s * cap_in)))) * cap_out
        else:
            x = s * scale2
        keep = (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
        x = x.masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = ex2(m - m_use)
        p = ex2(x - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm_3xtf32(p, vt[:, :, j0:j0 + KEY_TILE])
        m = m_new
    out = o * (1 / torch.clamp(l, min=1e-30))
    return out.reshape(B, Hkv, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, dh)


# The backward's cases: name -> a FLASH_CASES entry's fields.  Causal,
# window, softcap, GQA groups, Sq != Skv both ways, rows with no key (Sq >
# Skv under the causal mask), a width off the 64-column steps, and the
# training shapes the card runs: gemma-2b's (MQA, 8 heads of 256) and
# whisper-tiny's cross attention (not causal, dh 64) cut to CPU size.
BWD_CASES = {
    "causal": (2, 40, 40, 4, 2, 32, True, 0, 0.0, 1, 1),
    "non-causal": (2, 33, 33, 3, 3, 16, False, 0, 0.0, 1, 1),
    "window": (1, 70, 70, 4, 2, 24, True, 9, 0.0, 1, 1),
    "non-causal window": (1, 50, 50, 2, 2, 20, False, 7, 0.0, 1, 1),
    "softcap": (2, 45, 45, 4, 1, 32, True, 0, 5.0, 3, 1),
    "window + softcap": (2, 64, 64, 6, 3, 40, True, 17, 50.0, 1, 1),
    "group 5": (1, 37, 37, 10, 2, 16, True, 0, 0.0, 1, 1),
    "Sq < Skv": (2, 20, 53, 4, 2, 32, True, 0, 0.0, 1, 1),
    "Sq < Skv, not causal": (2, 19, 61, 6, 6, 64, False, 0, 0.0, 1, 1),
    "Sq > Skv (empty rows)": (2, 50, 21, 4, 2, 32, True, 0, 0.0, 1, 1),
    "dh 100": (1, 35, 35, 2, 1, 100, True, 0, 0.0, 1, 1),
    "gemma-2b training, cut": (2, 24, 24, 8, 1, 256, True, 0, 0.0, 1, 1),
}


def make_bwd_case(name: str):
    """(q, k, v, do, kw) of backward case `name`: float32 numpy arrays, dO
    standard normal."""
    B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap, qs, vs = BWD_CASES[name]
    rng = np.random.default_rng(7 * Sq + dh + Hq)
    q, k, v, do = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
                   for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))
    return (q * np.float32(qs), k, v * np.float32(vs), do,
            dict(causal=causal, window=window, softcap=softcap))


def empty_rows(Sq: int, Skv: int, kw: dict) -> int:
    """The leading query rows that see no key (causal, Sq > Skv)."""
    return max(0, Sq - Skv) if kw["causal"] else 0


def bwd_tile_mirror(q, k, v, o, lse, do, *, causal: bool, window: int, softcap: float,
                    tile: int):
    """The backward kernel's walk over tiles, in plain torch: the dK / dV
    pass takes a key tile at a time and only the packed rows from its r_lo
    to its r_hi, the dQ pass a row tile at a time and only the keys from its
    kv_lo to its kv_hi (the kernel's bounds, csrc/flash_attn_bwd.cu); inside
    a tile pair the backward's formulas densely.  Equal to the dense
    backward exactly where those bounds skip no pair that a mask keeps."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, R, off = Hq // Hkv, Sq * (Hq // Hkv), Skv - Sq
    scale = 1.0 / math.sqrt(dh)
    pack = lambda t: t.reshape(B, Sq, Hkv, G, -1).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, -1)
    qg, og, dog = pack(q), pack(o), pack(do)
    lg = pack(lse[..., None])[..., 0]
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    delta = (dog * og).sum(-1)
    qp = torch.arange(R) // G + off
    hi = torch.clamp(qp + 1, max=Skv) if causal else torch.full_like(qp, Skv)
    lo = torch.clamp(qp - window + 1, min=0) if window > 0 else torch.zeros_like(qp)

    def pair(r0, r1, j0, j1):
        s = qg[:, :, r0:r1] @ kt[:, :, j0:j1].transpose(-1, -2)
        if softcap > 0:
            th = torch.tanh(s * scale / softcap)
            x, dcap = softcap * th, (1 - th * th) * scale
        else:
            x, dcap = s * scale, scale
        j = torch.arange(j0, j1)
        keep = (j[None, :] >= lo[r0:r1, None]) & (j[None, :] < hi[r0:r1, None])
        p = torch.where(keep, torch.exp2(x * LOG2E - lg[:, :, r0:r1, None]), 0.0)
        dp = dog[:, :, r0:r1] @ vt[:, :, j0:j1].transpose(-1, -2)
        return p, p * (dp - delta[:, :, r0:r1, None]) * dcap

    dk, dv, dq = torch.zeros_like(kt), torch.zeros_like(vt), torch.zeros_like(qg)
    for j0 in range(0, Skv, tile):
        j1 = min(Skv, j0 + tile)
        r_lo = max(0, j0 - off) * G if causal else 0
        r_hi = min(R, max(0, j1 - 1 + window - off) * G) if window > 0 else R
        for r0 in range(r_lo, r_hi, tile):
            r1 = min(R, r0 + tile)
            p, ds = pair(r0, r1, j0, j1)
            dv[:, :, j0:j1] += p.transpose(-1, -2) @ dog[:, :, r0:r1]
            dk[:, :, j0:j1] += ds.transpose(-1, -2) @ qg[:, :, r0:r1]
    for r0 in range(0, R, tile):
        r1 = min(R, r0 + tile)
        kv_hi = min(Skv, (r1 - 1) // G + off + 1) if causal else Skv
        kv_lo = max(0, r0 // G + off - window + 1) if window > 0 else 0
        for j0 in range(kv_lo, kv_hi, tile):
            _, ds = pair(r0, r1, j0, min(kv_hi, j0 + tile))
            dq[:, :, r0:r1] += ds @ kt[:, :, j0:min(kv_hi, j0 + tile)]
    unpack = lambda t: t.reshape(B, Hkv, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, dh)
    return unpack(dq), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)
