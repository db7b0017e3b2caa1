"""Selective-scan inputs made from a numpy seed, and plain-torch mirrors of
the card kernels' decompositions, forward (`lanes_mirror`) and backward
(`bwd_kernel_mirror`): shared by the CPU parity tests
(tests/test_torch_ssm_scan.py, tests/test_torch_ssm_scan_bwd.py) and the
on-card tests (tests/test_torch_kernels_cuda.py).  Imports neither JAX nor
the reference package.

The cases aim at what the scan kernel (src/repro_torch/kernels/csrc/
ssm_scan.cu) can get wrong: state sizes that take 1, 2 or 4 lanes a channel
and that 4 does not divide (N 1, 3, 5, 13), sequence lengths around its
32-step tile (1, 31, 32, 33), around the backward's 8-step sub-tile (7, 8,
9; 41, one tile and a partial sub-tile) and one of many tiles (4096),
channel counts
that are not a multiple of its 64-channel block, one batch row, an A 100
times larger, so that exp(dt A) is a subnormal or 0 for many states, and h0
of zeros beside the random h0 of every other case.  A is drawn at random in
every case, as -exp(0.5 z) times that scale."""
import numpy as np
import torch
import torch.nn.functional as F

# name -> (B, L, D, N, A scale, random h0)
SCAN_CASES = {
    "N 1": (2, 33, 70, 1, 1.0, True),
    "N 3": (2, 33, 70, 3, 1.0, True),
    "N 4": (2, 33, 70, 4, 1.0, True),
    "N 5": (2, 33, 70, 5, 1.0, True),
    "N 13": (2, 33, 70, 13, 1.0, True),
    "N 16": (2, 33, 70, 16, 1.0, True),
    "L 1": (3, 1, 24, 16, 1.0, True),
    "L 31": (2, 31, 24, 16, 1.0, True),
    "L 32": (2, 32, 24, 16, 1.0, True),
    "L 33": (2, 33, 24, 16, 1.0, True),
    "L 7": (2, 7, 24, 16, 1.0, True),
    "L 8": (2, 8, 24, 16, 1.0, True),
    "L 9": (2, 9, 24, 16, 1.0, True),
    "L 41": (2, 41, 24, 16, 1.0, True),
    "L 4096, B 1": (1, 4096, 10, 16, 1.0, True),
    "B 1, D 130": (1, 40, 130, 16, 1.0, True),
    "exp underflows": (2, 40, 70, 16, 100.0, True),
    "h0 zero": (2, 40, 70, 16, 1.0, False),
}
LOG2E = 1.4426950408889634
FLT_MIN = 2.0 ** -126  # the smallest normal float32
TILE = 32  # steps a tile of both kernels: the forward checkpoints h once a tile
BWD_CHANNELS = 32  # channels a block of the backward kernel


def make_case(name: str, seed: int = 0):
    """(dt, x, Bc, Cc, A, h0) of case `name` as float32 numpy arrays: dt =
    softplus(z), A = -scale exp(0.5 z), x, B, C and h0 standard normal."""
    B, L, D, N, scale, random_h0 = SCAN_CASES[name]
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, L, D))
    dt = np.logaddexp(0.0, z).astype(np.float32)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    Bc = rng.normal(size=(B, L, N)).astype(np.float32)
    Cc = rng.normal(size=(B, L, N)).astype(np.float32)
    A = (-scale * np.exp(0.5 * rng.normal(size=(D, N)))).astype(np.float32)
    h0 = (rng.normal(size=(B, D, N)) if random_h0 else np.zeros((B, D, N))).astype(np.float32)
    return dt, x, Bc, Cc, A, h0


def lanes(N: int) -> int:
    """Lanes a channel in the card kernel: 4 states a lane."""
    return 1 if N <= 4 else 2 if N <= 8 else 4


def lanes_mirror(dt, x, Bc, Cc, A, h0):
    """The card kernel's arithmetic in plain torch: the states padded to 4 G
    with A, B, C and h0 of 0; a = exp2(dt * (A log2 e)) with subnormals
    flushed to 0; each lane's dot over its 4 states; y_t summed over the G
    lanes in the kernel's order, (l + l^2) + (l^1 + l^3) for l = t mod G.
    Tensors as `ssm_scan_batched_ref` takes them; returns (y, h_fin)."""
    B, L, D = dt.shape
    N = Bc.shape[2]
    G = lanes(N)
    pad = (0, 4 * G - N)
    A2 = torch.nn.functional.pad(A, pad) * torch.tensor(LOG2E, dtype=torch.float32)
    Bp, Cp = torch.nn.functional.pad(Bc, pad), torch.nn.functional.pad(Cc, pad)
    h = torch.nn.functional.pad(h0, pad)
    ys = []
    for t in range(L):
        a = torch.exp2(dt[:, t, :, None] * A2)
        a = torch.where(a < FLT_MIN, torch.zeros_like(a), a)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bp[:, t, None, :]
        hc = (h * Cp[:, t, None, :]).view(B, D, G, 4)
        p = ((hc[..., 0] + hc[..., 1]) + hc[..., 2]) + hc[..., 3]  # (B, D, G)
        i = t % G
        if G == 1:
            ys.append(p[..., 0])
        elif G == 2:
            ys.append(p[..., i] + p[..., i ^ 1])
        else:
            ys.append((p[..., i] + p[..., i ^ 2]) + (p[..., i ^ 1] + p[..., i ^ 3]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h[..., :N].contiguous()


def make_grads(name: str, seed: int = 1):
    """(dy (B, L, D), dh_fin (B, D, N)) standard normal for case `name`."""
    B, L, D, N = SCAN_CASES[name][:4]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, D)).astype(np.float32),
            rng.normal(size=(B, D, N)).astype(np.float32))


def _exp2_ftz(v):
    a = torch.exp2(v)
    return torch.where(a < FLT_MIN, torch.zeros_like(a), a)


def bwd_kernel_mirror(dt, x, Bc, Cc, A, h0, dy, dh_fin=None):
    """The backward kernel's decomposition in plain torch: the states padded
    to 4 G with A, B, C and h0 of 0, a = exp2(dt * (A log2 e)) with
    subnormals flushed; the forward's checkpoints, the state entering each
    TILE-step tile; the tiles from last to first, each tile's states
    recomputed from its checkpoint and walked backwards with a recomputed;
    dx and ddt as each lane's sum over its 4 states, then over the G lanes;
    dB and dC summed over each block of BWD_CHANNELS channels (zeros past
    D), then over the blocks in block order; dA summed over each batch row,
    then over the rows in row order.  Tensors as `ssm_scan_bwd_ref` takes
    them; returns (ddt, dx, dB, dC, dA, dh0)."""
    B, L, D = dt.shape
    N = Bc.shape[2]
    G = lanes(N)
    P = 4 * G
    A_p = F.pad(A, (0, P - N))
    A2 = A_p * torch.tensor(LOG2E, dtype=torch.float32)
    Bp, Cp = F.pad(Bc, (0, P - N)), F.pad(Cc, (0, P - N))

    def a_of(t):
        return _exp2_ftz(dt[:, t, :, None] * A2)

    def step(h, t):
        return a_of(t) * h + (dt[:, t] * x[:, t])[..., None] * Bp[:, t, None, :]

    h, ckpt = F.pad(h0, (0, P - N)), []
    for t in range(L):
        if t % TILE == 0:
            ckpt.append(h)
        h = step(h, t)
    gn = torch.zeros_like(h) if dh_fin is None else F.pad(dh_fin, (0, P - N))
    blocks = -(-D // BWD_CHANNELS)
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(x)
    pB = torch.zeros((B, blocks, L, P), dtype=torch.float32)
    pC = torch.zeros_like(pB)
    dA_rows = torch.zeros((B, D, P), dtype=torch.float32)

    def per_block(terms):  # (B, D, P) -> (B, blocks, P)
        padded = F.pad(terms, (0, 0, 0, blocks * BWD_CHANNELS - D))
        return padded.view(B, blocks, BWD_CHANNELS, P).sum(2)

    for k in reversed(range(len(ckpt))):
        lo, hi = k * TILE, min(L, (k + 1) * TILE)
        hs = [ckpt[k]]
        for t in range(lo, hi):
            hs.append(step(hs[-1], t))
        for t in reversed(range(lo, hi)):
            a, hp, hc = a_of(t), hs[t - lo], hs[t - lo + 1]
            g = gn + dy[:, t, :, None] * Cp[:, t, None, :]
            u = a * hp
            lane_x = (g * Bp[:, t, None, :]).view(B, D, G, 4).sum(-1)
            lane_dt = (g * (A_p * u + x[:, t, :, None] * Bp[:, t, None, :])).view(
                B, D, G, 4).sum(-1)
            dx[:, t] = dt[:, t] * lane_x.sum(-1)
            ddt[:, t] = lane_dt.sum(-1)
            dA_rows += g * dt[:, t, :, None] * u
            pB[:, :, t] = per_block(g * (dt[:, t] * x[:, t])[..., None])
            pC[:, :, t] = per_block(dy[:, t, :, None] * hc)
            gn = a * g
    dB, dC = pB[:, 0], pC[:, 0]
    for j in range(1, blocks):
        dB, dC = dB + pB[:, j], dC + pC[:, j]
    dA = dA_rows[0]
    for b in range(1, B):
        dA = dA + dA_rows[b]
    return (ddt, dx, dB[..., :N].contiguous(), dC[..., :N].contiguous(),
            dA[:, :N].contiguous(), gn[..., :N].contiguous())
