"""Selective-scan inputs made from a numpy seed, and a plain-torch mirror of
the card kernel's decomposition: shared by the CPU parity tests
(tests/test_torch_ssm_scan.py) and the on-card tests
(tests/test_torch_kernels_cuda.py).  Imports neither JAX nor the reference
package.

The cases aim at what the scan kernel (src/repro_torch/kernels/csrc/
ssm_scan.cu) can get wrong: state sizes that take 1, 2 or 4 lanes a channel
and that 4 does not divide (N 1, 3, 5, 13), sequence lengths around its
32-step tile (1, 31, 32, 33) and one of many tiles (4096), channel counts
that are not a multiple of its 64-channel block, one batch row, an A 100
times larger, so that exp(dt A) is a subnormal or 0 for many states, and h0
of zeros beside the random h0 of every other case.  A is drawn at random in
every case, as -exp(0.5 z) times that scale."""
import numpy as np
import torch

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
    "L 4096, B 1": (1, 4096, 10, 16, 1.0, True),
    "B 1, D 130": (1, 40, 130, 16, 1.0, True),
    "exp underflows": (2, 40, 70, 16, 100.0, True),
    "h0 zero": (2, 40, 70, 16, 1.0, False),
}
LOG2E = 1.4426950408889634
FLT_MIN = 2.0 ** -126  # the smallest normal float32


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
