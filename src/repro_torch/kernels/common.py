"""Shared kernel plumbing: the nvcc build, the ctypes loader, launch counters,
the argument checker and the TF32 switch of the float32 matmuls.

The CUDA sources live in `csrc/`.  At first use on a card, `library()`
compiles every `csrc/*.cu` to an object with its own `nvcc` (all started
together), links them into one shared library under `_build/` (git-ignored),
and loads it with `ctypes`.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a fresh checkout
builds on its own.  Nothing here runs when a module is imported.

Each C entry point takes raw device pointers (`c_void_p`), int sizes and the
PyTorch stream, launches one kernel, and returns `cudaGetLastError()`; the
wrapper raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# no --use_fast_math: hash_rp's division and floor must stay IEEE, or a
# projection moves across a bucket boundary; flash_attn and ssm_scan call
# their approximate ex2 (and flash_attn's rcp) by name, where the error is
# bounded in their sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/ (restype is cudaError_t == int)
SIGNATURES = {
    # I, L, Hd, qd, shifts, qidx, ids_out, lcps_out, n, m, R, width, stream
    "csa_probe_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ids, lcps, out_ids, out_vals, B, pool, n, chunk, k, out_cols, stream
    "pool_topk_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # data, ids, queries, out, n, d, B, Lc, angular, stream
    "gather_l2_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, scale, ids, queries, out, n, d, B, Lc, angular, stream
    "gather_q_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # data, ids, report, queries, out_ids, out_vals, keys, n, d, B, L, k, tile,
    # angular, exact, stream
    "gather_l2_topk_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    # codes, scale, ids, report, queries, out_ids, out_vals, keys, n, d, B, L, k,
    # tile, angular, exact, stream
    "gather_q_topk_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    # x, a, b, out, n, d, m, w, stream
    "hash_rp_launch": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x, rot, out, n, d, m, dr, stream
    "hash_xp_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    # h, q, out, n, m, B, stream
    "circrun_launch": (_P, _P, _P, _I, _I, _I, _P),
    # h, q, ok, lens, hist, n, m, B, ld, stream
    "circrun_score_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # lens, hist, vals, rows, n, m, B, k, ld, stream
    "circrun_topk_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse (nullptr: none), B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap,
    # stream
    "flash_attn_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # the bf16-P form (attn_bf16_probs), the same arguments
    "flash_attn_bf16_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # B, Sq, Hq, Hkv -> (rows a block << 16) | keys a tile of a forward launch (no stream)
    "flash_attn_tiles": (_I, _I, _I, _I),
    # q, k, v, o, lse, dO, dq, dk, dv, scratch, B, Sq, Skv, Hq, Hkv, dh, causal, window,
    # softcap, stream
    "flash_attn_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _P),
    # the bf16-P form, the same arguments
    "flash_attn_bwd_bf16_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _P),
    # B, Sq, Skv, Hq, Hkv, dh -> the backward's row chunks (no stream: launches nothing)
    "flash_attn_bwd_chunks": (_I, _I, _I, _I, _I, _I),
    # dt, x, Bc, Cc, A, h0, y, h_out, h_ckpt (nullptr: none), B, L, D, N, stream
    "ssm_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the bf16 form (dt, x, Bc, Cc bf16: ssm_bf16_acts), the same arguments
    "ssm_scan_bf16_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # dt, x, Bc, Cc, A, h_ckpt, dy, dh_fin (nullptr: zero), ddt, dx, dB, dC, dA, dh0
    # (nullptr: none), scratch, B, L, D, N, stream
    "ssm_scan_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _P),
    # the bf16 form (ddt, dx, dB, dC bf16 too), the same arguments
    "ssm_scan_bwd_bf16_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _P),
}

# launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else; `_count_lock` guards it, since the
# serving front's replica threads launch kernels side by side.  The bf16
# forms of flash_attn and ssm_scan (the models' attn_bf16_probs and
# ssm_bf16_acts) count apart from their float32 forms.
LAUNCHES: dict[str, int] = {"csa_probe": 0, "pool_topk": 0, "gather_l2": 0, "gather_q": 0,
                            "gather_l2_topk": 0, "gather_q_topk": 0, "hash_rp": 0,
                            "hash_xp": 0, "circrun": 0, "circrun_topk": 0, "flash_attn": 0,
                            "flash_attn_bwd": 0, "ssm_scan": 0, "ssm_scan_bwd": 0,
                            "flash_attn_bf16": 0, "flash_attn_bwd_bf16": 0,
                            "ssm_scan_bf16": 0, "ssm_scan_bwd_bf16": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def count_launch(kernel: str) -> None:
    """Add one launch of `kernel` (thread-safe: `+=` on a dict entry is a
    read and a write, and two threads can interleave them)."""
    with _count_lock:
        LAUNCHES[kernel] += 1


def no_tf32() -> None:
    """Full float32 matmuls for hashing and the model forwards: TF32 keeps
    ~10 mantissa bits, would move projections across bucket boundaries, and
    would hold the embeddings to a looser tolerance than the reference's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def find_nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    /usr/local/cuda/bin/nvcc.  Raises RuntimeError when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "repro_torch kernels: nvcc not found (looked in $CUDA_HOME/bin, PATH "
        "and /usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit to "
        "build -- CPU tensors take the plain torch versions instead"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR, verbose: bool = False) -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into one shared library; returns its path.  Reuses a library built from
    the same sources."""
    build_dir = Path(build_dir)
    so = build_dir / f"librepro_torch_{source_hash()}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    extra = ("-Xptxas", "-v") if verbose else ()
    procs, objs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = build_dir / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = build_dir / f"{so.stem}_{tag}.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point `entry` on PyTorch's current stream, count one
    launch of `kernel`, and raise on a launch error.  The stream comes from
    PyTorch's raw getter (Triton's launcher uses it too): well under a
    microsecond, where building a torch.cuda.Stream takes several."""
    fn = getattr(library(), entry)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
    count_launch(kernel)


def check(name: str, t: torch.Tensor, *, device: torch.device, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless `t` lies on `device`, has `dtype` and `shape`, and is
    contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record through a call on `tensors`: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

