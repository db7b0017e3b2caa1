"""Roofline analysis of the port on an NVIDIA H100 (port of
`repro.launch.roofline`, redone for the card and for PyTorch).

The card's constants live here, one home for every bound in the repository
(`chip_smoke.py` and `tools/` import them).  Each is the published figure of
one H100 SXM5 (NVIDIA H100 80GB HBM3, 700 W power limit), dense rates:

  bf16 tensor cores       989 TFLOP/s   NVIDIA H100 Tensor Core GPU data sheet
  TF32 tensor cores       495 TFLOP/s   (same)
  float32 outside them     67 TFLOP/s   (same)
  HBM3                   3.35 TB/s, 80 GB   (same)
  NVLink 4 (one GPU)      450 GB/s each way (900 GB/s total, same data sheet)
  off the node            50 GB/s each way: one 400 Gb/s ConnectX-7 port a GPU
                          (NVIDIA DGX H100 user guide); a collective whose
                          ranks span more than one 8-GPU node runs at this rate

The reference parses the compiled HLO; the port counts an eager step under a
`TorchDispatchMode` (`OpCounter`), which sees every aten op of the local
shards (the ops a DTensor dispatches, not the DTensor-level op):

  * FLOPs per aten op through `torch.utils.flop_counter`'s registry (the
    formulas `FlopCounterMode` applies);
  * traffic as each op's operand and output bytes: the unfused counterpart
    of the reference's top-level-op proxy.  It overstates a fused program
    (an elementwise chain reads and writes each intermediate here);
  * collective bytes by kind, from the c10d functional collectives that
    DTensor's redistributions issue, under the reference's ring conventions
    (`_collective_bytes`);
  * each hand-written kernel as one op under its own launch-counter name,
    with the FLOPs and bytes of `chip_smoke.py`'s bound for it (its fake
    branch reports the call; `kernel_cost`);
  * the live bytes of the storages the step allocates (freed as they die):
    the peak beyond the step's arguments is the dry run's temp size.

`roofline_terms` charges each op at the peak rate of its dtype: bf16
products at the bf16 peak, float32 ones and every elementwise op at the
float32 peak (the port keeps TF32 off), the kernels' 3xTF32 products at a
third of the TF32 peak, their exps on the special-function units.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ---- hardware constants (one H100 SXM5, NVIDIA H100 80GB HBM3, 700 W) -------
CARD = "NVIDIA H100 80GB HBM3, 700 W (H100 SXM5)"
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense (NVIDIA H100 data sheet)
TF32_FLOPS = 495e12  # TF32 on the tensor cores, dense (NVIDIA H100 data sheet)
FP32_FLOPS = 67e12  # float32 outside the tensor cores (NVIDIA H100 data sheet)
HBM_BYTES_PER_S = 3.35e12  # device memory (NVIDIA H100 data sheet)
HBM_BYTES = 80e9  # device memory size (NVIDIA H100 data sheet)
L2_BYTES = 50 * 2**20  # L2 cache (NVIDIA H100 data sheet)
# int32 outside the tensor cores: 132 SMs x 64 INT32 lanes (Hopper
# architecture white paper) x 1.98 GHz boost clock, one operation a lane
INT32_OPS = 132 * 64 * 1.98e9
# exps: 16 exp2 results a clock an SM on the special-function units (CUDA C++
# Programming Guide, arithmetic instruction throughput table, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction (900 GB/s total, data sheet)
NODE_GPUS = 8  # GPUs an NVLink node (DGX H100)
NET_BYTES_PER_S = 50e9  # 400 Gb/s ConnectX-7 a GPU, one direction (DGX H100 user guide)

# each compute class's peak: FLOPs (or exps) a second
RATES = {"bf16": BF16_FLOPS, "fp32": FP32_FLOPS, "tf32x3": TF32_FLOPS / 3,
         "exp": SFU_EXP_PER_S}


# ---------------------------------------------------------------------------
# The hand-written kernels' costs (the terms of chip_smoke.py's bounds)
# ---------------------------------------------------------------------------


def unmasked_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head of one sequence attends: query i sits at
    key position i + Skv - Sq (the ends aligned); causal keeps keys up to
    it, `window` > 0 the keys above it less `window` (`flash_attn.attn_mask`)."""
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos, Skv - 1) if causal else np.full_like(pos, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernel_cost(kernel: str, **s) -> dict:
    """{"flops": {class: n}, "exps": n, "bytes": n} of one launch of
    `kernel` (a launch counter's name) at the shapes in `s`: each input read
    once, each output written once, the operations `chip_smoke.py`'s bound
    counts for it.  The scan's forward under autograd also writes the
    state entering each 32-step tile (`ckpt_tiles`)."""
    if kernel.startswith("flash_attn"):
        B, Sq, Skv, Hq, Hkv, dh = (s[k] for k in ("B", "Sq", "Skv", "Hq", "Hkv", "dh"))
        pairs = unmasked_pairs(Sq, Skv, s["causal"], s["window"]) * B * Hq
        bf16 = kernel.endswith("_bf16")
        if kernel.startswith("flash_attn_bwd"):
            nbytes = 4 * (4 * B * Sq * Hq * dh + 4 * B * Skv * Hkv * dh + B * Sq * Hq)
            flops = ({"tf32x3": 6 * dh * pairs, "bf16": 4 * dh * pairs} if bf16
                     else {"tf32x3": 10 * dh * pairs})
        else:
            nbytes = 4 * (2 * B * Sq * Hq * dh + 2 * B * Skv * Hkv * dh)
            flops = ({"tf32x3": 2 * dh * pairs, "bf16": 2 * dh * pairs} if bf16
                     else {"tf32x3": 4 * dh * pairs})
        return {"flops": flops, "exps": pairs, "bytes": nbytes}
    if kernel.startswith("ssm_scan"):
        B, L, D, N = (s[k] for k in ("B", "L", "D", "N"))
        e = 2 if kernel.endswith("_bf16") else 4  # dt, x, B, C
        elems = B * L * D * N
        if kernel.startswith("ssm_scan_bwd"):
            T = -(-L // 32)
            nbytes = e * (4 * B * L * D + 4 * B * L * N) + 4 * (
                B * L * D + 2 * D * N + B * T * D * N + B * D * N)
            return {"flops": {"fp32": 20 * elems}, "exps": elems, "bytes": nbytes}
        nbytes = e * (2 * B * L * D + 2 * B * L * N) + 4 * (
            B * L * D + D * N + 2 * B * D * N + s.get("ckpt_tiles", 0) * B * D * N)
        return {"flops": {"fp32": 7 * elems}, "exps": elems, "bytes": nbytes}
    raise KeyError(f"no cost model for kernel {kernel!r}")


# ---------------------------------------------------------------------------
# Collectives (the reference's ring conventions, per device)
# ---------------------------------------------------------------------------

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_bytes(kind: str, out_bytes: float, in_bytes: float) -> float:
    """Wire bytes a device moves (the reference's `_collective_bytes`):
    all-gather its output; all-reduce twice its input (reduce-scatter then
    all-gather); reduce-scatter, all-to-all, permute their input."""
    if kind.startswith("all-gather"):
        return float(out_bytes)
    if kind.startswith("all-reduce"):
        return float(2 * in_bytes)
    return float(in_bytes)


def _group_rate(group_name) -> float:
    """The wire rate of a collective over the group `group_name`: NVLink
    when its ranks share one 8-GPU node, the network otherwise."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return NVLINK_BYTES_PER_S if len({r // NODE_GPUS for r in ranks}) == 1 else NET_BYTES_PER_S


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

# ops that move no data: views, allocations, metadata
_FREE = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "wait_tensor", "set_", "resize_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size"}
_BF16_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "convolution"}
_propagating = threading.local()


class _Propagating:
    """Marks DTensor's propagation through an op's decomposition, which
    runs the decomposition on global-shape meta stand-ins to learn the
    op's placements: those runs are no part of the step, and the counter
    skips them."""

    def __enter__(self):
        _propagating.depth = getattr(_propagating, "depth", 0) + 1

    def __exit__(self, *exc):
        _propagating.depth -= 1


@contextlib.contextmanager
def _mark_propagation():
    """Mark DTensor's runs of a decomposition
    (`DecompShardingStrategy.propagate_strategy`) for the body, where this
    torch has them.  Its other stand-in runs, of each new op once to learn
    its output's shape, are on FakeTensors, which the counter skips as it
    meets them (a dry run's own tensors are meta tensors)."""
    import functools

    try:
        from torch.distributed.tensor._decompositions import DecompShardingStrategy
    except ImportError:  # no propagation through decompositions in this torch
        yield
        return
    plain = DecompShardingStrategy.propagate_strategy

    @functools.wraps(plain)
    def marked(self, *args, **kwargs):
        with _Propagating():
            return plain(self, *args, **kwargs)

    DecompShardingStrategy.propagate_strategy = marked
    try:
        yield
    finally:
        DecompShardingStrategy.propagate_strategy = plain


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts one step's work on the local shards: per op name its calls,
    FLOPs by compute class, bytes, collective bytes by kind and their wire
    seconds; the hand-written kernels' launches (`record_kernel`, which
    their fake branches call); and the live bytes of the storages allocated
    inside it (`peak_bytes`).  Enter it around the step it counts; stand-in
    runs of DTensor's propagation (on FakeTensors, or marked) are skipped."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.ops: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": defaultdict(float), "exps": 0.0, "bytes": 0.0})
        self.collective_by_kind: dict[str, float] = defaultdict(float)
        self.collective_s = 0.0
        self.launches: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak_bytes = 0
        self._seen: set[int] = set()
        self._stack = contextlib.ExitStack()

    def exclude(self, tensors) -> None:
        """Mark the storages of `tensors` (a step's arguments, the local
        shards of its DTensors) as not the step's own: an op that returns
        one (an in-place update) adds no live bytes."""
        for t in tensors:
            self._seen.add(t.untyped_storage()._cdata)

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self._stack.enter_context(_mark_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run it; count its local ops
        out = func(*args, **kwargs)
        if not (getattr(_propagating, "depth", 0)
                or any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs, out)))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if ns == "prim" or func.is_view or name in _FREE:
            return
        rec = self.ops[f"{ns}.{name}"]
        rec["calls"] += 1
        ins = _tensors((args, kwargs))
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        if ns.startswith("_c10d_functional"):
            if name not in _COLLECTIVE_KINDS:  # wait_tensor, autograd wrappers: no wire
                return
            kind = _COLLECTIVE_KINDS[name]
            wire = collective_bytes(kind, out_bytes, in_bytes)
            self.collective_by_kind[kind] += wire
            names = [a.name for a in func._schema.arguments]
            i = names.index("group_name")
            group = args[i] if i < len(args) else kwargs["group_name"]
            self.collective_s += wire / _group_rate(group)
            return
        rec["bytes"] += in_bytes + out_bytes
        packet = func._overloadpacket
        if packet in self.flop_registry:
            flops = self.flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = ins[0].dtype if ins else torch.float32
            rec["flops"]["bf16" if name in _BF16_PRODUCTS and dtype in (
                torch.bfloat16, torch.float16) else "fp32"] += flops

    def _track(self, t: torch.Tensor) -> None:
        """Add a storage's bytes to the live count the first time an op
        returns it; take them off when it dies."""
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    # -- the kernels ---------------------------------------------------------
    def record_kernel(self, kernel: str, **shape) -> None:
        """One launch of a hand-written kernel that a fake branch stood in
        for, costed by `kernel_cost`."""
        cost = kernel_cost(kernel, **shape)
        rec = self.ops[f"kernel.{kernel}"]
        rec["calls"] += 1
        for cls, n in cost["flops"].items():
            rec["flops"][cls] += n
        rec["exps"] += cost["exps"]
        rec["bytes"] += cost["bytes"]
        self.launches[kernel] += 1

    # -- totals ----------------------------------------------------------------
    def aten_flops(self) -> float:
        """The FLOPs of the aten ops (what FlopCounterMode counts)."""
        return sum(sum(r["flops"].values()) for k, r in self.ops.items()
                   if not k.startswith("kernel."))

    def totals(self) -> dict:
        """The reference's per-device keys: hlo_flops_per_device (FLOPs of
        every op and kernel), hlo_bytes_per_device (operand and output bytes
        of every op, the kernels' own), collective_bytes_per_device and
        collective_by_kind; with the compute seconds at each op's rate and
        the collectives' wire seconds."""
        compute_s = 0.0
        for rec in self.ops.values():
            terms = [n / RATES[cls] for cls, n in rec["flops"].items()]
            if rec["exps"]:  # a kernel: its products and exps overlap
                compute_s += max(terms + [rec["exps"] / RATES["exp"]])
            else:
                compute_s += sum(terms)
        return {
            "hlo_flops_per_device": sum(sum(r["flops"].values()) for r in self.ops.values()),
            "hlo_bytes_per_device": sum(r["bytes"] for r in self.ops.values()),
            "collective_bytes_per_device": sum(self.collective_by_kind.values()),
            "collective_by_kind": dict(self.collective_by_kind),
            "compute_s": compute_s,
            "collective_s": self.collective_s,
        }

    def breakdown(self, top: int = 12) -> list[dict]:
        """The top ops and kernels by bytes: calls, bytes, FLOPs, and their
        memory and compute seconds at the card's rates."""
        rows = []
        for name, r in self.ops.items():
            flops = sum(r["flops"].values())
            rows.append({"op": name, "calls": r["calls"], "bytes": r["bytes"], "flops": flops,
                         "memory_s": r["bytes"] / HBM_BYTES_PER_S,
                         "compute_s": sum(n / RATES[c] for c, n in r["flops"].items())})
        rows.sort(key=lambda row: -row["bytes"])
        return rows[:top]


def roofline_terms(totals: dict) -> dict:
    """Seconds a step per the three-term model, per device: compute (each
    op at its dtype's peak), memory (bytes over the HBM rate), collective
    (each collective's wire bytes over its group's link rate)."""
    t_c = totals["compute_s"]
    t_m = totals["hlo_bytes_per_device"] / HBM_BYTES_PER_S
    t_x = totals["collective_s"]
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "bottleneck": max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1],
        "roofline_bound_s": bound,
        "compute_fraction_of_bound": t_c / max(bound, 1e-30),
    }


def model_flops(cfg, shape_cell, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (prefill, decode), N the
    parameters (the active ones of a MoE: the experts' weights at top_k /
    n_experts), D the tokens (a decode cell's one a sequence); attention
    over the cache is left out by convention.  N from a model on the meta
    device (no weight is drawn)."""
    from ..models.lm import LM
    from ..models.whisper import Whisper

    model = (Whisper if cfg.enc_dec else LM)(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    if cfg.n_experts:
        expert = sum(p.numel() for name, p in model.named_parameters()
                     if name.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down"))
        n_active = n_params - expert * (1 - cfg.moe_top_k / cfg.n_experts)
    else:
        n_active = n_params
    if n_tokens is None:
        n_tokens = shape_cell.global_batch * (1 if shape_cell.kind == "decode"
                                              else shape_cell.seq_len)
    return float((6 if shape_cell.kind == "train" else 2) * n_active * n_tokens)


__all__ = ["BF16_FLOPS", "CARD", "FP32_FLOPS", "HBM_BYTES", "HBM_BYTES_PER_S", "INT32_OPS",
           "L2_BYTES", "NET_BYTES_PER_S", "NVLINK_BYTES_PER_S", "OpCounter", "SFU_EXP_PER_S",
           "TF32_FLOPS", "collective_bytes", "kernel_cost", "model_flops",
           "roofline_terms", "unmasked_pairs"]
