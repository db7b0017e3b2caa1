"""Device meshes of the port (port of `repro.launch.mesh`): the production
meshes of a dry run, and small meshes over a real process group.

Functions, not module-level constants: importing this module starts no
process group.  A production mesh (16 x 16 or 2 x 16 x 16 ranks) lives on a
*fake* process group (`torch.testing`'s FakeStore with the "fake" backend:
every collective returns at once and moves nothing), for dry runs only
(`launch.dryrun`); `make_debug_mesh` refuses a fake group, and a production
mesh refuses a real one, so the one never stands in for the other.  A
process holds one default group: `release_fake_group` ends a dry run's
before another mesh size or a real group."""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

FAKE_BACKEND = "fake"
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _is_fake_group() -> bool:
    return dist.is_initialized() and dist.get_backend() == FAKE_BACKEND


def release_fake_group() -> None:
    """End the fake process group of a dry run, if one is up."""
    if _is_fake_group():
        dist.destroy_process_group()


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A DeviceMesh of `shape` over a fake process group of exactly that
    many ranks (this process rank 0), for dry runs: a fake group of another
    size is ended first; a real group raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    world = math.prod(shape)
    if dist.is_initialized():
        if not _is_fake_group():
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up: a dry run's fake mesh does "
                "not stand in for it (end it, or run the dry run in its own process)")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore
        except ImportError as e:  # no fallback: the dry run needs the fake backend
            raise RuntimeError(f"this torch ({torch.__version__}) has no fake process "
                               "group: a dry run needs one") from e
        dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks; the pod axis extends the DP / FSDP axis
    set.  Over a fake process group: for dry runs only."""
    return make_fake_mesh(*PRODUCTION[multi_pod])


def make_debug_mesh(n_data: int = 1, n_model: int = 1):
    """A (data, model) mesh over the first n_data x n_model ranks of the
    real default process group (NCCL on the card, gloo on the CPU), which
    the caller starts (`init_group`).  Raises without a group, on a fake
    group, when the mesh needs more ranks than the group has (as the
    reference's `make_production_mesh` does), and on a rank outside it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = n_data * n_model
    if n < 1:
        raise ValueError(f"mesh {n_data}x{n_model} has no rank")
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh: no process group is up (init_group)")
    if _is_fake_group():
        raise RuntimeError("make_debug_mesh: the process group is a dry run's fake one")
    world = dist.get_world_size()
    if n > world:
        raise RuntimeError(f"need {n} ranks for mesh {n_data}x{n_model}, "
                           f"the process group has {world}")
    if dist.get_rank() >= n:
        raise RuntimeError(f"rank {dist.get_rank()} is outside mesh {n_data}x{n_model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(device: torch.device, world_size: int = 1, rank: int = 0,
               addr: str | None = None) -> None:
    """Start the default process group with its address, world size and
    rank given: NCCL for a CUDA device, gloo for the CPU; `addr` defaults to
    tcp://localhost:<a free port> (one process)."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=addr or f"tcp://localhost:{free_port()}",
                            world_size=world_size, rank=rank)
