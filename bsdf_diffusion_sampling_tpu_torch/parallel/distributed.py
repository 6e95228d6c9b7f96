"""Several processes, one program: `torch.distributed` wiring (counterpart
of the JAX package's `parallel/distributed.py`).

Call `init_distributed()` first thing in an entry point. Under `torchrun`
it reads `RANK`, `WORLD_SIZE`, `LOCAL_RANK` and `MASTER_ADDR` /
`MASTER_PORT` and forms the default process group; in a single process it
is a no-op that returns False, so every entry point can call it
unconditionally. Each rank's card is `cuda:{LOCAL_RANK % device_count}`:
ranks that share one card land on it together (NCCL refuses that; gloo
takes CUDA tensors for `all_reduce`, `broadcast` and `barrier`, the only
collectives the port uses).

No silent fallback: when `WORLD_SIZE > 1` or the caller passes the group's
arguments and the group cannot form, `init_process_group` raises, and
nothing here carries on as one process or switches backend.

`host_fold(seed)` folds the rank into a seed, so stochastic draws
decorrelate across ranks deterministically; at world size 1 it returns the
seed unchanged.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from bsdf_diffusion_sampling_tpu_torch.core.prng import fold_in


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device_type: str = "cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` (LOCAL_RANK
    defaults to `rank`, else the group rank), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank_and_world()[0] if rank is None else rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device_type: str = "cuda",
) -> bool:
    """Form the default process group when this is one process of several;
    returns True if the group spans more than one process.

    Arguments left as None come from torchrun's environment (`init_method`
    from MASTER_ADDR / MASTER_PORT through "env://"). Without
    `init_method`, `world_size` and `rank`, and with WORLD_SIZE unset or 1,
    it does nothing and returns False. Safe to call twice. The ranks run on
    `device_type`: the card unless the caller asks for the CPU, and a group
    on the card raises without one. `backend` defaults to nccl for CUDA and
    gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(a is not None for a in (init_method, world_size, rank))
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and env_world <= 1:
        return False
    world_size = env_world if world_size is None else int(world_size)
    if rank is None:
        if "RANK" not in os.environ:
            raise RuntimeError("init_distributed: no rank given and RANK is not set")
        rank = int(os.environ["RANK"])
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: no init_method given and {', '.join(missing)} not set")
        init_method = "env://"
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda", int(rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=int(rank))
    return world_size > 1


def host_fold(seed: int, mesh=None) -> int:
    """`seed` with the rank folded in (`core/prng.py::fold_in`); the rank
    and world size are the mesh's, else the default group's. At world
    size 1 the seed comes back unchanged."""
    rank, world = (mesh.rank, mesh.size) if mesh is not None else rank_and_world()
    return int(seed) if world == 1 else fold_in(seed, rank)


def global_batch_slice(n_global: int) -> tuple[int, int]:
    """(start, size) of this rank's contiguous share of a global batch."""
    rank, world = rank_and_world()
    per = n_global // world
    return rank * per, per
