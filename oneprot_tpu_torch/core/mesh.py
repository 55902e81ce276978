"""Process-group bootstrap and the data-parallel world (counterpart of
oneprot_tpu/core/mesh.py: `init_distributed`, `process_index`,
`is_main_process`, `local_batch_size`, the (data, model) mesh).

One process per card over `torch.distributed`: the "data" axis of the JAX
mesh is the world of processes, each holding a whole replica of the
model and its own share of every batch. The "model" axis (tensor
parallelism) is not ported: `check_mesh` refuses it.

    init_distributed()            # torchrun's environment, or a no-op
    init_distributed("tcp://localhost:29500", num_processes=2, process_id=1)

The backend is NCCL where the rank's device is a card and gloo on the
CPU; a caller may name another (two ranks sharing one card need gloo:
NCCL refuses a card twice). A rank on a card takes `cuda:{LOCAL_RANK}`
and makes it the current device before NCCL starts.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TENSOR_PARALLEL_ITEM = "ROADMAP.md Queue 1 item 12 (tensor parallelism)"


def distributed() -> bool:
    """Whether a process group is up (of any size: a world of one runs
    the collectives too, each the identity)."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(processes, this process's rank): the initialised process group's,
    else (1, 0)."""
    if distributed():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def world_size() -> int:
    return world()[0]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return world()[1]


def is_main_process() -> bool:
    return process_index() == 0


def local_batch_size(global_batch: int, processes: Optional[int] = None) -> int:
    """A global batch's share on each process; it must divide evenly."""
    dp = processes or world_size()
    if global_batch % dp != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp={dp}")
    return global_batch // dp


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """An init method: a URL as given (tcp://, file://, env://), a bare
    host:port as tcp://, else MASTER_ADDR / MASTER_PORT's tcp://."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get(
            "MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if addr is None:
        return None
    return addr if "://" in addr else f"tcp://{addr}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     accelerator: str = "auto",
                     timeout_s: Optional[float] = None) -> None:
    """Join the process group. A no-op when a group is up already (so it
    is safe to call twice) and for one process that nothing launched as a
    world: no argument, no torchrun environment, ONEPROT_NUM_PROCESSES
    unset or 1. A torchrun world of one makes a group of one.

    The world size and this rank come from the arguments, else torchrun's
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    ONEPROT_NUM_PROCESSES above 1 without them is an error, not a world.
    `accelerator="cpu"` (a trainer's) keeps the rank on the CPU over gloo;
    otherwise, with a card present, the rank takes cuda:{LOCAL_RANK} (its
    rank when LOCAL_RANK is unset), which must exist, and NCCL."""
    if not dist.is_available() or dist.is_initialized():
        return
    nproc = num_processes or _env_int("WORLD_SIZE", "ONEPROT_NUM_PROCESSES") or 1
    launched = (num_processes is not None or coordinator_address is not None
                or _env_int("WORLD_SIZE") is not None)
    if nproc <= 1 and not launched:
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    init_method = _address(coordinator_address)
    if rank is None or init_method is None:
        raise ValueError(
            f"a world of {nproc} processes needs this process's rank and a "
            "rendezvous address: launch with `python -m "
            "torch.distributed.run --nproc_per_node N ...` or pass "
            "coordinator_address, num_processes and process_id")
    on_card = accelerator != "cpu" and torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card and backend == "nccl":
        local = _env_int("LOCAL_RANK")
        local = rank if local is None else local
        cards = torch.cuda.device_count()
        if local >= cards:
            raise ValueError(f"local rank {local} has no card: this host has "
                             f"{cards}; start at most {cards} processes on it")
        torch.cuda.set_device(local)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nproc, rank=rank, **kw)


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    if distributed():
        dist.destroy_process_group()


def check_mesh(mesh: Optional[Mapping[str, int]]) -> None:
    """The trainer's `mesh` config against the world: `data` must be -1
    (every process) or the world size; a `model` axis above 1 (tensor
    parallelism) is not ported and raises NotImplementedError."""
    mesh = dict(mesh or {})
    model = int(mesh.get(MODEL_AXIS, 1))
    if model > 1:
        raise NotImplementedError(
            f"mesh.model={model}: tensor parallelism is not ported; the "
            f"port is data-parallel only ({TENSOR_PARALLEL_ITEM})")
    data = int(mesh.get(DATA_AXIS, -1))
    if data not in (-1, world_size()):
        raise ValueError(
            f"mesh.data={data} but the world has {world_size()} processes: "
            "set -1 (every process) or launch that many processes")
