"""Process-group bootstrap and the data-parallel world (counterpart of
oneprot_tpu/core/mesh.py: `init_distributed`, `process_index`,
`is_main_process`, `local_batch_size`, the (data, model) mesh).

One process per card over `torch.distributed`, laid out as the JAX
`make_mesh` lays out its devices: a (data, model) grid with the model
axis innermost. Rank r is data rank r // model and model rank r % model;
a model group is `model` consecutive ranks (on one host, the cards of
one NVLink island), a data group the ranks of one model rank. The ranks
of a model group hold one replica between them, each weight of the
`core/partitioning.py` rules as its shard (tensor parallelism, the
Megatron layers of `models/layers.py`), and step on the same batches;
the data groups split every batch. `check_mesh` builds both kinds of
group (`dist.new_group`, in one order on every rank); without a model
axis (model 1) the data group is the whole world and no group is made.

    init_distributed()            # torchrun's environment, or a no-op
    init_distributed("tcp://localhost:29500", num_processes=2, process_id=1)

The backend is NCCL where the rank's device is a card and gloo on the
CPU; a caller may name another (two ranks sharing one card need gloo:
NCCL refuses a card twice). A rank on a card takes `cuda:{LOCAL_RANK}`
and makes it the current device before NCCL starts.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The groups of a (data, model) layout of the world: `model` ranks a
    model group; `data_group` and `model_group` are this rank's (None: the
    default group, for the data group of a mesh without a model axis)."""

    model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None


# the mesh of the process group, as the process group itself is one per
# process; `check_mesh` sets it, `shutdown_distributed` clears it
_MESH = Mesh()


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


def model_world() -> Tuple[int, int]:
    """(model ranks a group, this rank's model rank): (1, 0) without a
    model axis."""
    m = _MESH.model
    return m, world()[1] % m


def data_world() -> Tuple[int, int]:
    """(data ranks, this rank's data rank): the world's ranks over the
    model axis; `world()` without one."""
    n, rank = world()
    m = _MESH.model
    return n // m, rank // m


def data_group() -> Optional[dist.ProcessGroup]:
    """This rank's data group (None: the default group)."""
    return _MESH.data_group


def model_group() -> Optional[dist.ProcessGroup]:
    """This rank's model group (None without a model axis)."""
    return _MESH.model_group


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
    """Leave the process group, if one is up, and forget its mesh."""
    global _MESH
    _MESH = Mesh()
    if distributed():
        dist.destroy_process_group()


def _groups(n: int, model: int) -> Tuple[dist.ProcessGroup,
                                          dist.ProcessGroup]:
    """(this rank's data group, its model group), after every group of
    the layout is made on every rank in one order (`new_group` is a
    collective of the whole world)."""
    rank = world()[1]
    data_groups = [dist.new_group(list(range(j, n, model)))
                   for j in range(model)]
    model_groups = [dist.new_group(list(range(i * model, (i + 1) * model)))
                    for i in range(n // model)]
    return data_groups[rank % model], model_groups[rank // model]


def check_mesh(mesh: Optional[Mapping[str, int]]) -> None:
    """The trainer's `mesh` config against the world, and its groups:
    `model` must divide the world (a world of one takes model 1 only) and
    `data` must be -1 (world / model) or world / model, else ValueError.
    With model > 1 the first call builds the groups and later calls with
    the same layout reuse them; another model size while a mesh is up
    raises."""
    global _MESH
    mesh = dict(mesh or {})
    n = world_size()
    model = int(mesh.get(MODEL_AXIS, 1))
    if model < 1 or n % model:
        raise ValueError(
            f"mesh.model={model} does not divide the world of {n} "
            "process(es): launch a multiple of mesh.model processes, one "
            "per card (`python -m torch.distributed.run --nproc_per_node "
            f"{max(model, 1)} ...`)")
    data = int(mesh.get(DATA_AXIS, -1))
    if data not in (-1, n // model):
        raise ValueError(
            f"mesh.data={data} but the world has {n} processes over "
            f"mesh.model={model}: set -1 (world / model) or launch "
            f"{max(data, 1) * model} processes")
    if model == _MESH.model:
        return
    if _MESH.model > 1:
        raise ValueError(f"mesh.model={model} but this process group's "
                         f"mesh has model={_MESH.model}")
    _MESH = Mesh(model, *_groups(n, model))
