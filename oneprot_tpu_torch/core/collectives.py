"""The collectives of data- and tensor-parallel training (counterparts of
the JAX package's `all_gather`, `ppermute`, `process_allgather` and the
`psum`s that GSPMD inserts for the gradients and the row-parallel layers).

Every collective of data parallelism takes a `group`; None is the data
group of the mesh (`core/mesh.py`), which is the whole world without a
model axis. Ranks are counted within the group. The model group's:

- `copy_to_model_group(x)` (Megatron's f): identity forward, all-reduce
  of the gradient (in f32) backward: a replicated input entering
  column-parallel layers, whose gradient each rank holds a part of;
- `reduce_from_model_group(x)` (Megatron's g): all-reduce forward (in
  f32: the partial sums of a row-parallel layer), identity backward;
- `scatter_to_model_group(x)`: this rank's block of the last dim of a
  replicated `x`; backward, the blocks' gradients gathered (a
  row-parallel layer whose input is whole);
- `gather_from_model_group(x, dim)`: the ranks' blocks joined along
  `dim`, no gradient (a checkpoint's or an export's full tensor);
- `model_sum_(tensors)`: in place, the sum over the model group;
- `model_broadcast_(tensors)`: in place, the model group's first rank's
  values on every rank of the group (one replica of what each rank
  computed for itself).

- `all_gather_with_grad(x)`: the ranks' [b, ...] blocks stacked in rank
  order; backward: all_reduce(SUM) of the whole gradient, then this
  rank's rows (every rank's loss reaches every block).
- `ring_shift(x, offset)`: this rank receives rank - offset's `x`;
  backward: the gradient shifted by -offset.
- `gather_rows(x)`: blocks whose row counts differ by rank (sizes, pad,
  gather, cut); no gradient.
- `all_reduce_mean_(tensors)`: in place, one flat buffer a dtype.
- `broadcast_(tensors)`: rank 0's values everywhere, in place.
- `mean_across(x)`, `sum_across(x)` (over the data group);
  `broadcast_str(s)`, `broadcast_object(obj)`, `gather_objects(obj)`,
  `broadcast_(tensors)` and `barrier()` (over the whole world, or the
  group given); `all_agree(flag, group)`.

Without a process group each is the identity; in a group of one process
they run (NCCL's gather of one rank is a copy, its sum the value itself),
so a world of one takes the multi-process code path. gloo takes CUDA
tensors for all_reduce, broadcast and all_gather but not for send and
recv: `ring_shift` stages its tensor through host memory when the group's
backend is gloo and the tensor is on a card. NCCL never takes that branch.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from oneprot_tpu_torch.core.mesh import data_group, distributed, model_group

Group = Optional[dist.ProcessGroup]


def _group(group: Group) -> Group:
    """`group`, or the data group for None."""
    return data_group() if group is None else group


def _size_rank(group: Group) -> Tuple[int, int]:
    """(ranks, this rank's rank) of `group` (None: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


def _comm(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """`x` on a device the group's backend takes: a card for NCCL."""
    if dist.get_backend(group) == "nccl" and not x.is_cuda:
        return x.cuda()
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group) -> torch.Tensor:
        n, rank = _size_rank(group)
        ctx.rows, ctx.rank, ctx.group = x.shape[0], rank, group
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """[ranks * b, ...]: every rank's `x` (b rows each, the same b on
    every rank) in rank order, differentiable."""
    if not distributed():
        return x
    return _AllGather.apply(x, _group(group))


def _shift(x: torch.Tensor, offset: int, group: Group) -> torch.Tensor:
    n, rank = _size_rank(group)
    stage = dist.get_backend(group) == "gloo" and x.is_cuda
    send = (x.detach().to("cpu") if stage else x.detach()).contiguous()
    recv = torch.empty_like(send)

    def peer(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, peer((rank + offset) % n), group),
        dist.P2POp(dist.irecv, recv, peer((rank - offset) % n), group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if stage else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, offset: int,
                group: Group) -> torch.Tensor:
        ctx.offset, ctx.group = offset, group
        return _shift(x, offset, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _shift(grad, -ctx.offset, ctx.group), None, None


def ring_shift(x: torch.Tensor, offset: int, group: Group = None
               ) -> torch.Tensor:
    """The ring permutation i -> i + offset (mod ranks) of the JAX
    `ppermute`: this rank gets rank - offset's `x`. Differentiable."""
    if not distributed():
        return x
    group = _group(group)
    n, _ = _size_rank(group)
    if n == 1 or offset % n == 0:
        return x
    return _RingShift.apply(x, offset, group)


def gather_rows(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Every rank's `x` stacked in rank order, where the row counts may
    differ by rank (the trailing dims may not). No gradient."""
    if not distributed():
        return x
    group = _group(group)
    n, _ = _size_rank(group)
    x = x.detach()
    src = _comm(x, group).contiguous()
    size = torch.tensor([src.shape[0]], device=src.device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s.item()) for s in sizes]
    longest = max(sizes)
    padded = src.new_zeros((longest, *src.shape[1:]))
    padded[:src.shape[0]] = src
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)], 0)
    return out.to(x.device)


# -- the model group: Megatron's f and g, the scatter, the exports' gather --

def _model_ranks() -> int:
    group = model_group()
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = _comm(x.contiguous().clone(), group)
    dist.all_reduce(out, group=group)
    return out.to(x.device)


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        # summed in f32: a bf16 sum would round once more
        return _all_reduce(grad.float(), model_group()).to(grad.dtype)


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _all_reduce(x, model_group())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


def _block(x: torch.Tensor, dim: int) -> torch.Tensor:
    m, rank = dist.get_world_size(model_group()), dist.get_rank(model_group())
    return x.chunk(m, dim)[rank].contiguous()


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    group = model_group()
    src = _comm(x.detach().contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


class _ScatterToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _block(x, -1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _gather(grad, -1)


def copy_to_model_group(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: `x` itself; its gradient summed over the model group."""
    return x if _model_ranks() == 1 else _CopyToModelGroup.apply(x)


def reduce_from_model_group(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the f32 sum of `x` over the model group; the gradient
    passes unchanged (every rank holds the whole one). Returns float32
    (or `x` itself without a model axis)."""
    return x if _model_ranks() == 1 else _ReduceFromModelGroup.apply(
        x.float())


def scatter_to_model_group(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last dim of `x` (replicated over the model
    group); the gradient of the blocks gathered backward."""
    return x if _model_ranks() == 1 else _ScatterToModelGroup.apply(x)


def gather_from_model_group(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's blocks of a tensor joined along `dim` in model-rank
    order, on every rank of the group. No gradient."""
    return x if _model_ranks() == 1 else _gather(x, dim)


def model_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """In place: each tensor summed over the model group (one flat
    all-reduce per dtype)."""
    if _model_ranks() > 1 and tensors:
        group = model_group()
        _in_place(tensors, lambda flat: dist.all_reduce(flat, group=group),
                  group)


def model_broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """In place: each tensor as the model group's first rank holds it, on
    every rank of the group (one flat broadcast per dtype)."""
    if _model_ranks() > 1 and tensors:
        broadcast_(tensors, 0, model_group())


@torch.no_grad()
def _in_place(tensors: Sequence[torch.Tensor], collective,
              group: Group = None) -> None:
    """Run `collective` on one flat buffer per (dtype, device) group of
    `tensors` and copy the result back (every rank passes the same
    tensors in the same order)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for part in groups.values():
        flat = _comm(torch.cat([t.reshape(-1) for t in part]), group)
        collective(flat)
        offset = 0
        for t in part:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Group = None) -> None:
    """Replace each tensor by its mean over the group's ranks: one flat
    all_reduce per dtype."""
    if distributed() and tensors:
        group = _group(group)
        n, _ = _size_rank(group)
        _in_place(tensors, lambda flat: dist.all_reduce(flat, group=group)
                  or flat.div_(n), group)


def sum_across(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum over the group's ranks of `x` (a new tensor; no gradient)."""
    if not distributed():
        return x
    return _all_reduce(x.detach(), _group(group))


def mean_across(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The mean over the group's ranks of `x` (a new tensor; no
    gradient)."""
    if not distributed():
        return x
    group = _group(group)
    return sum_across(x, group) / _size_rank(group)[0]


def broadcast_object(obj: Any, src: int = 0, group: Group = None) -> Any:
    """The picklable `obj` of the group's rank `src` (the group: the whole
    world unless one is given) on every rank of the group."""
    if not distributed():
        return obj
    box: List[Any] = [obj]
    root = src if group is None else dist.get_global_rank(group, src)
    dist.broadcast_object_list(box, root, group=group)
    return box[0]


def gather_objects(obj: Any, group: Group = None) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank of the
    group (the whole world unless one is given)."""
    if not distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_agree(flag: bool, group: Group) -> bool:
    """Whether `flag` holds on every rank of `group` (a MIN all-reduce;
    `flag` itself without a process group)."""
    if not distributed():
        return flag
    t = _comm(torch.tensor([int(flag)]), group)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def broadcast_str(s: str, src: int = 0) -> str:
    """Rank `src`'s string on every rank (the run stamp)."""
    return str(broadcast_object(s, src))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group: Group = None) -> None:
    """In place: the values of `tensors` on the group's rank `src` on
    every rank of the group, one flat broadcast per dtype. The group is
    the whole world unless one is given (not the data group: this is how
    rank 0's replicated weights reach every rank)."""
    if distributed() and tensors:
        root = src if group is None else dist.get_global_rank(group, src)
        _in_place(tensors, lambda flat: dist.broadcast(flat, root,
                                                       group=group), group)


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if distributed():
        dist.barrier()
