"""The collectives of data-parallel training, over the default process
group (counterparts of the JAX package's `all_gather`, `ppermute`,
`process_allgather` and the gradient `psum` that GSPMD inserts).

- `all_gather_with_grad(x)`: the ranks' [b, ...] blocks stacked in rank
  order; backward: all_reduce(SUM) of the whole gradient, then this
  rank's rows (every rank's loss reaches every block).
- `ring_shift(x, offset)`: this rank receives rank - offset's `x`;
  backward: the gradient shifted by -offset.
- `gather_rows(x)`: blocks whose row counts differ by rank (sizes, pad,
  gather, cut); no gradient.
- `all_reduce_mean_(tensors)`: in place, one flat buffer a dtype.
- `broadcast_(tensors)`: rank 0's values everywhere, in place.
- `mean_across(x)`, `sum_across(x)`, `broadcast_str(s)`,
  `broadcast_object(obj)`, `gather_objects(obj)`, `barrier()`.

Without a process group each is the identity; in a group of one process
they run (NCCL's gather of one rank is a copy, its sum the value itself),
so a world of one takes the multi-process code path. gloo takes CUDA
tensors for all_reduce, broadcast and all_gather but not for send and
recv: `ring_shift` stages its tensor through host memory when the group's
backend is gloo and the tensor is on a card. NCCL never takes that branch.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from oneprot_tpu_torch.core.mesh import distributed, world


def _comm(x: torch.Tensor) -> torch.Tensor:
    """`x` on a device the group's backend takes: a card for NCCL."""
    if dist.get_backend() == "nccl" and not x.is_cuda:
        return x.cuda()
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        n, rank = world()
        ctx.rows, ctx.rank = x.shape[0], rank
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """[world * b, ...]: every rank's `x` (b rows each, the same b on
    every rank) in rank order, differentiable."""
    if not distributed():
        return x
    return _AllGather.apply(x)


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    n, rank = world()
    stage = dist.get_backend() == "gloo" and x.is_cuda
    send = (x.detach().to("cpu") if stage else x.detach()).contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (rank + offset) % n),
        dist.P2POp(dist.irecv, recv, (rank - offset) % n)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if stage else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, offset: int) -> torch.Tensor:
        ctx.offset = offset
        return _shift(x, offset)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _shift(grad, -ctx.offset), None


def ring_shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """The ring permutation i -> i + offset (mod world) of the JAX
    `ppermute`: this rank gets rank - offset's `x`. Differentiable."""
    n, _ = world()
    if n == 1 or offset % n == 0:
        return x
    return _RingShift.apply(x, offset)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` stacked in rank order, where the row counts may
    differ by rank (the trailing dims may not). No gradient."""
    if not distributed():
        return x
    n, _ = world()
    x = x.detach()
    src = _comm(x).contiguous()
    size = torch.tensor([src.shape[0]], device=src.device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    longest = max(sizes)
    padded = src.new_zeros((longest, *src.shape[1:]))
    padded[:src.shape[0]] = src
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)], 0)
    return out.to(x.device)


@torch.no_grad()
def _in_place(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run `collective` on one flat buffer per (dtype, device) group of
    `tensors` and copy the result back (every rank passes the same
    tensors in the same order)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = _comm(torch.cat([t.reshape(-1) for t in group]))
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks: one flat all_reduce
    per dtype."""
    n, _ = world()
    if distributed() and tensors:
        _in_place(tensors, lambda flat: dist.all_reduce(flat) or flat.div_(n))


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x` (a new tensor; no gradient)."""
    if not distributed():
        return x
    out = _comm(x.detach().clone())
    dist.all_reduce(out)
    return out.to(x.device)


def mean_across(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of `x` (a new tensor; no gradient)."""
    return sum_across(x) / world()[0] if distributed() else x


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank."""
    if not distributed():
        return obj
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if not distributed():
        return [obj]
    out: List[Any] = [None] * world()[0]
    dist.all_gather_object(out, obj)
    return out


def broadcast_str(s: str, src: int = 0) -> str:
    """Rank `src`'s string on every rank (the run stamp)."""
    return str(broadcast_object(s, src))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """In place: rank `src`'s values of `tensors` on every rank, one flat
    broadcast per dtype."""
    if distributed() and tensors:
        _in_place(tensors, lambda flat: dist.broadcast(flat, src))


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if distributed():
        dist.barrier()
