"""Layers whose parameters are stored in one dtype and computed in another,
and their tensor-parallel forms.

Flax's `dtype` is the compute dtype and `param_dtype` (float32 by default)
the storage dtype: a trainable bf16 tower keeps f32 master parameters and
casts them to bf16 at each use. These subclasses of `nn.Linear`,
`nn.LayerNorm` and `nn.Embedding` do the same, explicitly (no autocast,
whose op lists are not flax's): parameters in `param_dtype` (default: the
compute dtype), inputs and parameters cast to `dtype` in the forward. Their
state_dict keys are those of the torch layers they extend.

`ColumnParallelDense` and `RowParallelDense` are Megatron's layers over a
model group of `tp = (ranks, rank)` (`core/mesh.py:model_world`), built
as this rank's shard (the `core/partitioning.py` rules): a column-parallel
layer holds its block of the output features (weight and bias), a
row-parallel one its block of the input features and the whole bias. The
block a shard holds is marked on the tensor (`tp_dim`, the torch dimension
it splits; `partitioning.layout_of` reads it), so checkpoints and exports
join them into full tensors and `init_dense_` draws the full tensor and
keeps the block (a sharded model then holds the unsharded one's weights).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.core import collectives

TP = Tuple[int, int]  # (model ranks, this rank's model rank)


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device="cuda", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    def __init__(self, width: int, eps: float = 1e-5, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(width, eps=eps, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


class Embedding(nn.Embedding):
    def __init__(self, num_embeddings: int, width: int, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(num_embeddings, width, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


def mark_shard(t: Optional[torch.Tensor], dim: int, tp: TP) -> None:
    """Mark `t` as model rank tp[1]'s block of dimension `dim` of a tensor
    split into tp[0] blocks."""
    if t is not None and tp[0] > 1:
        t.tp_dim, t.tp = dim, tp


def draw_(t: torch.Tensor, fill) -> None:
    """`fill` (an in-place initializer such as `lambda x: x.normal_(...)`)
    on `t`; a shard's fill runs on the full tensor, whose block it keeps,
    so that the generator's draws are the unsharded model's."""
    dim = getattr(t, "tp_dim", None)
    if dim is None:
        fill(t)
        return
    m, rank = t.tp
    shape = list(t.shape)
    shape[dim] *= m
    full = torch.empty(shape, dtype=t.dtype, device=t.device)
    fill(full)
    t.copy_(full.chunk(m, dim)[rank])


class ColumnParallelDense(Dense):
    """y_r = x W_r^T + b_r: rank r's block of the output features
    (`out_features // ranks` of them). With `copy_input` the input goes
    through `copy_to_model_group` (its gradient summed over the group);
    without, the caller has done so once for the layers that share it
    (q, k and v)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, tp: TP = (1, 0), copy_input: bool = True, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features // tp[0], bias,
                         device=device, dtype=dtype, param_dtype=param_dtype)
        self.full_in, self.full_out = in_features, out_features
        self.copy_input = copy_input
        self.ranks = tp[0]
        mark_shard(self.weight, 0, tp)
        mark_shard(self.bias, 0, tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.copy_input and self.ranks > 1:
            x = collectives.copy_to_model_group(x)
        return super().forward(x)


class _PartialLinear(torch.autograd.Function):
    """x W^T in float32 from operands in the compute dtype: on a card
    `torch.mm(..., out_dtype=float32)` keeps the bf16 product's f32
    accumulator (a row-parallel rank's partial sum is then not rounded to
    bf16 before the model group adds it); elsewhere the operands go up to
    f32 (their products are exact there). The backward is a bf16 Dense's:
    dx and dW in the operands' dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float().t()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grad @ w
        if ctx.needs_input_grad[1]:
            dw = grad.reshape(-1, grad.shape[-1]).t() @ x.reshape(
                -1, x.shape[-1])
        return dx, dw


class RowParallelDense(Dense):
    """y = sum_r x_r W_r^T + b: rank r holds the block of the input features
    `in_features // ranks` wide and the whole bias. Each rank's partial
    product comes out of the matmul in float32 (`_PartialLinear`), the
    model group sums the partials in float32 (`reduce_from_model_group`),
    the bias is added once, after the sum, and the result is cast to the
    compute dtype once: one process's Dense up to the order of the f32
    sum. With `input_is_parallel`
    the input is this rank's block already (a column-parallel layer's
    output); without, the input is whole on every rank and the layer takes
    its block (`scatter_to_model_group`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, tp: TP = (1, 0), input_is_parallel: bool = True,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features // tp[0], out_features, bias,
                         device=device, dtype=dtype, param_dtype=param_dtype)
        self.full_in, self.full_out = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.ranks = tp[0]
        mark_shard(self.weight, 1, tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ranks == 1:
            return super().forward(x)
        if not self.input_is_parallel:
            x = collectives.scatter_to_model_group(x)
        dt = self.compute_dtype
        y = collectives.reduce_from_model_group(
            _PartialLinear.apply(x.to(dt), self.weight.to(dt)))
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dt)


def tensor_parallel_dense(kind: str, in_features: int, out_features: int,
                          tp: TP, **kw) -> Dense:
    """A `Dense` of `kind` "column" or "row" split over tp[0] model ranks
    (`ColumnParallelDense`, `RowParallelDense`; the keywords pass on), or a
    plain Dense where there is no model axis or it does not divide the
    split dimension (the rules replicate such a leaf)."""
    split = out_features if kind == "column" else in_features
    if tp[0] == 1 or split % tp[0]:
        kw.pop("copy_input", None)
        kw.pop("input_is_parallel", None)
        return Dense(in_features, out_features, **kw)
    cls = ColumnParallelDense if kind == "column" else RowParallelDense
    return cls(in_features, out_features, tp=tp, **kw)
