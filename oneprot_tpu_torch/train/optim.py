"""Optimizer construction and trainability (counterpart of
oneprot_tpu/train/optim.py: `adam`, `build_optimizer`, `trainable_mask`).

`build_optimizer` clips the gradients by their global norm with optax's
formula (g * max_norm / norm when norm >= max_norm, no epsilon; torch's
`clip_grad_norm_` adds 1e-6 to the norm) and then steps the base optimizer.
Across several processes the trainable gradients are first replaced by
their mean over the data group, in one flat all-reduce (after the zero
fill, before the clip): the clip then sees the global gradient, as optax
does under GSPMD, and every rank of a data group steps Adam on the same
numbers. Under a model axis a shard's gradient is its block of the full
gradient and Adam, elementwise, steps the block; a replicated parameter
whose gradient each rank holds a part of (LoRA's `lora_A` beside
column-parallel q/k/v, `tp_partial_grad`) is summed over the model group
first, and the global norm counts each shard's block once over the group
and each replicated gradient once. Every other replicated parameter
(embeddings, LayerNorms, heads) has its whole gradient computed by each
model rank on its own, and on the card those computations differ in their
last bits (the embedding and scatter backwards add with atomics): so the
model group's first rank broadcasts its gradients of them to the others,
one flat broadcast, before the data all-reduce and the clip. A model group
then holds one replica, as GSPMD's one logical gradient does in the JAX
package; a broadcast, not a mean, keeps one rank's own numbers, and
without a model axis nothing runs.
Trainability is `requires_grad`: the JAX package's partition into trainable
and frozen trees is not needed.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.nn as nn

from oneprot_tpu_torch.core.collectives import (
    all_reduce_mean_,
    model_broadcast_,
    model_sum_,
    sum_across,
)
from oneprot_tpu_torch.core.mesh import model_group, model_world
from oneprot_tpu_torch.models.esm2 import LORA_TRAINABLE_LEAVES

OptimizerFn = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adam(lr: float = 1e-3, weight_decay: float = 0.0) -> OptimizerFn:
    """Adam (AdamW with `weight_decay`), b1 0.9, b2 0.999, eps 1e-8: the
    update of optax.adam / optax.adamw. Returns a factory over parameters."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay:
        return lambda params: torch.optim.AdamW(params, weight_decay=weight_decay,
                                                **kw)
    return lambda params: torch.optim.Adam(params, **kw)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Sequence[bool] = ()) -> torch.Tensor:
    """In place: scale every gradient by min(1, max_norm / global norm), on
    the device (no host sync). `sharded[i]` marks a model rank's block of
    a split gradient: its squared norm is summed over the model group.
    Returns the global norm before clipping."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_world()[0] > 1 and any(sharded):
        split = torch.tensor(list(sharded), device=norms.device)
        sq = norms.float().square()
        blocks = sum_across(torch.where(split, sq, 0.0).sum(), model_group())
        norm = torch.sqrt(torch.where(split, 0.0, sq).sum() + blocks)
    else:
        norm = torch.linalg.vector_norm(norms)
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm


class ClippedOptimizer:
    """clip_by_global_norm(max_norm) -> base optimizer, over the given
    parameters. Every parameter steps every time, as optax updates every
    trainable leaf: one that got no gradient (a tower the step's modality
    does not run) steps on zeros, so Adam's moments decay and carry it
    on, and every parameter's step count is the global one. Every rank
    all-reduces the same gradients whatever the step ran, so the ranks
    meet in one collective of one size."""

    def __init__(self, params: Iterable[nn.Parameter], base: OptimizerFn,
                 max_norm: Optional[float]):
        self.params = list(params)
        self.base = base(self.params)
        self.max_norm = max_norm
        self.sharded = [getattr(p, "tp_dim", None) is not None
                        for p in self.params]
        self.partial = [p for p in self.params
                        if getattr(p, "tp_partial_grad", False)]
        self.replicated = [p for p, split in zip(self.params, self.sharded)
                           if not split and not getattr(p, "tp_partial_grad",
                                                        False)]

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Sum the partial gradients over the model group, take the model
        group's first rank's gradients of the replicated parameters,
        average over the data group, clip, then update."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        model_sum_([p.grad for p in self.partial])
        model_broadcast_([p.grad for p in self.replicated])
        all_reduce_mean_([p.grad for p in self.params])
        if self.max_norm:
            clip_by_global_norm_([p.grad for p in self.params], self.max_norm,
                                 self.sharded)
        self.base.step()


def build_optimizer(params: Iterable[nn.Parameter],
                    optimizer_fn: Optional[Callable[[], OptimizerFn]] = None,
                    gradient_clip_val: float = 1.0) -> ClippedOptimizer:
    """Global-norm clipping (when gradient_clip_val > 0) -> Adam (or what
    `optimizer_fn()` returns). `optimizer_fn` takes no arguments, as the
    JAX package's does: `lambda: adam(1e-3)`, or `partial(adam, lr=1e-3)`
    as a config's `_partial_: true` makes it."""
    base = optimizer_fn() if optimizer_fn is not None else adam()
    return ClippedOptimizer(params, base,
                            gradient_clip_val if gradient_clip_val > 0 else None)


def trainable_mask(encoders: Dict[str, nn.Module]) -> Dict[str, bool]:
    """True = trainable, per parameter name of a model holding `encoders`
    as `encoders.<name>` (a `OneProtModel`). The JAX package's rule: the
    `transformer` of a frozen encoder is frozen, but for its LoRA factors
    and every bias when it has LoRA (peft's bias="all"); heads and unfrozen
    encoders train."""
    mask = {}
    for name, enc in encoders.items():
        frozen = bool(getattr(enc, "frozen", False))
        lora = int(getattr(enc, "lora_rank", 0)) > 0
        for pname, _ in enc.named_parameters():
            in_transformer = pname.split(".")[0] == "transformer"
            adapter = lora and pname.rsplit(".", 1)[-1] in LORA_TRAINABLE_LEAVES
            mask[f"encoders.{name}.{pname}"] = (
                not (frozen and in_transformer) or adapter)
    return mask
