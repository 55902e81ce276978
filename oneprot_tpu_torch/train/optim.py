"""Optimizer construction and trainability (counterpart of
oneprot_tpu/train/optim.py: `adam`, `build_optimizer`, `trainable_mask`).

`build_optimizer` clips the gradients by their global norm with optax's
formula (g * max_norm / norm when norm >= max_norm, no epsilon; torch's
`clip_grad_norm_` adds 1e-6 to the norm) and then steps the base optimizer.
Trainability is `requires_grad`: the JAX package's partition into trainable
and frozen trees is not needed.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn as nn

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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place: scale every gradient by min(1, max_norm / global norm), on
    the device (no host sync). Returns the global norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm


class ClippedOptimizer:
    """clip_by_global_norm(max_norm) -> base optimizer, over the given
    parameters. Every parameter steps every time, as optax updates every
    trainable leaf: one that got no gradient (a tower the step's modality
    does not run) steps on zeros, so Adam's moments decay and carry it
    on, and every parameter's step count is the global one."""

    def __init__(self, params: Iterable[nn.Parameter], base: OptimizerFn,
                 max_norm: Optional[float]):
        self.params = list(params)
        self.base = base(self.params)
        self.max_norm = max_norm

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip, then update."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm:
            clip_by_global_norm_([p.grad for p in self.params], self.max_norm)
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
