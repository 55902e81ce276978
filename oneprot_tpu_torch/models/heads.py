"""Post-backbone heads: pooling -> projection -> L2-norm (+ logit scale).

Counterpart of oneprot_tpu/models/heads.py (`l2_normalize`, `mean_pool`,
`cls_pool`, `Projection`, `LogitScale`, `EncoderHead`). Attention pooling
and the per-segment pools of packed rows are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) semantics (norm clamped at eps)."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def mean_pool(features: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask-aware mean over the length axis, in the features' dtype."""
    if features.ndim == 2:
        return features
    if mask is None:
        return features.mean(dim=1)
    m = mask.to(features.dtype)[..., None]
    return (features * m).sum(dim=1) / m.sum(dim=1)


def cls_pool(features: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return features[:, 0]


class Projection(nn.Module):
    """proj_type: None/'identity' | 'linear' (LayerNorm + Linear, no bias) |
    'mlp' (LayerNorm, Linear to (d_model + output_dim) // 2, exact GELU,
    LayerNorm, Linear; no biases)."""

    def __init__(self, d_model: int, output_dim: int,
                 proj_type: Optional[str] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_type = proj_type
        kw = dict(device=device, dtype=dtype)
        if proj_type == "linear":
            self.ln = nn.LayerNorm(d_model, eps=1e-5, **kw)
            self.dense = nn.Linear(d_model, output_dim, bias=False, **kw)
        elif proj_type == "mlp":
            hidden = (d_model + output_dim) // 2
            self.ln1 = nn.LayerNorm(d_model, eps=1e-5, **kw)
            self.dense1 = nn.Linear(d_model, hidden, bias=False, **kw)
            self.ln2 = nn.LayerNorm(hidden, eps=1e-5, **kw)
            self.dense2 = nn.Linear(hidden, output_dim, bias=False, **kw)
        elif proj_type not in (None, "identity"):
            raise ValueError(f"unknown proj_type {proj_type!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.proj_type == "linear":
            return self.dense(self.ln(x))
        if self.proj_type == "mlp":
            x = F.gelu(self.dense1(self.ln1(x)), approximate="none")
            return self.dense2(self.ln2(x))
        return x


class LogitScale(nn.Module):
    """exp-parameterised temperature, init log(1/0.07), clipped at 100."""

    def __init__(self, logit_scale_init: float = 1.0 / 0.07,
                 learnable: bool = True, max_logit_scale: float = 100.0, *,
                 device="cuda"):
        super().__init__()
        init = torch.full((), math.log(logit_scale_init), device=device)
        if learnable:
            self.log_logit_scale = nn.Parameter(init)
        else:
            # a constant: not in the state_dict, as not in the JAX params
            self.register_buffer("log_logit_scale", init, persistent=False)
        self.max_logit_scale = max_logit_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.log_logit_scale.exp().clamp_max(self.max_logit_scale)
        return scale.to(x.dtype) * x


class EncoderHead(nn.Module):
    """pooling -> projection -> l2-norm (+ optional logit scale). `pool` and
    `project` are separate so a frozen backbone's pooled output can be
    cached and only the projection re-run."""

    def __init__(self, d_model: int, output_dim: int,
                 proj_type: Optional[str] = None, pooling_type: str = "mean",
                 use_logit_scale: bool = False,
                 learnable_logit_scale: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling_type not in ("mean", "cls", None, "identity"):
            raise NotImplementedError(
                f"pooling_type {pooling_type!r} is not ported yet")
        self.pooling_type = pooling_type
        self.proj = Projection(d_model, output_dim, proj_type, device=device,
                               dtype=dtype)
        self.logit_scale = (LogitScale(learnable=learnable_logit_scale,
                                       device=device)
                            if use_logit_scale else None)

    def pool(self, features: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pooling_type == "mean":
            return mean_pool(features, mask)
        if self.pooling_type == "cls":
            return cls_pool(features, mask)
        return features

    def project(self, pooled: torch.Tensor) -> torch.Tensor:
        out = l2_normalize(self.proj(pooled).float(), dim=-1)
        if self.logit_scale is not None:
            out = self.logit_scale(out)
        return out

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.project(self.pool(features, mask))
