"""Post-backbone heads: pooling -> projection -> L2-norm (+ logit scale).

Counterpart of oneprot_tpu/models/heads.py (`l2_normalize`, `mean_pool`,
`cls_pool`, `Projection`, `LogitScale`, `EncoderHead`, and the per-segment
pools of packed rows: `empty_slot_filler`, `segment_mean_pool`,
`segment_cls_pool`, `segment_pool`). Attention pooling is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.models.layers import Dense, LayerNorm


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
    LayerNorm, Linear; no biases). Computes in `dtype` over parameters
    stored in float32, as flax stores a head's parameters: heads always
    train."""

    def __init__(self, d_model: int, output_dim: int,
                 proj_type: Optional[str] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_type = proj_type
        kw = dict(device=device, dtype=dtype, param_dtype=torch.float32)
        if proj_type == "linear":
            self.ln = LayerNorm(d_model, eps=1e-5, **kw)
            self.dense = Dense(d_model, output_dim, bias=False, **kw)
        elif proj_type == "mlp":
            hidden = (d_model + output_dim) // 2
            self.ln1 = LayerNorm(d_model, eps=1e-5, **kw)
            self.dense1 = Dense(d_model, hidden, bias=False, **kw)
            self.ln2 = LayerNorm(hidden, eps=1e-5, **kw)
            self.dense2 = Dense(hidden, output_dim, bias=False, **kw)
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


def empty_slot_filler(d: int, device=None) -> torch.Tensor:
    """Filler of EMPTY pack slots: arange(d) / d - 0.5 in f32, bit for bit
    the JAX package's (the cached packed step must reproduce the uncached
    one exactly). Non-constant, so the head's LayerNorm does not centre it
    back to the zero vector, whose L2-norm has a NaN gradient."""
    return torch.arange(d, dtype=torch.float32, device=device) / d - 0.5


def _slot_pool(features: torch.Tensor, hot: torch.Tensor,
               counts: torch.Tensor, mean: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, P] one-hot selection -> ([B, P, H] in the features' dtype,
    f32 counts [B, P]): contraction in f32, the mean's divisor clamped at
    1, and empty slots (count 0) given the filler."""
    pooled = torch.einsum("blp,blh->bph", hot.float(), features.float())
    if mean:
        pooled = pooled / counts[..., None].clamp_min(1.0)
    empty = (counts <= 0).float()[..., None]
    pooled = pooled + empty * empty_slot_filler(features.shape[-1],
                                                features.device)
    return pooled.to(features.dtype), counts


def segment_mean_pool(features: torch.Tensor, token_mask: torch.Tensor,
                      segment_ids: torch.Tensor, num_segments: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mask-aware mean of PACKED rows. features [B, L, H];
    token_mask [B, L] (nonzero = real token); segment_ids [B, L] (padding
    -1). Returns (pooled [B, P, H], counts [B, P]) with P = num_segments;
    counts are exact f32 token counts."""
    slots = torch.arange(num_segments, device=segment_ids.device)
    hot = ((segment_ids[:, :, None] == slots)
           & (token_mask[:, :, None] > 0))                      # [B, L, P]
    return _slot_pool(features, hot, hot.float().sum(1), mean=True)


def segment_cls_pool(features: torch.Tensor, token_mask: torch.Tensor,
                     segment_ids: torch.Tensor, num_segments: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment first-token pooling of PACKED rows: slot s takes the
    token where segment s starts. Same contract as `segment_mean_pool`
    (counts are the segments' token totals)."""
    slots = torch.arange(num_segments, device=segment_ids.device)
    prev = torch.cat([torch.full_like(segment_ids[:, :1], -2),
                      segment_ids[:, :-1]], dim=1)
    is_start = (segment_ids != prev) & (segment_ids >= 0) & (token_mask > 0)
    in_slot = segment_ids[:, :, None] == slots                  # [B, L, P]
    counts = (in_slot & (token_mask[:, :, None] > 0)).float().sum(1)
    return _slot_pool(features, in_slot & is_start[:, :, None], counts,
                      mean=False)


def segment_pool(features: torch.Tensor, token_mask: torch.Tensor,
                 segment_ids: torch.Tensor, num_segments: int,
                 pooling_type: str = "mean"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment pooling by the head's pooling_type ('mean' or 'cls'
    only: any other type raises rather than pool differently from the
    unpacked path)."""
    if pooling_type == "cls":
        return segment_cls_pool(features, token_mask, segment_ids,
                                num_segments)
    if pooling_type != "mean":
        raise NotImplementedError(
            f"segment (packed) pooling has no '{pooling_type}' variant; "
            "use pooling_type 'mean'/'cls' with sequence packing")
    return segment_mean_pool(features, token_mask, segment_ids, num_segments)
