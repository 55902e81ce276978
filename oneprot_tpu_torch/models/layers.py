"""Layers whose parameters are stored in one dtype and computed in another.

Flax's `dtype` is the compute dtype and `param_dtype` (float32 by default)
the storage dtype: a trainable bf16 tower keeps f32 master parameters and
casts them to bf16 at each use. These subclasses of `nn.Linear`,
`nn.LayerNorm` and `nn.Embedding` do the same, explicitly (no autocast,
whose op lists are not flax's): parameters in `param_dtype` (default: the
compute dtype), inputs and parameters cast to `dtype` in the forward. Their
state_dict keys are those of the torch layers they extend.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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
