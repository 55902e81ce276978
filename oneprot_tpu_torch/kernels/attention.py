"""Plain attention: the oracle the flash-MHA kernel is held against.

Counterpart of oneprot_tpu/kernels/attention.py (`packed_segment_bias`,
`reference_attention`): [B, H, L, D] layout, softmax in f32.
`flash_mha.mha_attention_plain` is built on these two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

LOG2E = math.log2(math.e)


def packed_segment_bias(segment_ids: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        mask_value: float = -1e9) -> torch.Tensor:
    """[B, L] segment ids -> additive [B, 1, L, L] block-diagonal mask for
    packed rows (`mask_value` between segments), added to an optional
    existing bias."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    segmask = torch.where(same, 0.0, mask_value).to(torch.float32)[:, None]
    return segmask if bias is None else bias + segmask


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """q, k, v [B, H, L, D]; bias broadcastable to [B, H, Lq, Lk].
    Logits and softmax in f32; probabilities and the output take v's dtype.
    With `return_lse`, also returns the base-2 log-sum-exp [B, H, Lq] of the
    biased scaled logits."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1) * LOG2E
    return out
