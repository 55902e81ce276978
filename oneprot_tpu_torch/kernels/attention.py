"""Plain attention, the oracle the flash kernels are held against, and
the tied-row dispatch of the MSA tower.

Counterpart of oneprot_tpu/kernels/attention.py (`packed_segment_bias`,
`reference_attention`, `fused_tied_row`): [B, H, L, D] layout, softmax in
f32. `flash_mha.mha_attention_plain` and
`flash_attention.flash_attention_plain` are built on the first two. The
JAX module's `dot_product_attention` and the head-dim rule of its
`fused_mha` sit beside the kernels they dispatch to, in `flash_attention`
and `flash_mha`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from oneprot_tpu_torch.kernels import tied_row_attention as tra

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


class _TiedRow(torch.autograd.Function):
    """Forward only, as the JAX package's custom vjp: the MSA tower is
    always frozen, and a gradient through this op is refused."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, col_bias, scale):
        fwd = (tra.tied_row_attention_plain if q.device.type == "cpu"
               else tra.tied_row_attention_cuda)
        return fwd(q, k, v, num_heads, col_bias=col_bias, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "tied-row attention is forward only: the MSA tower must stay "
            "frozen (run it under torch.no_grad)")


def fused_tied_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, col_bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """MSA tied-row attention on the projections' [B, R, L, H*D] layout
    (see `tied_row_attention`). CPU tensors take the plain version; CUDA
    tensors the kernel, which raises on what it does not take (a head dim
    other than 64). No gradient: backward raises NotImplementedError."""
    return _TiedRow.apply(q, k, v, num_heads, col_bias, scale)
