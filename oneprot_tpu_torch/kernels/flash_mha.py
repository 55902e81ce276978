"""Flash multi-head attention forward in the [B, L, H*D] layout.

Counterpart of oneprot_tpu/kernels/flash_mha.py:mha_attention. The wrapper
`mha_attention` takes q, k, v as the QKV projections give them, optional
additive key bias [B, 1, 1, L], rotary tables [L, D] and segment ids [B, L]
(packed rows: attention is block-diagonal per segment), and returns
(out [B, L, H*D], lse [B, H, L]) with lse the base-2 log-sum-exp of the
scaled logits, which a backward pass needs.

On a CUDA tensor it launches the hand-written kernel of
`csrc/flash_mha_fwd.cu` (bf16, head dim even and at most 64, forward only)
or raises; on a CPU tensor it runs `mha_attention_plain`, the same function
in plain PyTorch with f32 logits and softmax.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from oneprot_tpu_torch.kernels import _build
from oneprot_tpu_torch.kernels.attention import (
    LOG2E,
    packed_segment_bias,
    reference_attention,
)

MAX_HEAD_DIM = 64
# added to a cross-segment logit, as in the TPU kernel: far below the -1e9
# key-padding bias, so a padded query row of a packed batch (its own
# segment id) attends to padding only, not to every key. The XLA fallback's
# `packed_segment_bias` masks at -1e9 and is kept so by default.
SEG_MASK = -1e30


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, D]; cos, sin [L, D]."""
    return x * cos + rotate_half(x) * sin


def _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin, segment_ids):
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, L, H*D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} is not a multiple of {num_heads} heads")
    D = hd // num_heads
    if D > MAX_HEAD_DIM or D % 2:
        raise ValueError(f"head dim {D} unsupported: must be even and <= "
                         f"{MAX_HEAD_DIM}")
    if bias is not None and tuple(bias.shape) != (B, 1, 1, L):
        raise ValueError(f"bias must be [B, 1, 1, L], got {tuple(bias.shape)}")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin go together")
    if rope_cos is not None and (tuple(rope_cos.shape) != (L, D)
                                 or tuple(rope_sin.shape) != (L, D)):
        raise ValueError(f"rotary tables must be [L, D] = [{L}, {D}]")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, L):
        raise ValueError(f"segment_ids must be [B, L], got "
                         f"{tuple(segment_ids.shape)}")
    return B, L, D


def mha_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (any device), on
    `attention.reference_attention`: rotary in f32, f32 logits and softmax,
    rotary tables and probabilities cast to the input dtype as the kernel
    does. Returns (out, base-2 lse)."""
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)

    def heads(x):
        return x.reshape(B, L, num_heads, D).transpose(1, 2)

    qh, kh = heads(q).float(), heads(k).float()
    if rope_cos is not None:
        # tables in the inputs' dtype, as the kernel reads them
        cos, sin = (t.to(q.dtype).float() for t in (rope_cos, rope_sin))
        qh, kh = apply_rotary(qh, cos, sin), apply_rotary(kh, cos, sin)
    if segment_ids is not None:
        bias = packed_segment_bias(segment_ids, bias, mask_value=SEG_MASK)
    out, lse = reference_attention(qh, kh, heads(v), bias, return_lse=True)
    return out.transpose(1, 2).reshape(B, L, num_heads * D), lse


def flash_mha_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. Inputs: contiguous, 16-byte aligned bf16 q,
    k, v on one card with a head dim that is a multiple of 8, none requiring
    grad (the kernel is forward only)."""
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    if D % 8:
        raise ValueError(f"head dim {D} unsupported by the kernel: must be a "
                         "multiple of 8")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the card of q, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.requires_grad:
            raise RuntimeError("flash-MHA kernel is forward only: "
                               f"{name} requires grad")
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    # f32 side inputs, made here so the kernel reads one layout
    bias_b = (None if bias is None else
              (bias.reshape(B, L).to(dev, torch.float32) * LOG2E).contiguous())
    cos, sin = ((None, None) if rope_cos is None else
                (t.to(dev, torch.bfloat16).contiguous() for t in (rope_cos, rope_sin)))
    seg = (None if segment_ids is None else
           segment_ids.to(dev, torch.int32).contiguous())

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.library("flash_mha_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias_b),
                ptr(cos), ptr(sin), ptr(seg), out.data_ptr(), lse.data_ptr(),
                B, L, num_heads, D, LOG2E / math.sqrt(D), stream)
    _build.check(rc, "flash_mha_fwd")
    flash_mha_cuda.launches += 1
    return out, lse


flash_mha_cuda.launches = 0


def mha_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash MHA on [B, L, H*D] q, k, v with optional in-kernel rotary.
    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises on what it does not take."""
    fn = mha_attention_plain if q.device.type == "cpu" else flash_mha_cuda
    return fn(q, k, v, num_heads, bias=bias, rope_cos=rope_cos,
              rope_sin=rope_sin, segment_ids=segment_ids)
