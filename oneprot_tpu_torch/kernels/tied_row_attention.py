"""Tied-row attention of the MSA Transformer, forward only.

Counterpart of oneprot_tpu/kernels/tied_row_attention.py. The MSA
Transformer's row attention ties one attention map across all R rows of an
MSA: q, k, v are [B, R, L, H*D] (the projections' own layout) and

    logits[b,h,i,j] = scale * sum_r q[b,r,i,h,:] . k[b,r,j,h,:] + bias[b,j]
    out[b,r,i,h,:]  = sum_j softmax_j(logits)[b,h,i,j] * v[b,r,j,h,:]

with `scale` = D^-0.5 * R^-0.5 by default and an additive column bias
[B, 1, 1, L] (-1e9 at padded columns). Logits and softmax are f32; the
probabilities are rounded to the input dtype before the PV product.

`tied_row_attention_cuda` launches the hand-written kernel of
`csrc/tied_row_attention.cu` (bf16, D = 64, 1 <= L <= 1024, any R and H;
wgmma and TMA, so sm_90a) or raises. Narrower heads (D a multiple of 8
below 64, as the debug MSA tower's 16) are zero-padded to 64 around the
launch: zero columns add nothing to q . k summed over rows and D, so the
logits are the unpadded ones, the scale stays the true D's, and the
output's padded columns are cut off; `tied_row_attention_plain` is the same
function in plain PyTorch, for any device, which the CPU path runs. The
dispatch (and the refusal of a gradient) is
`kernels.attention.fused_tied_row`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from oneprot_tpu_torch.kernels import _build

HEAD_DIM = 64       # the kernel's one head dim: MSA-1b's
MAX_LENGTH = 1024   # the kernel's probability strip holds at most this many keys
LOG2E = math.log2(math.e)


def _check_args(q, k, v, num_heads, col_bias):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, R, L, H*D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, R, L, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} is not a multiple of {num_heads} heads")
    if col_bias is not None and tuple(col_bias.shape) != (B, 1, 1, L):
        raise ValueError(f"col_bias must be [B, 1, 1, L] = [{B}, 1, 1, {L}], "
                         f"got {tuple(col_bias.shape)}")
    return B, R, L, hd // num_heads


def tied_scale(head_dim: int, rows: int) -> float:
    """The tied attention's default scale, head_dim^-0.5 * rows^-0.5."""
    return (head_dim ** -0.5) * (rows ** -0.5)


def tied_row_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int,
                             col_bias: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device): the JAX
    package's einsum path, with f32 logits and softmax and the
    probabilities cast to v's dtype. Returns [B, R, L, H*D] in v's dtype."""
    B, R, L, D = _check_args(q, k, v, num_heads, col_bias)
    if scale is None:
        scale = tied_scale(D, R)

    def heads(x):
        return x.reshape(B, R, L, num_heads, D).float()

    logits = torch.einsum("brihd,brjhd->bhij", heads(q), heads(k)) * scale
    if col_bias is not None:
        logits = logits + col_bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhij,brjhd->brihd", probs.float(), heads(v))
    return ctx.to(v.dtype).reshape(B, R, L, num_heads * D)


def tied_row_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, num_heads: int,
                            col_bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on contiguous, 16-byte aligned bf16 q, k, v on one
    card, heads narrower than 64 zero-padded to 64 (`_pad_heads`). Returns
    [B, R, L, H*D] bf16."""
    B, R, L, D = _check_args(q, k, v, num_heads, col_bias)
    if D > HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} unsupported by the kernel: must be "
                         f"a multiple of 8 up to {HEAD_DIM}")
    if not 1 <= L <= MAX_LENGTH:
        raise ValueError(f"L={L} unsupported by the kernel: 1 <= L <= "
                         f"{MAX_LENGTH}")
    dev = q.device
    for i, t in enumerate((q, k, v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"operand {i} must be on the card of q, got "
                             f"{t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"operand {i} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"operand {i} must be contiguous and 16-byte "
                             "aligned")
    if scale is None:
        scale = tied_scale(D, R)
    if D < HEAD_DIM:
        q, k, v = (_pad_heads(t, num_heads) for t in (q, k, v))
    bias_b = (None if col_bias is None else
              (col_bias.reshape(B, L).to(dev, torch.float32) * LOG2E)
              .contiguous())
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.library("tied_row_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias_b is None else bias_b.data_ptr(), out.data_ptr(),
                B, R, L, num_heads, scale * LOG2E, dev.index, stream)
    _build.check(rc, "tied_row_attention")
    tied_row_attention_cuda.launches += 1
    if D < HEAD_DIM:
        out = out.view(B, R, L, num_heads, HEAD_DIM)[..., :D].reshape(
            B, R, L, num_heads * D)
    return out


def _pad_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, R, L, H*D] -> [B, R, L, H*64], each head's columns past D zero."""
    B, R, L, hd = x.shape
    x = x.reshape(B, R, L, num_heads, hd // num_heads)
    return torch.nn.functional.pad(
        x, (0, HEAD_DIM - x.shape[-1])).reshape(B, R, L, num_heads * HEAD_DIM)


tied_row_attention_cuda.launches = 0
