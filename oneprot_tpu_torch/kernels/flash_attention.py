"""FlashAttention-2 forward over [B, H, L, D] with an additive key bias.

Counterpart of oneprot_tpu/kernels/flash_attention.py (`supports`, `_fwd`,
`flash_attention`): the attention of a model whose heads are wider than the
fused flash-MHA kernel takes (D in [64, 256], ESM2-15B's 128), reached
through `dot_product_attention`. On CUDA tensors the forward
launches the hand-written kernel of `csrc/flash_attention_fwd.cu` (bf16) or
raises; on CPU tensors it runs `flash_attention_plain`. Forward only: the
dq and dk/dv kernels of the JAX package (its `_bwd`) are not ported yet, so
a gradient through `flash_attention` raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from oneprot_tpu_torch.kernels import _build
from oneprot_tpu_torch.kernels.attention import reference_attention

MIN_HEAD_DIM, MAX_HEAD_DIM = 64, 256


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor]) -> bool:
    """Shapes the kernel takes: q [B, H, Lq, D], k and v [B, H, Lk, D] with
    D a multiple of 8 in [64, 256], bias [B, 1, 1, Lk] or None. Any
    Lq, Lk >= 1 (the TPU kernel's L % 128 rule is its tiling, not the
    function's)."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        return False
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if tuple(k.shape) != (B, H, Lk, D) or Lq < 1 or Lk < 1:
        return False
    if D % 8 or D < MIN_HEAD_DIM or D > MAX_HEAD_DIM:
        return False
    return bias is None or tuple(bias.shape) == (B, 1, 1, Lk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (any device): f32 logits and
    softmax, probabilities and the output in v's dtype. Returns (out,
    base-2 lse [B, H, Lq] f32)."""
    return reference_attention(q, k, v, bias, return_lse=True)


def _strides(t: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(batch, head, row) element strides of a [B, H, L, D] operand, which
    the kernel reads with unit stride over D and 16-byte aligned rows."""
    if t.stride(3) != 1:
        raise ValueError(f"{what} must have unit stride over the head dim")
    for dim in range(3):
        if t.shape[dim] > 1 and t.stride(dim) % 8:
            raise ValueError(f"{what}: stride {t.stride(dim)} of dim {dim} is "
                             "not a multiple of 8 elements")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on bf16 CUDA tensors. Returns (out [B, H,
    Lq, D] bf16, laid out as [B, Lq, H, D] so that the heads fold back into
    [B, Lq, H*D] without a copy; base-2 lse [B, H, Lq] f32)."""
    if not supports(q, k, v, bias):
        raise ValueError(
            f"flash_attention takes q [B, H, Lq, D], k, v [B, H, Lk, D] with D "
            f"a multiple of 8 in [{MIN_HEAD_DIM}, {MAX_HEAD_DIM}] and bias "
            f"[B, 1, 1, Lk] or None; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}, "
            f"{None if bias is None else tuple(bias.shape)}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the card of q, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _strides(t, name)]
    bias_b = (None if bias is None else
              bias.reshape(B, Lk).to(dev, torch.float32).contiguous())
    out = torch.empty(B, Lq, H, D, dtype=torch.bfloat16,
                      device=dev).transpose(1, 2)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    strides += [out.stride(0), out.stride(1), out.stride(2)]
    # q is multiplied by 1/sqrt(D) rounded to bf16, as the TPU kernel does
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.bfloat16))
    fn = _build.library("flash_attention_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias_b is None else bias_b.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, H, Lq, Lk, D, *strides, scale, stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward of the JAX package's custom vjp. Its backward needs the
    dq and dk/dv kernels (the TPU's `_bwd_dq_kernel` and `_bwd_dkv_kernel`),
    which are not ported yet: a gradient through this op is refused."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        fwd = (flash_attention_plain if q.device.type == "cpu"
               else flash_attention_fwd_cuda)
        out, _ = fwd(q, k, v, bias)
        return out

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "flash_attention is forward only: its dq and dk/dv kernels (the "
            "TPU's _bwd_dq_kernel and _bwd_dkv_kernel) are not ported yet; "
            "run a hub with heads wider than 64 frozen, under torch.no_grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over [B, H, L, D] q, k, v with an optional [B, 1, 1, Lk]
    additive key bias. CPU tensors take the plain version; CUDA tensors the
    kernel, which raises on what it does not take. No gradient: backward
    raises NotImplementedError."""
    return _FlashAttention.apply(q, k, v, bias)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over [B, H, L, D] q, k, v with an optional
    additive bias, through `flash_attention` (the CUDA kernel on the card,
    its plain version on the CPU). Counterpart of the JAX package's
    `kernels.attention.dot_product_attention`.

    Heads narrower than 64, or not a multiple of 8, are zero-padded to
    max(64, ceil8(D)) with q pre-scaled by sqrt(D_pad / D), so the kernel's
    1/sqrt(D_pad) nets to 1/sqrt(D); the output is sliced back. A shape the
    kernel does not take (a [B, 1, Lq, Lk] or [B, H, Lq, Lk] bias, D over
    256) runs `reference_attention` on the CPU, as the JAX package does, and
    raises on the card: no path of the port gives it one there."""
    d = q.shape[-1]
    d_pad = max(MIN_HEAD_DIM, -(-d // 8) * 8)
    if d_pad != d:
        pad = (0, d_pad - d)
        q_p = torch.nn.functional.pad(q * (d_pad / d) ** 0.5, pad)
        k_p, v_p = (torch.nn.functional.pad(t, pad) for t in (k, v))
        if supports(q_p, k_p, v_p, bias):
            return flash_attention(q_p, k_p, v_p, bias)[..., :d]
    elif supports(q, k, v, bias):
        return flash_attention(q, k, v, bias)
    if q.device.type != "cpu":
        raise ValueError(
            f"dot_product_attention: the flash-attention kernel does not take "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)} (head dim a "
            f"multiple of 8 up to {MAX_HEAD_DIM}, bias [B, 1, 1, Lk])")
    return reference_attention(q, k, v, bias)
