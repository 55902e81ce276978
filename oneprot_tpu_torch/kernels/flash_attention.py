"""FlashAttention-2 over [B, H, L, D] with an additive key bias, forward
and backward.

Counterpart of oneprot_tpu/kernels/flash_attention.py (`supports`, `_fwd`,
`_bwd`, `flash_attention`): the attention of a model whose heads are wider
than the fused flash-MHA kernel takes (D in [64, 256], ESM2-15B's 128),
reached through `dot_product_attention`. On CUDA tensors the forward
launches the hand-written kernel of `csrc/flash_attention_fwd.cu` and the
backward those of `csrc/flash_attention_bwd_dq.cu` (which also runs the
backward's prologue: q_s = q * bf16(1/sqrt(D)) and delta = rowsum(dout *
out)) and `csrc/flash_attention_bwd_dkv.cu` (which reads q_s and delta), in
bf16, or raise; on CPU tensors they run `flash_attention_plain` and
`flash_attention_bwd_plain`. As in the JAX package, the key bias gets no
gradient.

Packed rows (several proteins a row) give self-attention `segment_ids`
[B, L] (int, -1 on padding): a logit whose query and key ids differ takes
SEG_MASK (-1e30) on top of its bias. The JAX layer builds that mask densely
([B, 1, L, L], `packed_segment_bias`) and leaves the fused kernel for XLA;
here the kernels take the ids and visit only the tiles that hold pairs of
equal ids (`flash_mha.segment_tile_hits` at the tile shapes below), and
the plain versions build the mask from the ids.
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
from oneprot_tpu_torch.kernels.flash_mha import SEG_MASK

MIN_HEAD_DIM, MAX_HEAD_DIM = 64, 256
# the kernels' tiles, for the skip rule (`flash_mha.segment_tile_hits`): a
# CTA of #5 and #6 holds BLOCK query rows and streams key tiles (of
# `fwd_key_tile(D)` keys in #5, TILE in #6 at every head width); a CTA of
# #7 holds `dkv_key_block(D)` keys and streams query tiles of TILE
BLOCK, TILE = 128, 64


def fwd_key_tile(head_dim: int) -> int:
    """Keys of a tile of the forward (#5): 128 for heads up to 64 wide, 64
    above (up to 128, and the instance for 256)."""
    return 128 if head_dim <= 64 else 64


def dkv_key_block(head_dim: int) -> int:
    """Keys of a CTA of the dk/dv kernel (#7): BLOCK for heads up to 128
    wide, 64 for the instance for 256 (whose two consumer warpgroups split
    dK's and dV's columns, not the keys)."""
    return BLOCK if head_dim <= 128 else 64


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor],
             segment_ids: Optional[torch.Tensor] = None) -> bool:
    """Shapes the kernel takes: q [B, H, Lq, D], k and v [B, H, Lk, D] with
    D a multiple of 8 in [64, 256], bias [B, 1, 1, Lk] or None, and
    segment ids [B, L] or None, which need self-attention (Lq = Lk = L).
    Any Lq, Lk >= 1 (the TPU kernel's L % 128 rule is its tiling, not the
    function's)."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        return False
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if tuple(k.shape) != (B, H, Lk, D) or Lq < 1 or Lk < 1:
        return False
    if D % 8 or D < MIN_HEAD_DIM or D > MAX_HEAD_DIM:
        return False
    if segment_ids is not None and (Lq != Lk or tuple(segment_ids.shape)
                                    != (B, Lk)):
        return False
    return bias is None or tuple(bias.shape) == (B, 1, 1, Lk)


def _with_segments(bias: Optional[torch.Tensor],
                   segment_ids: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """The plain versions' bias: the key bias, plus SEG_MASK across
    segments as a dense [B, 1, L, L] mask where there are segment ids."""
    if segment_ids is None:
        return bias
    return packed_segment_bias(segment_ids, bias, mask_value=SEG_MASK)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (any device): f32 logits and
    softmax, probabilities and the output in v's dtype. Returns (out,
    base-2 lse [B, H, Lq] f32)."""
    return reference_attention(q, k, v, _with_segments(bias, segment_ids),
                               return_lse=True)


def _q_scale(D: int) -> float:
    """1/sqrt(D) rounded to bf16: the kernels multiply q by it, as the TPU
    kernels do in the input dtype."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.bfloat16))


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dout * out) in f32, [B, H, Lq]: the backward's delta (the JAX
    package's `_bwd` takes it outside its kernels; on the card the dq
    kernel's prologue computes it)."""
    return (dout.float() * out.float()).sum(-1)


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


def _kernel_args(q, k, v, bias, segment_ids=None, **rows):
    """The launchers' checks: shapes `supports` takes (and each of `rows`,
    e.g. out and dout, shaped as q), bf16 operands on one card. Returns
    (bias as contiguous f32 [B, Lk] or None, segment ids as contiguous
    int32 [B, L] or None, the operands' strides: q, k, v, then `rows` in
    their order)."""
    named = [("q", q), ("k", k), ("v", v), *rows.items()]
    if not supports(q, k, v, bias, segment_ids) or any(
            tuple(t.shape) != tuple(q.shape) for t in rows.values()):
        raise ValueError(
            f"flash_attention takes q [B, H, Lq, D], k, v [B, H, Lk, D] "
            f"({', '.join(rows) or 'nothing else'} as q) with D a multiple of "
            f"8 in [{MIN_HEAD_DIM}, {MAX_HEAD_DIM}], bias [B, 1, 1, Lk] or "
            f"None and segment ids [B, L] (Lq = Lk = L) or None; got "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, t in named)
            + f", bias {None if bias is None else tuple(bias.shape)}, "
            f"segment_ids "
            f"{None if segment_ids is None else tuple(segment_ids.shape)}")
    dev = q.device
    for name, t in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the card of q, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    strides = [s for name, t in named for s in _strides(t, name)]
    bias_b = (None if bias is None else
              bias.reshape(q.shape[0], -1).to(dev, torch.float32).contiguous())
    seg = (None if segment_ids is None else
           segment_ids.to(dev, torch.int32).contiguous())
    return bias_b, seg, strides


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _empty_heads(x: torch.Tensor) -> torch.Tensor:
    """An empty bf16 tensor of x's [B, H, L, D] shape laid out as [B, L, H,
    D]: the order of the projections the heads were viewed out of, so an
    output or a gradient folds back into [B, L, H*D] without a copy."""
    B, H, L, D = x.shape
    return torch.empty(B, L, H, D, dtype=torch.bfloat16,
                       device=x.device).transpose(1, 2)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             segment_ids: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on bf16 CUDA tensors. Returns (out [B, H,
    Lq, D] bf16, laid out as [B, Lq, H, D]; base-2 lse [B, H, Lq] f32)."""
    bias_b, seg, strides = _kernel_args(q, k, v, bias, segment_ids)
    dev = q.device
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    out = _empty_heads(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    strides += _strides(out, "out")
    fn = _build.library("flash_attention_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_b),
                _ptr(seg), out.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D,
                *strides, _q_scale(D), dev.index, stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              out: torch.Tensor, lse: torch.Tensor,
                              dout: torch.Tensor,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch (any device), with
    the TPU kernels' numerics: q times 1/sqrt(D) in the input dtype; s =
    (q k^T + bias) * log2(e) in f32 (SEG_MASK across segments); p =
    exp2(s - lse) from the forward's base-2 lse; delta = rowsum(dout * out)
    in f32; dS = p (dout v^T - delta), rounded to the input dtype; dq = (dS
    k) / sqrt(D) in f32, dk = dS^T q_scaled, dv = p^T dout with p rounded to
    the input dtype. Returns (dq, dk, dv) in the inputs' dtypes."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=dt, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    bias = _with_segments(bias, segment_ids)
    if bias is not None:
        s = s + bias.float()
    p = torch.exp2(s * LOG2E - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - attention_delta(dout, out)[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dout.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: Optional[torch.Tensor],
                                 out: torch.Tensor, lse: torch.Tensor,
                                 dout: torch.Tensor,
                                 segment_ids: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The dq kernel's function in plain PyTorch (any device), its
    prologue included: q_s = q * 1/sqrt(D) in q's dtype (the kernel's
    bf16(1/sqrt(D)) for bf16) and delta = rowsum(dout * out) in f32, then
    dq as `flash_attention_bwd_plain` has it. Returns (dq, q_s, delta), as
    `flash_attention_bwd_dq_cuda` does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    delta = attention_delta(dout, out)
    ds = _bwd_probs(qs, k, v, _with_segments(bias, segment_ids), dout, lse,
                    delta)[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), qs, delta


def flash_attention_bwd_dkv_plain(qs: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor],
                                  dout: torch.Tensor, lse: torch.Tensor,
                                  delta: torch.Tensor,
                                  segment_ids: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch (any device), on q_s
    and delta as the dq kernel's prologue gives them. Returns (dk, dv)."""
    p, ds = _bwd_probs(qs, k, v, _with_segments(bias, segment_ids), dout,
                       lse, delta)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(qs.dtype).float(), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_probs(qs, k, v, bias, dout, lse, delta):
    """p = exp2((q_s k^T + bias) * log2(e) - lse) and dS = p (dout v^T -
    delta) rounded to q_s's dtype, both as f32 [B, H, Lq, Lk]."""
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    p = torch.exp2(s * LOG2E - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, (p * (dp - delta[..., None])).to(qs.dtype).float()


def _row_stat(q: torch.Tensor, t: torch.Tensor, name: str) -> torch.Tensor:
    """lse or delta as the backward kernels read it: contiguous f32
    [B, H, Lq] on q's card."""
    if tuple(t.shape) != tuple(q.shape[:3]) or t.device != q.device:
        raise ValueError(f"{name} must be [B, H, Lq] on {q.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: Optional[torch.Tensor],
                                out: torch.Tensor, lse: torch.Tensor,
                                dout: torch.Tensor,
                                segment_ids: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Launch the dq kernel on bf16 CUDA tensors (out and lse from the
    forward). Its prologue writes what the dk/dv kernel reads. Returns (dq,
    q_s, delta): dq and q_s = q * bf16(1/sqrt(D)) [B, H, Lq, D] bf16, laid
    out as [B, Lq, H, D]; delta = rowsum(dout * out) [B, H, Lq] f32."""
    bias_b, seg, strides = _kernel_args(q, k, v, bias, segment_ids, out=out,
                                        dout=dout)
    lse = _row_stat(q, lse, "lse")
    B, H, Lq, D = q.shape
    dq, qs = _empty_heads(q), _empty_heads(q)
    delta = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, qs, delta
    strides += [*_strides(dq, "dq"), *_strides(qs, "qs")]
    fn = _build.library("flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_b),
                _ptr(seg), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), qs.data_ptr(), delta.data_ptr(), B, H, Lq,
                k.shape[2], D, *strides,
                _q_scale(D), 1.0 / math.sqrt(D), q.device.index, stream)
    _build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, qs, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(qs: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: Optional[torch.Tensor],
                                 dout: torch.Tensor, lse: torch.Tensor,
                                 delta: torch.Tensor,
                                 segment_ids: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel on bf16 CUDA tensors, with q_s and delta as
    `flash_attention_bwd_dq_cuda` returns them. Returns (dk, dv) [B, H,
    Lk, D] bf16, laid out as [B, Lk, H, D]."""
    bias_b, seg, strides = _kernel_args(qs, k, v, bias, segment_ids,
                                        dout=dout)
    lse, delta = _row_stat(qs, lse, "lse"), _row_stat(qs, delta, "delta")
    B, H, Lq, D = qs.shape
    dk, dv = _empty_heads(k), _empty_heads(v)
    if dk.numel() == 0:
        return dk, dv
    strides += [*_strides(dk, "dk"), *_strides(dv, "dv")]
    fn = _build.library("flash_attention_bwd_dkv")
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_b),
                _ptr(seg), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, Lq, k.shape[2], D,
                *strides, qs.device.index, stream)
    _build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, bias, out, lse, dout,
                             segment_ids=None):
    """The backward on the card: the dq kernel (prologue included), then
    the dk/dv kernel on its q_s and delta. Same arguments and result as
    `flash_attention_bwd_plain`."""
    dq, qs, delta = flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse, dout,
                                                segment_ids)
    dk, dv = flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout, lse, delta,
                                          segment_ids)
    return dq, dk, dv


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels read it: unit stride over D and 16-byte aligned rows
    (an upstream gradient may come in any layout)."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(t.shape[d] == 1 or t.stride(d) % 8 == 0 for d in range(3)))
    return t if ok else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom vjp: the forward saves q, k, v, the bias,
    the segment ids, out and the base-2 lse; CPU tensors take the plain
    versions, CUDA tensors the kernels. The bias and the ids get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids):
        fwd = (flash_attention_plain if q.device.type == "cpu"
               else flash_attention_fwd_cuda)
        out, lse = fwd(q, k, v, bias, segment_ids)
        ctx.save_for_backward(q, k, v, bias, segment_ids, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, segment_ids, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                   segment_ids)
        else:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, bias, out, lse,
                                                  _unit_rows(dout), segment_ids)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention over [B, H, L, D] q, k, v with an optional [B, 1, 1, Lk]
    additive key bias and optional [B, L] segment ids (self-attention on
    packed rows), differentiable in q, k and v. CPU tensors take the plain
    versions; CUDA tensors the kernels, which raise on what they do not
    take."""
    return _FlashAttention.apply(q, k, v, bias, segment_ids)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Multi-head attention over [B, H, L, D] q, k, v with an optional
    additive bias and optional segment ids [B, L] (packed rows: attention
    within a segment, SEG_MASK across), through `flash_attention` (the
    CUDA kernel on the card, its plain version on the CPU). Counterpart of
    the JAX package's `kernels.attention.dot_product_attention`, whose
    callers give packed rows a dense mask instead of the ids.

    Heads narrower than 64, or not a multiple of 8, are zero-padded to
    max(64, ceil8(D)) with q pre-scaled by sqrt(D_pad / D), so the kernel's
    1/sqrt(D_pad) nets to 1/sqrt(D); the output is sliced back. A shape the
    kernel does not take (a [B, 1, Lq, Lk] or [B, H, Lq, Lk] bias, D over
    256) runs `reference_attention` on the CPU, as the JAX package does, and
    raises on the card: the port gives packed rows the ids, never a dense
    mask, there."""
    d = q.shape[-1]
    d_pad = max(MIN_HEAD_DIM, -(-d // 8) * 8)
    if d_pad != d:
        pad = (0, d_pad - d)
        q_p = torch.nn.functional.pad(q * (d_pad / d) ** 0.5, pad)
        k_p, v_p = (torch.nn.functional.pad(t, pad) for t in (k, v))
        if supports(q_p, k_p, v_p, bias, segment_ids):
            return flash_attention(q_p, k_p, v_p, bias, segment_ids)[..., :d]
    elif supports(q, k, v, bias, segment_ids):
        return flash_attention(q, k, v, bias, segment_ids)
    if q.device.type != "cpu":
        raise ValueError(
            f"dot_product_attention: the flash-attention kernel does not take "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}, segment_ids "
            f"{None if segment_ids is None else tuple(segment_ids.shape)} "
            f"(head dim a multiple of 8 up to {MAX_HEAD_DIM}, bias [B, 1, 1, "
            f"Lk], segment ids [B, L] with Lq = Lk = L)")
    return reference_attention(q, k, v, _with_segments(bias, segment_ids))
