"""Flash multi-head attention, forward and backward, in the [B, L, H*D] layout.

Counterpart of oneprot_tpu/kernels/flash_mha.py:mha_attention and its custom
vjp. The wrapper `mha_attention` takes q, k, v as the QKV projections give
them, optional additive key bias [B, 1, 1, L], rotary tables [L, D] and
segment ids [B, L] (packed rows: attention is block-diagonal per segment),
and returns (out [B, L, H*D], lse [B, H, L]) with lse the base-2
log-sum-exp of the scaled logits. It is differentiable in q, k and v (no
gradient flows to the bias, the tables or the segment ids).

On CUDA tensors the forward launches the hand-written kernel of
`csrc/flash_mha_fwd.cu`, and the backward the dq kernel of
`csrc/flash_mha_bwd_dq.cu` (whose prologue writes q_r = rot(q) * q_pre and
delta = rowsum(dO * O)) and then the dk/dv kernel of
`csrc/flash_mha_bwd_dkv.cu` on them (bf16, head dim a multiple of 8 and at
most 64), or they raise. float32 tensors go to the f32 instances of
the three kernels (`csrc/flash_mha_*_f32.cu`: f32 FMA on the CUDA
cores, the same head dims); any other dtype raises. The backward kernels
skip the tiles of a packed row that share no segment
(`segment_tile_hits`). On CPU tensors they run
`mha_attention_plain` and `mha_attention_bwd_plain`, the same functions in
plain PyTorch with f32 logits and softmax.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from oneprot_tpu_torch.kernels import _build
from oneprot_tpu_torch.kernels.attention import (
    LOG2E,
    packed_segment_bias,
)

MAX_HEAD_DIM = 64
# added to a cross-segment logit, as in the TPU kernel: far below the -1e9
# key-padding bias, so a padded query row of a packed batch (its own
# segment id) attends to padding only, not to every key. The XLA fallback's
# `packed_segment_bias` masks at -1e9 and is kept so by default.
SEG_MASK = -1e30


def fused_mha_applies(head_dim: int) -> bool:
    """Whether an ESM2 layer with heads of `head_dim` takes the fused
    [B, L, H*D] path of `mha_attention`, as the JAX `fused_mha` does where
    it does not return None: heads of at most MAX_HEAD_DIM and even (its
    rotary pairs half with half). Wider heads go through
    `flash_attention.dot_product_attention`."""
    return head_dim <= MAX_HEAD_DIM and head_dim % 2 == 0


def check_card_dtype(device, dtype: torch.dtype, head_dim: int) -> None:
    """Refuse a model the card's attention kernels cannot run: bf16 runs
    every head width, float32 only the flash-MHA path's (`fused_mha_applies`
    and a multiple of 8), through the f32 instances of #1-#3."""
    if torch.device(device).type != "cuda" or dtype == torch.bfloat16:
        return
    if dtype != torch.float32:
        raise ValueError(f"dtype {dtype} on the card: the attention kernels "
                         "take bfloat16 or float32")
    if not fused_mha_applies(head_dim) or head_dim % 8:
        raise ValueError(f"float32 on the card with heads of {head_dim}: the "
                         "f32 attention kernels take head dims that are "
                         "multiples of 8 up to 64")


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, D]; cos, sin [L, D]."""
    return x * cos + rotate_half(x) * sin


def apply_rotary_t(g: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """The transpose (= inverse) rotation, R^T g = g cos - rotate_half(g) sin:
    takes a gradient from the rotated frame back to the input's."""
    return g * cos - rotate_half(g) * sin


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
    """The kernel's function in plain PyTorch (any device), with the TPU
    kernel's numerics: q_r = rot(q) * q_pre and rot(k) in the input dtype
    (`rotated_qk`), base-2 logits s = q_r rot(k)^T + bias * log2(e) in f32
    (-1e30 across segments), p = exp2(s - max) rounded to the input dtype
    before P V, the row sum clamped at 1e-30. Returns (out, base-2 lse)."""
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    dt = q.dtype
    qr, kr = rotated_qk(q, k, num_heads, rope_cos, rope_sin)
    s = _logits2(qr, kr, bias, segment_ids)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(dt).float(),
                       _heads(v, num_heads)) / l
    return _merge_heads(out, dt), (m + torch.log2(l))[..., 0]


def attention_delta(dout: torch.Tensor, out: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, f32 [B, H, L]: the backward's
    softmax correction (the plain versions'; on the card the dq kernel's
    prologue computes it)."""
    B, L, hd = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(B, L, num_heads, hd // num_heads).sum(-1).transpose(
        1, 2).contiguous()


def bwd_scales(head_dim: int, dtype: torch.dtype = torch.float32
               ) -> Tuple[float, float, float]:
    """(q_pre, dq_scale, dk_scale) of the kernels. q_r = rot(q) * q_pre,
    in the input dtype as the TPU kernels compute it, carries the softmax
    scale and log2(e), so q_r rot(k)^T is the base-2 logit; dq = R^T (dS
    rot(k)) * dq_scale; dk = R^T (dS^T q_r) * dk_scale, which takes q_r's
    log2(e) back out. q_pre is log2(e) / sqrt(D) rounded to `dtype`, as
    `jnp.asarray(scale * log2e, in_dtype)` rounds it; dq_scale and dk_scale
    stay f32, as the JAX kernels keep them. So q_pre * dk_scale = dq_scale
    in f32 and only approximately in bf16 (bf16(c) / c is 1.0018 at D = 64),
    as in the JAX package."""
    q_pre = LOG2E / math.sqrt(head_dim)
    if dtype != torch.float32:
        q_pre = float(torch.tensor(q_pre, dtype=dtype))
    return q_pre, 1.0 / math.sqrt(head_dim), 1.0 / LOG2E


def rotated_qk(q: torch.Tensor, k: torch.Tensor, num_heads: int,
               rope_cos: Optional[torch.Tensor] = None,
               rope_sin: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_r, rot(k)), [B, H, L, D] in the inputs' dtype: q_r = rot(q) *
    q_pre. As the TPU kernels compute them (`_apply_rot` on tables in the
    input dtype, then `q * jnp.asarray(scale * log2e, in_dtype)`), every
    product and sum is rounded to the input dtype: x * cos, rotate_half(x)
    * sin, their sum and the product with q_pre (in bf16, four roundings,
    not one). The forward kernel's q tile and the dq kernel's q_r."""
    dt = q.dtype
    q_pre = bwd_scales(q.shape[-1] // num_heads, dt)[0]
    q_pre = torch.tensor(q_pre, dtype=dt, device=q.device)
    return (_rotated(q, num_heads, rope_cos, rope_sin) * q_pre,
            _rotated(k, num_heads, rope_cos, rope_sin))


def _rotated(x, num_heads, rope_cos, rope_sin):
    """rot(x) [B, H, L, D] of x [B, L, H*D], each op rounded to x's dtype."""
    B, L, hd = x.shape
    xh = x.reshape(B, L, num_heads, hd // num_heads).transpose(1, 2)
    if rope_cos is None:
        return xh
    return apply_rotary(xh, rope_cos.to(x.dtype), rope_sin.to(x.dtype))


def _logits2(qr, kr, bias, segment_ids):
    """Base-2 logits in f32 [B, H, L, L]: q_r rot(k)^T plus the key bias in
    log2 units and -1e30 across segments."""
    s = torch.einsum("bhqd,bhkd->bhqk", qr.float(), kr.float())
    if bias is not None:
        s = s + bias.float() * LOG2E
    if segment_ids is not None:
        s = s + packed_segment_bias(segment_ids, mask_value=SEG_MASK)
    return s


def mha_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch (any device):
    q_r = rot(q) * q_pre and rot(k) as `rotated_qk` rounds them, s = q_r
    rot(k)^T + bias * log2(e) in f32, P recomputed from the forward's
    base-2 lse (clamped at 1, as the kernels do, so rows whose lse kept no
    digits stay finite), dS = P (dP - delta); P and dS rounded to the input
    dtype where the kernels feed them to a product; the scales of
    `bwd_scales`. Returns (dq, dk, dv) in the input dtype."""
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    dt = q.dtype
    _, dq_scale, dk_scale = bwd_scales(D, dt)
    qr, kr = (x.float() for x in rotated_qk(q, k, num_heads, rope_cos,
                                             rope_sin))
    vh, doh = _heads(v, num_heads), _heads(dout, num_heads)
    s = _logits2(qr, kr, bias, segment_ids)
    p = torch.exp2(torch.clamp_max(s - lse[..., None], 0.0))
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    ds = p * (dp - attention_delta(dout, out, num_heads)[..., None])
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * dq_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qr) * dk_scale
    if rope_cos is not None:
        cos, sin = _tables(rope_cos, rope_sin, dt)
        dq, dk = apply_rotary_t(dq, cos, sin), apply_rotary_t(dk, cos, sin)
    return _merge_heads(dq, dt), _merge_heads(dk, dt), _merge_heads(dv, dt)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*D] -> f32 [B, H, L, D]."""
    B, L, hd = x.shape
    return x.reshape(B, L, num_heads, hd // num_heads).transpose(1, 2).float()


def _merge_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D] in `dtype`."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D).to(dtype)


def _tables(rope_cos, rope_sin, dtype):
    """The rotary tables as the kernels take a gradient back through them:
    rounded to the inputs' dtype, computed with in f32; (None, None)
    without rotary."""
    if rope_cos is None:
        return None, None
    return rope_cos.to(dtype).float(), rope_sin.to(dtype).float()


def _bwd_probs(qr, k, v, dout, lse, delta, num_heads, bias, rope_cos,
               rope_sin, segment_ids):
    """(rot(k) in the input dtype, p, dS rounded to the input dtype), each
    f32 [B, H, L, *], from q_r [B, L, H*D] and the forward's lse."""
    dt = qr.dtype
    kr = _rotated(k, num_heads, rope_cos, rope_sin).float()
    s = _logits2(_heads(qr, num_heads), kr, bias, segment_ids)
    p = torch.exp2(torch.clamp_max(s - lse[..., None], 0.0))
    dp = torch.einsum("bhqd,bhkd->bhqk", _heads(dout, num_heads),
                      _heads(v, num_heads))
    ds = p * (dp - delta[..., None])
    return kr, p, ds.to(dt).float()


def flash_mha_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq kernel's function in plain PyTorch (any device), its
    prologue included: q_r = rot(q) * q_pre as `rotated_qk` rounds it (the
    forward's q tile) and delta = rowsum(dO * O) in f32, then dq as
    `mha_attention_bwd_plain` has it. Returns (dq, q_r [B, L, H*D], delta
    [B, H, L]), as `flash_mha_bwd_dq_cuda` does."""
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    dq_scale = bwd_scales(D, q.dtype)[1]
    qr = _merge_heads(rotated_qk(q, k, num_heads, rope_cos, rope_sin)[0],
                      q.dtype)
    delta = attention_delta(dout, out, num_heads)
    kr, _, ds = _bwd_probs(qr, k, v, dout, lse, delta, num_heads, bias,
                           rope_cos, rope_sin, segment_ids)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * dq_scale
    if rope_cos is not None:
        dq = apply_rotary_t(dq, *_tables(rope_cos, rope_sin, q.dtype))
    return _merge_heads(dq, q.dtype), qr, delta


def flash_mha_bwd_dkv_plain(
    q_r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch (any device), on q_r and
    delta as the dq kernel's prologue gives them. Returns (dk, dv)."""
    _, L, D = _check_args(q_r, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    dk_scale = bwd_scales(D, q_r.dtype)[2]
    _, p, ds = _bwd_probs(q_r, k, v, dout, lse, delta, num_heads, bias,
                          rope_cos, rope_sin, segment_ids)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q_r.dtype).float(),
                      _heads(dout, num_heads))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _heads(q_r, num_heads)) * dk_scale
    if rope_cos is not None:
        dk = apply_rotary_t(dk, *_tables(rope_cos, rope_sin, q_r.dtype))
    return _merge_heads(dk, k.dtype), _merge_heads(dv, v.dtype)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)
SKIP_TILE = 64  # rows of a tile of the backward kernels' skip rule
FWD_Q_TILE = 128  # query rows of a CTA of the forward kernel
_I32 = torch.iinfo(torch.int32)


def fwd_key_tile(head_dim: int) -> int:
    """Keys of a tile of the forward kernel: 64 for heads up to 32 wide
    (the 35M tower's packed rows skip finer), 128 up to 64."""
    return 64 if head_dim <= 32 else 128


def segment_tile_hits(segment_ids: torch.Tensor, tile: int = SKIP_TILE,
                      q_tile: Optional[int] = None) -> torch.Tensor:
    """The kernels' skip rule, bool [B, m, n] with m = ceil(L / q_tile)
    query blocks and n = ceil(L / tile) key tiles (q_tile defaults to tile,
    the flash-MHA backward's square tiles; its forward takes FWD_Q_TILE and
    `fwd_key_tile`). The FlashAttention-2 kernels (`flash_attention`) take
    the same rule at their own shapes: #5 `(seg, fwd_key_tile(D), BLOCK)`,
    #6 `(seg, TILE, BLOCK)`, #7 `(seg, TILE, dkv_key_block(D))` read key
    block first (its CTA holds the keys and streams query tiles of TILE);
    `csrc/segment_tiles.cuh` is the rule on the card. A block and a tile
    of a row are visited together when both hold padding (id -1) or when
    the ranges [min, max] of their other ids intersect. Disjoint ranges
    share no id, so a pair of equal ids always lies in a visited pair,
    whatever the order of the ids; with contiguous packing the rule is
    also tight. Rows past L count as neither (the int32 sentinels are the
    kernels')."""
    seg = segment_ids.to(torch.int32)
    B, L = seg.shape
    real = seg != -1

    def spans(rows):
        n = -(-L // rows)
        fill = lambda x, value: torch.cat(
            [x, torch.full((B, n * rows - L), value, dtype=x.dtype,
                           device=x.device)], 1).view(B, n, rows)
        return (fill(torch.where(real, seg, _I32.max), _I32.max).amin(-1),
                fill(torch.where(real, seg, _I32.min), _I32.min).amax(-1),
                fill(~real, False).any(-1))

    lo_k, hi_k, pad_k = spans(tile)
    lo_q, hi_q, pad_q = spans(tile if q_tile is None else q_tile)
    return ((pad_q[:, :, None] & pad_k[:, None, :])
            | ((lo_q[:, :, None] <= hi_k[:, None, :])
               & (lo_k[:, None, :] <= hi_q[:, :, None])))


def _kernel_args(tensors, num_heads, bias, rope_cos, rope_sin, segment_ids):
    """Check what the CUDA kernels take and make their side inputs: the key
    bias in log2 units (f32 [B, L]), rotary tables in the operands' dtype,
    int32 segment ids. `tensors` are the [B, L, H*D] operands (q first),
    which must be contiguous, 16-byte aligned bf16 or f32 (all of q's
    dtype) on q's card with a head dim that is a multiple of 8. Returns
    (B, L, D, bias_b, cos, sin, seg)."""
    q, k, v = tensors[:3]
    B, L, D = _check_args(q, k, v, num_heads, bias, rope_cos, rope_sin,
                          segment_ids)
    if D % 8:
        raise ValueError(f"head dim {D} unsupported by the kernel: must be a "
                         "multiple of 8")
    dev, dt = q.device, q.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"operands must be bfloat16 or float32, got {dt}")
    for i, t in enumerate(tensors):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"operand {i} must be on the card of q, got "
                             f"{t.device}")
        if t.dtype != dt:
            raise TypeError(f"operand {i} must be {dt} like q, got {t.dtype}")
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"operand {i} must be [B, L, H*D] like q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"operand {i} must be contiguous and 16-byte "
                             "aligned")
    bias_b = (None if bias is None else
              (bias.reshape(B, L).to(dev, torch.float32) * LOG2E).contiguous())
    cos, sin = ((None, None) if rope_cos is None else
                (t.to(dev, dt).contiguous() for t in (rope_cos, rope_sin)))
    seg = (None if segment_ids is None else
           segment_ids.to(dev, torch.int32).contiguous())
    return B, L, D, bias_b, cos, sin, seg


def _row_stats(t: torch.Tensor, B: int, H: int, L: int, dev) -> torch.Tensor:
    """lse or delta as the kernels read it: contiguous f32 [B, H, L]."""
    if tuple(t.shape) != (B, H, L) or t.device != dev:
        raise ValueError(f"row statistics must be [B, H, L] on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_mha_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel (with rotary, after its pass that writes
    rot(k) once); f32 operands launch its f32 instance. Returns (out,
    base-2 lse [B, H, L])."""
    B, L, D, bias_b, cos, sin, seg = _kernel_args(
        (q, k, v), num_heads, bias, rope_cos, rope_sin, segment_ids)
    if q.dtype == torch.float32:
        return flash_mha_f32_cuda(q, k, v, num_heads, B, L, D, bias_b, cos,
                                  sin, seg)
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    # rot(k), written once per (batch, head) by the kernel's first launch
    k_rot = None if cos is None else torch.empty_like(k)
    fn = _build.library("flash_mha_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_b),
                _ptr(cos), _ptr(sin), _ptr(seg), out.data_ptr(), lse.data_ptr(),
                _ptr(k_rot), B, L, num_heads, D,
                bwd_scales(D, torch.bfloat16)[0], dev.index, stream)
    _build.check(rc, "flash_mha_fwd")
    flash_mha_cuda.launches += 1
    return out, lse


flash_mha_cuda.launches = 0


def flash_mha_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dq kernel on bf16 CUDA tensors (out and lse from the
    forward; f32 operands launch its f32 instance). Its prologue writes
    what the dk/dv kernel reads. Returns (dq, q_r, delta): dq and q_r =
    rot(q) * q_pre in the operands' dtype, [B, L, H*D]; delta =
    rowsum(dout * out), f32 [B, H, L]."""
    B, L, D, bias_b, cos, sin, seg = _kernel_args(
        (q, k, v, out, dout), num_heads, bias, rope_cos, rope_sin, segment_ids)
    dev = q.device
    lse = _row_stats(lse, B, num_heads, L, dev)
    if q.dtype == torch.float32:
        return flash_mha_bwd_dq_f32_cuda(q, k, v, out, lse, dout, num_heads,
                                         B, L, D, bias_b, cos, sin, seg)
    dq, q_r = torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty((B, num_heads, L), dtype=torch.float32, device=dev)
    if dq.numel() == 0:
        return dq, q_r, delta
    q_pre, dq_scale, _ = bwd_scales(D, torch.bfloat16)
    fn = _build.library("flash_mha_bwd_dq")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), _ptr(bias_b), _ptr(cos), _ptr(sin), _ptr(seg),
                lse.data_ptr(), dq.data_ptr(), q_r.data_ptr(), delta.data_ptr(),
                B, L, num_heads, D, q_pre, dq_scale, dev.index, stream)
    _build.check(rc, "flash_mha_bwd_dq")
    flash_mha_bwd_dq_cuda.launches += 1
    return dq, q_r, delta


flash_mha_bwd_dq_cuda.launches = 0


def flash_mha_bwd_dkv_cuda(
    q_r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel on bf16 CUDA tensors (f32 operands launch
    its f32 instance), with q_r and delta as `flash_mha_bwd_dq_cuda`
    returns them. Returns (dk, dv), [B, L, H*D] in the operands' dtype."""
    B, L, D, bias_b, cos, sin, seg = _kernel_args(
        (q_r, k, v, dout), num_heads, bias, rope_cos, rope_sin, segment_ids)
    dev = q_r.device
    lse, delta = (_row_stats(t, B, num_heads, L, dev) for t in (lse, delta))
    if q_r.dtype == torch.float32:
        return flash_mha_bwd_dkv_f32_cuda(q_r, k, v, dout, lse, delta,
                                          num_heads, B, L, D, bias_b, cos,
                                          sin, seg)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    fn = _build.library("flash_mha_bwd_dkv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q_r.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(bias_b), _ptr(cos), _ptr(sin), _ptr(seg), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L,
                num_heads, D, bwd_scales(D)[2], dev.index, stream)
    _build.check(rc, "flash_mha_bwd_dkv")
    flash_mha_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_mha_bwd_dkv_cuda.launches = 0


def flash_mha_f32_cuda(q, k, v, num_heads, B, L, D, bias_b, cos, sin, seg):
    """The f32 instance of the forward, on `_kernel_args`'s side inputs."""
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    # q_r and rot(k), written once by the kernel's rotary pass
    q_rot, k_rot = (None, None) if cos is None else torch.empty(
        (2,) + tuple(q.shape), dtype=q.dtype, device=dev)
    fn = _build.library("flash_mha_fwd_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_b),
                _ptr(cos), _ptr(sin), _ptr(seg), out.data_ptr(), lse.data_ptr(),
                _ptr(q_rot), _ptr(k_rot), B, L, num_heads, D,
                bwd_scales(D)[0], dev.index, stream)
    _build.check(rc, "flash_mha_fwd_f32")
    flash_mha_f32_cuda.launches += 1
    return out, lse


def flash_mha_bwd_dq_f32_cuda(q, k, v, out, lse, dout, num_heads, B, L, D,
                              bias_b, cos, sin, seg):
    """The f32 instance of the dq kernel (prologue included)."""
    dev = q.device
    dq, q_r = torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty((B, num_heads, L), dtype=torch.float32, device=dev)
    if dq.numel() == 0:
        return dq, q_r, delta
    # rot(k), written once by the kernel's rotary pass
    k_rot = None if cos is None else torch.empty_like(k)
    q_pre, dq_scale, _ = bwd_scales(D)
    fn = _build.library("flash_mha_bwd_dq_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), _ptr(bias_b), _ptr(cos), _ptr(sin), _ptr(seg),
                lse.data_ptr(), dq.data_ptr(), q_r.data_ptr(), delta.data_ptr(),
                _ptr(k_rot), B, L, num_heads, D, q_pre, dq_scale, dev.index,
                stream)
    _build.check(rc, "flash_mha_bwd_dq_f32")
    flash_mha_bwd_dq_f32_cuda.launches += 1
    return dq, q_r, delta


def flash_mha_bwd_dkv_f32_cuda(q_r, k, v, dout, lse, delta, num_heads, B, L,
                               D, bias_b, cos, sin, seg):
    """The f32 instance of the dk/dv kernel."""
    dev = q_r.device
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    fn = _build.library("flash_mha_bwd_dkv_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q_r.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(bias_b), _ptr(cos), _ptr(sin), _ptr(seg), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L,
                num_heads, D, bwd_scales(D)[2], dev.index, stream)
    _build.check(rc, "flash_mha_bwd_dkv_f32")
    flash_mha_bwd_dkv_f32_cuda.launches += 1
    return dk, dv


# launches of the f32 instances, counted apart from the bf16 kernels'
flash_mha_f32_cuda.launches = 0
flash_mha_bwd_dq_f32_cuda.launches = 0
flash_mha_bwd_dkv_f32_cuda.launches = 0


def flash_mha_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, num_heads: int, **side,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: the dq kernel (prologue included), then the
    dk/dv kernel on its q_r and delta. Same arguments and result as
    `mha_attention_bwd_plain`."""
    dq, q_r, delta = flash_mha_bwd_dq_cuda(q, k, v, out, lse, dout, num_heads,
                                           **side)
    dk, dv = flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse, delta, num_heads,
                                    **side)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """mha_attention with the backward of the JAX package's custom vjp:
    saves q, k, v, out and lse; CPU tensors take the plain versions, CUDA
    tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, bias, rope_cos, rope_sin,
                segment_ids):
        fwd = mha_attention_plain if q.device.type == "cpu" else flash_mha_cuda
        out, lse = fwd(q, k, v, num_heads, bias=bias, rope_cos=rope_cos,
                       rope_sin=rope_sin, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, bias, rope_cos, rope_sin,
                              segment_ids)
        ctx.num_heads = num_heads
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, bias, rope_cos, rope_sin, segment_ids = (
            ctx.saved_tensors)
        bwd = (mha_attention_bwd_plain if q.device.type == "cpu"
               else flash_mha_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.num_heads,
                         bias=bias, rope_cos=rope_cos, rope_sin=rope_sin,
                         segment_ids=segment_ids)
        return dq, dk, dv, None, None, None, None, None


def mha_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash MHA on [B, L, H*D] q, k, v with optional in-kernel rotary,
    differentiable in q, k, v. CPU tensors take the plain versions; CUDA
    tensors the kernels, which raise on what they do not take."""
    return _FlashMHA.apply(q, k, v, num_heads, bias, rope_cos, rope_sin,
                           segment_ids)
