"""The flash-MHA backward of the PyTorch port against jax.grad, on the CPU.

The same numpy inputs and upstream gradient go through jax.grad of the JAX
`mha_attention` (Pallas in interpret mode, for a few small shapes: it is
slow) or of its jnp oracle (rotary + segment bias + reference_attention),
and through the port: its plain backward `mha_attention_bwd_plain`, and
torch.autograd through `mha_attention` on CPU tensors, which runs that
plain backward. The upstream gradient is zero on the padding rows of
packed batches, as a loss over pooled segments gives it: there the oracle
(segments masked at -1e9) and the kernels (-1e30) attend to different keys
in the forward, and those rows are don't-care.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.kernels.attention import packed_segment_bias as jax_segbias
from oneprot_tpu.kernels.attention import reference_attention as jax_refattn
from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu.models.esm2 import apply_rotary as jax_apply_rotary
from oneprot_tpu.models.esm2 import rotary_cos_sin as jax_rotary
from oneprot_tpu_torch.kernels import flash_mha
from tests.test_torch_kernels import _inputs

# f32 on the CPU: only summation order differs between the frameworks
RTOL, ATOL = 1e-4, 1e-5


def _case(B, L, nh, d, rotary, segments, seed):
    q, k, v, bias, seg = _inputs(B, L, nh, d, seed=seed, segments=segments)
    cos = sin = None
    if rotary:
        cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))
    g = np.random.RandomState(seed + 1).randn(B, L, nh * d).astype(np.float32)
    g *= (bias[:, 0, 0, :, None] == 0)  # no gradient from padding rows
    return q, k, v, bias, cos, sin, seg, g


def _port_grads(q, k, v, nh, bias, cos, sin, seg, g):
    """(autograd through mha_attention, mha_attention_bwd_plain), each a
    (dq, dk, dv) of numpy arrays."""
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    side = dict(bias=t(bias), rope_cos=t(cos), rope_sin=t(sin),
                segment_ids=t(seg))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_mha.mha_attention(qt, kt, vt, nh, **side)
    auto = torch.autograd.grad(out, (qt, kt, vt), t(g))
    plain = flash_mha.mha_attention_bwd_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(), lse, t(g), nh,
        **side)
    return ([x.numpy() for x in auto], [x.numpy() for x in plain])


def _check(port, want):
    for grads in port:
        for name, got, ref in zip("qkv", grads, want):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL,
                                       atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("nh,d,rotary,segments", [
    (4, 24, True, True),     # the 35M tower's head width, packed rows
    (2, 16, False, False),   # 8M head width, no rotary
])
def test_plain_backward_matches_jax_interpret(nh, d, rotary, segments):
    B, L = 1, 128
    q, k, v, bias, cos, sin, seg, g = _case(B, L, nh, d, rotary, segments, 7)
    j = lambda x: None if x is None else jnp.asarray(x)

    def loss(q_, k_, v_):
        out = jax_mha(q_, k_, v_, nh, bias=j(bias), rope_cos=j(cos),
                      rope_sin=j(sin), segment_ids=j(seg), interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    _check(_port_grads(q, k, v, nh, bias, cos, sin, seg, g), want)


@pytest.mark.parametrize("nh,d,rotary,segments,L", [
    (4, 24, True, True, 100),    # tower width, packed, ragged length
    (4, 24, True, False, 64),
    (4, 16, True, True, 37),
    (4, 16, False, False, 128),  # no rotary
    (2, 32, True, True, 96),
    (2, 64, False, True, 48),    # hub width, packed, no rotary
])
def test_plain_backward_matches_jax_reference(nh, d, rotary, segments, L):
    q, k, v, bias, cos, sin, seg, g = _case(2, L, nh, d, rotary, segments, L)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_attention(q_, k_, v_, nh, bias, cos, sin, seg) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(_port_grads(q, k, v, nh, bias, cos, sin, seg, g), want)


def _jax_attention(q, k, v, nh, bias, cos, sin, seg):
    """The JAX oracle on [B, L, H*D]: rotary, the block-diagonal segment
    bias and reference_attention in [B, H, L, D]."""
    B, L, hd = q.shape
    d = hd // nh
    heads = lambda x: x.reshape(B, L, nh, d).transpose(0, 2, 1, 3)
    qh, kh, vh = heads(q), heads(k), heads(v)
    if cos is not None:
        qh, kh = (jax_apply_rotary(x, jnp.asarray(cos), jnp.asarray(sin))
                  for x in (qh, kh))
    b = jnp.asarray(bias)
    if seg is not None:
        b = jax_segbias(jnp.asarray(seg), b)
    out = jax_refattn(qh, kh, vh, b)
    return out.transpose(0, 2, 1, 3).reshape(B, L, hd)


def test_padding_rows_of_packed_rows_stay_finite():
    """A packed row's padding queries see only padding keys, at -1e9: their
    lse keeps none of the logits' digits. P is clamped at 1, so with any
    upstream gradient the plain backward stays finite."""
    nh, d, L = 2, 16, 64
    q, k, v, bias, seg = _inputs(2, L, nh, d, seed=3, segments=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    side = dict(bias=torch.from_numpy(bias), segment_ids=torch.from_numpy(seg))
    out, lse = flash_mha.mha_attention(*t, nh, **side)
    g = torch.from_numpy(np.random.RandomState(0).randn(*q.shape)
                         .astype(np.float32))
    grads = flash_mha.mha_attention_bwd_plain(*t, out, lse, g, nh, **side)
    assert all(torch.isfinite(x).all() for x in grads)


def test_no_gradient_reaches_the_side_inputs():
    nh, d, L = 2, 8, 16
    q, k, v, bias, seg = _inputs(1, L, nh, d, segments=True)
    qt = torch.from_numpy(q).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    out, _ = flash_mha.mha_attention(qt, torch.from_numpy(k),
                                     torch.from_numpy(v), nh, bias=b,
                                     segment_ids=torch.from_numpy(seg))
    out.sum().backward()
    assert qt.grad is not None and b.grad is None
