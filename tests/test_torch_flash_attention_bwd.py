"""The FlashAttention-2 backward of the PyTorch port against the JAX
package, on the CPU in f32.

`flash_attention_bwd_plain` (the function of the dq and dk/dv kernels) on
the port's forward out and lse, against the vjp of the JAX Pallas
`flash_attention` in interpret mode (its `_bwd_dq_kernel` and
`_bwd_dkv_kernel`) and against the vjp of the JAX `reference_attention`;
the two kernels' own plain versions (the dq one with the backward's
prologue, the dk/dv one on its q_s and delta) against it; the autograd of
`flash_attention` and `dot_product_attention` (its padded branch at D = 24
included) against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from oneprot_tpu.kernels import attention as jattn
from oneprot_tpu.kernels import flash_attention as jfa
from oneprot_tpu_torch.kernels import flash_attention as fa

# f32 on the CPU: the kernels' bar in tests/test_kernels.py
RTOL, ATOL = 1e-4, 1e-5
# against the plain reference's autodiff, which takes another path (no
# base-2 lse, softmax's own vjp): tests/test_kernels.py's gradient bar
REF_RTOL, REF_ATOL = 1e-3, 1e-4


def _inputs(B, H, L, D, seed):
    """q, k, v [B, H, L, D] f32, a [B, 1, 1, L] key-padding bias (each row
    keeps a random prefix of at least L/2 keys) and an upstream gradient."""
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(4))
    lens = rng.randint(L // 2, L + 1, size=B)
    lens[0] = L // 2 + 3  # at least one row is padded
    valid = np.arange(L)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, dout


def _port_grads(q, k, v, bias, dout):
    t = [torch.from_numpy(a) for a in (q, k, v, bias, dout)]
    out, lse = fa.flash_attention_plain(*t[:4])
    return [g.numpy() for g in fa.flash_attention_bwd_plain(
        t[0], t[1], t[2], t[3], out, lse, t[4])]


def _jax_vjp(fn, q, k, v, bias, dout):
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, jnp.asarray(bias)),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("L", [128, 256])
def test_bwd_plain_matches_pallas_interpret(D, L):
    """The TPU kernels' own arithmetic: _bwd_dq_kernel and _bwd_dkv_kernel
    run in Pallas interpret mode on the CPU, on their own forward's lse."""
    q, k, v, bias, dout = _inputs(2, 2, L, D, seed=L + D)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_vjp(jfa.flash_attention, q, k, v, bias, dout)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              _port_grads(q, k, v, bias, dout), want):
        assert got.shape == (2, 2, L, D)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("L", [128, 256])
def test_bwd_plain_matches_reference_autodiff(D, L):
    q, k, v, bias, dout = _inputs(2, 2, L, D, seed=3 * L + D)
    want = _jax_vjp(jattn.reference_attention, q, k, v, bias, dout)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              _port_grads(q, k, v, bias, dout), want):
        np.testing.assert_allclose(got, ref, rtol=REF_RTOL, atol=REF_ATOL,
                                   err_msg=name)


def test_bwd_plain_without_bias_and_unequal_lengths():
    """No bias, Lq != Lk (an L the TPU kernel's tiling does not take):
    against the reference's autodiff."""
    rng = np.random.RandomState(9)
    q, dout = (rng.randn(1, 3, 40, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 3, 75, 64).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = fa.flash_attention_plain(*t[:3])
    got = fa.flash_attention_bwd_plain(t[0], t[1], t[2], None, out, lse, t[3])
    _, vjp = jax.vjp(lambda q, k, v: jattn.reference_attention(q, k, v),
                     *map(jnp.asarray, (q, k, v)))
    for name, g, ref in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=name)


def test_flash_attention_autograd_takes_the_plain_backward(monkeypatch):
    """On CPU tensors the autograd of flash_attention is
    flash_attention_bwd_plain on the saved out and lse, and the bias gets
    no gradient (the JAX vjp returns None for it)."""
    q, k, v, bias, dout = [torch.from_numpy(a) for a in
                           _inputs(2, 3, 48, 128, seed=11)]
    calls = []
    real = fa.flash_attention_bwd_plain

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    bias.requires_grad_()
    out = fa.flash_attention(*leaves, bias)
    grads = torch.autograd.grad(out, leaves, dout)
    assert len(calls) == 1
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, bias.detach())
    want = real(q, k, v, bias.detach(), ref_out, ref_lse, dout)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert bias.grad is None


@pytest.mark.parametrize("D,L", [(24, 130), (128, 96)])
def test_dot_product_attention_gradients_match_jax(D, L):
    """Gradients through dot_product_attention: D = 24 through the padded
    branch (q scaled by sqrt(64/24), zero-padded to 64, the output sliced
    back), 128 straight through the kernel's function; against the vjp of
    JAX's dot_product_attention (its reference path on the CPU)."""
    q, k, v, bias, dout = _inputs(2, 3, L, D, seed=L + 5 * D)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.dot_product_attention(*leaves, torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    want = _jax_vjp(lambda q, k, v, b: jattn.dot_product_attention(
        q, k, v, b, use_pallas=False), q, k, v, bias, dout)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (2, 3, L, D)
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,masked", [(64, False), (128, False), (128, True),
                                      (256, False)])
def test_plain_backward_from_the_prologue_equals_the_plain_backward(
        D, masked, dtype):
    """The two kernels' plain versions, the dk/dv one fed the q_s and delta
    that the dq one's prologue defines (q_s = q * 1/sqrt(D) in q's dtype,
    so bf16(1/sqrt(D)) for bf16, delta = rowsum(dout * out) in f32), give what
    flash_attention_bwd_plain gives, bit for bit; `masked`: every key of
    batch element 0 is masked, and the gradients stay finite."""
    q, k, v, bias, dout = _inputs(2, 2, 96, D, seed=D + masked)
    if masked:
        bias[0] = -1e9
    q, k, v, bias, dout = (torch.from_numpy(a).to(dtype)
                           for a in (q, k, v, bias, dout))
    bias = bias.float()
    out, lse = fa.flash_attention_plain(q, k, v, bias)
    dq, qs, delta = fa.flash_attention_bwd_dq_plain(q, k, v, bias, out, lse,
                                                    dout)
    assert qs.dtype == dtype and torch.equal(
        qs, q * torch.tensor(D ** -0.5, dtype=dtype))
    assert delta.dtype == torch.float32 and torch.equal(
        delta, (dout.float() * out.float()).sum(-1))
    dk, dv = fa.flash_attention_bwd_dkv_plain(qs, k, v, bias, dout, lse, delta)
    want = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype, name
        assert torch.isfinite(got.float()).all(), name
        assert torch.equal(got, ref), name


def test_backward_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="card"):
        fa.flash_attention_bwd_dq_cuda(x, x, x, None, x, lse, x)
    with pytest.raises(ValueError, match="card"):
        fa.flash_attention_bwd_dkv_cuda(x, x, x, None, x, lse, lse)
    with pytest.raises(ValueError, match="card"):
        fa.flash_attention_bwd_cuda(x, x, x, None, x, lse, x)
    with pytest.raises(ValueError):  # heads of 24 are the caller's to pad
        fa.flash_attention_bwd_dq_cuda(*(x[..., :24],) * 3, None, x[..., :24],
                                       lse, x[..., :24])
    with pytest.raises(ValueError, match="out"):  # out of another shape
        fa.flash_attention_bwd_dq_cuda(x, x, x, None, x[:, :, :8], lse, x)
