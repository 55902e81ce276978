"""The float32 paths of the card's attention, on the CPU.

The f32 instances of #1-#3 (`csrc/flash_mha_*_f32.cu`) run only on the
card (tests/test_torch_cuda.py holds them against their plain versions
there). Here: the plain versions they are held to, in f32 at the debug
hubs' head width 16 (ESM2-8M: 320 / 20) with rotary and packed rows and at
bert_tiny's 64 with a key bias and no rotary, against the JAX
`mha_attention` in Pallas interpret mode, forward and jax.grad, at 1e-4 /
1e-5; the build-time rule of which float32 models the card takes
(`check_card_dtype`); the launchers refusing CPU tensors; and the
zero-padding around #8 for heads narrower than 64, whose arithmetic (the
padded plain version on the true head dim's scale, cut back) equals the
unpadded plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu.models.esm2 import rotary_cos_sin as jax_rotary
from oneprot_tpu_torch.kernels import flash_mha
from oneprot_tpu_torch.kernels import tied_row_attention as tra
from oneprot_tpu_torch.models import bert, esm2
from tests.test_torch_kernels import _inputs

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("nh,d,rotary,segments", [
    (4, 16, True, True),     # the 8M debug hub's heads, packed rows
    (2, 64, False, False),   # bert_tiny: a key bias, no rotary
])
def test_f32_plain_matches_jax_interpret(nh, d, rotary, segments):
    B, L = 2, 64
    q, k, v, bias, seg = _inputs(B, L, nh, d, seed=d, segments=segments)
    cos = sin = None
    if rotary:
        cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))
    g = np.random.RandomState(d).randn(B, L, nh * d).astype(np.float32)
    g *= (bias[:, 0, 0, :, None] == 0)  # no gradient from padding rows
    j = lambda x: None if x is None else jnp.asarray(x)

    def jax_out(q_, k_, v_):
        return jax_mha(q_, k_, v_, nh, bias=j(bias), rope_cos=j(cos),
                       rope_sin=j(sin), segment_ids=j(seg), interpret=True)

    want = np.asarray(jax_out(j(q), j(k), j(v)))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_out(*a) * g),
                          argnums=(0, 1, 2))(j(q), j(k), j(v))
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    side = dict(bias=t(bias), rope_cos=t(cos), rope_sin=t(sin),
                segment_ids=t(seg))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_mha.mha_attention(qt, kt, vt, nh, **side)
    assert out.dtype == lse.dtype == torch.float32
    real = (bias[:, 0, 0, :] == 0)  # padding rows of packed rows differ
    np.testing.assert_allclose(out.detach().numpy()[real], want[real],
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(out, (qt, kt, vt), t(g))
    for name, got, ref in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


def test_card_takes_float32_where_the_f32_kernels_do():
    check = flash_mha.check_card_dtype
    for d in (8, 16, 24, 64):
        check("cuda", torch.float32, d)
    check("cuda", torch.bfloat16, 128)
    check("cpu", torch.float16, 12)
    for d in (12, 128):
        with pytest.raises(ValueError, match=f"heads of {d}"):
            check("cuda", torch.float32, d)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        check(torch.device("cuda"), torch.float16, 16)
    # the debug towers' sizes pass; the 15B width's heads of 128 do not
    for cfg in (esm2.ESM2_SIZES["esm2_t6_8M"], bert.BERT_SIZES["bert_tiny"]):
        check("cuda", torch.float32, cfg.hidden_size // cfg.num_heads)


def test_f32_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 32)
    lse = torch.zeros(1, 2, 8)
    for call in (lambda: flash_mha.flash_mha_cuda(x, x, x, 2),
                 lambda: flash_mha.flash_mha_bwd_dq_cuda(x, x, x, x, lse, x, 2),
                 lambda: flash_mha.flash_mha_bwd_dkv_cuda(x, x, x, x, lse,
                                                          lse, 2)):
        with pytest.raises(ValueError, match="on the card"):
            call()
    assert (flash_mha.flash_mha_f32_cuda.launches
            == flash_mha.flash_mha_bwd_dq_f32_cuda.launches
            == flash_mha.flash_mha_bwd_dkv_f32_cuda.launches == 0)


@pytest.mark.parametrize("R,L,nh,d", [(16, 37, 4, 16), (3, 64, 2, 8),
                                      (5, 20, 3, 56)])
def test_tied_row_zero_padding_is_exact(R, L, nh, d):
    """What the launcher does for heads narrower than 64: pad q, k, v with
    zero columns, keep the true head dim's scale, cut the output back. On
    the plain version that equals the unpadded function."""
    gen = torch.Generator().manual_seed(R + L + d)
    q, k, v = (torch.randn(2, R, L, nh * d, generator=gen) for _ in range(3))
    bias = torch.zeros(2, 1, 1, L)
    bias[1, ..., L - 5:] = -1e9
    want = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
    padded = [tra._pad_heads(t, nh) for t in (q, k, v)]
    assert padded[0].shape == (2, R, L, nh * tra.HEAD_DIM)
    assert padded[0].view(2, R, L, nh, 64)[..., d:].abs().max() == 0
    got = tra.tied_row_attention_plain(*padded, nh, col_bias=bias,
                                       scale=tra.tied_scale(d, R))
    got = got.view(2, R, L, nh, 64)[..., :d].reshape(2, R, L, nh * d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_tied_row_launcher_refuses():
    x = torch.zeros(1, 2, 8, 48)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        tra.tied_row_attention_cuda(x, x, x, 4)      # heads of 12
    y = torch.zeros(1, 2, 8, 128)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        tra.tied_row_attention_cuda(y, y, y, 1)      # heads of 128
    with pytest.raises(ValueError, match="on the card"):
        tra.tied_row_attention_cuda(y, y, y, 8)      # heads of 16, on the CPU
