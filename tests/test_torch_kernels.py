"""Kernels of the PyTorch port (oneprot_tpu_torch.kernels) against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function (Pallas in interpret
mode, or its jnp oracle) and the port's plain version, which is what the
port's wrappers run for a CPU tensor. The CUDA kernels themselves run only
on the card: tests/test_torch_cuda.py holds them against these plain
versions there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.kernels.attention import packed_segment_bias as jax_segbias
from oneprot_tpu.kernels.attention import reference_attention as jax_refattn
from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu.kernels.gelu_quant import gelu_quant_pallas
from oneprot_tpu.kernels.gelu_quant import gelu_quant_reference as jax_gq_ref
from oneprot_tpu.models.esm2 import apply_rotary as jax_apply_rotary
from oneprot_tpu.models.esm2 import rotary_cos_sin as jax_rotary
from oneprot_tpu_torch.kernels import _build
from oneprot_tpu_torch.kernels import attention as port_attn
from oneprot_tpu_torch.kernels import flash_mha, gelu_quant

# f32 on the CPU, the bar of the JAX package's own interpret-mode tests
# (tests/test_kernels.py): only summation order differs
RTOL, ATOL = 1e-4, 1e-5


def _inputs(B, L, nh, d, seed=0, segments=False):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, nh * d).astype(np.float32) for _ in range(3))
    lens = rng.randint(L // 2, L + 1, size=B)
    valid = np.arange(L)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    seg = None
    if segments:  # three contiguous proteins per row, padding its own id
        seg = np.minimum(np.arange(L)[None, :] * 3 // L, 2).repeat(B, 0)
        seg = np.where(valid, seg, -1).astype(np.int32)
    return q, k, v, bias, seg


def _port(q, k, v, nh, bias, cos, sin, seg):
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    return flash_mha.mha_attention(t(q), t(k), t(v), nh, bias=t(bias),
                                   rope_cos=t(cos), rope_sin=t(sin),
                                   segment_ids=t(seg))


def _jax_reference(q, k, v, nh, bias, cos, sin, seg):
    """JAX oracle: [B, H, L, D] reference_attention with rotary and the
    block-diagonal segment bias."""
    B, L, hd = q.shape
    d = hd // nh
    heads = lambda x: jnp.asarray(x).reshape(B, L, nh, d).transpose(0, 2, 1, 3)
    qh, kh, vh = heads(q), heads(k), heads(v)
    if cos is not None:
        qh, kh = (jax_apply_rotary(x, jnp.asarray(cos), jnp.asarray(sin))
                  for x in (qh, kh))
    b = None if bias is None else jnp.asarray(bias)
    if seg is not None:
        b = jax_segbias(jnp.asarray(seg), b)
    out = jax_refattn(qh, kh, vh, b)
    return np.asarray(out.transpose(0, 2, 1, 3).reshape(B, L, hd))


@pytest.mark.parametrize("nh,d,rotary,segments", [
    (4, 64, True, False),    # hub head shape
    (4, 64, False, False),   # no rotary
    (4, 64, True, True),     # packed rows
    (4, 32, True, True),     # 150M head width
    (4, 24, True, False),    # 35M tower: JAX pads 24 -> 32 half-wise
])
def test_mha_plain_matches_jax_interpret(nh, d, rotary, segments):
    B, L = 2, 128
    q, k, v, bias, seg = _inputs(B, L, nh, d, segments=segments)
    cos = sin = None
    if rotary:
        cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nh,
                  bias=jnp.asarray(bias),
                  rope_cos=None if cos is None else jnp.asarray(cos),
                  rope_sin=None if sin is None else jnp.asarray(sin),
                  segment_ids=None if seg is None else jnp.asarray(seg),
                  interpret=True)
    out, _ = _port(q, k, v, nh, bias, cos, sin, seg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("L", [128, 100, 64, 37])
@pytest.mark.parametrize("segments", [False, True])
def test_mha_plain_matches_jax_reference(L, segments):
    """Lengths that are no multiple of 128 (the serving bucket 64 among
    them) against the jnp oracle, which takes any L. With segments, rows of
    padding are left out: the oracle masks other segments at -1e9, as deep
    as the padding bias, while the kernels mask them at -1e30, so there the
    two average over different keys (rows past a length are don't-care,
    oneprot_tpu/kernels/flash_mha.py:351-353)."""
    nh, d = 4, 16
    q, k, v, bias, seg = _inputs(2, L, nh, d, seed=L, segments=segments)
    cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))
    out, lse = _port(q, k, v, nh, bias, cos, sin, seg)
    ref = _jax_reference(q, k, v, nh, bias, cos, sin, seg)
    rows = bias[:, 0, 0] == 0 if segments else np.ones((2, L), bool)
    np.testing.assert_allclose(out.numpy()[rows], ref[rows], rtol=RTOL,
                               atol=ATOL)
    assert lse.shape == (2, nh, L) and torch.isfinite(lse).all()


def test_mha_lse_is_base2_logsumexp():
    """lse [B, H, L] = log2 sum_k 2^(s_k log2 e), with s the scaled logits
    plus bias: the contract of the JAX kernel's lse output."""
    nh, d, L = 2, 8, 24
    q, k, v, bias, _ = _inputs(1, L, nh, d, seed=3)
    _, lse = _port(q, k, v, nh, bias, None, None, None)
    qh = q.reshape(1, L, nh, d).transpose(0, 2, 1, 3).astype(np.float64)
    kh = k.reshape(1, L, nh, d).transpose(0, 2, 1, 3).astype(np.float64)
    s = qh @ kh.transpose(0, 1, 3, 2) / math.sqrt(d) + bias
    m = s.max(-1, keepdims=True)
    ref = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / math.log(2)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5)


def test_mha_fully_masked_rows_stay_finite():
    nh, d, L = 2, 8, 16
    q, k, v, _, _ = _inputs(1, L, nh, d)
    bias = np.full((1, 1, 1, L), -1e9, np.float32)
    out, lse = _port(q, k, v, nh, bias, None, None, None)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_port_reference_attention_matches_jax():
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 3, 20, 8).astype(np.float32) for _ in range(3))
    seg = np.repeat(np.arange(20)[None, :] // 7, 2, 0).astype(np.int32)
    bias = np.zeros((2, 1, 1, 20), np.float32)
    bias[1, ..., 15:] = -1e9
    jb = jax_segbias(jnp.asarray(seg), jnp.asarray(bias))
    pb = port_attn.packed_segment_bias(torch.from_numpy(seg),
                                       torch.from_numpy(bias))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    ref = jax_refattn(*(jnp.asarray(x) for x in (q, k, v)), jb)
    out = port_attn.reference_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), pb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bad", ["head_dim_66", "odd_head_dim", "bias_shape",
                                 "rope_alone", "rope_shape", "seg_shape"])
def test_mha_rejects_what_the_kernel_does_not_take(bad):
    nh, d, L = 2, 8, 16
    q, k, v, bias, _ = _inputs(1, L, nh, d)
    cos = sin = seg = None
    if bad == "head_dim_66":
        q, k, v, bias, _ = _inputs(1, L, 1, 66)
        nh = 1
    elif bad == "odd_head_dim":
        q, k, v, bias, _ = _inputs(1, L, 2, 7)
    elif bad == "bias_shape":
        bias = bias[:, 0]
    elif bad == "rope_alone":
        cos = np.ones((L, d), np.float32)
    elif bad == "rope_shape":
        cos = sin = np.ones((L, d // 2), np.float32)
    else:
        seg = np.zeros((1, L + 1), np.int32)
    with pytest.raises(ValueError):
        _port(q, k, v, nh, bias, cos, sin, seg)


def test_mha_cpu_tensors_take_the_plain_version():
    nh, d, L = 2, 8, 16
    q, k, v, bias, _ = _inputs(1, L, nh, d)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    before = flash_mha.flash_mha_cuda.launches
    out, lse = flash_mha.mha_attention(*t, nh, bias=torch.from_numpy(bias))
    ref, ref_lse = flash_mha.mha_attention_plain(*t, nh,
                                                 bias=torch.from_numpy(bias))
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert flash_mha.flash_mha_cuda.launches == before


# ---------------------------------------------------------------------------
# GELU -> int8


def _codes_match(q, q_ref, max_share):
    """Codes equal, or off by one where f32 rounding of g / s lands on
    either side of a .5 tie; such flips stay rare."""
    diff = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    assert diff.max() <= 1
    assert np.mean(diff != 0) <= max_share


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gelu_quant_plain_matches_pallas_interpret(dtype):
    rng = np.random.RandomState(0)
    y = rng.randn(64, 256).astype(np.float32) * 3.0
    jy = jnp.asarray(y, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    q_ref, s_ref = gelu_quant_pallas(jy, bm=16, interpret=True)
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    if dtype == "bfloat16":
        ty = ty.to(torch.bfloat16)
    q, s = gelu_quant.fused_gelu_quant(ty)
    assert q.dtype == torch.int8 and s.shape == (64, 1)
    # the Pallas kernel's polynomial erf is within 1.5e-7 of erf, so the
    # scales agree to 1e-4 (the JAX package's own bar for it)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4)
    _codes_match(q.numpy(), np.asarray(q_ref), 0.01)


def test_gelu_quant_plain_matches_jax_reference():
    """Both in f32 with the exact erf: scales to f32 rounding, codes equal
    but for ulp-level gelu differences at .5 ties."""
    rng = np.random.RandomState(1)
    y = rng.randn(3, 5, 512).astype(np.float32) * 2.0
    q_ref, s_ref = jax_gq_ref(jnp.asarray(y))
    q, s = gelu_quant.fused_gelu_quant(torch.from_numpy(y))
    assert q.shape == (3, 5, 512) and s.shape == (3, 5, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    _codes_match(q.numpy(), np.asarray(q_ref), 1e-3)


def test_gelu_quant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        gelu_quant.fused_gelu_quant(torch.zeros(4, 8, dtype=torch.float16))


# ---------------------------------------------------------------------------
# No fallback: CUDA launchers refuse what is not on the card


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError):
        flash_mha.flash_mha_cuda(x.bfloat16(), x.bfloat16(), x.bfloat16(), 2)
    with pytest.raises(ValueError):
        gelu_quant.gelu_quant_cuda(x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means no kernels: the build raises instead of carrying on."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build_all.cache_clear()
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library("gelu_quant")
    finally:
        _build.build_all.cache_clear()
        _build.library.cache_clear()
