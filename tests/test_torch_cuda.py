"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch; the root
conftest imports JAX, hence `--noconftest` there:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from oneprot_tpu_torch.kernels import flash_mha, gelu_quant
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.models.esm2 import int8_matmul, rotary_cos_sin
from oneprot_tpu_torch.serving import OneProtEmbedder

FLASH_REL_TOL = 1.5e-2  # bf16: the JAX package's on-chip bar


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _attention_inputs(B, L, nh, d, card, seed, rotary, bias, segments):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, L, nh * d).astype(np.float32))
               .to(card, torch.bfloat16) for _ in range(3))
    lens = rng.randint(max(L // 2, 1), L + 1, size=B)
    valid = np.arange(L)[None, :] < lens[:, None]
    kw = {}
    if bias:
        kw["bias"] = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(
            np.float32)[:, None, None, :]).to(card)
    if rotary:
        kw["rope_cos"], kw["rope_sin"] = rotary_cos_sin(L, d, device=card)
    if segments:
        seg = np.minimum(np.arange(L)[None, :] * 3 // L, 2).repeat(B, 0)
        kw["segment_ids"] = torch.from_numpy(
            np.where(valid, seg, -1).astype(np.int32)).to(card)
    return q, k, v, kw


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,nh,d,rotary,bias,segments", [
    (2, 64, 20, 64, True, True, False),     # the hub's smallest bucket
    (2, 200, 4, 64, True, True, False),     # ragged edge: L % 64 != 0
    (1, 37, 4, 64, True, False, False),     # shorter than one tile
    (2, 256, 4, 64, True, True, True),      # packed rows
    (2, 384, 4, 64, False, True, False),    # no rotary
    (2, 128, 4, 64, False, False, False),   # no bias, no rotary
    (2, 300, 20, 24, True, True, False),    # 35M tower head width
    (2, 130, 8, 32, True, True, True),      # 150M head width
    (2, 96, 8, 16, True, True, False),      # 8M head width
])
def test_flash_kernel_matches_plain(card, B, L, nh, d, rotary, bias, segments):
    q, k, v, kw = _attention_inputs(B, L, nh, d, card, L + d, rotary, bias,
                                    segments)
    before = flash_mha.flash_mha_cuda.launches
    out, lse = flash_mha.mha_attention(q, k, v, nh, **kw)
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, nh, **kw)
    torch.cuda.synchronize()
    assert flash_mha.flash_mha_cuda.launches == before + 1
    assert out.shape == q.shape and lse.shape == (B, nh, L)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL
    if "bias" in kw and "segment_ids" in kw:  # padding rows' lse keep no digits
        rows = (kw["bias"][:, 0, 0] == 0)[:, None, :].expand_as(lse)
    else:
        rows = torch.ones_like(lse, dtype=torch.bool)
    assert (lse - ref_lse).abs()[rows].max().item() <= 5e-2


@pytest.mark.gpu
def test_flash_kernel_refuses(card):
    q = torch.zeros(1, 16, 8 * 12, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 12 is no multiple of 8
        flash_mha.mha_attention(q, q, q, 8)
    with pytest.raises(TypeError):
        flash_mha.mha_attention(q.float(), q.float(), q.float(), 2)
    x = torch.zeros(1, 16, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError):  # forward only
        flash_mha.mha_attention(x, x, x, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((256, 5120), torch.bfloat16),    # the hub's fc1 width
    ((3, 7, 128), torch.bfloat16),    # leading dims, esm2_tiny width
    ((64, 5120), torch.float32),
    ((64, 100), torch.bfloat16),      # N % 8 != 0: scalar path
    ((16, 10240), torch.bfloat16),    # 3B hub width: two-pass path
])
def test_gelu_quant_kernel_matches_plain(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    y = (torch.randn(shape, device=card, generator=gen) * 2).to(dtype)
    before = gelu_quant.gelu_quant_cuda.launches
    q, s = gelu_quant.fused_gelu_quant(y)
    q_ref, s_ref = gelu_quant.gelu_quant_reference(y)
    torch.cuda.synchronize()
    assert gelu_quant.gelu_quant_cuda.launches == before + 1
    assert q.shape == y.shape and s.shape == (*shape[:-1], 1)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=0)
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1
    assert diff.ne(0).float().mean().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("M", [3, 17, 300])
def test_int8_matmul_on_card_matches_cpu(card, M):
    """torch._int_mm wants more than 16 rows on the card; int8_matmul pads
    short inputs. Integer products are exact on both devices."""
    rng = np.random.RandomState(M)
    x_q = torch.from_numpy(rng.randint(-127, 128, (M, 64)).astype(np.int8))
    w_q = torch.from_numpy(rng.randint(-127, 128, (48, 64)).astype(np.int8))
    out = int8_matmul(x_q.to(card), w_q.to(card))
    assert out.shape == (M, 48) and out.dtype == torch.int32
    assert torch.equal(out.cpu(), int8_matmul(x_q, w_q))


@pytest.mark.gpu
def test_default_sequence_encoder_embeds_on_the_card(card):
    """`create_sequence_encoder()` with its defaults (ESM2-650M, bf16, on
    the card) embeds a batch through the flash-MHA kernel, one launch a
    block."""
    enc = encoders.create_sequence_encoder()
    esm2.init_esm2_weights_(enc, torch.Generator(device=card).manual_seed(0))
    embedder = OneProtEmbedder(encoders.OneProtModel({"sequence": enc}))
    before = flash_mha.flash_mha_cuda.launches
    feats = embedder.embed_sequences(["MKTAYIAKQRQISFVKSHFSRQ" * 5, "ACDEFGHIK"])
    assert flash_mha.flash_mha_cuda.launches == before + enc.config.num_layers
    assert feats.shape == (2, enc.config.hidden_size)  # no projection
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-2)
