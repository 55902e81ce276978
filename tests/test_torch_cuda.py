"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch; the root
conftest imports JAX, hence `--noconftest` there:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from oneprot_tpu_torch.cli import train as cli_train
from oneprot_tpu_torch.core import config
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.datamodule import OneProtDataModule
from oneprot_tpu_torch.data.datasets.struct_token_dataset import (
    StructTokenDataset,
)
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.kernels import flash_mha, gelu_quant
from oneprot_tpu_torch.kernels import tied_row_attention as tra
from oneprot_tpu_torch.kernels.attention import fused_tied_row
from oneprot_tpu_torch.kernels.flash_attention import dot_product_attention
from oneprot_tpu_torch.models import bert, encoders, esm2
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
    (2, 300, 20, 24, True, True, True),     # the 35M tower, packed rows
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
    with pytest.raises(TypeError):  # bf16 or f32 only
        flash_mha.mha_attention(q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError):  # f32 too: no multiple of 8
        flash_mha.mha_attention(q.float(), q.float(), q.float(), 8)
    x = torch.zeros(1, 16, 64, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 16, device=card)
    with pytest.raises(ValueError):  # lse must be [B, H, L]
        flash_mha.flash_mha_bwd_dq_cuda(x, x, x, x, lse[:, :, :8], x, 1)
    with pytest.raises(TypeError):  # one dtype for every operand
        flash_mha.flash_mha_bwd_dkv_cuda(x, x, x, x.float(), lse, lse, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,nh,d,rotary,bias,segments", [
    (2, 300, 20, 24, True, True, True),     # the 35M tower, packed rows
    (2, 256, 4, 64, True, True, True),      # the hub's head width, packed
    (2, 200, 4, 64, True, True, False),     # ragged edge: L % 64 != 0
    (1, 37, 4, 32, True, False, False),     # shorter than one tile
    (2, 130, 8, 32, False, True, True),     # no rotary
    (2, 96, 8, 16, True, True, False),      # 8M head width
    (2, 128, 4, 64, False, False, False),   # no bias, no rotary
    (2, 300, 6, 8, True, True, True),       # D = 8, packed, L = 300
    (2, 300, 4, 40, True, True, True),      # D = 40: the 64-column instance
    (1, 3, 2, 24, True, True, False),       # three tokens
    (1, 2100, 2, 24, True, True, True),     # 33 tiles: the skip list in chunks
])
def test_flash_backward_kernels_match_plain(card, B, L, nh, d, rotary, bias,
                                            segments):
    """Gradients through mha_attention on the card (forward, dq and dk/dv
    kernels, one launch each) against the plain backward on the same
    inputs, out and lse. The upstream gradient is zero on padding rows,
    as a loss over pooled segments gives it."""
    q, k, v, kw = _attention_inputs(B, L, nh, d, card, 2 * L + d, rotary,
                                    bias, segments)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    rng = np.random.RandomState(L)
    dout = torch.from_numpy(rng.randn(B, L, nh * d).astype(np.float32)).to(card)
    if "bias" in kw:
        dout = dout * (kw["bias"][:, 0, 0, :, None] == 0)
    dout = dout.to(torch.bfloat16)
    counts = (flash_mha.flash_mha_bwd_dq_cuda.launches,
              flash_mha.flash_mha_bwd_dkv_cuda.launches)
    out, lse = flash_mha.mha_attention(q, k, v, nh, **kw)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = flash_mha.mha_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                            out.detach(), lse, dout, nh, **kw)
    torch.cuda.synchronize()
    assert (flash_mha.flash_mha_bwd_dq_cuda.launches,
            flash_mha.flash_mha_bwd_dkv_cuda.launches) == (counts[0] + 1,
                                                         counts[1] + 1)
    for name, got, want in zip("qkv", grads, ref):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got.float()).all(), f"d{name}: non-finite"
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= FLASH_REL_TOL, f"d{name}: max rel err {rel}"


def _ragged_packed_rows(card, L, nh, d, seed, shuffled):
    """Rows from `packing.pack_token_rows` at length L: ragged proteins
    (segment edges off the 64-grid), one row a single protein, a last tile
    that mixes a protein and padding; `shuffled` permutes each row's ids
    (padding included), so segments are no longer contiguous."""
    rng = np.random.RandomState(seed)
    lengths = [L - 20, 61, 90, 47, 130, 29, 75, L // 2 - 5, 52]
    toks = [np.full(n, 5, np.int32) for n in lengths]
    _, seg, _, rows = packing.pack_token_rows(toks, L, 4)
    assert any(len(r) == 1 for r in rows) and (seg[:, -1] == -1).any()
    if shuffled:
        seg = np.stack([rng.permutation(r) for r in seg])
    B = seg.shape[0]
    q, k, v = (torch.from_numpy(rng.randn(B, L, nh * d).astype(np.float32))
               .to(card, torch.bfloat16) for _ in range(3))
    kw = {"bias": torch.from_numpy(np.where(seg >= 0, 0.0, -1e9).astype(
              np.float32)[:, None, None, :]).to(card),
          "segment_ids": torch.from_numpy(seg).to(card)}
    kw["rope_cos"], kw["rope_sin"] = rotary_cos_sin(L, d, device=card)
    dout = (torch.from_numpy(rng.randn(B, L, nh * d).astype(np.float32))
            .to(card) * kw["bias"][:, 0, 0, :, None].eq(0)).to(torch.bfloat16)
    return q, k, v, kw, dout


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 24, 40, 64])
@pytest.mark.parametrize("L,shuffled", [(300, False), (300, True),
                                        (1024, False)])
def test_flash_backward_kernels_on_ragged_packed_rows(card, d, L, shuffled):
    """The dq kernel (dq, q_r, delta) against its plain version and the
    dk/dv kernel against its own on the kernel's q_r and delta; the whole
    card backward against the plain backward; one launch each."""
    nh = 4
    q, k, v, kw, dout = _ragged_packed_rows(card, L, nh, d, L + d, shuffled)
    out, lse = flash_mha.flash_mha_cuda(q, k, v, nh, **kw)
    counts = (flash_mha.flash_mha_bwd_dq_cuda.launches,
              flash_mha.flash_mha_bwd_dkv_cuda.launches)
    dq, q_r, delta = flash_mha.flash_mha_bwd_dq_cuda(q, k, v, out, lse, dout,
                                                    nh, **kw)
    dk, dv = flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse, delta, nh,
                                              **kw)
    assert (flash_mha.flash_mha_bwd_dq_cuda.launches,
            flash_mha.flash_mha_bwd_dkv_cuda.launches) == (counts[0] + 1,
                                                         counts[1] + 1)
    ref_dq, ref_qr, ref_delta = flash_mha.flash_mha_bwd_dq_plain(
        q, k, v, out, lse, dout, nh, **kw)
    ref_dk, ref_dv = flash_mha.flash_mha_bwd_dkv_plain(q_r, k, v, dout, lse,
                                                       delta, nh, **kw)
    whole = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, nh,
                                              **kw)
    torch.cuda.synchronize()
    assert torch.equal(q_r, ref_qr), "q_r is not bf16(rot(q) * q_pre)"
    rel = ((delta - ref_delta).abs().max() / ref_delta.abs().max()).item()
    assert rel <= FLASH_REL_TOL, f"delta: max rel err {rel}"
    for name, got, want, plain in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      (ref_dq, ref_dk, ref_dv), whole):
        assert torch.isfinite(got.float()).all(), f"{name}: non-finite"
        for ref in (want, plain):
            rel = ((got.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            assert rel <= FLASH_REL_TOL, f"{name}: max rel err {rel}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((256, 5120), torch.bfloat16),    # the hub's fc1 width
    ((3, 7, 128), torch.bfloat16),    # leading dims, esm2_tiny width
    ((64, 5120), torch.float32),
    ((64, 100), torch.bfloat16),      # N % 8 != 0: scalar path
    ((16, 10240), torch.bfloat16),    # 3B hub width
    ((64, 20480), torch.bfloat16),    # 15B hub width
    ((16384, 20480), torch.bfloat16),  # 15B hub width, a batch of 32 x 512
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


# ---------------------------------------------------------------------------
# tied-row attention (the MSA tower's row attention)


def _tied_inputs(B, R, L, nh, card, seed, masked_tail):
    """q, k, v [B, R, L, nh*64] bf16 and a column bias [B, 1, 1, L] of -1e9
    on the last `masked_tail` columns: one count for every batch element,
    or a tuple of one count each."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(B, R, L, nh * 64, device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(B, 1, 1, L, device=card)
    tails = masked_tail if isinstance(masked_tail, tuple) else (masked_tail,) * B
    for b, tail in enumerate(tails):
        bias[b, ..., L - tail:] = -1e9
    return q, k, v, bias


def _serving_tails(L):
    """Padded tails of four MSAs in one bucket of L columns: none, a third
    (part of a key tile), all but column 0, and every column."""
    return (0, L // 3 + 1, L - 1, L)


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,L,nh,masked_tail", [
    (4, 16, 1024, 12, 0),    # embed_msas: depth 16, the widest bucket
    (4, 50, 1024, 12, 0),    # the MSA data config's depth
    (2, 16, 300, 3, 17),     # off the tile grid, odd heads, masked tail
    (1, 1, 1, 1, 0),         # one row, one column
    (2, 3, 64, 2, 5),        # the smallest bucket
] + [
    # every serving bucket at depths 1, 16 and 50, each batch element with
    # its own padded tail (key tiles of padding alone are skipped)
    (4, R, L, 2, _serving_tails(L))
    for L in (64, 128, 256, 512, 1024) for R in (1, 16, 50)
])
def test_tied_row_kernel_matches_plain(card, B, R, L, nh, masked_tail):
    q, k, v, bias = _tied_inputs(B, R, L, nh, card, L + R, masked_tail)
    before = tra.tied_row_attention_cuda.launches
    out = fused_tied_row(q, k, v, nh, col_bias=bias)
    ref = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
    torch.cuda.synchronize()
    assert tra.tied_row_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL


@pytest.mark.gpu
def test_tied_row_kernel_refuses(card):
    x = torch.zeros(1, 2, 16, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 128: above 64
        fused_tied_row(x, x, x, 1)
    with pytest.raises(ValueError):  # head dim 12: no multiple of 8
        y = x[..., :48].contiguous()
        fused_tied_row(y, y, y, 4)
    with pytest.raises(TypeError):
        fused_tied_row(x.float(), x.float(), x.float(), 2)
    q = x.clone().requires_grad_()
    out = fused_tied_row(q, x, x, 2)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,L,nh,d,masked_tail", [
    (2, 16, 300, 4, 16, 17),   # the debug MSA tower's heads of 16
    (2, 3, 64, 2, 8, 5),
    (1, 50, 1024, 12, 32, 0),
    (4, 8, 128, 4, 16, _serving_tails(128)),
])
def test_tied_row_kernel_pads_narrow_heads(card, B, R, L, nh, d, masked_tail):
    """Heads narrower than 64 are zero-padded around the one kernel launch,
    the scale taken from the true head dim."""
    q, k, v, bias = _tied_inputs(B, R, L, nh, card, L + R + d, masked_tail)
    q, k, v = (t.view(B, R, L, nh, 64)[..., :d].reshape(B, R, L, nh * d)
               for t in (q, k, v))
    before = tra.tied_row_attention_cuda.launches
    out = fused_tied_row(q, k, v, nh, col_bias=bias)
    ref = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
    torch.cuda.synchronize()
    assert tra.tied_row_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL


# ---------------------------------------------------------------------------
# the f32 instances of #1-#3 (the float32 debug towers)

F32_REL_TOL, F32_LSE_TOL = 1e-4, 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,nh,d,rotary,bias,segments", [
    (2, 96, 20, 16, True, True, False),     # the 8M hub's heads
    (2, 300, 20, 16, True, True, True),     # packed rows, L off the grid
    (2, 128, 2, 64, False, True, False),    # bert_tiny: key bias, no rotary
    (1, 37, 4, 8, True, False, False),      # shorter than one tile
    (2, 200, 4, 24, True, True, True),
    (2, 130, 2, 40, False, False, True),
    (1, 3, 2, 56, True, True, False),       # three tokens
])
def test_f32_kernels_match_plain(card, B, L, nh, d, rotary, bias, segments):
    """The f32 forward, dq and dk/dv kernels (one launch each) against the
    plain versions in f32 on the same inputs: max rel err <= 1e-4, the
    lse within 1e-5 on the rows that keep digits."""
    q, k, v, kw = _attention_inputs(B, L, nh, d, card, 3 * L + d, rotary,
                                    bias, segments)
    q, k, v = (t.float().requires_grad_() for t in (q, k, v))
    if rotary:
        kw["rope_cos"], kw["rope_sin"] = (t.float() for t in (
            kw["rope_cos"], kw["rope_sin"]))
    dout = torch.from_numpy(np.random.RandomState(L).randn(
        B, L, nh * d).astype(np.float32)).to(card)
    counts = [f.launches for f in F32_KERNELS]
    out, lse = flash_mha.mha_attention(q, k, v, nh, **kw)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    args = (q.detach(), k.detach(), v.detach())
    ref, ref_lse = flash_mha.mha_attention_plain(*args, nh, **kw)
    ref_grads = flash_mha.mha_attention_bwd_plain(*args, out.detach(), lse,
                                                  dout, nh, **kw)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(F32_KERNELS, counts)] == [1, 1, 1]
    for name, got, want in [("out", out, ref)] + list(zip(
            ("dq", "dk", "dv"), grads, ref_grads)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= F32_REL_TOL, f"{name}: max rel err {rel}"
    # padded rows of packed rows see only -1e9-biased keys: no digits kept
    rows = ref_lse.abs() < 1e6
    assert (lse - ref_lse).abs()[rows].max().item() <= F32_LSE_TOL


F32_KERNELS = (flash_mha.flash_mha_f32_cuda,
               flash_mha.flash_mha_bwd_dq_f32_cuda,
               flash_mha.flash_mha_bwd_dkv_f32_cuda)


# ---------------------------------------------------------------------------
# FlashAttention-2 forward (heads of 64 to 256: the ESM2-15B width)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 24, 40, 64])
@pytest.mark.parametrize("L,shuffled", [(300, False), (300, True),
                                        (1024, False)])
def test_flash_forward_kernel_on_ragged_packed_rows(card, d, L, shuffled):
    """The forward kernel (its key tiles skipped by the segment rule) against
    mha_attention_plain on rows from `pack_token_rows`: ragged proteins off
    the tile grid, shuffled ids (segments no longer contiguous), heads of
    8-64 (D = 8 and 24 on the 32-column instance, 40 and 64 on the
    64-column one); lse on real rows (a padding row's keep no digits)."""
    nh = 4
    q, k, v, kw, _ = _ragged_packed_rows(card, L, nh, d, 7 * L + d, shuffled)
    before = flash_mha.flash_mha_cuda.launches
    out, lse = flash_mha.flash_mha_cuda(q, k, v, nh, **kw)
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, nh, **kw)
    torch.cuda.synchronize()
    assert flash_mha.flash_mha_cuda.launches == before + 1
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL, f"out: max rel err {rel}"
    rows = (kw["segment_ids"] >= 0)[:, None, :].expand_as(lse)
    assert (lse - ref_lse).abs()[rows].max().item() <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("d,segments", [(24, True), (64, True), (64, False)])
def test_flash_forward_lse_feeds_the_backward_unchanged(card, d, segments):
    """Through _FlashMHA the backward kernels get the forward kernel's lse
    as it is: the lse mha_attention returns equals flash_mha_cuda's, and the
    gradients autograd gives equal flash_mha_bwd_cuda's on that lse, bit
    for bit."""
    q, k, v, kw = _attention_inputs(2, 300, 4, d, card, d, True, True,
                                    segments)
    rng = np.random.RandomState(d)
    dout = (torch.from_numpy(rng.randn(2, 300, 4 * d).astype(np.float32))
            .to(card) * (kw["bias"][:, 0, 0, :, None] == 0)).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = flash_mha.mha_attention(*leaves, 4, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    out2, lse2 = flash_mha.flash_mha_cuda(q, k, v, 4, **kw)
    want = flash_mha.flash_mha_bwd_cuda(q, k, v, out2, lse2, dout, 4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for name, got, ref in zip("qkv", grads, want):
        assert torch.equal(got, ref), f"d{name}"


@pytest.mark.gpu
@pytest.mark.parametrize("d", [24, 64])
def test_flash_backward_kernels_at_one_token(card, d):
    """L = 1: one key, so p = 1, out = v and dS = p (dO v - delta) = 0; dq
    and dk are 0 up to the rounding of two f32 dot products of one row
    (an absolute bound: their reference is 0), dv = dO (the relative
    bar)."""
    q, k, v, kw = _attention_inputs(3, 1, 4, d, card, 11 + d, True, True,
                                    False)
    dout = torch.from_numpy(np.random.RandomState(d).randn(3, 1, 4 * d)
                            .astype(np.float32)).to(card, torch.bfloat16)
    out, lse = flash_mha.flash_mha_cuda(q, k, v, 4, **kw)
    dq, dk, dv = flash_mha.flash_mha_bwd_cuda(q, k, v, out, lse, dout, 4, **kw)
    ref = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, 4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, v)
    scale = dout.float().abs().max().item() * v.float().abs().max().item()
    for name, got in (("dq", dq), ("dk", dk)):
        assert torch.isfinite(got.float()).all(), f"{name}: non-finite"
        assert got.float().abs().max().item() <= 1e-3 * scale, name
    rel = ((dv.float() - ref[2].float()).abs().max()
           / ref[2].float().abs().max()).item()
    assert rel <= FLASH_REL_TOL, f"dv: max rel err {rel}"


def _fa_inputs(B, H, Lq, Lk, D, card, seed, layout):
    """q [B, H, Lq, D], k, v [B, H, Lk, D] bf16 and a key-padding bias.
    layout "heads": views of [B, L, H*D] projections, as the ESM2 layer
    hands them over; "contiguous": [B, H, L, D] tensors."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def make(L):
        x = torch.randn(B, L, H * D, device=card, generator=gen)
        x = x.to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
        return x if layout == "heads" else x.contiguous()

    q, k, v = make(Lq), make(Lk), make(Lk)
    lens = torch.randint(max(Lk // 2, 1), Lk + 1, (B,), device=card,
                         generator=gen)
    valid = torch.arange(Lk, device=card)[None, :] < lens[:, None]
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    return q, k, v, bias


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Lq,Lk,D,layout,biased", [
    (2, 4, 256, 256, 128, "heads", True),       # the 15B head width
    (2, 4, 300, 300, 128, "heads", True),       # ragged: L % 64 != 0
    (2, 4, 1024, 1024, 64, "contiguous", True),
    (2, 2, 1024, 1024, 256, "heads", True),
    (1, 3, 37, 37, 256, "contiguous", False),   # shorter than one tile
    (2, 3, 130, 77, 96, "contiguous", True),    # Lq != Lk; D between instances
    (1, 1, 1, 1, 128, "heads", False),          # one query, one key
    (2, 4, 200, 333, 64, "heads", True),        # Lq < Lk, off the key tiles
    (2, 4, 333, 129, 128, "heads", True),       # Lq > Lk, one key past a tile
    (2, 2, 70, 300, 256, "heads", True),        # Lq != Lk at 256
    (2, 3, 1, 1, 64, "contiguous", True),       # L = 1 at 64
    (1, 2, 1, 1, 256, "heads", True),           # L = 1 at 256
])
def test_flash_attention_kernel_matches_plain(card, B, H, Lq, Lk, D, layout,
                                              biased):
    q, k, v, bias = _fa_inputs(B, H, Lq, Lk, D, card, Lq + D, layout)
    bias = bias if biased else None
    before = fa.flash_attention_fwd_cuda.launches
    out = fa.flash_attention(q, k, v, bias)
    got, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_cuda.launches == before + 2
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, got)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL
    assert (lse - ref_lse).abs().max().item() <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D,L", [(64, 300), (128, 1024), (256, 200)])
def test_flash_attention_forward_all_keys_masked(card, D, L):
    """A batch element whose keys are all masked (bias -1e9 everywhere):
    the row max starts at -1e30 and the logits sit near -1.44e9, so every
    key weighs the same and out is the mean of v, finite, as in the plain
    version; lse near -1.44e9."""
    q, k, v, bias = _fa_inputs(2, 3, L, L, D, card, D + 2 * L, "heads")
    bias[0] = -1e9
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL, f"out: max rel err {rel}"
    assert (lse[1] - ref_lse[1]).abs().max().item() <= 5e-2
    assert (lse[0] / ref_lse[0] - 1).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Lq,Lk,D,layout,biased", [
    (2, 4, 256, 256, 128, "heads", True),       # the 15B head width
    (2, 4, 300, 300, 128, "heads", True),       # ragged: L % 64 != 0
    (2, 4, 1024, 1024, 64, "contiguous", True),
    (2, 2, 512, 512, 256, "heads", True),       # dk/dv's split-D instance
    (1, 3, 37, 37, 256, "contiguous", False),   # shorter than one tile
    (2, 3, 130, 77, 96, "contiguous", True),    # Lq != Lk; D between instances
    (1, 1, 1, 5, 128, "heads", False),          # one query (with one key, dq
])                                              # and dk are 0)
def test_flash_attention_backward_kernels_match_plain(card, B, H, Lq, Lk, D,
                                                      layout, biased):
    """Gradients through flash_attention on the card (the forward, dq and
    dk/dv kernels, one launch each) against flash_attention_bwd_plain on
    the same inputs, out and lse; dq, dk and dv come back in the [B, L, H,
    D] order of the projections."""
    q, k, v, bias = _fa_inputs(B, H, Lq, Lk, D, card, 3 * Lq + D, layout)
    bias = bias if biased else None
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    gen = torch.Generator(device=card).manual_seed(Lk)
    dout = torch.randn(B, Lq, H, D, device=card, generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    counts = (fa.flash_attention_bwd_dq_cuda.launches,
              fa.flash_attention_bwd_dkv_cuda.launches)
    out = fa.flash_attention(q, k, v, bias)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    _, lse = fa.flash_attention_fwd_cuda(q.detach(), k.detach(), v.detach(),
                                         bias)
    ref = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       bias, out.detach(), lse, dout)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq_cuda.launches,
            fa.flash_attention_bwd_dkv_cuda.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    for name, got, want in zip("qkv", grads, ref):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert got.transpose(1, 2).is_contiguous(), f"d{name} layout"
        assert torch.isfinite(got.float()).all(), f"d{name}: non-finite"
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= FLASH_REL_TOL, f"d{name}: max rel err {rel}"


def _check_backward_kernels(q, k, v, bias, dout):
    """The dq kernel (prologue included) against flash_attention_bwd_dq_plain
    (dq, q_s, delta), the dk/dv kernel on the dq kernel's q_s and delta
    against flash_attention_bwd_dkv_plain, and both against
    flash_attention_bwd_plain; everything finite."""
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
    dq, qs, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                   dout)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout, lse, delta)
    ref_dq, ref_qs, ref_delta = fa.flash_attention_bwd_dq_plain(
        q, k, v, bias, out, lse, dout)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(qs, k, v, bias, dout,
                                                      lse, delta)
    whole = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(qs, ref_qs), "q_s"
    assert qs.transpose(1, 2).is_contiguous(), "q_s layout"
    assert torch.isfinite(delta).all(), "delta: non-finite"
    assert (delta - ref_delta).abs().max().item() <= 1e-3 * max(
        ref_delta.abs().max().item(), 1.0), "delta"
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                            ("dv", dv, ref_dv), ("dq", dq, whole[0]),
                            ("dk", dk, whole[1]), ("dv", dv, whole[2])):
        assert torch.isfinite(got.float()).all(), f"{name}: non-finite"
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max().clamp_min(1e-6)).item()
        assert rel <= FLASH_REL_TOL, f"{name}: max rel err {rel}"


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 384, 512, 768])
def test_flash_attention_backward_kernels_at_the_lora_buckets(card, L):
    """#6 and #7 at the LoRA-15B step's other buckets (heads of 128, views
    of [B, L, H*D] projections, a key-padding bias), each kernel against
    its own plain version and the pair against the whole plain backward."""
    q, k, v, bias = _fa_inputs(2, 4, L, L, 128, card, L, "heads")
    gen = torch.Generator(device=card).manual_seed(L + 1)
    dout = torch.randn(2, L, 4, 128, device=card, generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    _check_backward_kernels(q, k, v, bias, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("D,L", [(128, 300), (64, 256), (256, 200)])
def test_flash_attention_backward_all_keys_masked(card, D, L):
    """A batch element whose keys are all masked (bias -1e9 everywhere, lse
    near -1.44e9) comes out finite and right: keys past Lk must not take
    TMA's zero fill as their bias, or p = exp2(0 - lse) = inf there."""
    q, k, v, bias = _fa_inputs(2, 3, L, L, D, card, D + L, "heads")
    bias[0] = -1e9
    gen = torch.Generator(device=card).manual_seed(D)
    dout = torch.randn(2, L, 3, D, device=card, generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    _check_backward_kernels(q, k, v, bias, dout)


@pytest.mark.gpu
def test_flash_attention_backward_takes_any_upstream_layout(card):
    """An upstream gradient the kernels cannot read as it is (out.sum()'s
    is an expanded scalar, stride 0 over D) is made contiguous first."""
    q, k, v, bias = _fa_inputs(2, 3, 100, 100, 128, card, 5, "heads")
    q = q.detach().requires_grad_()
    fa.flash_attention(q, k, v, bias).sum().backward()
    torch.cuda.synchronize()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad.float()).all()


@pytest.mark.gpu
def test_dot_product_attention_pads_small_heads_on_the_card(card):
    """Heads of 24 (the 35M tower's width) reach the kernel zero-padded to
    64, q pre-scaled by sqrt(64/24)."""
    q, k, v, bias = _fa_inputs(2, 4, 200, 200, 24, card, 24, "heads")
    before = fa.flash_attention_fwd_cuda.launches
    out = dot_product_attention(q, k, v, bias)
    ref = fa.flash_attention_plain(q, k, v, bias)[0]
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_cuda.launches == before + 1
    assert out.shape == q.shape
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= FLASH_REL_TOL


@pytest.mark.gpu
def test_flash_attention_kernel_refuses(card):
    x = torch.zeros(1, 2, 16, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention(x.float(), x.float(), x.float())
    with pytest.raises(ValueError):  # head dim 264
        fa.flash_attention_fwd_cuda(*(torch.zeros(1, 2, 16, 264, device=card,
                                                  dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError):  # dense bias: the card has no such path
        dot_product_attention(x, x, x, torch.zeros(1, 1, 16, 16, device=card))
    with pytest.raises(ValueError):  # no unit stride over the head dim
        fa.flash_attention_fwd_cuda(x.transpose(2, 3), x.transpose(2, 3),
                                    x.transpose(2, 3))
    lse = torch.zeros(1, 2, 16, device=card)
    with pytest.raises(ValueError):  # dout of another shape than q
        fa.flash_attention_bwd_dq_cuda(x, x, x, None, x, lse, x[:, :, :8])
    with pytest.raises(TypeError):  # out must be bf16 too
        fa.flash_attention_bwd_dq_cuda(x, x, x, None, x.float(), lse, x)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd_dkv_cuda(x, x, x, None, x.float(), lse, lse)
    with pytest.raises(ValueError):  # delta of another shape than lse
        fa.flash_attention_bwd_dkv_cuda(x, x, x, None, x, lse, lse[:, :1])


@pytest.mark.gpu
def test_wide_head_esm2_on_the_card(card):
    """An ESM2 with heads of 128 (2 layers of 256) embeds through the
    FlashAttention-2 kernel, one launch a layer and no flash-MHA launch,
    and refuses packed rows on the card."""
    cfg = esm2.Esm2Config(hidden_size=256, num_layers=2, num_heads=2,
                          intermediate_size=512)
    enc = encoders.SequenceEncoder(cfg, 32, proj_type="mlp")
    esm2.init_esm2_weights_(enc, torch.Generator(device=card).manual_seed(0))
    counts = (fa.flash_attention_fwd_cuda.launches,
              flash_mha.flash_mha_cuda.launches)
    feats = OneProtEmbedder(encoders.OneProtModel({"sequence": enc})
                            ).embed_sequences(["MKTAYIAKQR" * 7, "ACDEFG"])
    assert (fa.flash_attention_fwd_cuda.launches,
            flash_mha.flash_mha_cuda.launches) == (counts[0] + 2, counts[1])
    assert feats.shape == (2, 32) and np.isfinite(feats).all()
    ids = torch.ones(1, 8, dtype=torch.long, device=card)
    with pytest.raises(ValueError):  # the dense segment mask has no kernel
        enc.transformer(ids, segment_ids=torch.zeros_like(ids))


class _MemoryStructTokens(StructTokenDataset):
    """StructTokenDataset serving RECORDS from memory (no h5py here)."""

    RECORDS: dict = {}

    def read_strucseq(self, seq_id):
        return self.RECORDS.get(seq_id)


class _MemoryDataModule(OneProtDataModule):
    def __init__(self, modalities, **kwargs):
        super().__init__(modalities,
                         dataset_classes={"struct_token": _MemoryStructTokens},
                         **kwargs)


@pytest.mark.gpu
def test_cli_shipped_train_packed_is_refused_in_f32(card, tmp_path,
                                                    monkeypatch):
    """experiment=train_packed as shipped asks for ESM2-8M towers in
    float32 (configs/model/struct_token_debug.yaml). It was refused on the
    card while the attention kernels took bf16 only; now it runs to its end
    through the f32 instances of #1-#3 (nothing casts the model behind the
    config's back), and no bf16 flash-MHA kernel launches."""
    rng = np.random.RandomState(0)
    records = {}
    for split in ("train", "val", "test"):
        ids = [f"{split}_{i}" for i in range(16)]
        for sid in ids:
            records[sid] = "".join(a + b for a, b in zip(
                rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 60),
                rng.choice(list("pynwrqhgdlvtmfsaeikc"), 60)))
        (tmp_path / f"{split}_saprot.txt").write_text("\n".join(ids) + "\n")
    monkeypatch.setattr(_MemoryStructTokens, "RECORDS", records)
    monkeypatch.setitem(config.TARGET_ALIASES,
                        "oneprot_tpu.data.datamodule.OneProtDataModule",
                        f"{__name__}._MemoryDataModule")
    counts = [f.launches for f in F32_KERNELS + (flash_mha.flash_mha_cuda,)]
    metrics = cli_train.main(
        ["experiment=train_packed", "trainer=gpu", "data=struct_token_only",
         "data.pack_rows=2", "data.pack_row_len=256", "trainer.max_epochs=1",
         f"paths.data_dir={tmp_path}", f"hydra.run.dir={tmp_path / 'run'}",
         "extras.print_config=false"])
    ran = [f.launches - c for f, c in zip(
        F32_KERNELS + (flash_mha.flash_mha_cuda,), counts)]
    assert min(ran[:3]) > 0 and ran[3] == 0, ran
    assert np.isfinite(metrics["val/loss"])


# ---------------------------------------------------------------------------
# the text tower: #1-#3 without rotary, BERT on the card


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,segments", [
    (32, 512, False),   # embed_texts' batch at bucket 512, key padding
    (16, 384, False),   # the LoRA text step's batch
    (3, 200, True),     # packed text rows: key bias and segment ids
    (2, 77, True),      # ragged: L off the tile grid
])
def test_flash_kernels_without_rotary_at_the_text_shapes(card, B, L, segments):
    """BERT's calls: heads of 64, 12 heads, the key-padding bias and, on
    packed rows, segment ids, no rotary tables. Forward, then dq and dk/dv,
    one launch each, against the plain versions."""
    q, k, v, kw = _attention_inputs(B, L, 12, 64, card, L + B, False, True,
                                    segments)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [f.launches for f in (flash_mha.flash_mha_cuda,
                                   flash_mha.flash_mha_bwd_dq_cuda,
                                   flash_mha.flash_mha_bwd_dkv_cuda)]
    out, lse = flash_mha.mha_attention(q, k, v, 12, **kw)
    valid = kw["bias"][:, 0, 0] == 0
    dout = (torch.randn(out.shape, device=card) * valid[..., None]).to(
        torch.bfloat16)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    after = [f.launches for f in (flash_mha.flash_mha_cuda,
                                  flash_mha.flash_mha_bwd_dq_cuda,
                                  flash_mha.flash_mha_bwd_dkv_cuda)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, 12, **kw)
    refs = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, 12, **kw)
    for got, want in ((out, ref), *zip(grads, refs)):
        assert torch.isfinite(got.float()).all()
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= FLASH_REL_TOL
    rows = valid[:, None, :].expand_as(lse)
    assert (lse - ref_lse).abs()[rows].max().item() <= 5e-2


@pytest.mark.gpu
def test_bert_on_the_card_matches_the_cpu(card):
    """bert_base's widths at 2 layers (random weights from a seed), bf16 on
    the card through #1 against f32 on the CPU, on padded and packed rows:
    the text encoder's features agree in cosine, and a packed text's
    features equal its padded row's on the card."""
    cfg = dataclasses.replace(bert.BERT_SIZES["bert_base"], num_layers=2)
    cpu = encoders.TextEncoder(cfg, 256, device="cpu", dtype=torch.float32)
    bert.init_bert_weights_(cpu, torch.Generator().manual_seed(0))
    gpu = encoders.TextEncoder(cfg, 256, device=card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    lens = [120, 37, 300, 64]
    ids = np.zeros((4, 384), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(5, 3000, size=n)
        ids[i, 0], ids[i, n - 1] = 2, 3
    t = torch.from_numpy(ids)
    with torch.no_grad():
        want = cpu(t)
        got = gpu(t.to(card)).float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= 0.999
    packed = np.full((1, 640), 1, np.int64)
    seg = np.full((1, 640), -1, np.int32)
    off = 0
    for s, i in enumerate((0, 1, 3)):
        packed[0, off:off + lens[i]] = ids[i, :lens[i]]
        seg[0, off:off + lens[i]] = s
        off += lens[i]
    with torch.no_grad():
        feats, counts = gpu.packed_features(
            torch.from_numpy(packed).to(card), torch.from_numpy(seg).to(card), 4)
        alone = gpu(t[[0, 1, 3]].to(card))
    assert counts.tolist() == [120, 37, 64, 0]
    cos = torch.nn.functional.cosine_similarity(feats[:3].float(), alone.float(),
                                                dim=-1)
    assert cos.min().item() >= 0.999


@pytest.mark.gpu
def test_float32_bert_is_refused_when_built(card):
    """float32 BERT runs on the card where its heads fit the f32 flash-MHA
    instances (bert_tiny's 64); wider heads and other dtypes are refused
    when the model is built."""
    assert encoders.create_text_encoder("bert_tiny", dtype="float32")
    wide = dataclasses.replace(bert.BERT_SIZES["bert_tiny"], num_heads=1)
    with pytest.raises(ValueError, match="heads of 128"):
        bert.Bert(wide, dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bert.Bert(bert.BERT_SIZES["bert_tiny"], dtype=torch.float16,
                  device=card)


# ---------------------------------------------------------------------------
# checkpoint interop and the eval entry point


@pytest.mark.gpu
def test_int8_canary_launches_on_the_card(card, tmp_path):
    """An int8 hub from a local HF directory (esm2_tiny's widths, a
    `pytorch_model.bin` written here): `load_pretrained` quantizes it and
    the canary runs its bf16 twin through #1 and the int8 hub through #1
    and #4, once a layer each, on the 16 x 512 probe; finite numbers."""
    import json

    from chip_smoke import hf_name
    from oneprot_tpu_torch.train.module import OneProtModule

    cfg = esm2.ESM2_SIZES["esm2_tiny"]
    hub = tmp_path / "esm2_tiny_hf"
    hub.mkdir()
    (hub / "config.json").write_text(json.dumps({
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size}))
    gen = torch.Generator().manual_seed(0)
    torch.save({hf_name(k): torch.randn(v.shape, generator=gen) * 0.1
                + float(k.endswith("ln.weight"))
                for k, v in esm2.Esm2(cfg, device="meta").state_dict().items()},
               hub / "pytorch_model.bin")
    module = OneProtModule({"sequence": encoders.create_sequence_encoder(
        str(hub), output_dim=32, proj_type="mlp", quantize="int8")})
    before = (flash_mha.flash_mha_cuda.launches,
              gelu_quant.gelu_quant_cuda.launches)
    canary = module.load_pretrained()["sequence"]
    torch.cuda.synchronize()
    assert (flash_mha.flash_mha_cuda.launches - before[0],
            gelu_quant.gelu_quant_cuda.launches - before[1]) == (
                2 * cfg.num_layers, cfg.num_layers)
    assert canary["rows"] == 16
    assert all(np.isfinite(canary[k]) for k in ("cos_min", "cos_mean", "r1"))


@pytest.mark.gpu
def test_cli_eval_on_a_tiny_bf16_run(card, tmp_path, monkeypatch):
    """`cli.eval.main` on a run dir of experiment=train_packed at
    esm2_tiny's widths in bf16 (its `best` written from the seeded
    weights), structures served from memory: one pair, both directions,
    finite, and #1 launched once a tower a batch."""
    from oneprot_tpu_torch.cli import default_config_dir
    from oneprot_tpu_torch.cli import eval as cli_eval
    from oneprot_tpu_torch.data import structure_io, synthetic
    from oneprot_tpu_torch.evaluation import retrieval_eval
    from oneprot_tpu_torch.train.checkpoint import CheckpointManager

    run = tmp_path / "run"
    cfg = config.prepare_run_dir(config.load_config(default_config_dir(), "train", [
        "experiment=train_packed", "trainer=gpu", "data=struct_token_only",
        "extras.print_config=false",
        *[f"model.components.{m}.{k}={v}" for m in ("sequence", "struct_token")
          for k, v in (("model_name_or_path", "esm2_tiny"),
                       ("dtype", "bfloat16"))]]), output_dir=str(run))
    module = cli_train.build_model(cfg["model"], card, 0)
    module.init()
    CheckpointManager(str(run / "checkpoints")).on_validation_end(
        module, {"val/loss_best": 1.0})
    rng = np.random.RandomState(1)
    structures, rows = {}, ["ids,msa,text,st,sg,seq,pocket"]
    for i in range(6):
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 30 + 17 * i))
        path = tmp_path / f"p{i}.pdb"
        path.write_text(synthetic.backbone_pdb(seq, rng))
        chain = structure_io.parse_structure_file(str(path))["A"]
        structures[f"p{i}"] = (chain.seq1, chain.atom_names,
                               chain.atom_amino_id, chain.xyz.astype(np.float64))
        tdi = "".join(rng.choice(list("pynwrqhgdlvtmfsaeikc"), len(seq)))
        rows.append(f"p{i},x.a3m,a protein,{tdi},p{i},p{i},p{i}")
    (tmp_path / "combined.csv").write_text("\n".join(rows) + "\n")
    monkeypatch.setattr(retrieval_eval.CombinedDataset, "read_structure",
                        lambda self, h5, pid: structures[pid])
    before = flash_mha.flash_mha_cuda.launches
    results = cli_eval.main([
        f"run_dir={run}", f"csv_file={tmp_path / 'combined.csv'}",
        f"paths.data_dir={tmp_path}", f"paths.log_dir={tmp_path / 'logs'}",
        "batch_size=4"])
    torch.cuda.synchronize()
    layers = esm2.ESM2_SIZES["esm2_tiny"].num_layers
    assert flash_mha.flash_mha_cuda.launches - before == 2 * 2 * layers
    assert list(results) == ["sequence-struct_token"]
    assert all(np.isfinite(v) for v in results["sequence-struct_token"].values())
    assert len((run / "retrieval_results.csv").read_text().splitlines()) == 3
