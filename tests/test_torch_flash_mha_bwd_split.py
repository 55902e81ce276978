"""The two flash-MHA backward kernels' plain versions, on the CPU.

`flash_mha_bwd_dq_plain` (the dq kernel with its prologue: q_r and delta)
and `flash_mha_bwd_dkv_plain` (the dk/dv kernel on them) are held against
`mha_attention_bwd_plain`, the CPU path and the oracle, bit for bit, and
through it against jax.grad of the JAX `mha_attention` (Pallas in interpret
mode for two shapes, its jnp oracle otherwise). `segment_tile_hits`, the
kernels' rule for skipping tile pairs that share no segment, is held to
never drop a pair of equal ids (hypothesis), and the card launchers refuse
CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu.models.esm2 import rotary_cos_sin as jax_rotary
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.kernels import flash_mha
from tests.test_torch_flash_bwd import _case, _check, _jax_attention

CASES = [  # nh, d, rotary, segments, L: D 8/24/32/64, L off the 64-grid
    (4, 24, True, True, 100),    # the 35M tower's heads, packed rows
    (4, 24, False, False, 64),
    (2, 8, True, True, 70),
    (2, 8, False, True, 37),
    (3, 32, True, False, 130),
    (3, 32, False, True, 96),
    (2, 64, True, True, 48),     # the hub's heads, packed rows
    (2, 64, False, False, 129),
]


def _side(bias, cos, sin, seg, dtype):
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    side = dict(bias=t(bias), rope_cos=t(cos), rope_sin=t(sin),
                segment_ids=t(seg))
    if dtype == torch.bfloat16 and cos is not None:
        side["rope_cos"], side["rope_sin"] = (side[n].to(dtype) for n in
                                              ("rope_cos", "rope_sin"))
    return side


def _split(q, k, v, out, lse, g, nh, side):
    """(dq, dk, dv) through the two kernels' plain versions, and the dq
    plain's (q_r, delta)."""
    dq, q_r, delta = flash_mha.flash_mha_bwd_dq_plain(q, k, v, out, lse, g, nh,
                                                     **side)
    dk, dv = flash_mha.flash_mha_bwd_dkv_plain(q_r, k, v, g, lse, delta, nh,
                                               **side)
    return (dq, dk, dv), q_r, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,d,rotary,segments,L", CASES)
def test_split_plain_backward_equals_plain_backward(nh, d, rotary, segments, L,
                                                    dtype):
    """Bit for bit, in f32 and in bf16; q_r is rot(q) * q_pre in the input
    dtype, op by op as the JAX kernels compute it (x cos, rotate_half(x)
    sin, their sum and the product with q_pre rounded to the dtype in turn,
    q_pre = log2(e) / sqrt(D) rounded to it), and delta rowsum(dO * O)."""
    q, k, v, bias, cos, sin, seg, g = _case(2, L, nh, d, rotary, segments, L)
    side = _side(bias, cos, sin, seg, dtype)
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out, lse = flash_mha.mha_attention(q, k, v, nh, **side)
    want = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, g, nh, **side)
    got, q_r, delta = _split(q, k, v, out, lse, g, nh, side)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and torch.equal(a, b), f"d{name}"
    qh = q.reshape(2, L, nh, d).transpose(1, 2)
    if rotary:
        c, s = side["rope_cos"].to(dtype), side["rope_sin"].to(dtype)
        half = d // 2
        x1, x2 = qh[..., :half], qh[..., half:]
        qh = qh * c + torch.cat([-x2, x1], -1) * s
    q_pre = torch.tensor(flash_mha.bwd_scales(d, dtype)[0], dtype=dtype)
    assert torch.equal(q_r, (qh * q_pre).transpose(1, 2).reshape(2, L, nh * d))
    assert torch.equal(delta, flash_mha.attention_delta(g, out, nh))


def test_bwd_scales_take_log2e_back_out():
    for d in (8, 24, 64):
        q_pre, dq_scale, dk_scale = flash_mha.bwd_scales(d)
        assert q_pre * dk_scale == pytest.approx(dq_scale, rel=1e-15)


@pytest.mark.parametrize("nh,d,rotary,segments", [
    (4, 24, True, True),     # the 35M tower's head width, packed rows
    (2, 16, False, False),
])
def test_split_plain_backward_matches_jax_interpret(nh, d, rotary, segments):
    q, k, v, bias, cos, sin, seg, g = _case(1, 128, nh, d, rotary, segments, 9)
    j = lambda x: None if x is None else jnp.asarray(x)

    def loss(q_, k_, v_):
        out = jax_mha(q_, k_, v_, nh, bias=j(bias), rope_cos=j(cos),
                      rope_sin=j(sin), segment_ids=j(seg), interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    side = _side(bias, cos, sin, seg, torch.float32)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_mha.mha_attention(qt, kt, vt, nh, **side)
    got = _split(qt, kt, vt, out, lse, gt, nh, side)[0]
    _check([[x.numpy() for x in got]], want)


@pytest.mark.parametrize("nh,d,rotary,segments,L", CASES)
def test_split_plain_backward_matches_jax_reference(nh, d, rotary, segments,
                                                    L):
    q, k, v, bias, cos, sin, seg, g = _case(2, L, nh, d, rotary, segments,
                                            L + 1)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_attention(q_, k_, v_, nh, bias, cos, sin, seg) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    side = _side(bias, cos, sin, seg, torch.float32)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_mha.mha_attention(qt, kt, vt, nh, **side)
    got = _split(qt, kt, vt, out, lse, gt, nh, side)[0]
    _check([[x.numpy() for x in got]], want)


def test_split_plain_backward_on_ragged_packed_rows():
    """Rows from `packing.pack_token_rows` with ragged lengths: segment
    edges off the 64-grid, a row that is one protein, a last tile that
    mixes a protein and padding."""
    rng = np.random.RandomState(4)
    lengths = [37, 90, 41, 150, 60, 171, 20]
    toks = [rng.randint(4, 24, size=n).astype(np.int32) for n in lengths]
    _, seg, _, _ = packing.pack_token_rows(toks, 190, 4)
    B, L = seg.shape
    assert B >= 3 and (seg == -1).any()
    nh, d = 2, 24
    q, k, v, g = (rng.randn(B, L, nh * d).astype(np.float32) for _ in range(4))
    bias = np.where(seg >= 0, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    g *= (seg >= 0)[..., None]
    cos, sin = (np.asarray(x) for x in jax_rotary(L, d, jnp.float32))

    def loss(q_, k_, v_):
        return jnp.sum(_jax_attention(q_, k_, v_, nh, bias, cos, sin, seg) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    side = _side(bias, cos, sin, seg, torch.float32)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_mha.mha_attention(qt, kt, vt, nh, **side)
    got = _split(qt, kt, vt, out, lse, gt, nh, side)[0]
    _check([[x.numpy() for x in got]], want)


def _assert_no_pair_dropped(seg: np.ndarray, tile: int):
    hits = flash_mha.segment_tile_hits(torch.from_numpy(seg), tile).numpy()
    B, L = seg.shape
    n = -(-L // tile)
    assert hits.shape == (B, n, n)
    assert (hits == hits.transpose(0, 2, 1)).all()
    t = np.arange(L) // tile
    for b in range(B):
        same = seg[b][:, None] == seg[b][None, :]
        r, c = np.nonzero(same)
        assert hits[b, t[r], t[c]].all(), f"row {b}: a pair of equal ids dropped"


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3), st.integers(1, 300), st.sampled_from([8, 16, 64]),
       st.sampled_from(["contiguous", "shuffled", "random", "padding"]),
       st.integers(0, 2**31 - 1))
def test_segment_tile_hits_never_drops_a_pair_of_equal_ids(B, L, tile, kind,
                                                           seed):
    rng = np.random.RandomState(seed)
    if kind == "padding":  # every id -1, or nearly
        seg = np.where(rng.rand(B, L) < 0.95, -1, 3)
    elif kind == "random":  # any ids, negative ones too
        seg = rng.randint(-3, 6, size=(B, L))
    else:  # packed: contiguous proteins, then padding
        seg = np.full((B, L), -1)
        for b in range(B):
            cuts = np.sort(rng.randint(0, L + 1, size=rng.randint(1, 6)))
            for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
                seg[b, lo:hi] = i
            if kind == "shuffled":
                seg[b] = rng.permutation(seg[b])
    _assert_no_pair_dropped(seg.astype(np.int32), tile)


def test_segment_tile_hits_is_tight_on_contiguous_packing():
    """16 proteins of 64 tokens a row, aligned with the tiles, then
    padding: each tile meets itself and the padding tiles only."""
    seg = np.repeat(np.arange(16), 64)[None].astype(np.int32)
    seg[0, 900:] = -1
    hits = flash_mha.segment_tile_hits(torch.from_numpy(seg)).numpy()[0]
    want = np.eye(16, dtype=bool)
    want[14:, 14:] = True  # tiles 14 and 15 both hold padding
    assert (hits == want).all()


def test_bwd_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError):
        flash_mha.flash_mha_bwd_dq_cuda(x, x, x, x, lse, x, 2)
    with pytest.raises(ValueError):
        flash_mha.flash_mha_bwd_dkv_cuda(x, x, x, x, lse, lse, 2)
    with pytest.raises(ValueError):
        flash_mha.flash_mha_bwd_cuda(x, x, x, x, lse, x, 2)
