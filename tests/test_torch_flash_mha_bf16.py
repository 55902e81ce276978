"""The flash-MHA plain versions in bf16 against the JAX kernels, on the CPU.

The JAX kernels scale q by a constant rounded to the input dtype,
`q2 * jnp.asarray(scale * log2e, in_dtype)`, after `_apply_rot` has rotated
q and k in that dtype. Run by XLA on the CPU (Pallas in interpret mode), that
bf16 arithmetic rounds every product and sum: x cos, rotate_half(x) sin,
their sum, and the product with bf16(log2(e) / sqrt(D)), whose ratio to the
exact constant is 1.0018 at D = 64 and 1.0015 at D = 24. The port copies it
(`flash_mha.rotated_qk`); a softmax 0.15-0.18% hotter or cooler than JAX's
shows in bf16, not in f32. Here the same numpy inputs, in bf16, go through
the Pallas `mha_attention` (interpret mode) and its jax.vjp, and through the
port's plain forward and backward (whole, and split as the two backward
kernels compute it). The forward's q tile is held equal to the dq kernel's
q_r bit for bit, and the forward's skip rule (query blocks of 128 rows, key
tiles of 64 or 128) never drops a pair of equal ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from oneprot_tpu.kernels.flash_mha import mha_attention as jax_mha
from oneprot_tpu_torch.kernels import flash_mha
from tests.test_torch_flash_bwd import _case

# One bf16 step at the top of the range, relative to the largest |value|:
# with JAX's rounding copied, the two frameworks differ only where their f32
# sums, taken in another order, land a value on the other side of a bf16
# rounding boundary (a few elements, one step each); the unrounded q scale
# moves outputs and gradients by 1.4-3.6% of their largest value here.
BF16_STEP = 2.0 ** -8


def _bf16_case(nh, d, seed):
    """B=2, L=128 with rotary, key padding and three packed proteins a row,
    q, k, v doubled (sharper softmax rows, where the temperature shows), an
    upstream gradient zero on padding rows; all rounded to bf16."""
    q, k, v, bias, cos, sin, seg, g = _case(2, 128, nh, d, True, True, seed)
    q, k, v = (2 * x for x in (q, k, v))
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return bf(q), bf(k), bf(v), bias, cos, sin, seg, bf(g)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_STEP, f"{what}: max err {err:.3e} of the largest value"


@pytest.mark.parametrize("nh,d", [(4, 24), (2, 64)])  # the tower's, the hub's
def test_bf16_plain_matches_jax_interpret(nh, d, monkeypatch):
    # heads of 64 in pairs: the JAX forward's pair-fused variant shares one
    # row max across two heads, so its bf16 P rounds against another max;
    # the unfused variant is the function the port's kernel computes
    monkeypatch.setenv("ONEPROT_MHA_PAIRFUSE", "0")
    q, k, v, bias, cos, sin, seg, g = _bf16_case(nh, d, 5)
    j = lambda x: None if x is None else jnp.asarray(x)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)

    def fwd(q_, k_, v_):
        return jax_mha(q_, k_, v_, nh, bias=j(bias), rope_cos=j(cos),
                       rope_sin=j(sin), segment_ids=j(seg), interpret=True)

    want_out, vjp = jax.vjp(fwd, jb(q), jb(k), jb(v))
    want = vjp(jb(g))

    tb = lambda x: torch.from_numpy(np.array(x)).to(torch.bfloat16)
    t = lambda x: torch.from_numpy(np.array(x))
    side = dict(bias=t(bias), rope_cos=t(cos), rope_sin=t(sin),
                segment_ids=t(seg))
    qt, kt, vt, gt = tb(q), tb(k), tb(v), tb(g)
    out, lse = flash_mha.mha_attention_plain(qt, kt, vt, nh, **side)
    rows = bias[:, 0, 0] == 0  # padding rows attend to padding: don't-care
    _close(out.float().numpy()[rows], np.asarray(want_out, np.float32)[rows],
           "out")
    whole = flash_mha.mha_attention_bwd_plain(qt, kt, vt, out, lse, gt, nh,
                                              **side)
    dq, q_r, delta = flash_mha.flash_mha_bwd_dq_plain(qt, kt, vt, out, lse,
                                                      gt, nh, **side)
    dk, dv = flash_mha.flash_mha_bwd_dkv_plain(q_r, kt, vt, gt, lse, delta,
                                               nh, **side)
    for grads in (whole, (dq, dk, dv)):
        for name, got, ref in zip("qkv", grads, want):
            _close(got.float().numpy(), np.asarray(ref, np.float32),
                   f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,d,rotary", [(4, 24, True), (2, 64, True),
                                         (3, 32, False)])
def test_forward_q_tile_equals_dq_prologue(nh, d, rotary, dtype):
    """The forward's q tile (q_r = rot(q) * q_pre: `rotated_qk`, which
    mha_attention_plain takes its logits from) and the dq kernel's
    prologue's q_r are the same tensor, bit for bit: the forward's lse and
    the backward recompute the same logits."""
    q, k, v, bias, cos, sin, seg, g = _case(2, 70, nh, d, rotary, True, 3)
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    side = dict(bias=t(bias), rope_cos=t(cos), rope_sin=t(sin),
                segment_ids=t(seg))
    qt, kt, vt, gt = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out, lse = flash_mha.mha_attention_plain(qt, kt, vt, nh, **side)
    _, q_r, _ = flash_mha.flash_mha_bwd_dq_plain(qt, kt, vt, out, lse, gt, nh,
                                                 **side)
    q_tile = flash_mha.rotated_qk(qt, kt, nh, side["rope_cos"],
                                  side["rope_sin"])[0]
    q_tile = q_tile.transpose(1, 2).reshape(q_r.shape)
    assert q_tile.dtype == dtype and torch.equal(q_tile, q_r)


def _assert_no_pair_dropped(seg: np.ndarray, tile: int, q_tile: int):
    hits = flash_mha.segment_tile_hits(torch.from_numpy(seg), tile,
                                       q_tile).numpy()
    B, L = seg.shape
    assert hits.shape == (B, -(-L // q_tile), -(-L // tile))
    tq, tk = np.arange(L) // q_tile, np.arange(L) // tile
    for b in range(B):
        r, c = np.nonzero(seg[b][:, None] == seg[b][None, :])
        assert hits[b, tq[r], tk[c]].all(), f"row {b}: a pair of equal ids dropped"


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3), st.integers(1, 400), st.sampled_from([24, 64]),
       st.sampled_from(["contiguous", "shuffled", "random", "padding"]),
       st.integers(0, 2**31 - 1))
def test_forward_skip_rule_never_drops_a_pair_of_equal_ids(B, L, d, kind,
                                                           seed):
    """The forward's tiles: query blocks of FWD_Q_TILE rows against key
    tiles of fwd_key_tile(D) (64 at D = 24, 128 at D = 64)."""
    rng = np.random.RandomState(seed)
    if kind == "padding":
        seg = np.where(rng.rand(B, L) < 0.95, -1, 3)
    elif kind == "random":
        seg = rng.randint(-3, 6, size=(B, L))
    else:
        seg = np.full((B, L), -1)
        for b in range(B):
            cuts = np.sort(rng.randint(0, L + 1, size=rng.randint(1, 6)))
            for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
                seg[b, lo:hi] = i
            if kind == "shuffled":
                seg[b] = rng.permutation(seg[b])
    _assert_no_pair_dropped(seg.astype(np.int32), flash_mha.fwd_key_tile(d),
                            flash_mha.FWD_Q_TILE)


def test_forward_skip_rule_at_the_towers_packing():
    """16 proteins of 64 tokens a row, then padding: a query block of 128
    rows meets its own two key tiles of 64 and the padding tiles only."""
    seg = np.repeat(np.arange(16), 64)[None].astype(np.int32)
    seg[0, 900:] = -1
    hits = flash_mha.segment_tile_hits(torch.from_numpy(seg), 64, 128).numpy()[0]
    # block 7 (ids 14 and padding) meets tile 14 (the same) and tile 15
    # (padding only)
    want = np.repeat(np.eye(8, dtype=bool), 2, axis=1)
    assert (hits == want).all()
