"""Segment ids in the FlashAttention-2 kernels (#5-#7) of the PyTorch port,
against the JAX package, on the CPU in f32.

Packed rows at heads wider than 64 (ESM2-15B's 128): the JAX layer gives
`reference_attention` a dense block-diagonal mask (`packed_segment_bias`,
-1e9 across segments); the port's kernels take the ids themselves, and
their plain versions build the mask from them at -1e30. Held here:

- `flash_attention_plain` and `flash_attention_bwd_plain` with segment ids
  against the JAX reference and its vjp, at D 72 (zero-filled to 128 by the
  kernel), 128 and 256, L 200 (off the tile grid) and 256, on ragged
  segments with padded tails and one row that is all padding; real rows
  only (the padded query rows are the documented don't-care rows);
- the dq and dk/dv kernels' own plain versions with ids against the whole
  plain backward, bit for bit (f32 and bf16);
- `dot_product_attention(segment_ids=)` and its autograd against JAX's
  `dot_product_attention` on the dense mask;
- `segment_tile_hits` at the FA kernels' tile shapes (hypothesis, heads of
  64, 128 and 256; and the heads-of-256 tiles on fixed rows, with the
  tables' sizes): no pair of equal ids is dropped, and on contiguous
  packing #6's and #7's tables are tight;
- one packed LoRA step of a hub with heads of 128 (a config.json in a
  temporary directory) and the tiny tower, against the JAX module: loss,
  clipped gradients and the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from oneprot_tpu.kernels import attention as jattn
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.kernels import flash_mha
from tests.test_torch_lora import (
    TINY_HF,
    _jax_module,
    _numpy_tree,
    _port_module,
    _trainable_after,
)

RTOL, ATOL = 1e-5, 1e-5
# against the JAX reference's autodiff, which takes another path (no
# base-2 lse, softmax's own vjp): tests/test_torch_flash_attention_bwd.py's
# bar for the same comparison without ids
REF_RTOL, REF_ATOL = 1e-3, 1e-4
# the LoRA step: tests/test_torch_lora.py's bar (two frameworks' summation
# orders and last ulps of erf, exp and LayerNorm)
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


def _segments(B, L, rng):
    """[B, L] int32 ids as packing lays them out: ragged proteins from 0 up,
    then a padded tail (-1); the last row is all padding."""
    seg = np.full((B, L), -1, np.int32)
    for b in range(B - 1):
        end = int(rng.randint(L // 2, L - 5))
        cuts = np.sort(rng.choice(np.arange(1, end), size=3, replace=False))
        for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, end])):
            seg[b, lo:hi] = i
    return seg


def _inputs(B, H, L, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, H, L, D).astype(np.float32)
                     for _ in range(4))
    seg = _segments(B, L, rng)
    bias = np.where(seg >= 0, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    # a pooled loss gives padded rows no gradient
    dout *= (seg >= 0)[:, None, :, None]
    return q, k, v, bias, seg, dout


def _real(x, seg):
    """The rows of real tokens of a [B, H, L, ...] array."""
    return np.asarray(x).transpose(0, 2, 1, *range(3, np.ndim(x)))[seg >= 0]


def _jax_dense(q, k, v, bias, seg):
    return jattn.reference_attention(
        q, k, v, jattn.packed_segment_bias(jnp.asarray(seg), bias))


CASES = [(72, 200), (128, 200), (128, 256), (256, 256)]


@pytest.mark.parametrize("D,L", CASES)
def test_plain_forward_with_ids_matches_jax(D, L):
    q, k, v, bias, seg, _ = _inputs(3, 2, L, D, seed=D + L)
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias, seg)))
    want = _jax_dense(*map(jnp.asarray, (q, k, v, bias)), seg)
    np.testing.assert_allclose(_real(out, seg), _real(want, seg), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("D,L", CASES)
def test_plain_backward_with_ids_matches_jax(D, L):
    q, k, v, bias, seg, dout = _inputs(3, 2, L, D, seed=3 * L + D)
    t = [torch.from_numpy(a) for a in (q, k, v, bias, seg, dout)]
    out, lse = fa.flash_attention_plain(*t[:5])
    got = fa.flash_attention_bwd_plain(t[0], t[1], t[2], t[3], out, lse, t[5],
                                       t[4])
    _, vjp = jax.vjp(lambda q, k, v: _jax_dense(q, k, v, jnp.asarray(bias),
                                                seg),
                     *map(jnp.asarray, (q, k, v)))
    for name, g, ref in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(dout))):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(_real(g, seg), _real(ref, seg),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 256])
def test_kernel_plain_versions_with_ids_equal_the_whole_backward(dtype, D):
    """The dq kernel's plain version (prologue included) and the dk/dv
    kernel's on its q_s and delta give what flash_attention_bwd_plain gives
    with the same ids, bit for bit."""
    q, k, v, bias, seg, dout = _inputs(3, 2, 200, D, seed=D + 1)
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in (q, k, v, dout))
    bias, seg = torch.from_numpy(bias), torch.from_numpy(seg)
    out, lse = fa.flash_attention_plain(q, k, v, bias, seg)
    dq, qs, delta = fa.flash_attention_bwd_dq_plain(q, k, v, bias, out, lse,
                                                    dout, seg)
    dk, dv = fa.flash_attention_bwd_dkv_plain(qs, k, v, bias, dout, lse,
                                              delta, seg)
    want = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout, seg)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got.float()).all(), name
        assert torch.equal(got, ref), name


@pytest.mark.parametrize("D,L", [(24, 130), (128, 96)])
def test_dot_product_attention_with_ids_matches_jax(D, L):
    """dot_product_attention(segment_ids=) on the CPU (the plain versions,
    D = 24 through the padded branch) against JAX's dot_product_attention
    on the dense mask, values and gradients, real rows only."""
    q, k, v, bias, seg, dout = _inputs(2, 3, L, D, seed=L + 5 * D)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.dot_product_attention(*leaves, torch.from_numpy(bias),
                                   segment_ids=torch.from_numpy(seg))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    dense = jattn.packed_segment_bias(jnp.asarray(seg), jnp.asarray(bias))
    want, vjp = jax.vjp(lambda q, k, v: jattn.dot_product_attention(
        q, k, v, dense, use_pallas=False), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_real(out.detach(), seg), _real(want, seg),
                               rtol=RTOL, atol=ATOL)
    for name, g, ref in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(_real(g, seg), _real(ref, seg),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=name)


def test_ids_need_self_attention():
    x = torch.zeros(1, 2, 16, 128)
    seg = torch.zeros(1, 16, dtype=torch.int32)
    assert fa.supports(x, x, x, None, seg)
    assert not fa.supports(x, x[:, :, :8], x[:, :, :8], None, seg)
    assert not fa.supports(x, x, x, None, seg[:, :8])


# -- the skip rule at the FA kernels' tiles ------------------------------------

def _tile_tables(seg, D):
    """The skip rule's tables at the kernels' tiles for heads of D: #5
    (query blocks of BLOCK, key tiles of fwd_key_tile(D)), #6 (blocks of
    BLOCK, key tiles of TILE at every width) and #7 (key blocks of
    dkv_key_block(D), query tiles of TILE; the table read key block
    first)."""
    ids = torch.from_numpy(seg.astype(np.int32))
    return (flash_mha.segment_tile_hits(ids, fa.fwd_key_tile(D), fa.BLOCK),
            flash_mha.segment_tile_hits(ids, fa.TILE, fa.BLOCK),
            flash_mha.segment_tile_hits(ids, fa.TILE, fa.dkv_key_block(D)))


def _assert_pairs_visited(seg, D):
    fwd, dq, dkv = _tile_tables(seg, D)
    b, i, j = np.nonzero(seg[:, :, None] == seg[:, None, :])  # query i, key j
    assert fwd[b, i // fa.BLOCK, j // fa.fwd_key_tile(D)].all()
    assert dq[b, i // fa.BLOCK, j // fa.TILE].all()
    assert dkv[b, j // fa.dkv_key_block(D), i // fa.TILE].all()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 3), st.integers(1, 600), st.sampled_from([64, 128, 256]),
       st.sampled_from(["contiguous", "shuffled", "padding"]),
       st.integers(0, 2**31 - 1))
def test_fa_tile_shapes_never_drop_a_pair_of_equal_ids(B, L, D, kind, seed):
    """#5 (query blocks of 128, key tiles of fwd_key_tile(D)), #6 (blocks
    of 128, key tiles of 64) and #7 (key blocks of dkv_key_block(D), query
    tiles of 64): every (query, key) pair of equal ids lies in a visited
    pair."""
    rng = np.random.RandomState(seed)
    if kind == "padding":
        seg = np.where(rng.rand(B, L) < 0.95, -1, 3)
    else:
        seg = np.full((B, L), -1)
        for b in range(B):
            cuts = np.sort(rng.randint(0, L + 1, size=rng.randint(1, 6)))
            for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
                seg[b, lo:hi] = i
            if kind == "shuffled":
                seg[b] = rng.permutation(seg[b])
    _assert_pairs_visited(seg, D)


@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129, 300, 1024])
def test_fa_tile_shapes_at_heads_of_256(L):
    """The tiles of the heads-of-256 instances: #5 and #6 stream key tiles
    of 64 against query blocks of 128, #7 holds 64 keys a CTA against query
    tiles of 64. The tables list every (block, tile) pair that holds a pair
    of equal ids, on contiguous packing with a padded tail and on shuffled
    ids, and no tile past L: ceil(L / rows) of each kind. On contiguous
    packing #6's and #7's tables are tight."""
    assert (fa.fwd_key_tile(256), fa.dkv_key_block(256)) == (64, 64)
    assert (fa.fwd_key_tile(128), fa.dkv_key_block(128)) == (64, fa.BLOCK)
    rng = np.random.RandomState(L)
    seg = np.full((2, L), -1)
    cuts = np.sort(rng.randint(0, L + 1, size=4))
    for i, (lo, hi) in enumerate(zip([0, *cuts[:-1]], cuts)):
        seg[0, lo:hi] = i
    seg[1] = rng.permutation(seg[0])
    fwd, dq, dkv = _tile_tables(seg, 256)
    up = lambda rows: -(-L // rows)
    assert tuple(fwd.shape) == (2, up(fa.BLOCK), up(64))
    assert tuple(dq.shape) == (2, up(fa.BLOCK), up(fa.TILE))
    assert tuple(dkv.shape) == (2, up(64), up(fa.TILE))
    _assert_pairs_visited(seg, 256)
    # contiguous packing is tight: a block and a tile meet exactly when they
    # share an id (or both hold padding)
    for kb in range(up(64)):
        for qt in range(up(fa.TILE)):
            keys = set(seg[0, kb * 64:(kb + 1) * 64])
            queries = set(seg[0, qt * fa.TILE:(qt + 1) * fa.TILE])
            assert bool(dkv[0, kb, qt]) == bool(keys & queries)
    for qb in range(up(fa.BLOCK)):
        for kt in range(up(fa.TILE)):
            queries = set(seg[0, qb * fa.BLOCK:(qb + 1) * fa.BLOCK])
            keys = set(seg[0, kt * fa.TILE:(kt + 1) * fa.TILE])
            assert bool(dq[0, qb, kt]) == bool(keys & queries)


# -- the packed LoRA step at heads of 128 --------------------------------------

@pytest.fixture(scope="module")
def wide_dir(tmp_path_factory):
    """The hub's config.json; the JAX registry's esm2_t6_8M entry, which
    `_jax_module` shrinks for the tower, is set back afterwards."""
    import json

    from oneprot_tpu.models import esm2 as jesm2

    root = tmp_path_factory.mktemp("esm2_d128_packed")
    (root / "config.json").write_text(json.dumps(TINY_HF))
    before = jesm2.ESM2_SIZES["esm2_t6_8M"]
    yield root
    jesm2.ESM2_SIZES["esm2_t6_8M"] = before


def _packed_batch(seed):
    rng = np.random.RandomState(seed)
    lengths = (30, 22, 41, 18, 27, 12)
    seqs, sts = [], []
    for n in lengths:
        seqs.append(rng.randint(4, 24, size=n).astype(np.int32))
        sts.append(rng.randint(20, 50, size=n).astype(np.int32))
        for t in (seqs[-1], sts[-1]):
            t[0], t[-1] = 0, 2
    ids, seg, valid, rows = packing.pack_token_rows(seqs, 64, 3)
    st_ids, st_seg = np.full_like(ids, 1), np.full_like(seg, -1)
    for r, members in enumerate(rows):
        off = 0
        for s, idx in enumerate(members):
            st_ids[r, off:off + lengths[idx]] = sts[idx]
            st_seg[r, off:off + lengths[idx]] = s
            off += lengths[idx]
    return ({"ids": ids, "segment_ids": seg},
            {"ids": st_ids, "segment_ids": st_seg}, valid)


def test_packed_lora_step_at_heads_of_128_matches_jax(wide_dir):
    """train_step_packed of a LoRA hub with heads of 128 and the tiny
    tower: the loss, every trainable leaf's clipped gradient and its
    update, against the JAX module's packed step."""
    from oneprot_tpu.models.encoders import OneProtModel as JaxModel
    from oneprot_tpu.train import optim as joptim

    jm = _jax_module(wide_dir)
    pm = _port_module(wide_dir, jm)
    seq, mod, valid = _packed_batch(8)
    slots = valid.shape[1]
    trainable, frozen = joptim.partition_params(jm.state.params, jm.mask)

    def loss_fn(params):
        params = joptim.merge_params(params, frozen)
        feats = [jm.model.apply({"params": params}, jnp.asarray(x["ids"]),
                                jnp.asarray(x["segment_ids"]), slots, m,
                                method=JaxModel.encode_packed)[0]
                 for x, m in ((seq, "sequence"), (mod, "struct_token"))]
        return jm._packed_loss_value(feats[1], feats[0],
                                     jnp.asarray(valid.reshape(-1)))

    jgrads = jax.jit(jax.grad(loss_fn))(trainable)
    jgrads, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
    jgrads = convert.oneprot_state_dict(_numpy_tree(
        joptim.merge_params(jgrads, jax.tree_util.tree_map(jnp.zeros_like,
                                                           frozen))))
    state, jloss = jm.train_step_packed(jm.state, "struct_token", seq, mod,
                                        valid)
    loss, _ = pm.train_step_packed("struct_token", seq, mod, valid)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_RTOL)
    grads = {n: p.grad.numpy() for n, p in pm.model.named_parameters()
             if p.requires_grad}
    assert any(n.endswith("lora_B") for n in grads)
    for name, got in grads.items():
        np.testing.assert_allclose(got, jgrads[name].numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=name)
    want = convert.oneprot_state_dict(_numpy_tree(state.params))
    for name, got in _trainable_after(pm).items():
        np.testing.assert_allclose(got, want[name].numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=name)
