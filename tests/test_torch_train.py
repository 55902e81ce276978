"""The packed training slice of the PyTorch port against the JAX package, on
the CPU at tiny sizes: packing, the struct-token tokenizer, segment pools,
the packed Esm2 (per-protein token-dropout rescale), the CLIP losses, the
optimizer and one whole `train_step_packed`, plus the port's own
invariants (cached == uncached, a protein packed at an offset == alone).

Weights are made by the JAX init and carried over with
oneprot_tpu_torch.convert; inputs come from numpy seeds. The root conftest
sets ONEPROT_USE_PALLAS=0, so JAX runs its reference attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oneprot_tpu.data import packing as jpacking
from oneprot_tpu.data.tokenizers import struct_token_tokenizer as jax_st_tok
from oneprot_tpu.losses import clip_loss as jax_clip
from oneprot_tpu.losses import clip_loss_masked as jax_clip_masked
from oneprot_tpu.models import esm2 as jesm2
from oneprot_tpu.models import heads as jheads
from oneprot_tpu.models.encoders import OneProtModel as JaxOneProtModel
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.tokenizers import struct_token_tokenizer
from oneprot_tpu_torch.losses.clip import clip_loss, clip_loss_masked
from oneprot_tpu_torch.models import encoders, esm2, heads
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule

# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of erf, exp and LayerNorm, nothing else
RTOL, ATOL = 1e-4, 1e-5
L_ROW, SLOTS = 128, 4
LENGTHS = (30, 40, 26, 50, 36, 44)


def _tokens(rng, n, lo=4, hi=24):
    t = rng.randint(lo, hi, size=n).astype(np.int32)
    t[0], t[-1] = 0, 2
    return t


def _mirror(rows, token_lists, L):
    """Pack the modality side's tokens into the slots the sequence side's
    packing chose for the same proteins."""
    R = len(rows)
    ids = np.full((R, L), 1, np.int32)
    seg = np.full((R, L), -1, np.int32)
    for r, members in enumerate(rows):
        off = 0
        for s, idx in enumerate(members):
            t = token_lists[idx]
            ids[r, off:off + len(t)] = t
            seg[r, off:off + len(t)] = s
            off += len(t)
    return ids, seg


def _batch(seed=4):
    """Packed seq <-> struct_token rows of six proteins, two of them with
    <mask> tokens (token-dropout rescale), as test_packing.py builds them."""
    rng = np.random.RandomState(seed)
    seqs = [_tokens(rng, n) for n in LENGTHS]
    seqs[1][5:9] = 32
    sts = [_tokens(rng, n, lo=20, hi=50) for n in LENGTHS]
    sts[3][10:12] = 32
    ids, seg, valid, rows = packing.pack_token_rows(seqs, L_ROW, SLOTS)
    st_ids, st_seg = _mirror(rows, sts, L_ROW)
    return ids, seg, st_ids, st_seg, valid


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# data


def test_packing_matches_jax():
    rng = np.random.RandomState(1)
    toks = [_tokens(rng, n) for n in rng.randint(10, 120, size=17)]
    got = packing.pack_token_rows(toks, L_ROW, SLOTS)
    want = jpacking.pack_token_rows(toks, L_ROW, SLOTS)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    with pytest.raises(ValueError):
        packing.pack_lengths([L_ROW + 1], L_ROW, SLOTS)


def test_struct_token_tokenizer_matches_jax():
    seqs = ["MdKpTyAw#", "", "acdefghik", "LvqrsT"]
    tok, jtok = struct_token_tokenizer(), jax_st_tok()
    assert tok.vocab_size == jtok.vocab_size == 54
    np.testing.assert_array_equal(tok(seqs), jtok(seqs))


# ---------------------------------------------------------------------------
# segment pools


def _pool_inputs(seed=0):
    rng = np.random.RandomState(seed)
    B, L, H, P = 2, 40, 16, 4
    feats = rng.randn(B, L, H).astype(np.float32)
    seg = np.full((B, L), -1, np.int32)
    seg[0, :12], seg[0, 12:30] = 0, 1        # slots 2, 3 empty
    seg[1, :5], seg[1, 5:20], seg[1, 20:38] = 0, 2, 3   # slot 1 empty
    mask = (seg >= 0).astype(np.int32)
    mask[1, 7] = 0                           # a pad token inside a segment
    return feats, mask, seg, P


@pytest.mark.parametrize("kind", ["mean", "cls"])
def test_segment_pool_matches_jax(kind):
    feats, mask, seg, P = _pool_inputs()
    want, want_counts = jheads.segment_pool(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(seg), P, kind)
    got, counts = heads.segment_pool(torch.from_numpy(feats),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(seg), P, kind)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # empty slots carry the filler, bit for bit
    filler = np.asarray(jheads.empty_slot_filler(feats.shape[-1]))
    for b, s in ((0, 2), (0, 3), (1, 1)):
        np.testing.assert_array_equal(got.numpy()[b, s], filler)
    with pytest.raises(NotImplementedError):
        heads.segment_pool(torch.from_numpy(feats), torch.from_numpy(mask),
                           torch.from_numpy(seg), P, "attention1d")


@pytest.mark.parametrize("d", [1, 24, 480, 1280])
def test_empty_slot_filler_is_bit_exact(d):
    np.testing.assert_array_equal(heads.empty_slot_filler(d).numpy(),
                                  np.asarray(jheads.empty_slot_filler(d)))


def test_segment_mean_pool_counts_exact_in_bf16():
    """Counts are f32 sums: a bf16 sum would round 300 and 212."""
    B, L, H, P = 1, 512, 8, 2
    feats = torch.ones(B, L, H, dtype=torch.bfloat16)
    seg = torch.zeros(B, L, dtype=torch.int32)
    seg[0, 300:] = 1
    pooled, counts = heads.segment_mean_pool(feats, torch.ones(B, L), seg, P)
    assert counts.dtype == torch.float32 and pooled.dtype == torch.bfloat16
    assert counts.tolist() == [[300.0, 212.0]]
    np.testing.assert_array_equal(pooled.float().numpy(), 1.0)


# ---------------------------------------------------------------------------
# packed Esm2


@pytest.fixture(scope="module")
def tiny_esm2():
    """(JAX config, perturbed params, the port's f32 Esm2 with them)."""
    cfg = jesm2.Esm2Config(hidden_size=32, num_layers=2, num_heads=2,
                           intermediate_size=64)
    ids = jnp.asarray(_batch()[0])
    params = jesm2.Esm2(cfg).init(jax.random.PRNGKey(0), ids)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    model = esm2.Esm2(esm2.Esm2Config(**dataclasses.asdict(cfg)), device="cpu",
                      dtype=torch.float32)
    model.load_state_dict(convert.esm2_state_dict(_numpy_tree(params)))
    return cfg, params, model


def test_packed_esm2_matches_jax(tiny_esm2):
    """Packed rows with <mask> tokens in some proteins: the per-protein
    token-dropout rescale and the segment mask, on every token of a
    protein (padding tokens are don't-care: the JAX oracle masks other
    segments at -1e9, the kernels at -1e30)."""
    cfg, params, model = tiny_esm2
    ids, seg = _batch()[:2]
    want = jesm2.Esm2(cfg).apply({"params": params}, jnp.asarray(ids),
                                 segment_ids=jnp.asarray(seg))
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(seg))
    real = seg >= 0
    np.testing.assert_allclose(got.detach().numpy()[real],
                               np.asarray(want)[real], rtol=RTOL, atol=ATOL)


def test_packed_dropout_scale_of_padding():
    """Padding (segment -1) belongs to no protein: length 1, no masks, so
    its rescale is 1 - 0.15 * 0.8, as the JAX einsum gives it."""
    ids = torch.tensor([[0, 32, 5, 2, 0, 6, 2, 1, 1]])
    seg = torch.tensor([[0, 0, 0, 0, 1, 1, 1, -1, -1]])
    scale = esm2._segment_dropout_scale(ids != 1, ids == 32, seg)
    want = torch.tensor([[0.88 / 0.75] * 4 + [0.88] * 5])
    torch.testing.assert_close(scale, want)


def test_protein_packed_at_an_offset_matches_it_alone(tiny_esm2):
    """RoPE logits depend on position differences only, so each protein of
    a packed row (mask tokens included) encodes as it does alone."""
    _, _, model = tiny_esm2
    ids, seg = _batch()[:2]
    with torch.no_grad():
        packed = model(torch.from_numpy(ids).long(), torch.from_numpy(seg))
        for r in range(ids.shape[0]):
            for s in range(SLOTS):
                where = np.nonzero(seg[r] == s)[0]
                if len(where) == 0:
                    continue
                alone = np.full((1, L_ROW), 1, np.int64)
                alone[0, :len(where)] = ids[r, where]
                solo = model(torch.from_numpy(alone))[0, :len(where)]
                np.testing.assert_allclose(packed[r, where].numpy(),
                                           solo.numpy(), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# losses and optimizer


def test_clip_losses_match_jax():
    rng = np.random.RandomState(3)
    f, g = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    full = clip_loss(t(f), t(g), logit_scale=10.0)
    np.testing.assert_allclose(
        full.item(), float(jax_clip(jnp.asarray(f), jnp.asarray(g),
                                    logit_scale=10.0)), rtol=1e-6)
    # masked == unmasked when every slot is valid
    np.testing.assert_allclose(
        clip_loss_masked(t(f), t(g), torch.ones(6), logit_scale=10.0).item(),
        full.item(), rtol=1e-6)
    # empty slots (any features) change nothing, as in JAX
    f2 = np.concatenate([f, rng.randn(2, 8).astype(np.float32)])
    g2 = np.concatenate([g, rng.randn(2, 8).astype(np.float32)])
    valid = np.array([1] * 6 + [0] * 2, np.float32)
    got = clip_loss_masked(t(f2), t(g2), t(valid), logit_scale=10.0).item()
    want = float(jax_clip_masked(jnp.asarray(f2), jnp.asarray(g2),
                                 jnp.asarray(valid), logit_scale=10.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, full.item(), rtol=1e-6)


@pytest.mark.parametrize("weight_decay,scale", [(0.0, 3.0), (0.0, 0.01),
                                                (0.1, 3.0)])
def test_clipped_adam_matches_optax(weight_decay, scale):
    """Three steps of clip_by_global_norm(1.0) -> Adam(W) against optax,
    with gradients whose norm is above (scale 3) or below the clip."""
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[scale * rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = optim.build_optimizer(
        params, lambda: optim.adam(1e-2, weight_decay), 1.0)
    base = (optax.adamw(1e-2, weight_decay=weight_decay, b1=0.9, b2=0.999,
                        eps=1e-8) if weight_decay
            else optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8))
    tx = optax.chain(optax.clip_by_global_norm(1.0), base)
    jp = [jnp.asarray(x) for x in init]
    state = tx.init(jp)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in step_grads],
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
    for p, want in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the packed train step


def _jax_module(frozen_hub=True):
    from tests.helpers.tiny_models import build_tiny_module

    module = build_tiny_module(mesh=None, frozen_hub=frozen_hub)
    module.use_l1_regularization = True
    init_ids = np.full((2, 16), 1, np.int32)
    init_ids[:, 0] = 0
    module.init({"struct_token": (init_ids, init_ids)})
    return module


def _port_module(jax_module, frozen_param_dtype=None, params=None):
    """The port's tiny module on the CPU in f32, carrying the JAX params
    (or `params`, a numpy tree of the same layout), int8 hub where the JAX
    hub is."""
    jenc = jax_module.encoders
    cfg = lambda name: esm2.Esm2Config(**dataclasses.asdict(jenc[name].config))
    seq = encoders.SequenceEncoder(cfg("sequence"), 32, proj_type="mlp",
                                   frozen=jenc["sequence"].frozen,
                                   quant_int8=jenc["sequence"].quant_int8,
                                   device="cpu", dtype=torch.float32)
    st = encoders.StructTokenEncoder(cfg("struct_token"), 32, device="cpu",
                                     dtype=torch.float32)
    module = OneProtModule({"sequence": seq, "struct_token": st},
                           optimizer=lambda: optim.adam(1e-3),
                           use_l1_regularization=True,
                           frozen_param_dtype=frozen_param_dtype)
    module.model.load_state_dict(convert.oneprot_state_dict(
        params or _numpy_tree(jax_module.state.params)))
    return module.init()


@pytest.fixture(scope="module")
def step_pair():
    """(JAX module, port module, batch) after one packed step in each, with
    the JAX gradients (clipped as the optimizer sees them) and loss."""
    jm = _jax_module()
    pm = _port_module(jm)
    ids, seg, st_ids, st_seg, valid = _batch()
    j = jnp.asarray
    params = jm.state.params

    def loss_fn(p):
        seq_f, _ = jm.model.apply({"params": p}, j(ids), j(seg), SLOTS,
                                  "sequence", method=JaxOneProtModel.encode_packed)
        mod_f, _ = jm.model.apply({"params": p}, j(st_ids), j(st_seg), SLOTS,
                                  "struct_token",
                                  method=JaxOneProtModel.encode_packed)
        return jm._packed_loss_value(mod_f, seq_f, j(valid.reshape(-1)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    jgrads, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
    step = jax.jit(jm.train_step_packed_fn("struct_token", SLOTS))
    jstate, jstep_loss = step(jm.state, j(ids), j(seg), j(st_ids), j(st_seg),
                              j(valid.reshape(-1)))
    loss, n = pm.train_step_packed(
        "struct_token", {"ids": ids, "segment_ids": seg},
        {"ids": st_ids, "segment_ids": st_seg}, valid)
    return dict(jax_loss=float(jloss), jax_step_loss=float(jstep_loss),
                jax_grads=convert.oneprot_state_dict(_numpy_tree(jgrads)),
                jax_params=convert.oneprot_state_dict(
                    _numpy_tree(jstate.params)),
                port=pm, loss=loss, step=n)


def test_packed_step_loss_matches_jax(step_pair):
    assert step_pair["step"] == 1
    np.testing.assert_allclose(step_pair["jax_step_loss"], step_pair["jax_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(step_pair["loss"].item(), step_pair["jax_loss"],
                               rtol=RTOL)


def test_packed_step_gradients_match_jax(step_pair):
    """The clipped gradient of every trainable parameter; the frozen hub's
    transformer gets none (its JAX gradient is zero: stop_gradient)."""
    named = dict(step_pair["port"].model.named_parameters())
    n_trainable = 0
    for name, want in step_pair["jax_grads"].items():
        p = named[name]
        if not p.requires_grad:
            assert p.grad is None and not np.any(want.numpy()), name
            continue
        n_trainable += 1
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert n_trainable > 20


def test_packed_step_updates_match_jax(step_pair):
    """Every parameter after the step. Adam's first step is lr * g / (|g| +
    eps): it magnifies differences of near-zero gradients, which is why the
    gradients themselves are held at the f32 bar above."""
    named = dict(step_pair["port"].model.named_parameters())
    for name, want in step_pair["jax_params"].items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_packed_train_step_learns():
    """Eight steps on one batch: the loss falls (test_packing.py's JAX
    assertion)."""
    module = _port_module(_jax_module())
    ids, seg, st_ids, st_seg, valid = _batch()
    losses = [module.train_step_packed(
        "struct_token", {"ids": ids, "segment_ids": seg},
        {"ids": st_ids, "segment_ids": st_seg}, valid)[0].item()
        for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_cached_step_equals_uncached():
    """encode_packed_pooled's per-slot pooled hub features (the empty
    slots' filler included) fed to train_step_packed_cached give the loss
    and the update of train_step_packed, exactly."""
    jm = _jax_module()
    a, b = _port_module(jm), _port_module(jm)
    ids, seg, st_ids, st_seg, valid = _batch()
    mod_pack = {"ids": st_ids, "segment_ids": st_seg}
    loss_a, _ = a.train_step_packed(
        "struct_token", {"ids": ids, "segment_ids": seg}, mod_pack, valid)
    pooled = b.encode_packed_pooled("sequence", ids, seg, SLOTS)
    assert pooled.shape == (ids.shape[0] * SLOTS, 32)
    loss_b, _ = b.train_step_packed_cached("struct_token", pooled, mod_pack,
                                           valid)
    assert torch.equal(loss_a, loss_b)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name


def test_init_freezes_the_hub_and_stores_it_in_bf16():
    """trainable_mask: the frozen hub's transformer is frozen, its head and
    the struct-token tower train; frozen float parameters go to bf16."""
    module = _port_module(_jax_module(), frozen_param_dtype="bfloat16")
    for name, p in module.model.named_parameters():
        frozen = name.startswith("encoders.sequence.transformer.")
        assert p.requires_grad == (not frozen), name
        assert p.dtype == (torch.bfloat16 if frozen else torch.float32), name
    assert set(module.opt.params) == {p for p in module.model.parameters()
                                      if p.requires_grad}


def test_int8_hub_packed_step_matches_jax():
    """A frozen int8 hub (quantize: int8) with frozen leaves stored in bf16,
    as the JAX init stores them: every frozen float leaf in bf16 but the
    dequantization scales, so the Int8Dense biases too. The hub's biases
    are random f32 values, loaded unrounded into the port (as a float
    checkpoint would be) and into the JAX state in the dtype its init gave
    the leaf. One packed step: the loss, every trainable leaf's clipped
    gradient and every trainable parameter after the step at the f32 bar.
    The update is held where |g| >= 1e-6: Adam's first step moves an
    element by lr * g / (|g| + 1e-8), so for a gradient near 1e-8 an ulp
    of difference upstream (an int8 code that flips at a .5 tie between
    the two frameworks' LayerNorms) moves it by up to lr; the gradient of
    that element is held all the same."""
    from oneprot_tpu.models.encoders import create_sequence_encoder as jseq
    from oneprot_tpu.models.encoders import create_struct_token_encoder as jst
    from oneprot_tpu.train.module import OneProtModule as JaxModule
    from oneprot_tpu.train.optim import adam as jadam
    from tests.helpers.tiny_models import patch_tiny_esm2

    patch_tiny_esm2()
    name = "facebook/esm2_t6_8M_UR50D"
    jm = JaxModule(
        components={"sequence": jseq(name, output_dim=32, proj_type="mlp",
                                     dtype="float32", quantize="int8"),
                    "struct_token": jst(name, output_dim=32, dtype="float32")},
        optimizer=lambda: jadam(1e-3), loss_fn="CLIP", mesh=None, seed=0,
        frozen_param_dtype="bfloat16")
    jm.use_l1_regularization = True
    init_ids = np.full((2, 16), 1, np.int32)
    init_ids[:, 0] = 0
    jm.init({"struct_token": (init_ids, init_ids)})

    rng = np.random.RandomState(9)
    f32_tree = _numpy_tree(jm.state.params)
    hub = f32_tree["encoders_sequence"]["transformer"]
    jax_hub = jax.tree_util.tree_map(lambda x: x, jm.state.params[
        "encoders_sequence"]["transformer"])
    n_bias = 0
    for i in range(2):
        layer, jlayer = hub[f"layer_{i}"], jax_hub[f"layer_{i}"]
        for sub, jsub in [(layer["attn"][n], jlayer["attn"][n])
                          for n in ("q", "k", "v", "o")] + [
                (layer[n], jlayer[n]) for n in ("fc1", "fc2")]:
            sub = sub.get("dense", sub)
            jsub = jsub.get("dense", jsub)
            assert jsub["bias"].dtype == jnp.bfloat16  # the JAX rule
            assert jsub["kernel_scale"].dtype == jnp.float32
            b = (rng.randn(*sub["bias"].shape) * 0.5).astype(np.float32)
            sub["bias"] = b
            jsub["bias"] = jnp.asarray(b).astype(jsub["bias"].dtype)
            n_bias += 1
    params = dict(jm.state.params)
    params["encoders_sequence"] = dict(params["encoders_sequence"],
                                       transformer=jax_hub)
    jm.state = jm.state.replace(params=params)
    pm = _port_module(jm, frozen_param_dtype="bfloat16", params=f32_tree)

    int8 = [m for m in pm.model.modules() if isinstance(m, esm2.Int8Dense)]
    assert len(int8) == n_bias == 12
    for m in int8:
        assert m.bias.dtype == torch.bfloat16
        assert m.weight_scale.dtype == torch.float32
        assert m.weight_q.dtype == torch.int8

    ids, seg, st_ids, st_seg, valid = _batch()
    j = jnp.asarray
    frozen = params["encoders_sequence"]

    def loss_fn(trainable):
        p = {"encoders_struct_token": trainable["tower"],
             "encoders_sequence": dict(frozen, head=trainable["head"])}
        seq_f, _ = jm.model.apply({"params": p}, j(ids), j(seg), SLOTS,
                                  "sequence", method=JaxOneProtModel.encode_packed)
        mod_f, _ = jm.model.apply({"params": p}, j(st_ids), j(st_seg), SLOTS,
                                  "struct_token",
                                  method=JaxOneProtModel.encode_packed)
        return jm._packed_loss_value(mod_f, seq_f, j(valid.reshape(-1)))

    jgrads = jax.jit(jax.grad(loss_fn))(
        {"tower": params["encoders_struct_token"], "head": frozen["head"]})
    jgrads, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
    jgrads = _numpy_tree(jgrads)
    jgrads = {**convert.encoder_state_dict(jgrads["tower"],
                                           "encoders.struct_token."),
              **convert.head_state_dict(jgrads["head"],
                                        "encoders.sequence.head.")}
    step = jax.jit(jm.train_step_packed_fn("struct_token", SLOTS))
    jstate, jloss = step(jm.state, j(ids), j(seg), j(st_ids), j(st_seg),
                         j(valid.reshape(-1)))
    loss, _ = pm.train_step_packed(
        "struct_token", {"ids": ids, "segment_ids": seg},
        {"ids": st_ids, "segment_ids": st_seg}, valid)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = convert.oneprot_state_dict(_numpy_tree(jstate.params))
    trainable = {n: p for n, p in pm.model.named_parameters() if p.requires_grad}
    assert trainable.keys() == jgrads.keys()
    for pname, p in trainable.items():
        g = jgrads[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=pname)
        held = np.abs(g) >= 1e-6
        np.testing.assert_allclose(p.detach().numpy()[held],
                                   want[pname].numpy()[held], rtol=RTOL,
                                   atol=ATOL, err_msg=pname)


def test_module_refuses_what_is_not_ported():
    enc = {"sequence": encoders.create_sequence_encoder(
        "esm2_tiny", device="cpu", dtype="float32")}
    # SigLIP, the text tower, the graph towers, tensor parallelism and the
    # int8 hub over a model axis (held whole) are ported
    # (tests/test_torch_siglip.py, test_torch_text.py, test_torch_graph.py,
    # test_torch_tensor_parallel.py); a model axis that does not divide the
    # world is refused, as is a modality the JAX package does not know
    assert OneProtModule(enc, loss_fn="SIGLIP").loss_name == "SIGLIP"
    with pytest.raises(ValueError, match="does not divide the world"):
        OneProtModule(enc, mesh={"data": -1, "model": 2})
    int8 = encoders.create_sequence_encoder("esm2_tiny", quantize="int8",
                                            device="cpu", dtype="float32",
                                            tp=(2, 0))
    assert not int8.transformer.layers[0].attn.heads_split
    with pytest.raises(NotImplementedError):
        encoders.OneProtModel({"no_such": torch.nn.Linear(2, 2)})
    with pytest.raises(NotImplementedError):
        convert.oneprot_state_dict({"encoders_no_such": {}})


def test_struct_token_encoder_matches_jax():
    """create_struct_token_encoder (+21 rows, linear head, logit scale
    1/0.07) against the JAX encoder's unpacked forward."""
    from oneprot_tpu.models.encoders import create_struct_token_encoder as jcreate

    jenc = jcreate("facebook/esm2_t6_8M_UR50D", output_dim=16)
    jenc = dataclasses.replace(jenc, config=dataclasses.replace(
        jenc.config, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64))
    rng = np.random.RandomState(6)
    ids = np.stack([_tokens(rng, 24, lo=20, hi=54) for _ in range(3)])
    ids[1, 15:] = 1
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(ids))["params"]
    want = jenc.apply({"params": params}, jnp.asarray(ids))
    port = encoders.create_struct_token_encoder(
        "facebook/esm2_t6_8M_UR50D", output_dim=16, dtype="float32",
        device="cpu")
    assert port.config.vocab_size == 33 + encoders.STRUCT_EXTRA_TOKENS
    port = encoders.StructTokenEncoder(
        esm2.Esm2Config(**dataclasses.asdict(jenc.config)), 16, device="cpu",
        dtype=torch.float32)
    port.load_state_dict(convert.encoder_state_dict(_numpy_tree(params)))
    got = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=-1),
                               1 / 0.07, rtol=1e-5)
