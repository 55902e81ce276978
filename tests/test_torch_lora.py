"""LoRA, remat and the unpacked training step of the PyTorch port against
the JAX package, on the CPU in f32.

`LoraDense` (forward on converted params, init bounds, dropout), the
trainability rule of a frozen hub with LoRA (`trainable_mask`, the
gradient barrier, `backbone_is_cacheable`), `convert` of the LoRA factors,
remat on == off under dropout (the per-layer seeds that survive the
recompute), and whole steps: two unpacked `train_step`s and one
`train_step_packed` of a LoRA hub with heads of 128 (a config.json written
to a temporary directory, so its attention takes the FlashAttention-2 path)
and the tiny struct-token tower, against the JAX `OneProtModule` at LoRA
dropout 0.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models import esm2 as jesm2
from oneprot_tpu.train import optim as joptim
from oneprot_tpu.train.module import OneProtModule as JaxModule
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule

# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of erf, exp and LayerNorm, nothing else
RTOL, ATOL = 1e-4, 1e-5
LORA = dict(lora_r=4, lora_alpha=8)
# Adam's rate in the steps below: the rate chip_smoke.py trains this slice
# at. Adam's first update of a leaf is lr * g / (|g| + eps), so f32 noise on
# a gradient near eps moves the update by up to lr; the gradients
# themselves are held at the f32 bar
LR = 1e-4
TINY_HF = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 512, "vocab_size": 33, "pad_token_id": 1,
           "mask_token_id": 32, "token_dropout": True, "layer_norm_eps": 1e-5}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(rng, B, L, lo=4, hi=24, short=(1, 12)):
    ids = rng.randint(lo, hi, size=(B, L)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 0, 2
    row, end = short
    ids[row, end - 1], ids[row, end:] = 2, 1  # a shorter protein, padding
    return ids


# ---------------------------------------------------------------------------
# LoraDense


def _lora_pair(n_in=48, n_out=40, rank=4, alpha=8.0, seed=0):
    """(JAX LoraDense, its params with B != 0, the port's on them)."""
    jmod = jesm2.LoraDense(n_out, lora_rank=rank, lora_alpha=alpha)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.ones((2, n_in)))["params"]
    params = dict(params, lora_B=0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["lora_B"].shape))
    port = esm2.LoraDense(n_in, n_out, esm2.LoraConfig(rank, alpha, 0.0), 0,
                          device="cpu", dtype=torch.float32)
    port.load_state_dict(convert._dense(_numpy_tree(params), ""))
    return jmod, params, port


def test_lora_dense_matches_jax():
    jmod, params, port = _lora_pair()
    x = np.random.RandomState(1).randn(3, 5, 48).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(want - np.asarray(
        jmod.apply({"params": dict(params, lora_B=0 * params["lora_B"])},
                   jnp.asarray(x)))).max() > 1e-2  # the adapter counts
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_convert_carries_the_lora_factors():
    _, params, port = _lora_pair(n_in=48, n_out=40, rank=4)
    state = convert._dense(_numpy_tree(params), "q.")
    assert set(state) == {"q.weight", "q.bias", "q.lora_A", "q.lora_B"}
    assert state["q.lora_A"].shape == (4, 48) and state["q.lora_B"].shape == (40, 4)
    np.testing.assert_array_equal(state["q.lora_A"].numpy(),
                                  np.asarray(params["lora_A"]).T)
    np.testing.assert_array_equal(state["q.lora_B"].numpy(),
                                  np.asarray(params["lora_B"]).T)
    assert torch.equal(port.lora_B, state["q.lora_B"])


def test_lora_init_bounds_match_peft_and_jax():
    """A ~ U(+-sqrt(1/fan_in)), B = 0, in both packages, and the same
    through init_esm2_weights_."""
    n_in = 512
    bound = n_in ** -0.5
    jparams = jesm2.LoraDense(64, lora_rank=16).init(
        jax.random.PRNGKey(0), jnp.ones((1, n_in)))["params"]
    layer = esm2.LoraDense(n_in, 64, esm2.LoraConfig(16, 16.0, 0.1), 0,
                           device="cpu", dtype=torch.float32)
    esm2.init_esm2_weights_(layer, torch.Generator().manual_seed(0))
    for a in (layer.lora_A.detach().numpy(), np.asarray(jparams["lora_A"]),
              esm2.LoraDense(n_in, 64, esm2.LoraConfig(16), 0, device="cpu",
                             dtype=torch.float32).lora_A.detach().numpy()):
        assert np.abs(a).max() <= bound
        assert abs(a.std() - bound / 3 ** 0.5) < 0.05 * bound  # uniform's std
    assert not layer.lora_B.any() and not np.any(jparams["lora_B"])


def _dropout_probe(n=64, p=0.1, stream=0, seed=0, training=True):
    """A LoraDense whose adapter is the identity (A = B = I, alpha = r, zero
    dense weight): its output on ones is the dropout mask of its input."""
    layer = esm2.LoraDense(n, n, esm2.LoraConfig(n, float(n), p), stream,
                           device="cpu", dtype=torch.float32)
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()
        layer.lora_A.copy_(torch.eye(n))
        layer.lora_B.copy_(torch.eye(n))
    layer.train(training)
    esm2.set_lora_dropout_seed(layer, seed)
    with torch.no_grad():
        return layer(torch.ones(n, n))


def test_lora_dropout_keeps_about_nine_in_ten_in_training():
    y = _dropout_probe()
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    rate = kept.float().mean().item()  # 4096 draws: sd 0.0047
    assert abs(rate - 0.9) < 0.02, rate
    assert torch.equal(y, _dropout_probe())  # same seed, same layer: same mask
    assert not torch.equal(y, _dropout_probe(stream=1))
    assert not torch.equal(y, _dropout_probe(seed=1))


def test_lora_dropout_is_off_in_eval():
    assert torch.equal(_dropout_probe(training=False), torch.ones(64, 64))


# ---------------------------------------------------------------------------
# the LoRA hub: trainability, barrier, remat


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("esm2_tiny_d128_lora")
    (root / "config.json").write_text(json.dumps(TINY_HF))
    return root


def _tower_cfg():
    return dataclasses.replace(
        esm2.Esm2Config(hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64),
        vocab_size=33 + encoders.STRUCT_EXTRA_TOKENS)


def _jax_module(tiny_dir, use_lora=True, frozen=True):
    from tests.helpers.tiny_models import patch_tiny_esm2

    patch_tiny_esm2()  # the struct-token tower: 2 layers of 32
    seq = jenc.create_sequence_encoder(
        str(tiny_dir), output_dim=32, proj_type="mlp", use_lora=use_lora,
        lora_dropout=0.0, frozen=frozen, dtype="float32", **LORA)
    st = jenc.create_struct_token_encoder(
        "facebook/esm2_t6_8M_UR50D", output_dim=32, dtype="float32")
    module = JaxModule(components={"sequence": seq, "struct_token": st},
                       optimizer=lambda: joptim.adam(LR), loss_fn="CLIP",
                       mesh=None, seed=0, frozen_param_dtype=None)
    module.use_l1_regularization = True
    init_ids = np.full((2, 16), 1, np.int32)
    init_ids[:, 0] = 0
    module.init({"struct_token": (init_ids, init_ids)})
    return module


def _port_module(tiny_dir, jax_module, use_lora=True, frozen=True,
                 lora_dropout=0.0, remat=False):
    seq = encoders.create_sequence_encoder(
        str(tiny_dir), output_dim=32, proj_type="mlp", use_lora=use_lora,
        lora_dropout=lora_dropout, frozen=frozen, remat=remat,
        dtype="float32", device="cpu", **LORA)
    st = encoders.StructTokenEncoder(_tower_cfg(), 32, device="cpu",
                                     dtype=torch.float32)
    module = OneProtModule({"sequence": seq, "struct_token": st},
                           optimizer=lambda: optim.adam(LR),
                           use_l1_regularization=True, frozen_param_dtype=None)
    module.model.load_state_dict(convert.oneprot_state_dict(
        _numpy_tree(jax_module.state.params)))
    return module.init()


@pytest.fixture(scope="module")
def jax_lora(tiny_dir):
    return _jax_module(tiny_dir)


def test_trainable_mask_matches_jax_leaf_by_leaf(tiny_dir, jax_lora):
    """The port's mask equals the JAX mask carried through `convert` (each
    JAX leaf as an array of its mask value): LoRA factors and every bias
    of the frozen hub's transformer train, the rest of it is frozen."""
    tree = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), jax_lora.mask,
        _numpy_tree(jax_lora.state.params))
    want = {k: bool(v.all()) for k, v in convert.oneprot_state_dict(tree).items()}
    assert all(bool(v.any()) == want[k] for k, v in
               convert.oneprot_state_dict(tree).items())
    module = _port_module(tiny_dir, jax_lora)
    assert module.mask == want
    hub = {k for k, m in want.items() if m and ".sequence.transformer." in k}
    assert {k.rsplit(".", 1)[-1] for k in hub} == {"lora_A", "lora_B", "bias"}
    assert any(".attn_ln.bias" in k for k in hub)
    assert not any(".attn.o.lora" in k for k in want)  # not on o, as JAX
    for name, p in module.model.named_parameters():
        assert p.requires_grad == want[name], name


@pytest.mark.parametrize("use_lora,frozen", [(True, True), (False, True),
                                             (True, False)])
def test_cacheable_and_barrier_follow_jax(tiny_dir, use_lora, frozen):
    """backbone_is_cacheable (frozen, no LoRA, mean pooling) as JAX's; the
    hub's graph is kept (no barrier) unless it is cacheable."""
    kw = dict(output_dim=32, proj_type="mlp", use_lora=use_lora,
              frozen=frozen, dtype="float32", **LORA)
    jseq = jenc.create_sequence_encoder(str(tiny_dir), **kw)
    seq = encoders.create_sequence_encoder(str(tiny_dir), device="cpu", **kw)
    assert seq.backbone_is_cacheable == jseq.backbone_is_cacheable
    pooled = seq.backbone_pooled(torch.from_numpy(
        _ids(np.random.RandomState(0), 2, 16)).long())
    assert pooled.requires_grad == (not seq.backbone_is_cacheable)


def test_int8_with_lora_is_refused():
    with pytest.raises(ValueError, match="use_lora"):
        encoders.create_sequence_encoder("esm2_tiny", use_lora=True,
                                         quantize="int8", device="cpu",
                                         dtype="float32")


def test_remat_on_equals_off_under_dropout(tiny_dir, jax_lora):
    """Checkpointed layers (recomputed in the backward) with LoRA dropout
    0.1 give the loss and every gradient of the layers kept whole: the
    recompute draws the masks the forward drew. B is moved off zero, so
    the adapters count in the loss; another seed gives another loss, so
    the dropout is on."""
    rng = np.random.RandomState(2)
    ids, st_ids = _ids(rng, 4, 24), _ids(rng, 4, 24, lo=20, hi=50)
    runs = []
    for remat, seed in ((True, 0), (False, 0), (False, 1)):
        module = _port_module(tiny_dir, jax_lora, lora_dropout=0.1,
                              remat=remat)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in module.model.named_parameters():
                if name.endswith("lora_B"):
                    p.normal_(0.0, 0.05, generator=gen)
        module.seed = seed
        assert module.model.encoders["sequence"].transformer.remat == remat
        loss, _ = module.train_step("struct_token", ids, st_ids)
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   module.model.named_parameters()
                                   if p.grad is not None}))
    (loss_on, g_on), (loss_off, g_off), (loss_other, _) = runs
    assert abs(loss_on - loss_off) <= 1e-6
    assert g_on.keys() == g_off.keys() and len(g_on) > 20
    for name in g_on:
        np.testing.assert_allclose(g_on[name].numpy(), g_off[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert abs(loss_other - loss_off) > 1e-4


def test_remat_recomputes_each_layer_in_the_backward(tiny_dir, jax_lora,
                                                     monkeypatch):
    """Under remat each hub layer's attention runs twice a step (forward
    and recompute); without it once. Under no_grad remat does nothing."""
    calls = []
    real = esm2.dot_product_attention
    monkeypatch.setattr(esm2, "dot_product_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ids = _ids(np.random.RandomState(3), 2, 16)
    st_ids = _ids(np.random.RandomState(4), 2, 16, lo=20, hi=50)
    for remat, want in ((True, 4), (False, 2)):
        calls.clear()
        _port_module(tiny_dir, jax_lora, remat=remat).train_step(
            "struct_token", ids, st_ids)
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        _port_module(tiny_dir, jax_lora, remat=True).model(
            torch.from_numpy(ids).long(), "sequence")
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# whole steps against the JAX module


def _trainable_after(module):
    return {n: p.detach().numpy().copy()
            for n, p in module.model.named_parameters() if p.requires_grad}


@pytest.fixture(scope="module")
def unpacked_steps(tiny_dir):
    """Two unpacked steps of each package on the same batches: LoRA hub
    with heads of 128 (B = 0 at init, so A's first gradient is exactly 0;
    the second step moves A) and the tiny tower."""
    jm = _jax_module(tiny_dir)
    pm = _port_module(tiny_dir, jm)
    rng = np.random.RandomState(5)
    batches = [(_ids(rng, 4, 24), _ids(rng, 4, 24, lo=20, hi=50))
               for _ in range(2)]
    out = []
    state = jm.state
    before = _trainable_after(pm)
    for ids, st_ids in batches:
        def loss_fn(params, ids=jnp.asarray(ids), st_ids=jnp.asarray(st_ids)):
            seq = jm.model.apply({"params": params}, ids, "sequence")
            mod = jm.model.apply({"params": params}, st_ids, "struct_token")
            return jm._loss_value(mod, seq)

        # the frozen leaves' gradients are left out of the norm, as the
        # step differentiates the trainable partition only
        jgrads = jax.tree_util.tree_map(
            lambda g, m: g if m else jnp.zeros_like(g),
            jax.grad(loss_fn)(state.params), jm.mask)
        jgrads, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
        state, jloss = jm.train_step(state, "struct_token", jnp.asarray(ids),
                                     jnp.asarray(st_ids))
        loss, n = pm.train_step("struct_token", ids, st_ids)
        out.append(dict(
            jax_loss=float(jloss), loss=loss.item(), step=n, before=before,
            jax_grads=convert.oneprot_state_dict(_numpy_tree(jgrads)),
            grads={n: p.grad.numpy().copy() for n, p in
                   pm.model.named_parameters() if p.grad is not None},
            jax_params=convert.oneprot_state_dict(_numpy_tree(state.params)),
            params=_trainable_after(pm)))
        before = out[-1]["params"]
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_unpacked_lora_step_loss_matches_jax(unpacked_steps, step):
    run = unpacked_steps[step]
    assert run["step"] == step + 1
    np.testing.assert_allclose(run["loss"], run["jax_loss"], rtol=RTOL)


@pytest.mark.parametrize("step", [0, 1])
def test_unpacked_lora_step_gradients_match_jax(unpacked_steps, step):
    """The clipped gradient of every trainable leaf, the LoRA factors and
    the hub's biases among them (no gradient barrier)."""
    run = unpacked_steps[step]
    assert run["grads"].keys() == run["params"].keys()
    for name, got in run["grads"].items():
        np.testing.assert_allclose(got, run["jax_grads"][name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_unpacked_lora_step_updates_match_jax(unpacked_steps, step):
    run = unpacked_steps[step]
    lora = [n for n in run["params"] if "lora_" in n]
    assert len(lora) == 2 * 3 * 2  # A and B of q, k, v in both layers
    for name, got in run["params"].items():
        np.testing.assert_allclose(got, run["jax_params"][name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # step 1: B = 0 gives A no gradient, B moves; step 2: A moves too
    for name in lora:
        moved = not np.array_equal(run["params"][name], run["before"][name])
        assert moved == (name.endswith("lora_B") or step == 1), name


def test_unpacked_step_runs_the_hub_through_flash_attention(tiny_dir,
                                                            jax_lora,
                                                            monkeypatch):
    """The hub's heads of 128 go through flash_attention forward and
    backward (its plain versions here), one call a layer each."""
    counts = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "flash_attention_plain"),
                      ("bwd", "flash_attention_bwd_plain")):
        real = getattr(fa, name)

        def spy(*a, _real=real, _key=key):
            counts[_key] += 1
            return _real(*a)

        monkeypatch.setattr(fa, name, spy)
    rng = np.random.RandomState(6)
    _port_module(tiny_dir, jax_lora).train_step(
        "struct_token", _ids(rng, 2, 16), _ids(rng, 2, 16, lo=20, hi=50))
    assert counts == {"fwd": 2, "bwd": 2}


def test_packed_lora_step_matches_jax(tiny_dir):
    """A LoRA hub through train_step_packed: no gradient barrier (the
    adapters and biases of the frozen hub get their updates), as JAX."""
    from oneprot_tpu_torch.data import packing

    jm = _jax_module(tiny_dir)
    pm = _port_module(tiny_dir, jm)
    rng = np.random.RandomState(7)
    lengths = (30, 22, 41, 18, 27)
    seqs, sts = [], []
    for n in lengths:
        seqs.append(rng.randint(4, 24, size=n).astype(np.int32))
        sts.append(rng.randint(20, 50, size=n).astype(np.int32))
        for t in (seqs[-1], sts[-1]):
            t[0], t[-1] = 0, 2
    ids, seg, valid, rows = packing.pack_token_rows(seqs, 64, 3)
    st_ids = np.full_like(ids, 1)
    st_seg = np.full_like(seg, -1)
    for r, members in enumerate(rows):
        off = 0
        for s, idx in enumerate(members):
            st_ids[r, off:off + lengths[idx]] = sts[idx]
            st_seg[r, off:off + lengths[idx]] = s
            off += lengths[idx]
    state, jloss = jm.train_step_packed(
        jm.state, "struct_token", {"ids": ids, "segment_ids": seg},
        {"ids": st_ids, "segment_ids": st_seg}, valid)
    before = _trainable_after(pm)
    loss, _ = pm.train_step_packed("struct_token",
                                   {"ids": ids, "segment_ids": seg},
                                   {"ids": st_ids, "segment_ids": st_seg},
                                   valid)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = convert.oneprot_state_dict(_numpy_tree(state.params))
    after = _trainable_after(pm)
    for name, got in after.items():
        np.testing.assert_allclose(got, want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    moved = [n for n in after if ".sequence.transformer." in n
             and not np.array_equal(after[n], before[n])]
    assert any(n.endswith("lora_B") for n in moved)
    assert any(n.endswith(".bias") for n in moved)


def test_cached_step_refuses_a_lora_hub(tiny_dir, jax_lora):
    module = _port_module(tiny_dir, jax_lora)
    assert not module.hub_is_cacheable()
    with pytest.raises(ValueError, match="cached"):
        module.train_step_packed_cached(
            "struct_token", torch.zeros(3, 256),
            {"ids": np.ones((1, 16), np.int32),
             "segment_ids": np.zeros((1, 16), np.int32)},
            np.ones((1, 3), np.float32))
    assert _port_module(tiny_dir, _jax_module(tiny_dir, use_lora=False),
                        use_lora=False).hub_is_cacheable()


def test_embedder_serves_a_lora_hub_without_dropout(tiny_dir, jax_lora):
    """OneProtEmbedder puts the model in eval mode: a LoRA hub with dropout
    0.1 and B moved off zero embeds the same twice, and as the JAX
    embedder (deterministic) does on the same weights."""
    import types

    from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder
    from oneprot_tpu_torch.serving import OneProtEmbedder

    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if "lora_B" in jax.tree_util.keystr(path)
        else x, jax_lora.state.params)
    module = _port_module(tiny_dir, jax_lora, lora_dropout=0.1)
    module.model.load_state_dict(convert.oneprot_state_dict(
        _numpy_tree(params)))
    assert module.model.training
    rng = np.random.RandomState(10)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
            for n in (20, 45, 9)]
    embedder = OneProtEmbedder(module.model, buckets=(64,))
    assert not module.model.training
    first = embedder.embed_sequences(seqs)
    np.testing.assert_array_equal(first, embedder.embed_sequences(seqs))
    jax_side = types.SimpleNamespace(
        model=jax_lora.model, state=types.SimpleNamespace(params=params))
    want = JaxEmbedder(jax_side, buckets=(64,)).embed_sequences(seqs)
    np.testing.assert_allclose(first, np.asarray(want), rtol=RTOL, atol=ATOL)
