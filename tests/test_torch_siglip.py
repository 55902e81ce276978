"""SigLIP and the text steps of the PyTorch port against the JAX package, on
the CPU in f32.

`siglip_loss` and `siglip_loss_masked` (values and gradients, with and
without a logit scale and bias; the masked form equals the plain one when
every slot is valid; an all-invalid block stays finite; a world of several
processes is refused), then whole `OneProtModule` steps of a seq<->text
model (tiny ESM2 hub, frozen; `bert_tiny` text tower over the tiny
WordPiece vocabulary) step for step against the JAX module: SigLIP
`train_step_cached` with a LoRA text tower, `train_step_fully_cached` and
`eval_step_fully_cached` with a frozen one, and the packed text step
(`train_step_packed_cached`, LoRA, SigLIP).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.losses import siglip as jsiglip
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.train.module import OneProtModule as JaxModule
from oneprot_tpu.train.optim import adam as jax_adam
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.tokenizers import tiny_wordpiece_vocab
from oneprot_tpu_torch.losses import siglip
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule

RTOL, ATOL = 1e-4, 1e-5
VOCAB = len(tiny_wordpiece_vocab())
WIDTH = 32
# Adam's first update of a leaf is lr * g / (|g| + eps): f32 noise on a
# gradient entry near eps moves it by up to lr (tests/test_torch_lora.py
# takes 1e-4 for the same reason)
LR = 1e-4


def _feats(seed, n=6, d=16, scale=1 / 0.07):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return scale * x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# the losses


@pytest.mark.parametrize("scale,bias", [(1.0, None), (2.5, -10.0)],
                         ids=["scaled-features", "scale-and-bias"])
def test_siglip_loss_and_gradients_match_jax(scale, bias):
    m, s = _feats(0), _feats(1)
    jbias = None if bias is None else jnp.float32(bias)
    ref, (gm, gs) = jax.value_and_grad(
        lambda a, b: jsiglip.siglip_loss(a, b, scale, jbias), argnums=(0, 1))(
            jnp.asarray(m), jnp.asarray(s))
    tm, ts = (torch.tensor(x, requires_grad=True) for x in (m, s))
    tbias = None if bias is None else torch.tensor(bias)
    loss = siglip.siglip_loss(tm, ts, scale, tbias)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=RTOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("valid", [[1, 1, 0, 1, 0, 1], [1, 0, 0, 0, 0, 0]],
                         ids=["two-empty-slots", "one-real-pair"])
def test_siglip_loss_masked_and_gradients_match_jax(valid):
    m, s = _feats(2), _feats(3)
    v = np.asarray(valid, np.float32)
    ref, (gm, gs) = jax.value_and_grad(
        lambda a, b: jsiglip.siglip_loss_masked(a, b, jnp.asarray(v)),
        argnums=(0, 1))(jnp.asarray(m), jnp.asarray(s))
    tm, ts = (torch.tensor(x, requires_grad=True) for x in (m, s))
    loss = siglip.siglip_loss_masked(tm, ts, torch.tensor(v))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=RTOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=RTOL,
                               atol=ATOL)
    # empty slots get no gradient
    assert not tm.grad.numpy()[v == 0].any()


def test_siglip_masked_equals_plain_when_full():
    m, s = (torch.from_numpy(_feats(i)) for i in (4, 5))
    full = siglip.siglip_loss_masked(m, s, torch.ones(6))
    assert torch.equal(full, siglip.siglip_loss(m, s))


def test_siglip_all_invalid_stays_finite():
    m, s = (torch.tensor(_feats(i), requires_grad=True) for i in (6, 7))
    loss = siglip.siglip_loss_masked(m, s, torch.zeros(6))
    loss.backward()
    assert loss.item() == 0.0 and torch.isfinite(m.grad).all()
    ref = jsiglip.siglip_loss_masked(jnp.asarray(_feats(6)),
                                     jnp.asarray(_feats(7)), jnp.zeros(6))
    assert float(ref) == 0.0


@pytest.mark.parametrize("world", [1, 4])
def test_siglip_refuses_several_processes_naming_item(monkeypatch, world):
    """Under a process group of several processes the losses raise (the
    ring of negatives is not ported); in a group of one they run."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    m = torch.from_numpy(_feats(8))
    for fn, args in ((siglip.siglip_loss, ()),
                     (siglip.siglip_loss_masked, (torch.ones(6),))):
        if world > 1:
            with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
                fn(m, m, *args)
        else:
            assert torch.isfinite(fn(m, m, *args))


def test_module_refuses_an_unknown_loss():
    hub = encoders.SequenceEncoder(esm2.ESM2_SIZES["esm2_tiny"], WIDTH,
                                   device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="SigLIP"):
        OneProtModule({"sequence": hub}, loss_fn="triplet")
    assert OneProtModule({"sequence": hub}, loss_fn="siglip").loss_name == "SIGLIP"


# ---------------------------------------------------------------------------
# the seq<->text steps against the JAX module


def _text_kw(use_lora):
    return dict(output_dim=WIDTH, vocab_size=VOCAB, use_lora=use_lora, lora_r=4,
                lora_alpha=8, lora_dropout=0.0, dtype="float32")


def _jax_module(use_lora, loss_fn="SigLIP"):
    hub = jenc.create_sequence_encoder(
        "esm2_tiny", output_dim=WIDTH, proj_type="mlp",
        frozen=True, dtype="float32")
    text = jenc.create_text_encoder("bert_tiny", **_text_kw(use_lora))
    module = JaxModule(components={"sequence": hub, "text": text},
                       optimizer=lambda: jax_adam(LR), loss_fn=loss_fn,
                       use_l1_regularization=True, seed=0,
                       frozen_param_dtype=None)
    rng = np.random.RandomState(0)
    module.init({"text": (_seq_ids(rng, 2, 16), _text_ids(rng, 2, 16))})
    # move LoRA's B and the LayerNorms off their init
    leaves, treedef = jax.tree_util.tree_flatten(module.state.params)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    module.state = module.state.replace(params=jax.tree_util.tree_unflatten(
        treedef, [x + 0.05 * jax.random.normal(k, x.shape)
                  for x, k in zip(leaves, keys)]))
    return module


def _port_module(jax_module, use_lora, loss_fn="SigLIP"):
    cfg = esm2.Esm2Config(**dataclasses.asdict(
        jax_module.encoders["sequence"].config))
    hub = encoders.SequenceEncoder(cfg, WIDTH, proj_type="mlp", frozen=True,
                                   device="cpu", dtype=torch.float32)
    text = encoders.create_text_encoder("bert_tiny", device="cpu",
                                        **_text_kw(use_lora))
    module = OneProtModule({"sequence": hub, "text": text},
                           optimizer=lambda: optim.adam(LR), loss_fn=loss_fn,
                           use_l1_regularization=True, frozen_param_dtype=None)
    module.model.load_state_dict(convert.oneprot_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_module.state.params)))
    return module.init()


def _seq_ids(rng, B, L):
    ids = rng.randint(4, 24, size=(B, L)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 0, 2
    ids[-1, L // 2], ids[-1, L // 2 + 1:] = 2, 1
    return ids


def _text_ids(rng, B, L):
    ids = rng.randint(5, VOCAB, size=(B, L)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 2, 3
    ids[0, L // 3], ids[0, L // 3 + 1:] = 3, 0
    return ids


def _trainable(module):
    return {n: p.detach().numpy().copy()
            for n, p in module.model.named_parameters() if p.requires_grad}


def _assert_params(pm, state, steps, what):
    """Every trainable leaf at the f32 bar, but the attention's key bias:
    it shifts each query's logits by one constant, so its gradient is 0 in
    exact arithmetic and f32 noise in both packages, which Adam's update
    lr * m / (sqrt(v) + eps) scales up to about lr a step."""
    want = convert.oneprot_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    for name, got in _trainable(pm).items():
        if name.endswith("attn.k.bias"):
            assert np.abs(got - want[name].numpy()).max() <= 2 * LR * steps, name
            continue
        np.testing.assert_allclose(got, want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {name}")


def test_lora_text_cached_steps_match_jax():
    """Three SigLIP `train_step_cached` steps with a LoRA text tower (the
    hub's pooled features cached): loss and every trainable leaf after
    each step, the text tower's adapters and biases among them."""
    jm = _jax_module(use_lora=True)
    pm = _port_module(jm, use_lora=True)
    assert not pm.modality_is_cacheable("text") and pm.hub_is_cacheable()
    rng = np.random.RandomState(1)
    state = jm.state
    before = _trainable(pm)
    for step in range(3):
        seq, text = _seq_ids(rng, 4, 24), _text_ids(rng, 4, 20)
        jpooled = jm.encode_pooled(state.params, "sequence", seq)
        pooled = pm.encode_pooled("sequence", seq)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                                   rtol=RTOL, atol=ATOL)
        state, jloss = jm.train_step_cached(state, "text", jpooled, text)
        loss, n = pm.train_step_cached("text", pooled.numpy(), text)
        assert n == step + 1
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        _assert_params(pm, state, step + 1, f"step {step}")
    moved = [k for k, v in _trainable(pm).items()
             if ".text.transformer." in k and not np.array_equal(v, before[k])]
    assert any(k.endswith("lora_A") for k in moved)
    assert any(k.endswith(".bias") for k in moved)


@pytest.mark.parametrize("loss_fn", ["SigLIP", "CLIP"])
def test_fully_cached_steps_match_jax(loss_fn):
    """A frozen text tower: both towers' pooled features cached, only the
    heads train (`train_step_fully_cached`), and `eval_step_fully_cached`
    gives the eval step's features and loss."""
    jm = _jax_module(use_lora=False, loss_fn=loss_fn)
    pm = _port_module(jm, use_lora=False, loss_fn=loss_fn)
    assert pm.modality_is_cacheable("text")
    rng = np.random.RandomState(2)
    state = jm.state
    for step in range(3):
        seq, text = _seq_ids(rng, 4, 24), _text_ids(rng, 4, 20)
        spooled = pm.encode_pooled("sequence", seq)
        tpooled = pm.encode_pooled("text", text)
        np.testing.assert_allclose(
            tpooled.numpy(), np.asarray(jm.encode_pooled(state.params, "text",
                                                         text)),
            rtol=RTOL, atol=ATOL)
        state, jloss = jm.train_step_fully_cached(
            state, "text", jnp.asarray(spooled.numpy()),
            jnp.asarray(tpooled.numpy()))
        loss, _ = pm.train_step_fully_cached("text", spooled, tpooled)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        _assert_params(pm, state, step + 1, f"step {step}")
    assert all(".transformer." not in k for k in _trainable(pm))

    seq, text = _seq_ids(rng, 4, 24), _text_ids(rng, 4, 20)
    js, jt, jl = jm.eval_step_fully_cached(
        state.params, "text", np.asarray(pm.encode_pooled("sequence", seq)),
        np.asarray(pm.encode_pooled("text", text)))
    s, t, loss = pm.eval_step_fully_cached(
        "text", pm.encode_pooled("sequence", seq), pm.encode_pooled("text", text))
    for got, want in ((s, js), (t, jt), (loss, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    es, et, el = pm.eval_step("text", seq, text)
    for got, want in ((s, es), (t, et), (loss, el)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_packed_lora_text_step_matches_jax():
    """`train_step_packed_cached` on packed text rows (pad id 1 on the
    tails, as the packer writes them; per-text positions and CLS pools)
    with a LoRA text tower and SigLIP over the slots, two steps."""
    jm = _jax_module(use_lora=True)
    pm = _port_module(jm, use_lora=True)
    rng = np.random.RandomState(4)
    state = jm.state
    for step in range(2):
        pairs = []
        for n, m in zip(rng.randint(10, 40, size=6), rng.randint(6, 30, size=6)):
            seq, text = _seq_ids(rng, 1, n)[0], _text_ids(rng, 1, m)[0]
            pairs.append((seq[seq != 1], text[text != 0]))
        batch = next(packing.pack_stream(iter(pairs), 64, 4, 3))
        seq_pack = {"ids": batch["ids_a"], "segment_ids": batch["seg_a"]}
        text_pack = {"ids": batch["ids_b"], "segment_ids": batch["seg_b"]}
        valid = batch["valid"]
        assert valid.sum() >= 4 and (valid == 0).any()
        P = valid.shape[1]
        jpooled = jm.encode_packed_pooled(state.params, "sequence",
                                          seq_pack["ids"],
                                          seq_pack["segment_ids"], P)
        pooled = pm.encode_packed_pooled("sequence", seq_pack["ids"],
                                         seq_pack["segment_ids"], P)
        state, jloss = jm.train_step_packed_cached(state, "text", jpooled,
                                                   text_pack, valid)
        loss, _ = pm.train_step_packed_cached("text", pooled, text_pack, valid)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        _assert_params(pm, state, step + 1, f"packed step {step}")
