"""ESM2 and its pieces in the PyTorch port against the JAX package, on the
CPU, at the tiny size (esm2_tiny: 2 layers, 64 wide, 4 heads).

Weights are made by the JAX model's init, carried over with
oneprot_tpu_torch.convert, and both models see the same token ids. The
root conftest sets ONEPROT_USE_PALLAS=0, so JAX runs its reference path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.data.common import pick_bucket as jax_pick_bucket
from oneprot_tpu.data.tokenizers import esm2_tokenizer as jax_tokenizer
from oneprot_tpu.models import esm2 as jesm2
from oneprot_tpu.models import heads as jheads
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data.common import pick_bucket
from oneprot_tpu_torch.data.tokenizers import esm2_tokenizer
from oneprot_tpu_torch.models import esm2, heads

# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of erf, exp and LayerNorm, nothing else
RTOL, ATOL = 1e-4, 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(B=3, L=24, seed=0):
    """Token rows with <cls>, residues, <eos>, padding and <mask> tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 24, size=(B, L)).astype(np.int32)
    ids[:, 0] = 0
    ids[:, -1] = 2
    ids[1, 14], ids[1, 15:] = 2, 1   # a shorter protein, then padding
    ids[2, [3, 7]] = 32              # <mask> tokens: token-dropout rescale
    return ids


@pytest.fixture(scope="module")
def tiny():
    """(config, float params, int8 params) of a perturbed JAX esm2_tiny:
    the perturbation keeps LayerNorm and bias params off their 1/0 init."""
    cfg = jesm2.resolve_esm2_config("esm2_tiny")
    ids = jnp.asarray(_ids())
    params = jesm2.Esm2(cfg).init(jax.random.PRNGKey(0), ids)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    return cfg, params, jesm2.quantize_esm2_int8_tree(params)


def _port_esm2(cfg, tree, quant_int8):
    model = esm2.Esm2(esm2.Esm2Config(**dataclasses.asdict(cfg)), quant_int8,
                      device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.esm2_state_dict(_numpy_tree(tree)))
    return model


# ---------------------------------------------------------------------------
# data layer


@pytest.mark.parametrize("kw", [
    dict(),
    dict(padding=64),
    dict(max_length=10, padding=16),
    dict(max_length=12),
    dict(padding="max_length", max_length=30),
    dict(pad_to_multiple_of=8),
])
def test_tokenizer_matches_jax(kw):
    seqs = ["MKTAYIAKQR", "", "ACDEFGHIKLMNPQRSTVWYXBUZO", "mkJ*", "M.-K"]
    np.testing.assert_array_equal(esm2_tokenizer()(seqs, **kw),
                                  jax_tokenizer()(seqs, **kw))


def test_tokenizer_ids_and_decode():
    """Non-ASCII input: one <unk> per character, as JAX's encode_ids (its
    native batch path maps bytes, so it gives one <unk> per UTF-8 byte)."""
    tok, ref = esm2_tokenizer(), jax_tokenizer()
    assert tok.vocab == ref.vocab and tok.vocab_size == ref.vocab_size == 33
    assert tok.encode_ids("MKÄV", 6) == ref.encode_ids("MKÄV", 6)
    assert tok.decode(tok(["MKV"])[0]) == "MKV"


@pytest.mark.parametrize("length", [1, 64, 65, 300, 1024, 2000])
@pytest.mark.parametrize("buckets", [(64, 128, 256, 512, 1024),
                                     (256, 384, 512, 768, 1024), ()])
def test_pick_bucket_matches_jax(length, buckets):
    assert (pick_bucket(length, buckets, 1024)
            == jax_pick_bucket(length, buckets, 1024))


# ---------------------------------------------------------------------------
# rotary, config


def test_rotary_matches_jax():
    cos, sin = esm2.rotary_cos_sin(40, 16)
    jcos, jsin = jesm2.rotary_cos_sin(40, 16)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6,
                               atol=1e-6)
    x = np.random.RandomState(0).randn(2, 3, 40, 16).astype(np.float32)
    np.testing.assert_array_equal(esm2.rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jesm2.rotate_half(jnp.asarray(x))))
    out = esm2.apply_rotary(torch.from_numpy(x), cos, sin)
    ref = jesm2.apply_rotary(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["facebook/esm2_t33_650M_UR50D",
                                  "esm2_t6_8M_UR50D", "esm2_tiny"])
def test_resolve_config_matches_jax(name):
    assert (dataclasses.asdict(esm2.resolve_esm2_config(name))
            == dataclasses.asdict(jesm2.resolve_esm2_config(name)))
    with pytest.raises(ValueError):
        esm2.resolve_esm2_config("not_an_esm")


# ---------------------------------------------------------------------------
# int8


def test_quantize_matches_jax(tiny):
    _, params, qparams = tiny
    state = convert.esm2_state_dict(_numpy_tree(params))
    ours = esm2.quantize_esm2_int8_tree(state)
    theirs = convert.esm2_state_dict(_numpy_tree(qparams))
    assert set(ours) == set(theirs)
    for key, t in theirs.items():
        if key.endswith("weight_q"):
            # the same f32 division and round: codes identical
            assert torch.equal(ours[key], t), key
        else:
            torch.testing.assert_close(ours[key], t, rtol=1e-6, atol=0)


def test_int8_dense_same_codes_same_products():
    """Identical int8 inputs give identical int32 products, and the same
    dequantized output as the JAX Int8Dense to f32 rounding."""
    rng = np.random.RandomState(0)
    K, N = 64, 48
    x_q = rng.randint(-127, 128, size=(2, 5, K)).astype(np.int8)
    s_x = rng.rand(2, 5, 1).astype(np.float32) * 0.1
    dense = jesm2.Int8Dense(N)
    params = dense.init(jax.random.PRNGKey(0), None,
                        pre_quant=(jnp.asarray(x_q), jnp.asarray(s_x)))
    params["params"]["bias"] = jnp.asarray(rng.randn(N).astype(np.float32))
    ref = dense.apply(params, None,
                      pre_quant=(jnp.asarray(x_q), jnp.asarray(s_x)))
    port = esm2.Int8Dense(K, N, device="cpu", dtype=torch.float32)
    sd = convert._dense(_numpy_tree(params["params"]), "")
    port.load_state_dict(sd)
    w_q = np.asarray(params["params"]["kernel_q"])
    prod = esm2.int8_matmul(torch.from_numpy(x_q.reshape(-1, K)),
                            port.weight_q)
    ref_prod = np.asarray(jax.lax.dot_general(
        jnp.asarray(x_q.reshape(-1, K)), jnp.asarray(w_q),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    assert prod.dtype == torch.int32
    np.testing.assert_array_equal(prod.numpy(), ref_prod)
    out = port(None, pre_quant=(torch.from_numpy(x_q), torch.from_numpy(s_x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_int8_dense_quantizes_like_jax():
    """Float input: the per-token codes are the same f32 division and
    round as in JAX, so the outputs agree to f32 rounding."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 32).astype(np.float32)
    dense = jesm2.Int8Dense(16)
    params = dense.init(jax.random.PRNGKey(2), jnp.asarray(x))
    port = esm2.Int8Dense(32, 16, device="cpu", dtype=torch.float32)
    port.load_state_dict(convert._dense(_numpy_tree(params["params"]), ""))
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(dense.apply(params, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Esm2


def test_esm2_float_matches_jax(tiny):
    cfg, params, _ = tiny
    ids = _ids()
    ref = jesm2.Esm2(cfg).apply({"params": params}, jnp.asarray(ids))
    out = _port_esm2(cfg, params, False)(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_esm2_int8_matches_jax(tiny):
    """int8 hub (the port's fc1 -> fc2 epilogue is the fused GELU -> int8
    plain version, JAX's here the unfused gelu + Int8Dense quantization,
    which compute the same codes). The two frameworks differ in the last
    ulp of LayerNorm and gelu, and such a difference flips an int8 code
    where it lands on a .5 tie; each flip moves one token's row by about
    one quantization step. So: most values agree to f32 rounding, every
    token's hidden state has cosine >= 0.999, and no value is off by more
    than a few steps."""
    cfg, _, qparams = tiny
    ids = _ids()
    ref = np.asarray(jesm2.Esm2(cfg, quant_int8=True).apply(
        {"params": qparams}, jnp.asarray(ids)))
    out = _port_esm2(cfg, qparams, True)(torch.from_numpy(ids).long())
    out = out.detach().numpy()
    diff = np.abs(out - ref)
    assert np.mean(diff <= 1e-4) >= 0.5
    assert diff.max() <= 0.2
    cos = np.sum(out * ref, -1) / (np.linalg.norm(out, axis=-1)
                                   * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999


def test_esm2_int8_layer_runs_the_gelu_quant_wrapper(tiny, monkeypatch):
    """The int8 block hands fc1's output to fused_gelu_quant and its codes
    to fc2 through pre_quant, as the JAX block does."""
    cfg, _, qparams = tiny
    seen = []
    real = esm2.fused_gelu_quant

    def spy(h):
        seen.append(tuple(h.shape))
        return real(h)

    monkeypatch.setattr(esm2, "fused_gelu_quant", spy)
    ids = _ids()
    _port_esm2(cfg, qparams, True)(torch.from_numpy(ids).long())
    assert seen == [(3, 24, cfg.intermediate_size)] * cfg.num_layers


def test_esm2_packed_rows_not_ported_yet(tiny):
    cfg, params, _ = tiny
    model = _port_esm2(cfg, params, False)
    ids = torch.from_numpy(_ids()).long()
    with pytest.raises(NotImplementedError):
        model(ids, segment_ids=torch.zeros_like(ids))


def test_random_init_is_seeded():
    cfg = esm2.ESM2_SIZES["esm2_tiny"]
    a, b = (esm2.Esm2(cfg, device="cpu") for _ in range(2))
    esm2.init_esm2_weights_(a, torch.Generator().manual_seed(3))
    esm2.init_esm2_weights_(b, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


# ---------------------------------------------------------------------------
# heads


def test_pooling_and_norm_match_jax():
    rng = np.random.RandomState(0)
    f = rng.randn(3, 9, 16).astype(np.float32)
    mask = (np.arange(9)[None, :] < np.array([[9], [4], [1]])).astype(np.int32)
    tf, tm = torch.from_numpy(f), torch.from_numpy(mask)
    np.testing.assert_allclose(heads.mean_pool(tf, tm).numpy(),
                               np.asarray(jheads.mean_pool(f, mask)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(heads.cls_pool(tf).numpy(),
                                  np.asarray(jheads.cls_pool(f)))
    np.testing.assert_allclose(heads.l2_normalize(tf[:, 0]).numpy(),
                               np.asarray(jheads.l2_normalize(f[:, 0])),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("proj_type", ["mlp", "linear", None])
@pytest.mark.parametrize("logit_scale", [False, True])
def test_encoder_head_matches_jax(proj_type, logit_scale):
    rng = np.random.RandomState(0)
    f = rng.randn(4, 7, 32).astype(np.float32)
    mask = (np.arange(7)[None, :] < np.array([[7], [3], [5], [1]])).astype(np.int32)
    out_dim = 32 if proj_type is None else 12
    jhead = jheads.EncoderHead(32, out_dim, proj_type=proj_type,
                               use_logit_scale=logit_scale,
                               learnable_logit_scale=logit_scale)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(f),
                        jnp.asarray(mask)).get("params", {})
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [x + np.asarray(0.1 * rng.randn(*x.shape), np.float32)
                  for x in leaves])
    ref = jhead.apply({"params": params}, jnp.asarray(f), jnp.asarray(mask))
    head = heads.EncoderHead(32, out_dim, proj_type, "mean", logit_scale,
                             logit_scale, device="cpu")
    head.load_state_dict(convert.head_state_dict(_numpy_tree(params)))
    out = head(torch.from_numpy(f), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
