"""The FlashAttention-2 forward of the PyTorch port and the ESM2 path that
reaches it (heads wider than 64) against the JAX package, on the CPU.

Kernel level: `flash_attention_plain` against the JAX Pallas kernel in
interpret mode and against the JAX `reference_attention`; the port's
`dot_product_attention` against JAX's (which takes its reference path on
the CPU) at D = 24 (the padded branch), 128 and 256. Model level: a tiny
ESM2 with heads of 128 (2 layers of 256, 2 heads, FFN 512), written as an
HF config.json, resolved by both packages, carried over with `convert`,
through `Esm2`, `SequenceEncoder` and `embed_sequences`. The committed
ESM2-15B config resolves to its published widths in both packages.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from oneprot_tpu.kernels import attention as jattn
from oneprot_tpu.kernels import flash_attention as jfa
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models import esm2 as jesm2
from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.serving import OneProtEmbedder

# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of exp, nothing else (the bar of tests/test_kernels.py)
RTOL, ATOL = 1e-4, 1e-5
AAS = "ACDEFGHIKLMNPQRSTVWY"
HUB_15B = esm2.HUB_CONFIG_DIR / "esm2_t48_15B_UR50D"
TINY_HF = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 512, "vocab_size": 33, "pad_token_id": 1,
           "mask_token_id": 32, "token_dropout": True, "layer_norm_eps": 1e-5,
           "max_position_embeddings": 1026, "position_embedding_type": "rotary",
           "architectures": ["EsmForMaskedLM"]}


def _qkv(B, H, L, D, seed, masked_rows=()):
    """q, k, v [B, H, L, D] f32 and a [B, 1, 1, L] key-padding bias (each
    row keeps a random prefix; rows in `masked_rows` mask every key)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(L // 2, L + 1, size=B)
    lens[list(masked_rows)] = 0
    valid = np.arange(L)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# kernel level


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_plain_matches_pallas_and_reference(D):
    q, k, v, bias = _qkv(2, 2, 256, D, seed=D)
    out, lse = fa.flash_attention_plain(*_t(q, k, v, bias))
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._fwd(*map(jnp.asarray, (q, k, v, bias)))
    ref = jattn.reference_attention(*map(jnp.asarray, (q, k, v, bias)))
    assert out.shape == (2, 2, 256, D) and lse.shape == (2, 2, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # the TPU kernel keeps its base-2 lse in 8 replicated lanes
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               rtol=RTOL, atol=ATOL)


def test_flash_plain_all_masked_row_stays_finite():
    """A row whose keys are all masked (bias -1e9 everywhere): finite out
    and lse in both, and the same values."""
    q, k, v, bias = _qkv(2, 2, 128, 128, seed=3, masked_rows=(1,))
    out, lse = fa.flash_attention_plain(*_t(q, k, v, bias))
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._fwd(*map(jnp.asarray, (q, k, v, bias)))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    # lse of the masked row is ~-1.44e9: compare it relative to its size
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,L", [(24, 130), (128, 96), (256, 64)])
def test_dot_product_attention_matches_jax(D, L):
    """D = 24 goes through the padded branch (zero-padded to 64, q scaled
    by sqrt(64/24)); 128 and 256 straight into the kernel's function."""
    q, k, v, bias = _qkv(2, 3, L, D, seed=L + D)
    out = fa.dot_product_attention(*_t(q, k, v, bias))
    ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v, bias)),
                                      use_pallas=False)
    assert out.shape == (2, 3, L, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_dot_product_attention_dense_bias_takes_reference_on_cpu(monkeypatch):
    """A [B, 1, L, L] bias (the packed rows' segment mask) is no shape the
    kernel takes: the CPU runs reference_attention, as JAX does."""
    q, k, v, _ = _qkv(2, 2, 40, 128, seed=5)
    seg = np.repeat((np.arange(40) // 15)[None], 2, 0)
    mask = np.where(seg[:, :, None] == seg[:, None, :], 0.0,
                    -1e9).astype(np.float32)[:, None]
    monkeypatch.setattr(fa, "flash_attention", None)  # must not be reached
    out = fa.dot_product_attention(*_t(q, k, v, mask))
    ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v, mask)),
                                      use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,bias,ok", [
    ((2, 3, 256, 128), (2, 1, 1, 256), True),
    ((2, 3, 300, 64), None, True),      # any L, as the port's other kernels
    ((1, 1, 1, 256), (1, 1, 1, 1), True),
    ((2, 3, 64, 24), None, False),      # under 64: padded by the caller
    ((2, 3, 64, 100), None, False),     # not a multiple of 8
    ((2, 3, 64, 264), None, False),     # over 256
    ((2, 3, 64, 128), (2, 1, 64, 64), False),  # dense bias
    ((2, 3, 64, 128), (2, 3, 64, 64), False),
])
def test_supports_keeps_the_jax_head_rule(shape, bias, ok):
    x = torch.zeros(shape)
    b = None if bias is None else torch.zeros(bias)
    assert fa.supports(x, x, x, b) is ok
    if shape[2] % 128 == 0 and shape[2] >= 128:  # where JAX's L rule holds
        jb = None if bias is None else jnp.zeros(bias)
        assert jfa.supports(jnp.zeros(shape), jnp.zeros(shape),
                            jnp.zeros(shape), jb) is ok


def test_cuda_launcher_refuses_cpu_tensors():
    x = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="card"):
        fa.flash_attention_fwd_cuda(x, x, x)
    with pytest.raises(ValueError):  # heads of 24 are the caller's to pad
        fa.flash_attention_fwd_cuda(x[..., :24], x[..., :24], x[..., :24])


# ---------------------------------------------------------------------------
# model level: a tiny ESM2 with heads of 128, from a config.json


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("esm2_tiny_d128")
    (root / "config.json").write_text(json.dumps(TINY_HF))
    return root


def _ids(B=3, L=24, seed=0):
    """Token rows with <cls>, residues, <eos>, padding and <mask> tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 24, size=(B, L)).astype(np.int32)
    ids[:, 0] = 0
    ids[:, -1] = 2
    ids[1, 14], ids[1, 15:] = 2, 1   # a shorter protein, then padding
    ids[2, [3, 7]] = 32              # <mask> tokens: token-dropout rescale
    return ids


def _perturbed(params, seed=1):
    """Every leaf moved off its init, so LayerNorms and biases count."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(key, x.shape)
        for x, key in zip(leaves, keys)])


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_json_resolves_alike(tiny_dir):
    ours = esm2.resolve_esm2_config(str(tiny_dir))
    theirs = jesm2.resolve_esm2_config(str(tiny_dir))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.hidden_size // ours.num_heads == 128


def test_committed_15b_config_resolves_in_both():
    for cfg in (esm2.resolve_esm2_config(HUB_15B),
                jesm2.resolve_esm2_config(str(HUB_15B))):
        assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                cfg.intermediate_size, cfg.vocab_size) == (48, 5120, 40, 20480, 33)
        assert cfg.hidden_size // cfg.num_heads == 128
    assert "esm2_t48_15B" in json.loads(
        (HUB_15B / "config.json").read_text())["_source"]


@pytest.fixture(scope="module")
def tiny_esm2(tiny_dir):
    cfg = jesm2.resolve_esm2_config(str(tiny_dir))
    params = jesm2.Esm2(cfg).init(jax.random.PRNGKey(0),
                                  jnp.asarray(_ids()))["params"]
    params = _perturbed(params)
    model = esm2.Esm2(esm2.resolve_esm2_config(str(tiny_dir)), device="cpu",
                      dtype=torch.float32)
    model.load_state_dict(convert.esm2_state_dict(_numpy_tree(params)))
    return cfg, params, model


def test_esm2_d128_matches_jax(tiny_esm2):
    cfg, params, model = tiny_esm2
    ids = _ids()
    ref = np.asarray(jesm2.Esm2(cfg).apply({"params": params},
                                           jnp.asarray(ids)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_esm2_d128_packed_rows_match_jax(tiny_esm2):
    """Packed rows at heads of 128 on the CPU: the dense segment mask and
    plain attention, as the JAX layer's reference path."""
    cfg, params, model = tiny_esm2
    ids = np.random.RandomState(4).randint(4, 24, size=(2, 32)).astype(np.int32)
    seg = np.repeat(np.where(np.arange(32) < 14, 0, 1)[None], 2, 0)
    ids[:, [0, 14]], ids[:, [13, 31]] = 0, 2  # two proteins a row
    ids[1, 24], ids[1, 25:], seg[1, 25:] = 2, 1, -1  # a shorter one, padding
    ids[0, [3, 20]] = 32  # <mask> tokens: per-protein token-dropout rescale
    seg = seg.astype(np.int32)
    ref = np.asarray(jesm2.Esm2(cfg).apply(
        {"params": params}, jnp.asarray(ids), segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(),
                    segment_ids=torch.from_numpy(seg)).numpy()
    real = seg >= 0
    np.testing.assert_allclose(out[real], ref[real], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,path", [(16, "mha_attention"), (64, "mha_attention"),
                                    (128, "dot_product_attention")])
def test_esm2_attention_dispatch_by_head_dim(D, path, monkeypatch):
    """Heads of at most 64 take the fused flash-MHA path (rotary inside the
    kernel); wider heads rotary in the compute dtype, then
    dot_product_attention with the [B, 1, 1, L] key bias."""
    calls = {"mha_attention": [], "dot_product_attention": []}
    for name in calls:
        real = getattr(esm2, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name].append(kw.get("bias"))
            return _real(*args, **kw)

        monkeypatch.setattr(esm2, name, spy)
    cfg = esm2.Esm2Config(hidden_size=2 * D, num_layers=2, num_heads=2,
                          intermediate_size=4 * D)
    model = esm2.Esm2(cfg, device="cpu", dtype=torch.float32)
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        model(ids)
    other = ({"mha_attention", "dot_product_attention"} - {path}).pop()
    assert len(calls[path]) == cfg.num_layers and not calls[other]
    assert all(tuple(b.shape) == (3, 1, 1, 24) for b in calls[path])


def test_d128_rotary_in_compute_dtype(tiny_esm2, monkeypatch):
    """The wide-head path rotates q and k with the tables cast to the
    compute dtype (JAX builds them with dtype=q2d.dtype)."""
    _, _, model = tiny_esm2
    seen = []
    real = esm2.apply_rotary

    def spy(x, cos, sin):
        seen.append((x.dtype, cos.dtype, sin.dtype, tuple(cos.shape)))
        return real(x, cos, sin)

    monkeypatch.setattr(esm2, "apply_rotary", spy)
    bf16 = esm2.Esm2(model.config, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        bf16(torch.from_numpy(_ids()).long())
    assert seen == [(torch.bfloat16,) * 3 + ((24, 128),)] * 4


@pytest.fixture(scope="module")
def tiny_pair(tiny_dir):
    """(JAX hub model, its params, the port's hub model) on the same
    weights: the D = 128 ESM2 from tiny_dir, mean pooling, 32-wide mlp."""
    kw = dict(output_dim=32, proj_type="mlp")
    jmodel = jenc.OneProtModel(encoders={
        "sequence": jenc.create_sequence_encoder(str(tiny_dir), **kw)})
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((2, 16), jnp.int32),
                         "sequence")["params"]
    params = _perturbed(params)
    port = encoders.OneProtModel({"sequence": encoders.create_sequence_encoder(
        str(tiny_dir), dtype="float32", device="cpu", **kw)})
    port.load_state_dict(convert.oneprot_state_dict(_numpy_tree(params)))
    return jmodel, params, port


def _seqs(n, seed=0, max_len=150):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), n_res))
            for n_res in rng.randint(1, max_len, size=n)]


def test_sequence_encoder_d128_matches_jax(tiny_pair):
    jmodel, params, port = tiny_pair
    ids = OneProtEmbedder(port).seq_tok(_seqs(5, seed=1), padding=64)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                  "sequence"))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), "sequence").numpy()
    assert out.shape == (5, 32)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_embed_sequences_d128_matches_jax(tiny_pair):
    jmodel, params, port = tiny_pair
    seqs = _seqs(7, seed=2) + ["M" * 300]
    jax_module = types.SimpleNamespace(
        model=jmodel, state=types.SimpleNamespace(params=params))
    ref = JaxEmbedder(jax_module, buckets=(64, 128)).embed_sequences(
        seqs, max_length=128, batch_size=4)
    out = OneProtEmbedder(port, buckets=(64, 128)).embed_sequences(
        seqs, max_length=128, batch_size=4)
    assert out.shape == (8, 32)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
