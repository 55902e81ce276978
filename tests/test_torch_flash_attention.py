"""The FlashAttention-2 forward of the PyTorch port and the ESM2 path that
reaches it (heads wider than 64) against the JAX package, on the CPU.

Kernel level: `flash_attention_plain` against the JAX Pallas kernel in
interpret mode and against the JAX `reference_attention`; the port's
`dot_product_attention` against JAX's (which takes its reference path on
the CPU) at D = 24 (the padded branch), 128 and 256. Model level: tiny
ESM2s with 2 heads of 128 (2 layers of 256, FFN 512) and of 256 (2 layers
of 512, FFN 1024), written as HF config.json files and resolved by both
packages, on the same weights (drawn with numpy, carried over with
`convert`): `Esm2`'s forward, unpacked and on packed rows, and every
parameter's gradient; at heads of 128 also `SequenceEncoder` and
`embed_sequences`. The committed ESM2-15B config resolves to its
published widths in both packages.
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
# model level: a tiny ESM2 with heads of 128 or 256, from a config.json


def _tiny_hf(head_dim):
    """TINY_HF at 2 heads of `head_dim` (FFN 4x the width)."""
    return {**TINY_HF, "hidden_size": 2 * head_dim,
            "intermediate_size": 4 * head_dim}


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("esm2_tiny_d128")
    (root / "config.json").write_text(json.dumps(TINY_HF))
    return root


@pytest.fixture(scope="module", params=[128, 256], ids=lambda d: f"d{d}")
def esm2_dir(request, tmp_path_factory):
    """A config.json of 2 layers with 2 heads of 128 (TINY_HF) or 256: the
    FlashAttention-2 kernels' instances for heads up to 128 and above."""
    root = tmp_path_factory.mktemp(f"esm2_tiny_d{request.param}")
    (root / "config.json").write_text(json.dumps(_tiny_hf(request.param)))
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


def _packed_ids():
    """Two packed rows of 32 tokens: two proteins a row, the second row's
    second one shorter, then padding (segment id -1)."""
    ids = np.random.RandomState(4).randint(4, 24, size=(2, 32)).astype(np.int32)
    seg = np.repeat(np.where(np.arange(32) < 14, 0, 1)[None], 2, 0)
    ids[:, [0, 14]], ids[:, [13, 31]] = 0, 2  # two proteins a row
    ids[1, 24], ids[1, 25:], seg[1, 25:] = 2, 1, -1  # a shorter one, padding
    ids[0, [3, 20]] = 32  # <mask> tokens: per-protein token-dropout rescale
    return ids, seg.astype(np.int32)


def _perturbed(params, seed=1):
    """Every leaf moved off its init, so LayerNorms and biases count."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(key, x.shape)
        for x, key in zip(leaves, keys)])


def _random_esm2_params(cfg, seed=0):
    """JAX `Esm2` params drawn with numpy at the shapes `init` gives (no
    init run): kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.05^2),
    every other leaf N(0, 0.05^2), so that LayerNorms and biases count."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jesm2.Esm2(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(_ids())))["params"]

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        sd = x.shape[0] ** -0.5 if "kernel" in name else 0.05
        a = rng.normal(0.0, sd, size=x.shape).astype(np.float32)
        return jnp.asarray(a + 1.0 if "scale" in name else a)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_json_resolves_alike(esm2_dir):
    ours = esm2.resolve_esm2_config(str(esm2_dir))
    theirs = jesm2.resolve_esm2_config(str(esm2_dir))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    spec = json.loads((esm2_dir / "config.json").read_text())
    assert ours.hidden_size // ours.num_heads == spec["hidden_size"] // 2


def test_committed_15b_config_resolves_in_both():
    for cfg in (esm2.resolve_esm2_config(HUB_15B),
                jesm2.resolve_esm2_config(str(HUB_15B))):
        assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                cfg.intermediate_size, cfg.vocab_size) == (48, 5120, 40, 20480, 33)
        assert cfg.hidden_size // cfg.num_heads == 128
    assert "esm2_t48_15B" in json.loads(
        (HUB_15B / "config.json").read_text())["_source"]


@pytest.fixture(scope="module")
def tiny_esm2(esm2_dir):
    """(JAX config, params, the port's f32 CPU Esm2 on the same weights, a
    jitted JAX forward (params, ids, segment ids or None))."""
    cfg = jesm2.resolve_esm2_config(str(esm2_dir))
    params = _random_esm2_params(cfg)
    model = esm2.Esm2(esm2.resolve_esm2_config(str(esm2_dir)), device="cpu",
                      dtype=torch.float32)
    model.load_state_dict(convert.esm2_state_dict(_numpy_tree(params)))
    forward = jax.jit(lambda p, ids, seg: jesm2.Esm2(cfg).apply(
        {"params": p}, ids, segment_ids=seg))
    return cfg, params, model, forward


def test_esm2_d128_matches_jax(tiny_esm2):
    cfg, params, model, forward = tiny_esm2
    ids = _ids()
    ref = np.asarray(forward(params, jnp.asarray(ids), None))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_esm2_d128_packed_rows_match_jax(tiny_esm2):
    """Packed rows at heads of 128 and 256 on the CPU: the dense segment
    mask and plain attention, as the JAX layer's reference path."""
    cfg, params, model, forward = tiny_esm2
    ids, seg = _packed_ids()
    ref = np.asarray(forward(params, jnp.asarray(ids), jnp.asarray(seg)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(),
                    segment_ids=torch.from_numpy(seg)).numpy()
    real = seg >= 0
    np.testing.assert_allclose(out[real], ref[real], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_esm2_gradients_match_jax(tiny_esm2, packed, monkeypatch):
    """Every parameter's gradient of sum(hidden * g) (g from numpy, zero on
    padding, scaled to unit norm as a mean loss would be, so the gradients
    are O(1) and the bar is the f32 one of the forward) against jax.grad of
    the JAX Esm2 on the same weights. Unpacked
    rows reach `_FlashAttention` (the kernels' autograd Function; its plain
    forward and backward on the CPU) once a layer each way; packed rows take
    the dense segment mask on the CPU, as the JAX layer does."""
    cfg, params, model, _ = tiny_esm2
    ids, seg = _packed_ids() if packed else (_ids(), None)
    real = ids != cfg.pad_token_id if seg is None else seg >= 0
    g = np.random.RandomState(7).randn(*ids.shape, cfg.hidden_size) * real[..., None]
    g = (g / np.linalg.norm(g)).astype(np.float32)
    j_seg = None if seg is None else jnp.asarray(seg)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jesm2.Esm2(cfg).apply(
        {"params": p}, jnp.asarray(ids), segment_ids=j_seg) * g)))(params)
    want = convert.esm2_state_dict(_numpy_tree(want))
    calls = []
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        real_fn = getattr(fa, name)

        def spy(*args, _fn=real_fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(fa, name, spy)
    model.zero_grad()
    out = model(torch.from_numpy(ids).long(),
                segment_ids=None if seg is None else torch.from_numpy(seg))
    (out * torch.from_numpy(g)).sum().backward()
    n = 0 if packed else cfg.num_layers
    assert calls.count("flash_attention_plain") == n
    assert calls.count("flash_attention_bwd_plain") == n
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(grads[key].numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("D,path", [(16, "mha_attention"), (64, "mha_attention"),
                                    (128, "dot_product_attention"),
                                    (256, "dot_product_attention")])
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
    cfg, _, model, _ = tiny_esm2
    seen = []
    real = esm2.apply_rotary

    def spy(x, cos, sin):
        seen.append((x.dtype, cos.dtype, sin.dtype, tuple(cos.shape)))
        return real(x, cos, sin)

    monkeypatch.setattr(esm2, "apply_rotary", spy)
    bf16 = esm2.Esm2(model.config, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        bf16(torch.from_numpy(_ids()).long())
    head_dim = cfg.hidden_size // cfg.num_heads
    assert seen == [(torch.bfloat16,) * 3 + ((24, head_dim),)] * 4


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
