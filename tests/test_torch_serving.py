"""The serving path of the PyTorch port end to end against the JAX package
on the CPU: SequenceEncoder, OneProtModel and OneProtEmbedder
(embed_sequences, retrieve) on the same weights and sequences, plus the
port's import boundary and its refusal to run a CUDA request without a card.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models.esm2 import quantize_esm2_int8_tree as jax_quantize
from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.models import encoders, esm2, heads
from oneprot_tpu_torch.serving import OneProtEmbedder

ROOT = Path(__file__).resolve().parents[1]
AAS = "ACDEFGHIKLMNPQRSTVWY"
# f32 on the CPU: summation order and last-ulp erf/exp/LayerNorm only
RTOL, ATOL = 1e-4, 1e-5


def _seqs(n, seed=0, max_len=150):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len, size=n)
    return ["".join(rng.choice(list(AAS), n_res)) for n_res in lens]


@pytest.fixture(scope="module", params=[None, "int8"])
def pair(request):
    """(JAX model, its params, the port's model) on the same weights:
    esm2_tiny hub, mean pooling, 32-wide mlp head; float or int8 hub."""
    quantize = request.param
    kw = dict(output_dim=32, proj_type="mlp", quantize=quantize)
    jmodel = jenc.OneProtModel(encoders={"sequence": jenc.create_sequence_encoder(
        "esm2_tiny", pretrained=False, **kw)})
    ids = jnp.ones((2, 16), jnp.int32)
    float_model = jenc.OneProtModel(encoders={
        "sequence": jenc.create_sequence_encoder("esm2_tiny", pretrained=False,
                                                 output_dim=32, proj_type="mlp")})
    params = float_model.init(jax.random.PRNGKey(0), ids, "sequence")["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    if quantize:
        seq = dict(params["encoders_sequence"])
        seq["transformer"] = jax_quantize(seq["transformer"])
        params = {"encoders_sequence": seq}
    port = encoders.OneProtModel({"sequence": encoders.create_sequence_encoder(
        "esm2_tiny", dtype="float32", device="cpu", **kw)})
    port.load_state_dict(convert.oneprot_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return quantize, jmodel, params, port


def _close(out, ref, quantize):
    """Float hub: f32 rounding. int8 hub: an ulp of LayerNorm or gelu can
    flip an int8 code at a .5 tie and move one token by about one
    quantization step, which the mean pool dilutes: unit-norm embeddings
    agree to 2e-2 and in cosine to 1e-3."""
    if quantize is None:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
        assert np.min(np.sum(out * ref, -1)) >= 0.999


def test_sequence_encoder_matches_jax(pair):
    quantize, jmodel, params, port = pair
    tok = OneProtEmbedder(port).seq_tok
    ids = tok(_seqs(5, seed=1), padding=64)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                  "sequence"))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), "seqsim").numpy()
    assert out.shape == (5, 32)
    _close(out, ref, quantize)


def test_embed_sequences_matches_jax_embedder(pair):
    """Both embedders bucket, tokenize and batch the same way (batches of
    4 across buckets 64 and 128 and a truncated 256-long protein)."""
    quantize, jmodel, params, port = pair
    seqs = _seqs(9, seed=2) + ["M" * 300]
    jax_module = types.SimpleNamespace(
        model=jmodel, state=types.SimpleNamespace(params=params))
    ref = JaxEmbedder(jax_module, buckets=(64, 128)).embed_sequences(
        seqs, max_length=128, batch_size=4)
    out = OneProtEmbedder(port, buckets=(64, 128)).embed_sequences(
        seqs, max_length=128, batch_size=4)
    assert out.shape == (10, 32) and out.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-5)
    _close(out, ref, quantize)


def test_retrieve_matches_jax(pair):
    _, _, _, port = pair
    rng = np.random.RandomState(0)
    pool = rng.randn(50, 32).astype(np.float32)
    queries = pool[[3, 7, 41]] + rng.randn(3, 32).astype(np.float32) * 0.01
    scores, idx = OneProtEmbedder(port).retrieve(queries, pool, k=5)
    ref_scores, ref_idx = JaxEmbedder.retrieve(queries, pool, k=5)
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(scores, np.asarray(ref_scores), rtol=1e-5)
    assert list(idx[:, 0]) == [3, 7, 41]


def test_create_sequence_encoder_validates_like_jax():
    with pytest.raises(ValueError):
        encoders.create_sequence_encoder("esm2_tiny", quantize="fp8",
                                         device="cpu")
    with pytest.raises(ValueError):
        encoders.create_sequence_encoder("esm2_tiny", quantize="int8",
                                         frozen=False, device="cpu")
    with pytest.raises(NotImplementedError):  # no such modality
        encoders.OneProtModel({"struct_graph_v2": torch.nn.Identity()})


def test_cuda_request_without_a_card_raises():
    """The entry points default to the card; with none they fail rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        encoders.create_sequence_encoder("esm2_tiny")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


_TINY = esm2.ESM2_SIZES["esm2_tiny"]


@pytest.mark.parametrize("build", [
    lambda: esm2.Esm2(_TINY),
    lambda: esm2.Esm2(_TINY, quant_int8=True),
    lambda: esm2.Esm2Layer(_TINY),
    lambda: esm2.Int8Dense(8, 8),
    lambda: encoders.SequenceEncoder(_TINY, 32, proj_type="mlp"),
    lambda: heads.EncoderHead(64, 32, "mlp"),
    lambda: heads.EncoderHead(64, 32, use_logit_scale=True),
], ids=["esm2", "esm2_int8", "layer", "int8_dense", "sequence_encoder",
        "head_mlp", "head_logit_scale"])
def test_modules_default_to_the_card(build):
    """Each public module is built on the card unless told otherwise; with
    no card, building it raises rather than falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        build()


def test_esm2_refuses_float32_on_the_card():
    """The card runs float32 only through the f32 flash-MHA instances
    (heads that are multiples of 8 up to 64): an f32 hub with wider heads,
    or another dtype, is refused on the card when it is built, not at its
    first forward. The CPU takes any."""
    wide = dataclasses.replace(_TINY, num_heads=1)  # heads of 64: fine
    wider = dataclasses.replace(_TINY, hidden_size=256, num_heads=2,
                                intermediate_size=512)  # heads of 128
    with pytest.raises(ValueError, match="heads of 128"):
        esm2.Esm2(wider, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        esm2.Esm2(_TINY, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        encoders.create_sequence_encoder("esm2_tiny", dtype=torch.float16)
    for cfg in (_TINY, wide, wider):
        assert esm2.Esm2(cfg, dtype=torch.float32, device="cpu") is not None


def test_embed_struct_tokens_matches_jax_embedder():
    """3Di strings through the struct-token tower (esm2_tiny + 21 rows),
    both embedders batching and bucketing alike."""
    jtower = jenc.OneProtModel(encoders={
        "struct_token": jenc.create_struct_token_encoder(
            "esm2_tiny", output_dim=32)})
    params = jtower.init(jax.random.PRNGKey(3), jnp.ones((2, 16), jnp.int32),
                         "struct_token")["params"]
    port = encoders.OneProtModel({"struct_token": encoders.
                                  create_struct_token_encoder(
                                      "esm2_tiny", output_dim=32,
                                      dtype="float32", device="cpu")})
    port.load_state_dict(convert.oneprot_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(4)
    tdi = ["".join(rng.choice(list("acdefghiklmnpqrstvwy"), n))
           for n in (5, 40, 90, 200)]
    jax_module = types.SimpleNamespace(
        model=jtower, state=types.SimpleNamespace(params=params))
    ref = JaxEmbedder(jax_module, buckets=(64, 128)).embed_struct_tokens(
        tdi, max_length=128, batch_size=3)
    out = OneProtEmbedder(port, buckets=(64, 128)).embed_struct_tokens(
        tdi, max_length=128, batch_size=3)
    assert out.shape == (4, 32)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# import boundary: the port and its on-card scripts import no JAX

FORBIDDEN = ("jax", "flax", "yaml", "rich", "oneprot_tpu")
# and not loaded by importing them: h5py comes only inside the functions
# that open a file (the card's host has none)
NOT_LOADED = FORBIDDEN + ("h5py",)
PORT_FILES = sorted((ROOT / "oneprot_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serving.py",
    ROOT / "scripts" / "profile_torch_train.py",
    ROOT / "scripts" / "time_fa_backward.py",
    ROOT / "scripts" / "time_mha_backward.py",
    ROOT / "scripts" / "time_attention_forward.py",
    ROOT / "scripts" / "time_tied_row_gelu.py",
    ROOT / "scripts" / "time_host_library.py",
    ROOT / "scripts" / "probe_host_cpu.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_source_imports_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), f"{path}: imports {roots & set(FORBIDDEN)}"


def test_port_import_loads_no_jax_module():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in PORT_FILES]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {NOT_LOADED!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
