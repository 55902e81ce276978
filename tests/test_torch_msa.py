"""The MSA slice of the PyTorch port against the JAX package, on the CPU at
small sizes: MSA reading and subsampling, the MSA batch converter, the
plain tied-row attention (against the Pallas kernel in interpret mode and
against the JAX einsum path), the MSA Transformer and encoder through
`convert.msa_state_dict` (padded rows and columns), the committed MSA
golden, and `OneProtEmbedder.embed_msas` end to end.

Weights are made by the JAX init (perturbed, so biases and LayerNorms are
not at their init values) and carried over with oneprot_tpu_torch.convert;
inputs come from numpy seeds.
"""

import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.data.tokenizers import MsaBatchConverter as JaxConverter
from oneprot_tpu.data.utils import msa_io as jmsa_io
from oneprot_tpu.kernels.tied_row_attention import tied_row_attention as jax_tra
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models import msa_transformer as jmt
from oneprot_tpu.models.hf_convert import convert_msa1b_state_dict
from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import msa_io
from oneprot_tpu_torch.data.tokenizers import MsaBatchConverter
from oneprot_tpu_torch.kernels import tied_row_attention as tra
from oneprot_tpu_torch.kernels.attention import fused_tied_row
from oneprot_tpu_torch.models import encoders, msa_transformer
from oneprot_tpu_torch.serving import OneProtEmbedder

# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of erf, exp and LayerNorm, nothing else
RTOL, ATOL = 1e-4, 1e-5
GOLDEN = Path(__file__).resolve().parent / "goldens" / "msa_oracle_golden.npz"
AAS = "ACDEFGHIKLMNPQRSTVWY"
# a small tower with the kernel's head dim: 2 layers, 2 heads of 64
SMALL = dict(num_layers=2, hidden_size=128, num_heads=2, intermediate_size=256)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed):
    """JAX init params + 0.05 N(0, 1) on every leaf (non-zero biases,
    LayerNorms off identity)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        x + 0.05 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])


def write_a3m(path, rng, query_len, n_homologs):
    """A synthetic .a3m: a random query and point-mutated homologs with '-'
    gaps and lowercase insertions (which read_msa removes)."""
    query = rng.choice(list(AAS), query_len)
    lines = [">query", "".join(query)]
    for i in range(n_homologs):
        row = query.copy()
        mutate = rng.rand(query_len) < rng.uniform(0.05, 0.6)
        row[mutate] = rng.choice(list(AAS), int(mutate.sum()))
        row[rng.rand(query_len) < 0.1] = "-"
        out = []
        for ch in row:
            out.append(ch)
            if rng.rand() < 0.03:
                out.append("".join(rng.choice(list("acdefghik"),
                                              rng.randint(1, 4))))
        lines += [f">homolog_{i} synthetic", "".join(out)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# data


@pytest.fixture(scope="module")
def a3m_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("msas")
    rng = np.random.RandomState(0)
    specs = [(40, 30), (57, 12), (25, 3), (90, 20), (1030, 5)]
    return [write_a3m(root / f"msa_{i}.a3m", rng, n, m)
            for i, (n, m) in enumerate(specs)]


def test_read_msa_matches_jax(a3m_files):
    for path in a3m_files:
        got = msa_io.read_msa(path)
        assert got == jmsa_io.read_msa(path)
        assert len({len(s) for _, s in got}) == 1  # insertions removed
    stem = a3m_files[0][:-len(".a3m")]
    assert msa_io.read_msa(stem) == jmsa_io.read_msa(stem)
    assert msa_io.remove_insertions("AcD.e-F*") == "AD-F"


@pytest.mark.parametrize("num_seqs", [8, 4, 1, 64])
def test_greedy_select_matches_jax(a3m_files, num_seqs):
    for path in a3m_files:
        msa = msa_io.read_msa(path)
        got = msa_io.greedy_select(msa, num_seqs)
        assert got == jmsa_io.greedy_select(msa, num_seqs)
        assert got[0] == msa[0] and len(got) == min(num_seqs, len(msa))
        idx = [msa.index(row) for row in got]
        assert idx == sorted(idx)


def test_msa_batch_converter_matches_jax(a3m_files):
    msas = [msa_io.greedy_select(msa_io.read_msa(p), 6) for p in a3m_files]
    for kw in ({}, {"max_rows": 4}, {"max_rows": 6, "pad_rows_to": 8,
                                     "pad_cols_to": 128}):
        got = MsaBatchConverter()(msas, **kw)
        want = JaxConverter()(msas, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    tok = MsaBatchConverter()(msas[-1:])
    assert tok.shape[-1] == 1 + 1022                # <cls>, cut at 1022
    assert (tok[0, :, 0] == 0).all() and not (tok == 2).any()  # no <eos>


# ---------------------------------------------------------------------------
# tied-row attention


def _qkv(B, R, L, nh, d=64, seed=0, masked_tail=17):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, R, L, nh * d).astype(np.float32) for _ in range(3))
    bias = np.zeros((B, 1, 1, L), np.float32)
    bias[0, ..., L - masked_tail:] = -1e9
    return q, k, v, bias


@pytest.mark.parametrize("R,L", [(4, 256), (3, 384)])
def test_plain_tied_row_matches_pallas_kernel(R, L):
    """The Pallas kernel in interpret mode at tests/test_kernels.py's own
    cases and bar (masked tail columns, rtol/atol 2e-3)."""
    B, nh, d = 2, 4, 64
    q, k, v, bias = _qkv(B, R, L, nh)
    scale = tra.tied_scale(d, R)
    want = jax_tra(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nh,
                   col_bias=jnp.asarray(bias), scale=scale, interpret=True)
    t = torch.from_numpy
    got = tra.tied_row_attention_plain(t(q), t(k), t(v), nh, col_bias=t(bias),
                                       scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("R,L,nh", [(2, 64, 3), (3, 200, 3), (1, 200, 4),
                                    (1, 64, 1)])
def test_plain_tied_row_matches_jax_einsum_path(R, L, nh):
    """At shapes the Pallas kernel refuses (odd head counts, L = 64 and
    200, one row): the JAX TiedRowAttention's einsum path, its output
    projection set to the identity, against the plain version on the same
    q, k, v projections."""
    B, d = 2, 64
    H = nh * d
    cfg = jmt.MsaTransformerConfig(hidden_size=H, num_heads=nh)
    rng = np.random.RandomState(L + R)
    x = rng.randn(B, R, L, H).astype(np.float32)
    bias = np.zeros((B, 1, 1, L), np.float32)
    bias[1, ..., L - 9:] = -1e9
    dense = {n: {"kernel": rng.randn(H, H).astype(np.float32) * H ** -0.5,
                 "bias": rng.randn(H).astype(np.float32) * 0.1}
             for n in "qkv"}
    dense["o"] = {"kernel": np.eye(H, dtype=np.float32),
                  "bias": np.zeros(H, np.float32)}
    want = jmt.TiedRowAttention(cfg).apply(
        {"params": dense}, jnp.asarray(x), jnp.asarray(bias),
        jnp.ones((B, R, L), bool))
    t = torch.from_numpy
    q, k, v = (t(x) @ t(dense[n]["kernel"]) + t(dense[n]["bias"]) for n in "qkv")
    got = tra.tied_row_attention_plain(q, k, v, nh, col_bias=t(bias),
                                       scale=tra.tied_scale(d, R))
    assert got.shape == (B, R, L, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_tied_row_refuses_a_gradient():
    q, k, v, bias = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 1))
    q.requires_grad_()
    out = fused_tied_row(q, k, v, 1, col_bias=bias)
    torch.testing.assert_close(out.detach(), tra.tied_row_attention_plain(
        q.detach(), k, v, 1, col_bias=bias))
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_tied_row_kernel_refuses_what_it_does_not_take():
    """Checked before any launch, so here too: a CPU tensor, a head dim
    other than 64, L past the strip, a malformed bias."""
    x = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tra.tied_row_attention_cuda(x, x, x, 2)           # not on the card
    with pytest.raises(ValueError):
        tra.tied_row_attention_cuda(x, x, x, 4)           # head dim 32
    long = torch.zeros(1, 1, tra.MAX_LENGTH + 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tra.tied_row_attention_cuda(long, long, long, 1)
    with pytest.raises(ValueError):
        tra.tied_row_attention_plain(x, x, x, 2, col_bias=torch.zeros(1, 16))


# ---------------------------------------------------------------------------
# the tower and the encoder


def _padded_tokens(seed=3, B=2, R=5, L=24):
    """Tokens with padded columns (batch 1 after column 17) and padded rows
    (batch 1's last row, batch 0's last two)."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(4, 24, (B, R, L)).astype(np.int32)
    tok[:, :, 0] = 0
    tok[1, :, 18:] = 1
    tok[1, -1] = 1
    tok[0, -2:] = 1
    tok[0, 1, 5:8] = 30  # gaps
    return tok


def test_msa_transformer_matches_jax():
    cfg = jmt.MsaTransformerConfig(max_positions=64, max_rows=8, **SMALL)
    tok = _padded_tokens()
    jmodel = jmt.MsaTransformer(cfg)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(tok))["params"], 1)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                            jnp.asarray(tok)))
    port = msa_transformer.MsaTransformer(
        msa_transformer.MsaTransformerConfig(**dataclasses.asdict(cfg)),
        device="cpu", dtype=torch.float32)
    port.load_state_dict(convert.msa_transformer_state_dict(
        _numpy_tree(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(tok).long()).numpy()
    assert got.shape == tok.shape + (cfg.hidden_size,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("padded", [True, False])
def test_msa_encoder_matches_jax(padded):
    """create_msa_encoder's head (mlp, fixed logit scale 1/0.07) over the
    all-MSA f32 mean, on a batch with and without padded rows and
    columns."""
    tok = _padded_tokens(seed=5)
    if not padded:
        tok[tok == 1] = 7
    jm = jenc.create_msa_encoder(output_dim=32, dtype="float32", **SMALL)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                         jnp.asarray(tok))["params"], 3)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(tok)))
    port = encoders.create_msa_encoder(output_dim=32, dtype="float32",
                                       device="cpu", **SMALL)
    port.load_state_dict(convert.msa_state_dict(_numpy_tree(params)))
    got = port(torch.from_numpy(tok).long()).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1 / 0.07,
                               rtol=1e-5)
    assert not any(p.requires_grad for p in port.transformer.parameters())


def test_msa_golden_replays_through_the_port():
    """tests/goldens/msa_oracle_golden.npz: the recorded fair-esm-layout
    state_dict through the JAX package's `convert_msa1b_state_dict` and
    then `msa_transformer_state_dict`; the port's tower reproduces the
    recorded output at tests/test_msa_golden.py's bar."""
    data = np.load(GOLDEN)
    tokens, want = data["tokens"], data["expected"]
    sd = {k[len("sd::"):]: data[k] for k in data.files if k.startswith("sd::")}
    num_layers = 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("layers."))
    flax_params = convert_msa1b_state_dict(sd, num_layers)
    cfg = msa_transformer.MsaTransformerConfig(
        vocab_size=sd["embed_tokens.weight"].shape[0],
        hidden_size=sd["embed_tokens.weight"].shape[1], num_layers=num_layers,
        num_heads=2,
        intermediate_size=sd["layers.0.feed_forward_layer.layer.fc1.weight"].shape[0],
        max_positions=flax_params["embed_positions"].shape[0],
        max_rows=flax_params["msa_position_embedding"].shape[0])
    port = msa_transformer.MsaTransformer(cfg, device="cpu", dtype=torch.float32)
    port.load_state_dict(convert.msa_transformer_state_dict(flax_params))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_msa_modules_default_to_the_card():
    """Built on the card unless told otherwise; with no card, building
    raises rather than falls back to the CPU. The card takes bf16 only."""
    with pytest.raises(ValueError):
        msa_transformer.MsaTransformer(msa_transformer.MsaTransformerConfig(
            **SMALL), dtype=torch.float32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        encoders.create_msa_encoder(**SMALL)


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def msa_pair():
    """(JAX OneProtModel, its params, the port's OneProtModel) on the same
    weights: an MSA encoder of the small size, 32-wide mlp head."""
    kw = dict(output_dim=32, dtype="float32", **SMALL)
    jmodel = jenc.OneProtModel(encoders={"msa": jenc.create_msa_encoder(**kw)})
    tok = np.ones((1, 2, 8), np.int32)
    tok[:, :, 0] = 0
    init = jax.jit(jmodel.init, static_argnums=2)
    params = _perturbed(init(jax.random.PRNGKey(4), jnp.asarray(tok),
                             "msa")["params"], 5)
    port = encoders.OneProtModel({"msa": encoders.create_msa_encoder(
        device="cpu", **kw)})
    port.load_state_dict(convert.oneprot_state_dict(_numpy_tree(params)))
    return jmodel, params, port


def test_embed_msas_matches_jax_embedder(msa_pair, a3m_files):
    """Both embedders read, subsample, bucket and batch the same way:
    batches of 2 across buckets 64 and 128, depth 4 (one MSA has fewer
    rows), and a 1030-long query cut to max_length."""
    jmodel, params, port = msa_pair
    jax_module = types.SimpleNamespace(
        model=jmodel, state=types.SimpleNamespace(params=params))
    kw = dict(msa_depth=4, max_length=128, batch_size=2)
    want = JaxEmbedder(jax_module, buckets=(64, 128)).embed_msas(a3m_files, **kw)
    got = OneProtEmbedder(port, buckets=(64, 128)).embed_msas(a3m_files, **kw)
    assert got.shape == (len(a3m_files), 32) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1 / 0.07,
                               rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
