"""The MSA options no shipped config sets, against the JAX package, on the
CPU in f32: `MsaEncoder(use_all_msa=False)` (the query row pooled alone
with `pooling_type` mean, cls or attention1d), `create_msa_encoder`'s
identity -> mean, `greedy_select(mode="min")`, and the frozen-feature
store's digest, which the port keys on the MSA encoder's pooling (the JAX
keys ignore it: a documented divergence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.data.utils import msa_io as jmsa_io
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import msa_io
from oneprot_tpu_torch.models import encoders
from oneprot_tpu_torch.train.feature_cache import params_fingerprint
from oneprot_tpu_torch.train.module import OneProtModule
from tests.test_torch_msa import (
    ATOL,
    RTOL,
    SMALL,
    _numpy_tree,
    _padded_tokens,
    _perturbed,
    write_a3m,
)


@pytest.mark.parametrize("pooling", ["mean", "cls", "attention1d"])
def test_query_row_pooling_matches_jax(pooling):
    """use_all_msa=False: the tower's query row (row 0) pooled over its own
    tokens, then the mlp head, on padded rows and columns; the pooled
    features and the projected ones against the JAX encoder, and which
    poolings the trainer may cache."""
    tok = _padded_tokens(seed=11)
    kw = dict(output_dim=32, dtype="float32", use_all_msa=False,
              pooling_type=pooling, **SMALL)
    jm = jenc.create_msa_encoder(**kw)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(4),
                                         jnp.asarray(tok))["params"], 5)
    want, want_pooled = map(np.asarray, jax.jit(lambda p, t: (
        jm.apply({"params": p}, t),
        jm.apply({"params": p}, t, method=jm.backbone_pooled)))(
            params, jnp.asarray(tok)))
    port = encoders.create_msa_encoder(device="cpu", **kw)
    port.load_state_dict(convert.msa_state_dict(_numpy_tree(params)))
    tokens = torch.from_numpy(tok).long()
    got = port(tokens).detach().numpy()
    pooled = port.backbone_pooled(tokens).detach().numpy()
    np.testing.assert_allclose(pooled, want_pooled, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert port.backbone_is_cacheable == jm.backbone_is_cacheable == (
        pooling != "attention1d")
    trainable = [n for n, p in port.named_parameters() if p.requires_grad]
    assert trainable and all(n.startswith("head.") for n in trainable)


def test_identity_pooling_becomes_mean_in_the_factory():
    """create_msa_encoder turns 'identity' into 'mean' without use_all_msa,
    as the JAX factory does; the class itself refuses it."""
    port = encoders.create_msa_encoder(use_all_msa=False, device="cpu",
                                       dtype="float32", **SMALL)
    jm = jenc.create_msa_encoder(use_all_msa=False, dtype="float32", **SMALL)
    assert port.pooling_type == jm.pooling_type == "mean"
    assert encoders.create_msa_encoder(device="cpu", dtype="float32",
                                       **SMALL).pooling_type == "identity"
    with pytest.raises(ValueError, match="identity"):
        encoders.MsaEncoder(port.config, 32, pooling_type="identity",
                            use_all_msa=False, device="cpu",
                            dtype=torch.float32)


@pytest.fixture(scope="module")
def a3m_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("msas_min")
    rng = np.random.RandomState(1)
    specs = [(40, 30), (57, 12), (25, 3), (90, 20)]
    return [write_a3m(root / f"msa_{i}.a3m", rng, n, m)
            for i, (n, m) in enumerate(specs)]


@pytest.mark.parametrize("num_seqs", [8, 4, 1, 64])
def test_greedy_select_min_matches_jax(a3m_files, num_seqs):
    """mode="min" (the closest homologs first) against the JAX function:
    the query row first, the first row on a tie, the picks in file
    order."""
    for path in a3m_files:
        msa = msa_io.read_msa(path)
        got = msa_io.greedy_select(msa, num_seqs, mode="min")
        assert got == jmsa_io.greedy_select(msa, num_seqs, mode="min")
        assert got[0] == msa[0] and len(got) == min(num_seqs, len(msa))
        idx = [msa.index(row) for row in got]
        assert idx == sorted(idx)
        if len(msa) > num_seqs > 1:
            assert got != msa_io.greedy_select(msa, num_seqs, mode="max")
    with pytest.raises(ValueError, match="mode"):
        msa_io.greedy_select(msa_io.read_msa(a3m_files[0]), 2, mode="mid")


def test_store_digest_keys_the_msa_pooling():
    """The frozen-feature store's digest of a module with an MSA encoder:
    the all-MSA mean's is the weights' digest as before; query-row mean
    and cls each give another, on the same weights."""
    digests = {}
    state = None
    for name, kw in (("all", {}), ("mean", dict(use_all_msa=False)),
                     ("cls", dict(use_all_msa=False, pooling_type="cls"))):
        enc = encoders.create_msa_encoder(device="cpu", dtype="float32",
                                          output_dim=32, **SMALL, **kw)
        if state is None:
            state = enc.state_dict()
        enc.load_state_dict(state)
        module = OneProtModule({"msa": enc}, frozen_param_dtype=None).init()
        digests[name] = module.frozen_digest()
        if name == "all":
            assert digests[name] == params_fingerprint(module._frozen_state())
    assert len(set(digests.values())) == 3
