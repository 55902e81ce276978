"""MSA and seqsim training in the port against the JAX package, on the CPU.

`filter_and_create_msa_file_list`, the `MSADataset` and
`SequenceSimDataset` collates (equal arrays, bit for bit, on the shared
synthetic fixtures, every split; the seqsim CSV reader against pandas),
`MsaEncoder`'s cache methods (`backbone_is_cacheable`, `backbone_pooled`
with its f32 mean cast back to the tower's dtype, `head_from_pooled`),
three seq<->msa fully cached steps against the JAX `OneProtModule` (the
hub and the MSA tower frozen, both pooled features from the feature
cache's `msa|` keys), and the shipped default `train.yaml` and
`experiment=debug_all_modalities` composed, every dataset and encoder
they name built in the port (tests/test_torch_cli_all_modalities.py runs
that experiment through both CLIs). f32 at 1e-4 / 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.data.datasets.msa_dataset import MSADataset as JaxMSADataset
from oneprot_tpu.data.datasets.seqsim_dataset import (
    SequenceSimDataset as JaxSeqsim,
)
from oneprot_tpu.data.utils import msa_io as jmsa_io
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.train.feature_cache import FrozenFeatureCache as JaxCache
from oneprot_tpu.train.module import OneProtModule as JaxModule
from oneprot_tpu.train.optim import adam as jax_adam
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.core import config
from oneprot_tpu_torch.data import msa_io
from oneprot_tpu_torch.data.datasets.msa_dataset import MSADataset
from oneprot_tpu_torch.data.datasets.seqsim_dataset import (
    SequenceSimDataset,
    read_csv_columns,
)
from oneprot_tpu_torch.data.synthetic import generate_fixtures
from oneprot_tpu_torch.models import encoders, esm2
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.feature_cache import FrozenFeatureCache
from oneprot_tpu_torch.train.module import OneProtModule

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = str(ROOT / "configs")
RTOL, ATOL = 1e-4, 1e-5
MSA_SMALL = dict(num_layers=2, hidden_size=32, num_heads=2,
                 intermediate_size=64)
WIDTH = 16
LR = 1e-4  # Adam's first update: see tests/test_torch_siglip.py


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("msa_fixtures"))
    generate_fixtures(d, n_train=8, n_eval=4, seed=0)
    return d


# ---------------------------------------------------------------------------
# the datasets


def test_msa_file_list_matches_jax(data_dir, tmp_path):
    odd = tmp_path / "odd.csv"
    odd.write_text("id,path\np1,/a/p1.a3m\np2,/a/p2.fasta\np3,x.a3m,extra\n")
    for path in (str(odd), f"{data_dir}/train_msa.csv"):
        assert (msa_io.filter_and_create_msa_file_list(path)
                == jmsa_io.filter_and_create_msa_file_list(path))


@pytest.mark.parametrize("split,depth,buckets", [
    ("train", 4, [64, 128]), ("val", 3, None), ("test", 50, [32, 64]),
    ("train", 2, [16])])
def test_msa_dataset_collate_matches_jax(data_dir, split, depth, buckets):
    kw = dict(data_dir=data_dir, split=split, msa_depth=depth,
              max_length=48 if buckets == [16] else 1024, buckets=buckets)
    port, ref = MSADataset(**kw), JaxMSADataset(**kw)
    assert len(port) == len(ref) and port.modality == ref.modality == "msa"
    items = [port[i] for i in range(len(port))]
    assert items == [ref[i] for i in range(len(ref))]
    for chunk in (items[:3], items[3:4]):
        p, j = port.collate_fn(chunk), ref.collate_fn(chunk)
        for got, want in zip(p[:2], j[:2]):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert p[2:] == j[2:]


def test_seqsim_reader_matches_pandas(data_dir, tmp_path):
    pd = pytest.importorskip("pandas")
    odd = tmp_path / "odd.csv"
    odd.write_text('req_seq,aligned_seq\n'
                   'MKT,"M-KT"\n'
                   '"A,B",NA\n'
                   '\n'
                   'GGG,\n'
                   'null,"x ""y"""\n', encoding="utf-8")
    for path in (odd, *(Path(data_dir) / f"{s}_msa_seqsim.csv"
                        for s in ("train", "val", "test"))):
        df = pd.read_csv(path)
        want = [{c: str(df[c].iloc[i]) for c in df.columns}
                for i in range(len(df))]
        assert read_csv_columns(str(path)) == want, path


@pytest.mark.parametrize("split", ["train", "val"])
def test_seqsim_collate_matches_jax(data_dir, split):
    kw = dict(data_dir=data_dir, split=split, buckets=[64, 128])
    port, ref = SequenceSimDataset(**kw), JaxSeqsim(**kw)
    assert port.num_items() == ref.num_items() and len(port) == len(ref)
    items = [port[i] for i in range(len(port))]
    assert items == [ref[i] for i in range(len(ref))]
    # a protein whose mutations never apply falls back to the wild type
    seq0 = items[0][0]
    port.pathogenic_mutations[seq0] = ref.pathogenic_mutations[seq0] = [
        "W999A", "Z1Y"]
    for seed in (0, 5):
        p = port.collate_fn(items[:3], rng=np.random.RandomState(seed))
        j = ref.collate_fn(items[:3], rng=np.random.RandomState(seed))
        for got, want in zip(p[:2], j[:2]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert p[2:] == j[2:]
    p = port.collate_fn(items[:1])
    assert p[3][2] == seq0  # list1's pathogenic slot: the wild type
    with pytest.raises(ValueError, match="Mutation mismatch"):
        SequenceSimDataset._apply_mutation("MKT", "A2C")


# ---------------------------------------------------------------------------
# the MSA encoder's cache methods and the fully cached steps


def _msa_tokens(rng, B=3, R=4, L=12):
    tok = rng.randint(4, 24, size=(B, R, L)).astype(np.int32)
    tok[:, :, 0] = 0
    tok[0, 2:] = 1           # padded rows
    tok[1, :, 9:] = 1        # padded columns
    return tok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msa_encoder_cache_methods_match_jax(dtype):
    jm = jenc.create_msa_encoder(output_dim=WIDTH, dtype=dtype, **MSA_SMALL)
    tok = _msa_tokens(np.random.RandomState(0))
    params = jm.init(jax.random.key(1), jnp.asarray(tok))["params"]
    pm = encoders.create_msa_encoder(output_dim=WIDTH, dtype=dtype,
                                     device="cpu", **MSA_SMALL)
    pm.load_state_dict(convert.msa_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    assert pm.backbone_is_cacheable and jm.backbone_is_cacheable
    want = jm.apply({"params": params}, jnp.asarray(tok),
                    method=jenc.MsaEncoder.backbone_pooled)
    got = pm.backbone_pooled(torch.from_numpy(tok).long())
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    # bf16: the two frameworks round the tower's products at other places
    tol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-1)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), *tol)
    pooled = np.array(want, np.float32)
    np.testing.assert_allclose(
        pm.head_from_pooled(torch.from_numpy(pooled)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(pooled),
                            method=jenc.MsaEncoder.head_from_pooled)), *tol)
    with pytest.raises(NotImplementedError, match="use_all_msa"):
        encoders.create_msa_encoder(use_all_msa=False, device="cpu",
                                    **MSA_SMALL)


def _seq_ids(rng, B, L):
    ids = rng.randint(4, 24, size=(B, L)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 0, 2
    ids[-1, L // 2], ids[-1, L // 2 + 1:] = 2, 1
    return ids


def test_msa_fully_cached_steps_match_jax():
    """A frozen hub and the frozen MSA tower: both pooled features through
    the feature cache (keys `sequence|` per row and `msa|` per [R, L]
    block, as the JAX cache keys them), three `train_step_fully_cached`
    steps and an eval step, loss and every trainable leaf."""
    hub = jenc.create_sequence_encoder("esm2_tiny", output_dim=WIDTH,
                                       proj_type="mlp", frozen=True,
                                       dtype="float32")
    tower = jenc.create_msa_encoder(output_dim=WIDTH, dtype="float32",
                                    **MSA_SMALL)
    jm = JaxModule(components={"sequence": hub, "msa": tower},
                   optimizer=lambda: jax_adam(LR), loss_fn="CLIP",
                   use_l1_regularization=True, seed=0,
                   frozen_param_dtype=None)
    rng = np.random.RandomState(0)
    jm.init({"msa": (_seq_ids(rng, 2, 12), _msa_tokens(rng))})
    params = jax.tree_util.tree_map(np.asarray, jm.state.params)
    cfg = esm2.Esm2Config(**{f: getattr(hub.config, f) for f in (
        "hidden_size", "num_layers", "num_heads", "intermediate_size",
        "vocab_size")})
    pm = OneProtModule(
        {"sequence": encoders.SequenceEncoder(cfg, WIDTH, proj_type="mlp",
                                              frozen=True, device="cpu",
                                              dtype=torch.float32),
         "msa": encoders.create_msa_encoder(output_dim=WIDTH, dtype="float32",
                                            device="cpu", **MSA_SMALL)},
        optimizer=lambda: optim.adam(LR), loss_fn="CLIP",
        use_l1_regularization=True, frozen_param_dtype=None)
    pm.model.load_state_dict(convert.oneprot_state_dict(params))
    pm.init()
    assert pm.hub_is_cacheable() and pm.modality_is_cacheable("msa")
    assert not pm.modality_is_cacheable("struct_graph")
    pcache, jcache = FrozenFeatureCache(), JaxCache()
    state = jm.state
    batches = [(_seq_ids(rng, 3, 14), _msa_tokens(rng)) for _ in range(2)]
    for step, (seq, msa) in enumerate(batches + batches[:1]):
        sp, mp = (pcache.get_pooled(pm, seq),
                  pcache.get_pooled(pm, msa, "msa"))
        jsp = jcache.get_pooled(jm, seq)
        jmp = jcache.get_pooled(jm, msa, "msa")
        np.testing.assert_allclose(mp, jmp, rtol=RTOL, atol=ATOL)
        state, jloss = jm.train_step_fully_cached(state, "msa", jnp.asarray(jsp),
                                                  jnp.asarray(jmp))
        loss, _ = pm.train_step_fully_cached("msa", sp, mp)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        want = convert.oneprot_state_dict(
            jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in pm.model.named_parameters():
            if p.requires_grad:
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
    assert sorted(pcache._store) == sorted(jcache._store)
    assert sum(k.startswith(b"msa|") for k in pcache._store) == 6
    assert (pcache.hits, pcache.misses) == (jcache.hits, jcache.misses)
    assert pcache.host_bytes() == sum(
        len(k) + np.asarray(v).nbytes for k, v in jcache._store.items())
    seq, msa = batches[1]
    s, m, loss = pm.eval_step_fully_cached("msa", pcache.get_pooled(pm, seq),
                                           pcache.get_pooled(pm, msa, "msa"))
    es, em, el = pm.eval_step("msa", seq, msa)
    for got, want in ((s, es), (m, em), (loss, el)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the shipped configs


@pytest.mark.parametrize("overrides", [[], ["experiment=debug_all_modalities"]],
                         ids=["train.yaml", "debug_all_modalities"])
def test_shipped_configs_build_every_dataset_and_encoder(data_dir,
                                                         overrides):
    """The shipped default train.yaml (pocket, seqsim, struct_graph and
    text at oneprot.yaml's modalities) and debug_all_modalities: every
    dataset and every encoder they name is built in the port (the encoders
    at the debug widths on the CPU, the default's widths on the meta
    device)."""
    cfg = config.resolve(config.load_config(
        CONFIG_DIR, "train", [f"paths.data_dir={data_dir}", *overrides]),
        resolvers={"hydra": lambda a: "/unused"})
    dm = config.instantiate({**cfg["data"], "seed": cfg["seed"]})
    dm.setup()
    want = set(cfg["data"]["modalities"])
    assert {k.rsplit("_", 1)[0] for k in dm.datasets} == want
    assert len(dm.datasets) == 3 * len(want)
    for name, (seq, mod) in dm.example_batches().items():
        # two items a batch; seqsim makes three pairs of each
        assert len(seq) == (6 if name == "seqsim" else 2) and name in want
    device = "cpu" if overrides else "meta"
    comps = cfg["model"]["components"]
    built = {name: config.instantiate({**c, "device": device})
             for name, c in comps.items()}
    model = encoders.OneProtModel(built)
    assert set(model.encoders) == set(comps)
    if not overrides:
        assert set(comps) == {"sequence", "struct_graph", "pocket", "text"}
        assert built["struct_graph"].encoder.config.hidden_size == 128
        assert built["sequence"].config.num_layers == 33
