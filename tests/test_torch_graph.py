"""The port's graph and pocket tower against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages: the segment
ops, `rbf_expand`, `backbone_frames`, `ProNet` and `StructGraphEncoder` in
eval mode on weights carried over by `convert.struct_graph_state_dict`
(backbone and allatom levels), the host graph builders (`knn_neighbors`
in the port's host library against the JAX package's native kNN, also on
coordinates rounded to a grid, where distances tie; `protein_to_padded_graph`,
`stack_graphs`; `augment_graph_batch` bit for bit from one RandomState),
`structure_io` on PDB and mmCIF text written to `tmp_path`, and
`StructDataset`'s collate (struct_graph and pocket, train split with
every augmentation and val) on the shared synthetic fixtures. Then the
training noise on its own (off in eval, std 0.025, the same for the same
step seed), and two `train_step`s of seq<->struct_graph against the JAX
`OneProtModule` with noise and dropout off. f32 at 1e-4 / 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.data.datasets.struct_graph_dataset import (
    StructDataset as JaxStructDataset,
)
from oneprot_tpu.data.utils import graphs as jgraphs
from oneprot_tpu.data.utils import structure_io as jsio
from oneprot_tpu.kernels import segment_ops as jseg
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models import pronet as jpronet
from oneprot_tpu.train.module import OneProtModule as JaxModule
from oneprot_tpu.train.optim import adam as jax_adam
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import graphs, structure_io, synthetic
from oneprot_tpu_torch.data.datasets.struct_graph_dataset import StructDataset
from oneprot_tpu_torch.data.synthetic import generate_fixtures
from oneprot_tpu_torch.kernels import segment_ops
from oneprot_tpu_torch.models import encoders, esm2, pronet
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule

RTOL, ATOL = 1e-4, 1e-5
AAS = "ACDEFGHIKLMNPQRSTVWY"


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# segment ops


def test_segment_ops_match_jax():
    rng = np.random.RandomState(0)
    data = rng.randn(40, 5).astype(np.float32)
    ids = rng.randint(0, 6, 40).astype(np.int32)
    ids[ids == 3] = 4        # segment 3 stays empty
    ids[:2] = 9              # out of range: dropped
    t, ti = torch.from_numpy(data), torch.from_numpy(ids)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    for port_fn, jax_fn in ((segment_ops.segment_sum, jseg.segment_sum),
                            (segment_ops.segment_mean, jseg.segment_mean),
                            (segment_ops.segment_max, jseg.segment_max)):
        _close(port_fn(t, ti, 7), jax_fn(jd, ji, 7), msg=port_fn.__name__)
    keep = ids < 7
    logits = rng.randn(40).astype(np.float32)[keep]
    _close(segment_ops.segment_softmax(torch.from_numpy(logits),
                                       ti[torch.from_numpy(keep)], 7),
           jseg.segment_softmax(jnp.asarray(logits), ji[keep], 7))
    msgs = rng.randn(2, 6, 4, 3).astype(np.float32)
    mask = (rng.rand(2, 6, 4) > 0.4).astype(np.float32)
    mask[0, 0] = 0.0  # a node with no neighbour
    for port_fn, jax_fn in ((segment_ops.masked_neighbor_sum,
                             jseg.masked_neighbor_sum),
                            (segment_ops.masked_neighbor_mean,
                             jseg.masked_neighbor_mean)):
        _close(port_fn(torch.from_numpy(msgs), torch.from_numpy(mask)),
               jax_fn(jnp.asarray(msgs), jnp.asarray(mask)))
    feats = rng.randn(2, 6, 3).astype(np.float32)
    idx = rng.randint(0, 6, (2, 6, 4)).astype(np.int32)
    _close(segment_ops.gather_neighbors(torch.from_numpy(feats),
                                        torch.from_numpy(idx)),
           jseg.gather_neighbors(jnp.asarray(feats), jnp.asarray(idx)),
           rtol=0, atol=0)


def test_segment_mean_counts_past_256_in_bf16():
    data = torch.ones(300, 2, dtype=torch.bfloat16)
    out = segment_ops.segment_mean(data, torch.zeros(300, dtype=torch.long), 1)
    assert out.dtype == torch.bfloat16 and out.float().tolist() == [[1.0, 1.0]]


# ---------------------------------------------------------------------------
# geometry and the tower


def test_rbf_and_frames_match_jax():
    rng = np.random.RandomState(1)
    d = (rng.rand(3, 7) * 12).astype(np.float32)
    _close(pronet.rbf_expand(torch.from_numpy(d), 16, 10.0),
           jpronet.rbf_expand(jnp.asarray(d), 16, 10.0))
    n, ca, c = (rng.randn(2, 9, 3).astype(np.float32) for _ in range(3))
    c[0, 0] = ca[0, 0]  # a degenerate residue: the epsilon keeps it finite
    got = pronet.backbone_frames(*(torch.from_numpy(x) for x in (n, ca, c)))
    _close(got, jpronet.backbone_frames(*(jnp.asarray(x) for x in (n, ca, c))))
    assert torch.isfinite(got).all()


def _structure(rng, n_res):
    """(sequence, atom names, residue ids, xyz) of a synthetic chain through
    the port's PDB writer and parser."""
    seq = "".join(AAS[i] for i in rng.randint(0, 20, n_res))
    chain = structure_io.chains_from_atoms(structure_io.parse_pdb_atoms(
        synthetic.backbone_pdb(seq, rng)))["A"]
    return (chain.seq1, chain.atom_names, chain.atom_amino_id,
            chain.xyz.astype(np.float64))


def _graph_batch(seed, lengths=(30, 17, 24), max_residues=28, k=6):
    rng = np.random.RandomState(seed)
    return graphs.stack_graphs([
        graphs.protein_to_padded_graph(*_structure(rng, n), max_residues, k)
        for n in lengths])


ENC = dict(hidden_size=16, num_layers=2, out_channels=24, num_rbf=8,
           euler_noise=False, data_augment_eachlayer=False, dropout=0.0)


def _pair(level="backbone", **over):
    """The JAX and the port's StructGraphEncoder on the JAX init."""
    enc = dict(ENC, level=level, **over)
    jm = jenc.create_struct_graph_encoder(encoder=dict(enc), output_dim=12)
    graph = _graph_batch(0)
    params = jm.init({"params": jax.random.key(0)},
                     {k: jnp.asarray(v) for k, v in graph.items()})["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pm = encoders.create_struct_graph_encoder(encoder=dict(enc),
                                              output_dim=12, device="cpu")
    pm.load_state_dict(convert.struct_graph_state_dict(params))
    return jm, params, pm.eval()


@pytest.mark.parametrize("level", ["backbone", "allatom", "aminoacid"])
def test_struct_graph_encoder_matches_jax(level):
    jm, params, pm = _pair(level)
    graph = _graph_batch(3)
    want = jm.apply({"params": params},
                    {k: jnp.asarray(v) for k, v in graph.items()})
    with torch.no_grad():
        got = pm({k: torch.from_numpy(v) for k, v in graph.items()})
    _close(got, want)
    # the ProNet tower alone, before the head
    jp = jpronet.ProNet(jm.config)
    want_enc = jp.apply({"params": params["encoder"]},
                        {k: jnp.asarray(v) for k, v in graph.items()})
    with torch.no_grad():
        got_enc = pm.encoder({k: torch.from_numpy(v) for k, v in graph.items()})
    _close(got_enc, want_enc)


def _graph(graph):
    return {k: torch.from_numpy(v) for k, v in graph.items()}


def test_training_noise_and_dropout():
    """Off in eval mode; in training mode the Euler noise has std 0.025 on
    the relative rotations, the same draws for the same step seed and
    others for another; dropout drops about its rate."""
    torch.manual_seed(0)
    pm = encoders.create_struct_graph_encoder(
        encoder=dict(ENC, euler_noise=True, data_augment_eachlayer=True,
                     dropout=0.25), output_dim=12, device="cpu")
    esm2.init_esm2_weights_(pm, torch.Generator().manual_seed(0))
    g = _graph(_graph_batch(5))
    with torch.no_grad():
        pm.eval()
        ev1, ev2 = pm(g), pm(g)
        clean = pm.encoder.edge_features(g)
        pm.train()
        pronet.set_graph_noise_seed(pm, 7)
        noisy = pm.encoder.edge_features(g)
        a, b = pm(g), pm(g)
        pronet.set_graph_noise_seed(pm, 8)
        c = pm(g)
    assert torch.equal(ev1, ev2)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, ev1)
    rot = slice(ENC["num_rbf"] + 3, ENC["num_rbf"] + 12)
    real = g["neighbor_mask"] > 0
    diff = (noisy - clean)[..., rot][real]
    assert abs(diff.std().item() - 0.025) < 0.0025
    others = torch.cat([(noisy - clean)[..., :rot.start],
                        (noisy - clean)[..., rot.stop:]], -1)
    assert others.abs().max().item() == 0.0
    x = torch.ones(4000)
    dropped = pronet.graph_dropout(x, 0.25, 3, 0)
    assert abs((dropped == 0).float().mean().item() - 0.25) < 0.03
    assert set(dropped.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert torch.equal(dropped, pronet.graph_dropout(x, 0.25, 3, 0))


# ---------------------------------------------------------------------------
# host graphs and structure files


def test_knn_and_padded_graph_match_jax():
    rng = np.random.RandomState(2)
    coords = (rng.rand(40, 3) * 20).astype(np.float32)
    for k in (8, 60):  # 60 > n - 1: padded neighbour lists
        got_i, got_m = graphs.knn_neighbors(coords, k, 10.0)
        want_i, want_m = jgraphs.knn_neighbors(coords, k, 10.0)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_m.astype(np.float32),
                                      np.asarray(want_m, np.float32))
    got_i, got_m = graphs.knn_neighbors(coords[:0], 4, 10.0)
    assert got_i.shape == (0, 4) and got_m.shape == (0, 4)
    for n_res, max_res in ((30, 40), (30, 20)):  # padded, then cut
        record = _structure(rng, n_res)
        got = graphs.protein_to_padded_graph(*record, max_res, 8)
        want = jgraphs.protein_to_padded_graph(*record, max_res, 8)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _check_same(graphs.stack_graphs([got, got]),
                jgraphs.stack_graphs([want, want]))


def test_padded_graph_with_tied_distances_matches_jax():
    """Coordinates rounded to a 2 A grid: many neighbours of a residue lie
    at one distance, and both packages' host libraries order them by
    index, so the padded graphs are equal."""
    rng = np.random.RandomState(8)
    for n_res, max_res, k in ((60, 64, 24), (90, 48, 8)):
        seq, names, ids, xyz = _structure(rng, n_res)
        record = (seq, names, ids, np.round(xyz / 2.0) * 2.0)
        got = graphs.protein_to_padded_graph(*record, max_res, k)
        want = jgraphs.protein_to_padded_graph(*record, max_res, k)
        _check_same(got, want)
        ca = got["coords_ca"][:min(n_res, max_res)]
        d2 = ((ca[:, None] - ca[None]) ** 2).sum(-1)
        assert len(np.unique(d2)) < d2.size // 4  # ties are common


def _check_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_augment_graph_batch_is_bit_exact(flags):
    batch = _graph_batch(4)
    mask, noise, deform = flags
    got = graphs.augment_graph_batch(batch, np.random.RandomState(11), mask,
                                     noise, deform)
    want = jgraphs.augment_graph_batch(batch, np.random.RandomState(11), mask,
                                       noise, deform)
    _check_same(got, want)


def _render_cif(chain_atoms):
    rows = ["data_test", "loop_"] + [f"_atom_site.{f}" for f in (
        "group_PDB", "id", "auth_atom_id", "label_alt_id", "auth_comp_id",
        "auth_asym_id", "auth_seq_id", "pdbx_PDB_ins_code", "Cartn_x",
        "Cartn_y", "Cartn_z", "pdbx_PDB_model_num")]
    for serial, (a, xyz) in enumerate(chain_atoms, start=1):
        rows.append(f"ATOM {serial} {a.atom_name} . {a.res_name} {a.chain} "
                    f"{a.res_key[0]} ? {xyz[0]:.3f} {xyz[1]:.3f} {xyz[2]:.3f} 1")
    return "\n".join(rows) + "\n#\n"


def test_structure_io_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    text = (synthetic.backbone_pdb("MKTAYW", rng, chain="A")
            + synthetic.backbone_pdb("GHE", rng, chain="B"))
    text += "HETATM 9999  C1  LIG A 100       1.000   1.000   1.000  1.00  0.00\n"
    (tmp_path / "two.pdb").write_text(text)
    atoms = structure_io.parse_pdb_atoms(text)
    assert atoms == [structure_io.Atom(**vars(a))
                     for a in jsio.parse_pdb_atoms(text)]
    cif = _render_cif([(a, a.xyz) for a in atoms])
    (tmp_path / "two.cif").write_text(cif)
    for name in ("two.pdb", "two.cif"):
        got = structure_io.parse_structure_file(str(tmp_path / name))
        want = jsio.parse_structure_file(str(tmp_path / name))
        assert sorted(got) == sorted(want) == ["A", "B"]
        for cid in want:
            assert got[cid].seq1 == want[cid].seq1
            for f in ("atom_names", "atom_amino_id", "xyz"):
                np.testing.assert_array_equal(getattr(got[cid], f),
                                              getattr(want[cid], f))
    h5py = pytest.importorskip("h5py")
    paths = [str(tmp_path / "two.pdb"), str(tmp_path / "two.cif")]
    for chain in ("first", "all", "B"):
        out = {}
        for pkg, fn in (("port", structure_io.ingest_files),
                        ("jax", jsio.ingest_files)):
            h5_path = str(tmp_path / f"{pkg}_{chain}.h5")
            assert fn(paths, h5_path, chain=chain) == ["two"]
            with h5py.File(h5_path, "r") as h5:
                out[pkg] = {}
                h5.visititems(lambda k, v: out[pkg].__setitem__(
                    k, v[()] if isinstance(v, h5py.Dataset) else None))
        assert sorted(out["port"]) == sorted(out["jax"])
        for key, value in out["jax"].items():
            np.testing.assert_array_equal(out["port"][key], value, err_msg=key)


# ---------------------------------------------------------------------------
# the dataset


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("graph_fixtures"))
    generate_fixtures(d, n_train=8, n_eval=4, seed=0)
    return d


@pytest.mark.parametrize("pocket", [False, True], ids=["struct_graph", "pocket"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_struct_dataset_collate_matches_jax(data_dir, pocket, split):
    kw = dict(data_dir=data_dir, split=split, pocket=pocket, max_residues=48,
              max_neighbors=8, use_struct_mask=True,
              use_struct_coord_noise=True, use_struct_deform=True,
              buckets=[64, 128])
    port, ref = StructDataset(**kw), JaxStructDataset(**kw)
    assert len(port) == len(ref) and port.modality == ref.modality
    ids = [port[i] for i in range(len(port))][:5] + ["missing_id"]
    p = port.collate_fn(ids, rng=np.random.RandomState(3))
    j = ref.collate_fn(ids, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(p[0], j[0])
    _check_same(p[1], j[1])
    assert p[2:] == j[2:]


class _MemoryStructs(StructDataset):
    """A StructDataset whose records come from memory."""

    def __init__(self, records, **kw):
        self.records = records
        super().__init__(**kw)

    def read_structure(self, seq_id):
        return self.records.get(seq_id)


def test_struct_dataset_reads_through_one_method(data_dir):
    rng = np.random.RandomState(9)
    ids = StructDataset(data_dir, "val").id_list
    records = {sid: (s[0],) + _structure(rng, 20) for sid, s in zip(
        ids, (("MKT" * 7,),) * len(ids))}
    ds = _MemoryStructs(records, data_dir=data_dir, split="val",
                        max_residues=24, max_neighbors=6)
    seq, graph, modality, seqs = ds.collate_fn(ids[:2])
    assert modality == "struct_graph" and seqs == ["MKT" * 7] * 2
    assert graph["aa"].shape == (2, 24) and seq.shape[0] == 2
    with pytest.raises(ValueError, match="no valid structure ids"):
        ds.collate_fn(["nope"])


# ---------------------------------------------------------------------------
# seq<->struct_graph steps against the JAX module

LR = 1e-4


def test_struct_graph_steps_match_jax():
    """Two `train_step`s of a trainable tiny hub + struct_graph tower,
    noise and dropout off, then `eval_step`: loss, every trainable leaf."""
    hub = jenc.create_sequence_encoder("esm2_tiny", output_dim=12,
                                       proj_type="mlp", frozen=False,
                                       dtype="float32")
    tower = jenc.create_struct_graph_encoder(encoder=dict(ENC), output_dim=12)
    jm = JaxModule(components={"sequence": hub, "struct_graph": tower},
                   optimizer=lambda: jax_adam(LR), loss_fn="CLIP",
                   use_l1_regularization=True, seed=0,
                   frozen_param_dtype=None)
    rng = np.random.RandomState(0)

    def seq_ids(B, L):
        ids = rng.randint(4, 24, size=(B, L)).astype(np.int32)
        ids[:, 0], ids[:, -1] = 0, 2
        return ids

    jm.init({"struct_graph": (seq_ids(3, 16), _graph_batch(1))})
    params = jax.tree_util.tree_map(np.asarray, jm.state.params)
    cfg = esm2.Esm2Config(**{f: getattr(hub.config, f) for f in (
        "hidden_size", "num_layers", "num_heads", "intermediate_size",
        "vocab_size")})
    phub = encoders.SequenceEncoder(cfg, 12, proj_type="mlp", frozen=False,
                                    device="cpu", dtype=torch.float32)
    ptower = encoders.create_struct_graph_encoder(encoder=dict(ENC),
                                                  output_dim=12, device="cpu")
    pm = OneProtModule({"sequence": phub, "struct_graph": ptower},
                       optimizer=lambda: optim.adam(LR), loss_fn="CLIP",
                       use_l1_regularization=True, frozen_param_dtype=None)
    pm.model.load_state_dict(convert.oneprot_state_dict(params))
    pm.init()
    state = jm.state
    for step in range(2):
        seq, graph = seq_ids(3, 20), _graph_batch(10 + step)
        state, jloss = jm.train_step(state, "struct_graph", seq, graph)
        loss, n = pm.train_step("struct_graph", seq, graph)
        assert n == step + 1
        _close(loss.item(), float(jloss), msg=f"step {step}")
        want = convert.oneprot_state_dict(
            jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in pm.model.named_parameters():
            if p.requires_grad and not name.endswith("attn.k.bias"):
                _close(p, want[name], msg=f"step {step}: {name}")
    seq, graph = seq_ids(3, 20), _graph_batch(20)
    js, jg, jl = jm.eval_step(state.params, "struct_graph", seq, graph)
    s, g, loss = pm.eval_step("struct_graph", seq, graph)
    for got, want in ((s, js), (g, jg), (loss, jl)):
        _close(got, want)
