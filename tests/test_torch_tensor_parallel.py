"""Tensor parallelism of the port (the JAX package's `model` mesh axis,
`oneprot_tpu/core/partitioning.py`) against the JAX package, on the CPU.

- The rule table: `core/partitioning.spec_of` on every port state-dict
  entry of ESM2 (with and without LoRA), BERT (with and without LoRA),
  the MSA Transformer, ProNet and the heads (attention1d pooling too)
  equals the JAX `_placement_spec` of the leaf behind it (found through
  `convert.py`, by tagging every JAX leaf with its own number), at model
  2 and 4: 6 heads of 8 and an FFN of 90, so that at model 4 the FFN
  falls back to replicated and the heads do not divide. The layouts the
  port's layers are built with equal the table but for q, k and v (and
  their `lora_B`) where the heads do not divide: kept whole there.
- Gloo worlds of 4 (data 2 x model 2) and 2 (data 1 x model 2) on the
  CPU (`tests/helpers/torch_dist_child.py`, case `tp`): two packed
  struct_token steps and one text step of `OneProtModule` (a frozen LoRA
  hub, a trainable struct-token tower, a frozen text tower, all split),
  against the JAX module on the concatenated batch under
  `make_mesh(data=2, model=2)` on four of the conftest's 8 CPU devices;
  the full trainable parameters; the eval features gathered over the
  data group (each row once); the loaders and the dropout seed shared
  within a model group; the replicated parameters bit-identical within
  it. At data 1: the column- and row-parallel layers and Megatron's f
  and g against an unsharded Dense pair, a checkpoint written at model 2
  restored at model 1 bit for bit and the reverse, and the peft export of
  a split `lora_B`; an int8 hub at model 2 (held whole) whose pooled
  features equal one process's bit for bit, with its checkpoint restored
  at model 1; and `Trainer.fit` at model 2 with rank-dependent noise added
  to a replicated gradient (standing in for the card's atomics): the model
  group's replicas stay bit-identical, and without the noise, under
  `deterministic=True`, the fit equals one process's.
- The int8 hub over a model axis is held whole on every rank, as the JAX
  rules place its int8 leaves (they split only `kernel` leaves), and the
  rule layout leaves its entries whole.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneprot_tpu.core import partitioning as jpart
from oneprot_tpu.core.mesh import make_mesh
from oneprot_tpu.models import bert as jbert
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.models import esm2 as jesm2
from oneprot_tpu.models import msa_transformer as jmsa
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.core import partitioning
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.synthetic import generate_fixtures
from oneprot_tpu_torch.models import bert, encoders, esm2, msa_transformer
from oneprot_tpu_torch.models.hf_convert import export_peft_lora
from oneprot_tpu_torch.train import checkpoint as ckpt
from tests.helpers.torch_dist_child import (
    TP_FIT_BATCHES,
    TP_LORA,
    TP_WIDTH,
    int8_hub_rows,
    int8_tp_module,
    tp_fit,
    tp_module,
    tp_steps,
)
from tests.test_torch_distributed import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    World,
    _mirror,
    _tokens,
    dm_kwargs,
    jax_losses,
    loss_inputs,
)
from tests.test_torch_graph import ENC, _graph_batch

# f32 on the CPU: the model group's f32 sums and the data group's gathers
# reorder the sums of one process
RTOL, ATOL = 1e-4, 1e-5
LR = 1e-4
SLOTS, L_ROW = 4, 64
# each data rank's proteins: two packed rows of 64 tokens apiece
RANK_LENGTHS = ((30, 24, 20, 36), (40, 20, 50))
TEXT_ROWS, SEQ_L, TEXT_L = 4, 24, 20

# -- the rule table -----------------------------------------------------------

RULE_ESM2 = jesm2.Esm2Config(hidden_size=48, num_layers=1, num_heads=6,
                             intermediate_size=90)
RULE_BERT = jbert.BertConfig(vocab_size=50, hidden_size=48, num_layers=1,
                             num_heads=6, intermediate_size=90,
                             max_position_embeddings=16)
RULE_MSA = jmsa.MsaTransformerConfig(hidden_size=48, num_layers=1,
                                     num_heads=6, intermediate_size=90,
                                     max_positions=16, max_rows=4)
IDS = np.ones((2, 8), np.int32)


def _jax_towers():
    """{tower: (JAX encoder, its init inputs, the port encoder's
    constructor over tp, the modality)}."""
    lora = dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0)
    plora = esm2.LoraConfig(**TP_LORA)
    pcfg = esm2.Esm2Config(**dataclasses.asdict(RULE_ESM2))
    bcfg = bert.BertConfig(**dataclasses.asdict(RULE_BERT))
    mcfg = msa_transformer.MsaTransformerConfig(
        **dataclasses.asdict(RULE_MSA))
    kw = dict(device="cpu", dtype=torch.float32)
    graph = {k: jnp.asarray(v) for k, v in _graph_batch(0).items()}
    return {
        "esm2": (jenc.SequenceEncoder(config=RULE_ESM2, output_dim=16,
                                      proj_type="mlp"), (IDS,),
                 lambda tp: encoders.SequenceEncoder(
                     pcfg, 16, proj_type="mlp", tp=tp, **kw), "sequence"),
        "esm2_lora": (jenc.SequenceEncoder(config=RULE_ESM2, output_dim=16,
                                           proj_type="mlp", **lora), (IDS,),
                      lambda tp: encoders.SequenceEncoder(
                          pcfg, 16, proj_type="mlp", lora=plora, tp=tp, **kw),
                      "sequence"),
        "attention1d": (jenc.StructTokenEncoder(
            config=RULE_ESM2, output_dim=16, pooling_type="attention1d"),
            (IDS,), lambda tp: encoders.StructTokenEncoder(
                pcfg, 16, pooling_type="attention1d", tp=tp, **kw),
            "struct_token"),
        "bert": (jenc.TextEncoder(config=RULE_BERT, output_dim=16), (IDS,),
                 lambda tp: encoders.TextEncoder(bcfg, 16, tp=tp, **kw),
                 "text"),
        "bert_lora": (jenc.TextEncoder(config=RULE_BERT, output_dim=16,
                                       **lora), (IDS,),
                      lambda tp: encoders.TextEncoder(bcfg, 16, lora=plora,
                                                      tp=tp, **kw), "text"),
        "msa": (jenc.MsaEncoder(config=RULE_MSA, output_dim=16),
                (np.ones((1, 2, 8), np.int32),),
                lambda tp: encoders.MsaEncoder(mcfg, 16, tp=tp, **kw), "msa"),
        "pronet": (jenc.create_struct_graph_encoder(encoder=dict(ENC),
                                                    output_dim=12), (graph,),
                   lambda tp: encoders.create_struct_graph_encoder(
                       encoder=dict(ENC), output_dim=12, device="cpu"),
                   "struct_graph"),
    }


TOWERS = ("esm2", "esm2_lora", "attention1d", "bert", "bert_lora", "msa",
          "pronet")


@pytest.fixture(scope="module")
def rule_trees():
    """{tower: (JAX leaves by tag, the port's full state by name)}: every
    JAX leaf tagged with its own number, converted by `convert.py`."""
    out = {}
    for name, (jm, inputs, _, modality) in _jax_towers().items():
        shapes = jax.eval_shape(
            lambda: jm.init({"params": jax.random.key(0)}, *inputs))["params"]
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            {f"encoders_{modality}": shapes})
        tagged = jax.tree_util.tree_unflatten(treedef, [
            np.full(leaf.shape, i + 1, np.float32)
            for i, (_, leaf) in enumerate(leaves)])
        out[name] = (leaves, convert.oneprot_state_dict(tagged), tagged)
    return out


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("tower", TOWERS)
def test_rule_table_matches_jax_param_pspec(rule_trees, tower, model):
    leaves, state, _ = rule_trees[tower]
    mesh = make_mesh(data=8 // model, model=model, devices=jax.devices()[:8])
    split = 0
    assert len(state) == len(leaves)
    for name, t in state.items():
        path, leaf = leaves[int(t.reshape(-1)[0]) - 1]
        want = tuple(jpart._placement_spec(path, leaf, mesh))
        assert partitioning.spec_of(name, tuple(t.shape), model) == want, (
            name, jax.tree_util.keystr(path))
        split += bool(want)
    # what the rules hit, by tower (the FFN of 90 divides 2, not 4)
    expected = {
        "esm2": {2: 10, 4: 7}, "esm2_lora": {2: 13, 4: 10},
        "attention1d": {2: 10, 4: 7}, "bert": {2: 10, 4: 7},
        "bert_lora": {2: 13, 4: 10}, "msa": {2: 5, 4: 2},
        "pronet": {2: 0, 4: 0}}[tower][model]
    assert split == expected


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("tower", TOWERS)
def test_built_layout_is_the_rule_table(rule_trees, tower, model):
    """The port's layers, built as model rank 1's shard, hold the table's
    blocks: at model 4 the 6 heads do not divide and q, k, v (with their
    lora_B) stay whole, the documented difference; every other entry is
    the table's, and each shard's shape is its block's."""
    _, state, _ = rule_trees[tower]
    _, _, build, modality = _jax_towers()[tower]
    prefix = f"encoders.{modality}."
    enc = build((model, 1))
    built = {prefix + k: d for k, d in partitioning.layout_of(enc).items()}
    rules = partitioning.rule_layout(state, model)
    whole_qkv = model == 4 and tower in ("esm2", "esm2_lora", "attention1d",
                                         "bert", "bert_lora")
    differ = {k for k in rules if ".attn.q." in k or ".attn.k." in k
              or ".attn.v." in k}
    assert built == ({k: d for k, d in rules.items() if k not in differ}
                     if whole_qkv else rules)
    assert bool(differ) == (tower not in ("msa", "pronet"))
    local = {prefix + k: tuple(v.shape) for k, v in enc.state_dict().items()}
    cut = partitioning.shard_state_dict(state, 1, model, built)
    assert local == {k: tuple(v.shape) for k, v in cut.items()}


def test_shard_and_gather_round_trip(rule_trees):
    """A JAX tree cut into model ranks' blocks by
    `convert.oneprot_shard_state_dict` joins back into the full state,
    bit for bit."""
    _, state, tagged = rule_trees["esm2_lora"]
    layout = partitioning.rule_layout(state, 2)
    blocks = [convert.oneprot_shard_state_dict(tagged, r, 2)
              for r in range(2)]
    for name, t in state.items():
        joined = (torch.cat([b[name] for b in blocks], layout[name])
                  if name in layout else blocks[0][name])
        assert torch.equal(joined, t), name
    assert layout["encoders.sequence.transformer.layers.0.attn.q.weight"] == 0
    assert layout["encoders.sequence.transformer.layers.0.attn.o.weight"] == 1
    assert layout["encoders.sequence.transformer.layers.0.attn.q.lora_B"] == 0


def test_int8_hub_is_refused_under_a_model_axis():
    """No longer refused: under a model axis the int8 hub is built whole
    on every rank (no split heads, every dense layer an Int8Dense of the
    full width, no shard), and the rule layout leaves its entries whole,
    while the JAX rules would split its q/k/v and fc1 biases (the port's
    documented placement difference)."""
    enc = encoders.create_sequence_encoder("esm2_tiny", quantize="int8",
                                           device="cpu", dtype="float32",
                                           tp=(2, 1))
    whole = esm2.Esm2(esm2.ESM2_SIZES["esm2_tiny"], quant_int8=True,
                      tp=(4, 0), device="cpu", dtype=torch.float32)
    one = esm2.Esm2(esm2.ESM2_SIZES["esm2_tiny"], quant_int8=True,
                    device="cpu", dtype=torch.float32)
    for model in (enc.transformer, whole):
        assert partitioning.layout_of(model) == {}
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
            k: tuple(v.shape) for k, v in one.state_dict().items()}
        for layer in model.layers:
            assert not layer.attn.heads_split
            assert all(isinstance(m, esm2.Int8Dense) for m in (
                layer.attn.q, layer.attn.k, layer.attn.v, layer.attn.o,
                layer.fc1, layer.fc2))
    state = {f"encoders.sequence.transformer.{k}": v
             for k, v in one.state_dict().items()}
    assert partitioning.rule_layout(state, 2) == {}
    assert partitioning.spec_of(
        "encoders.sequence.transformer.layers.0.fc1.bias", (64,), 2) == (
        "model",)


# -- the worlds ---------------------------------------------------------------

HUB = jesm2.Esm2Config(hidden_size=32, num_layers=2, num_heads=4,
                       intermediate_size=64)
TOWER = dataclasses.replace(HUB, vocab_size=54)
TEXT = jbert.BertConfig(vocab_size=60, hidden_size=32, num_layers=2,
                        num_heads=4, intermediate_size=64,
                        max_position_embeddings=32)


def jax_module():
    """The JAX module of the port's `tp_module` under a (2, 2) mesh."""
    from oneprot_tpu.train.module import OneProtModule as JaxModule
    from oneprot_tpu.train.optim import adam

    lora = TP_LORA
    components = {
        "sequence": jenc.SequenceEncoder(
            config=HUB, output_dim=TP_WIDTH, proj_type="mlp", frozen=True,
            lora_rank=lora["rank"], lora_alpha=lora["alpha"],
            lora_dropout=lora["dropout"]),
        "struct_token": jenc.StructTokenEncoder(config=TOWER,
                                                output_dim=TP_WIDTH),
        "text": jenc.TextEncoder(config=TEXT, output_dim=TP_WIDTH,
                                 frozen=True)}
    module = JaxModule(components=components, optimizer=lambda: adam(LR),
                       use_l1_regularization=True, seed=0,
                       frozen_param_dtype=None,
                       mesh=make_mesh(data=2, model=2,
                                      devices=jax.devices()[:4]))
    seq = np.full((2, 16), 1, np.int32)
    seq[:, 0] = 0
    text = np.full((2, 16), 3, np.int32)
    module.init({"struct_token": (seq, seq), "text": (seq, text)})
    return module


def batches() -> dict:
    """The global batches: per step and data rank two packed rows of its
    proteins, then a text batch and an eval batch of TEXT_ROWS rows (the
    data ranks' halves in order)."""
    out = {k: [] for k in ("ids", "seg", "st_ids", "st_seg", "valid")}
    for i in range(2):
        rng = np.random.RandomState(200 + i)
        parts = []
        for lengths in RANK_LENGTHS:
            seqs = [_tokens(rng, n, 4, 24) for n in lengths]
            sts = [_tokens(rng, n, 20, 54) for n in lengths]
            ids, seg, valid, rows = packing.pack_token_rows(seqs, L_ROW, SLOTS)
            assert ids.shape[0] == 2
            parts.append((ids, seg, *_mirror(rows, sts, L_ROW), valid))
        for k, v in zip(out, zip(*parts)):
            out[k].append(np.concatenate(v))
    out = {k: np.stack(v) for k, v in out.items()}
    rng = np.random.RandomState(7)
    for seq_key, text_key in (("text_seq", "text_ids"),
                              ("eval_seq", "eval_text")):
        out[seq_key] = np.stack([_tokens(rng, SEQ_L, 4, 24)
                                 for _ in range(TEXT_ROWS)])
        text = rng.randint(5, 60, size=(TEXT_ROWS, TEXT_L)).astype(np.int32)
        text[:, 0] = 2
        for r in range(1, TEXT_ROWS):
            text[r, TEXT_L - 3 * r:] = 0  # BERT's pad
        out[text_key] = text
    return out


def jax_oracle(jm, b: dict) -> dict:
    state, losses = jm.state, []
    for i in range(2):
        state, loss = jm.train_step_packed(
            state, "struct_token",
            {"ids": b["ids"][i], "segment_ids": b["seg"][i]},
            {"ids": b["st_ids"][i], "segment_ids": b["st_seg"][i]},
            b["valid"][i])
        losses.append(float(loss))
    state, loss = jm.train_step(state, "text", b["text_seq"], b["text_ids"])
    losses.append(float(loss))
    seq_f, mod_f, loss = jm.eval_step(state.params, "text", b["eval_seq"],
                                      b["eval_text"])
    return {"losses": np.array(losses),
            "params": convert.oneprot_state_dict(
                jax.tree.map(np.asarray, state.params)),
            "eval": (np.asarray(seq_f), np.asarray(mod_f), float(loss))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    jm = jax_module()
    saved = {"configs": {"sequence": dataclasses.asdict(HUB),
                         "struct_token": dataclasses.asdict(TOWER),
                         "text": dataclasses.asdict(TEXT)},
             "state": convert.oneprot_state_dict(
                 jax.tree.map(np.asarray, jm.state.params))}
    torch.save(saved, root / "tiny.pt")
    b = batches()
    # one process, model 1: the steps, a checkpoint, a restore that steps on
    one = tp_module(saved, (1, 0), LR).init()
    one_losses = tp_steps(one, b, 0, 1)
    ckpt.CheckpointManager(str(root / "ckpt" / "tp1")).on_validation_end(
        one, {"val/loss_best": 1.0})
    again = tp_module(saved, (1, 0), LR).init()
    ckpt.load_state(again, str(root / "ckpt" / "tp1" / "last"))
    again_losses = tp_steps(again, b, 0, 1)
    data = str(root / "fixtures")
    generate_fixtures(data, n_train=16, n_eval=8, modalities=["struct_token"])
    # one process: the int8 hub's features (one thread, as the ranks run)
    # and the fit the ranks run without noise
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        int8_one = int8_tp_module(saved, (1, 0)).init()
        with torch.no_grad():
            int8_pooled = int8_one.encoders["sequence"].eval().backbone_pooled(
                int8_hub_rows()).numpy()
    finally:
        torch.set_num_threads(threads)
    fit_one = tp_module(saved, (1, 0))
    tp_fit(fit_one, dm_kwargs(data), str(root / "fit_one"), True)
    rng = np.random.RandomState(3)
    layers = {"x": rng.randn(2, 5, 8).astype(np.float32),
              "dy": rng.randn(2, 5, 8).astype(np.float32),
              "dy1": rng.randn(2, 5, 12).astype(np.float32),
              "w1": rng.randn(12, 8).astype(np.float32),
              "b1": rng.randn(12).astype(np.float32),
              "w2": rng.randn(8, 12).astype(np.float32),
              "b2": rng.randn(8).astype(np.float32),
              "lora_a": rng.randn(4, 8).astype(np.float32),
              "lora_b": rng.randn(12, 4).astype(np.float32)}
    inputs = {**b, **layers, **{f"loss_{k}": v for k, v in
                                loss_inputs(2).items()},
              "state": np.array(str(root / "tiny.pt")),
              "ckpt_dir": np.array(str(root / "ckpt")),
              "dm": np.array(json.dumps(dm_kwargs(data)))}
    worlds = {w: World(root, "tp", w, inputs) for w in (4, 2)}
    return {"worlds": worlds, "oracle": jax_oracle(jm, b), "batches": b,
            "losses": jax_losses(2, loss_inputs(2)),
            "one": (one_losses, one), "again": (again_losses, again),
            "root": root, "saved": saved, "layers": layers,
            "int8": (int8_one, int8_pooled), "fit_one": fit_one}


def _results(runs, world):
    return runs["worlds"][world].result()


@pytest.mark.parametrize("world", [4, 2])
def test_mesh_layout_of_the_ranks(runs, world):
    """Rank r is data rank r // 2 and model rank r % 2."""
    for rank, r in enumerate(_results(runs, world)):
        assert tuple(r["tp"]) == (2, rank % 2)
        assert tuple(r["data"]) == (world // 2, rank // 2)


@pytest.mark.parametrize("world", [4, 2])
def test_steps_match_jax_on_the_concatenated_batch(runs, world):
    """Two packed struct_token steps and a text step: every rank's loss
    against the JAX module under the (2, 2) mesh, and against the port's
    one process (model 1) on the same rows."""
    for r in _results(runs, world):
        np.testing.assert_allclose(r["losses"], runs["oracle"]["losses"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["losses"], runs["one"][0], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("world", [4, 2])
def test_trainable_parameters_match_jax(runs, world):
    """The full trainable parameters after the steps (the shards joined
    over the model group): the tower's split matrices, the hub's LoRA
    factors and biases, the heads."""
    r0 = _results(runs, world)[0]
    names = [k[len("param/"):] for k in r0 if k.startswith("param/")]
    assert any(".fc1.weight" in n for n in names)
    assert any(".lora_B" in n for n in names)
    for name in names:
        np.testing.assert_allclose(r0[f"param/{name}"],
                                   runs["oracle"]["params"][name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("world", [4, 2])
def test_eval_features_gathered_once_per_row(runs, world):
    """The validation gather runs over the data group: TEXT_ROWS rows (not
    one copy per model rank), the JAX eval step's features and loss."""
    seq_f, mod_f, loss = runs["oracle"]["eval"]
    for r in _results(runs, world):
        assert r["eval/seq"].shape == seq_f.shape == (TEXT_ROWS, TP_WIDTH)
        np.testing.assert_allclose(r["eval/seq"], seq_f, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(r["eval/mod"], mod_f, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(r["eval/loss"]), loss, rtol=RTOL)


@pytest.mark.parametrize("world", [4, 2])
def test_model_group_holds_one_replica(runs, world):
    """The replicated parameters as each rank holds them, and the losses,
    are bit-identical within a model group (and across the world)."""
    results = _results(runs, world)
    keys = [k for k in results[0] if k.startswith(("held/", "param/"))]
    assert len(keys) > 20
    for r in results[1:]:
        for key in keys + ["losses"]:
            np.testing.assert_array_equal(r[key], results[0][key],
                                          err_msg=key)


LOSS_NAMES = ("clip_local", "clip_global", "clip_masked", "siglip_bidir",
              "siglip_chain", "siglip_masked_bidir", "siglip_masked_chain")


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_run_over_the_data_group(runs, name):
    """CLIP's gather and SigLIP's ring at data 2 x model 2: each data
    rank's share against the JAX function under shard_map over 2 devices
    (the mean of the shares; a rank's feature gradient is 2 x its rows of
    the JAX gradient), the same on both model ranks of a data group."""
    r = _results(runs, 4)
    loss, gm, gs = runs["losses"][name]
    b = loss_inputs(2)["mod"].shape[0] // 2
    shares = [float(r[k][f"dloss/{name}/loss"]) for k in (0, 2)]
    np.testing.assert_allclose(np.mean(shares), loss, rtol=LOSS_RTOL)
    for rank, res in enumerate(r):
        dr = rank // 2
        for key in ("loss", "grad_mod", "grad_seq"):
            np.testing.assert_array_equal(res[f"dloss/{name}/{key}"],
                                          r[2 * dr][f"dloss/{name}/{key}"])
        for got, want in ((res[f"dloss/{name}/grad_mod"], gm),
                          (res[f"dloss/{name}/grad_seq"], gs)):
            np.testing.assert_allclose(got / 2, want[dr * b:(dr + 1) * b],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_data_group_collectives(runs):
    """The gather with gradient, the ring shift and the ragged gather run
    over the data group (ranks {0, 2} and {1, 3}): as at a world of 2."""
    inp = loss_inputs(2)
    mod, w = inp["mod"], inp["weights"]
    b = mod.shape[0] // 2
    for rank, r in enumerate(_results(runs, 4)):
        dr = rank // 2
        np.testing.assert_array_equal(r["dloss/gather/value"], mod)
        np.testing.assert_allclose(r["dloss/gather/grad"],
                                   (w[0] + w[1])[dr * b:(dr + 1) * b],
                                   rtol=1e-6)
        np.testing.assert_array_equal(r["dloss/shift/value"],
                                      mod[(1 - dr) * b:(2 - dr) * b])
        np.testing.assert_array_equal(r["dloss/shift/grad"], w[1 - dr][:b])
        np.testing.assert_array_equal(r["dloss/gather_rows"],
                                      np.concatenate([mod[:3], mod[:5]]))
        assert float(r["dloss/mean"]) == 0.5


def test_loaders_and_seed_shared_within_a_model_group(runs):
    """Data rank d's two model ranks load the same rows and draw the same
    dropout seed; the two data ranks different ones."""
    r = _results(runs, 4)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(r[a]["loader"], r[b]["loader"])
        assert int(r[a]["seed"]) == int(r[b]["seed"])
    assert not np.array_equal(r[0]["loader"], r[2]["loader"])
    assert int(r[0]["seed"]) != int(r[2]["seed"])


def test_parallel_layers_match_an_unsharded_dense_pair(runs):
    """fc1 column- and fc2 row-parallel against Dense, forward and
    backward: the output and the input gradient whole on every rank, each
    weight gradient the block of the whole one, the row-parallel bias's
    gradient whole; a row-parallel layer on a whole input likewise."""
    lay = runs["layers"]
    for rank, r in enumerate(_results(runs, 2)):
        for key in ("y", "gx", "fc1_gb", "fc2_gb"):
            want = r[f"layers/full/{key}"]
            if key == "fc1_gb":
                want = np.split(want, 2, 0)[rank]
            np.testing.assert_allclose(r[f"layers/tp/{key}"], want,
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        for tag, dim in (("fc1", 0), ("fc2", 1)):
            np.testing.assert_allclose(
                r[f"layers/tp/{tag}_gw"],
                np.split(r[f"layers/full/{tag}_gw"], 2, dim)[rank],
                rtol=1e-5, atol=1e-6)
        x, dy = torch.from_numpy(lay["x"]), torch.from_numpy(lay["dy"])
        w = torch.from_numpy(lay["w2"][:, :8])
        np.testing.assert_allclose(r["layers/scatter/y"], (
            x @ w.T + torch.from_numpy(lay["b2"])).numpy(), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(r["layers/scatter/gx"], (dy @ w).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_lora_column_parallel_matches_whole(runs):
    """LoraDense split with its q/k/v: the output is the whole one's block,
    the input gradient the whole one's, lora_B's gradient its block and
    lora_A's, summed over the model group, the whole one's."""
    for rank, r in enumerate(_results(runs, 2)):
        np.testing.assert_allclose(r["lora/tp/y"],
                                   np.split(r["lora/full/y"], 2, -1)[rank],
                                   rtol=1e-5, atol=1e-6)
        for key in ("gx", "ga"):
            np.testing.assert_allclose(r[f"lora/tp/{key}"],
                                       r[f"lora/full/{key}"], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(r["lora/tp/gb"],
                                   np.split(r["lora/full/gb"], 2, 0)[rank],
                                   rtol=1e-5, atol=1e-6)


def test_megatron_f_and_g(runs):
    """f: identity forward, the gradient summed over the model group
    (ranks' factors 1 and 2: 3); g: the sum forward (1 + 2)."""
    for r in _results(runs, 2):
        np.testing.assert_array_equal(r["f/grad"], np.full(3, 3.0))
        np.testing.assert_array_equal(r["g/value"], np.full(3, 3.0))


def test_checkpoint_written_at_model_2_restores_at_model_1(runs):
    """The model-2 ranks' checkpoint holds full tensors: one process
    restores it bit for bit (parameters and Adam moments) and holds the
    ranks' joined parameters."""
    r0 = _results(runs, 2)[0]
    path = str(runs["root"] / "ckpt" / "tp2" / "last")
    state = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    module = tp_module(runs["saved"], (1, 0), LR).init()
    ckpt.load_state(module, path)
    got = module.model.state_dict()
    assert set(got) == set(state["model"]) and module.step == 3
    for name, t in state["model"].items():
        assert torch.equal(got[name], t), name
        if f"param/{name}" in r0:
            np.testing.assert_array_equal(t.numpy(), r0[f"param/{name}"],
                                          err_msg=name)
    want = state["optimizer"]["state"]
    for i, s in module.opt.base.state_dict()["state"].items():
        for key in ckpt.MOMENTS:
            assert torch.equal(s[key], want[i][key]), (i, key)
            assert s[key].shape == module.opt.params[i].shape


def test_checkpoint_written_at_model_1_restores_at_model_2(runs):
    """Each model-2 rank restores the one process's checkpoint as its
    blocks, bit for bit, and steps on from it as the process does."""
    path = str(runs["root"] / "ckpt" / "tp1" / "last")
    state = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    one = runs["one"][1]
    layout = {}
    for rank, r in enumerate(_results(runs, 2)):
        module = tp_module(runs["saved"], (2, rank), LR)
        layout = partitioning.layout_of(module.model)
        cut = partitioning.shard_state_dict(state["model"], rank, 2, layout)
        for name, t in cut.items():
            np.testing.assert_array_equal(r[f"restored/{name}"], t.numpy(),
                                          err_msg=name)
        for i, p in enumerate(one.opt.params):
            dim = layout.get(next(k for k, q in one.model.named_parameters()
                                  if q is p))
            for key in ckpt.MOMENTS:
                full = state["optimizer"]["state"][i][key]
                want = full if dim is None else full.chunk(2, dim)[rank]
                np.testing.assert_array_equal(
                    r[f"restored_opt/{i}/{key}"], want.numpy())
        assert int(r["restored/step"]) == 3
        np.testing.assert_allclose(r["restored/losses"], runs["again"][0],
                                   rtol=RTOL, atol=ATOL)
    assert layout


def test_peft_export_of_a_split_lora_b(runs):
    """The model-2 ranks' peft adapter (lora_B joined over the model
    group) equals one process's export of the same weights."""
    module = tp_module(runs["saved"], (1, 0), LR).init()
    ckpt.load_state(module, str(runs["root"] / "ckpt" / "tp2" / "last"))
    want = export_peft_lora(
        module.encoders["sequence"].transformer.state_dict(), 2)
    got = np.load(runs["root"] / "ckpt" / "tp2" / "peft" / "adapter_model.npz")
    assert sorted(got.files) == sorted(want) and len(want) == 12
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)


# -- the int8 hub at model 2, and one replica a model group (F1) --------------


def test_int8_hub_at_model_2_equals_one_process(runs):
    """Each model rank's int8 hub (whole: no split heads, no model-group
    collective) pools the rows as one process's does, bit for bit, and
    holds as many bytes."""
    one, pooled = runs["int8"]
    hub = one.encoders["sequence"].transformer
    want_bytes = sum(t.numel() * t.element_size() for t in hub.buffers())
    for r in _results(runs, 2):
        np.testing.assert_array_equal(r["int8/pooled"], pooled)
        assert int(r["int8/hub_bytes"]) == want_bytes


def test_int8_checkpoint_at_model_2_restores_at_model_1(runs):
    """The model-2 ranks' checkpoint of the int8 hub + split tower holds
    the int8 leaves whole: one process restores it bit for bit."""
    path = str(runs["root"] / "ckpt" / "int8_tp2" / "last")
    state = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    module = int8_tp_module(runs["saved"], (1, 0)).init()
    want = module.model.state_dict()
    ckpt.load_state(module, path)
    got = module.model.state_dict()
    assert set(got) == set(state["model"]) == set(want)
    assert any(k.endswith("weight_q") for k in got)
    for name, t in state["model"].items():
        assert torch.equal(got[name], t), name
        assert torch.equal(t, want[name]), name


def test_replicas_stay_one_under_rank_noise(runs):
    """Trainer.fit at model 2 with deterministic algorithms off and noise
    of each rank's own added to the tower's embedding gradient (a
    replicated parameter): the raw gradients differ across the ranks, and
    after the steps every replicated parameter is bit-identical across the
    model group (the group's first rank's gradient is everyone's)."""
    r0, r1 = _results(runs, 2)
    assert not np.array_equal(r0["f1/noisy/noisy_grad"],
                              r1["f1/noisy/noisy_grad"])
    held = [k for k in r0 if k.startswith("f1/noisy/held/")]
    assert any("embed_tokens" in k for k in held) and len(held) > 10
    for key in held:
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    assert int(r0["f1/noisy/step"]) == TP_FIT_BATCHES


def test_fit_at_model_2_equals_one_process(runs):
    """Without the noise, the model-2 fit's trainable parameters (joined
    over the group) equal one process's fit at model 1, at the bar the
    steps above are held to."""
    want = {n: p.detach().numpy() for n, p in
            runs["fit_one"].model.named_parameters() if p.requires_grad}
    for r in _results(runs, 2):
        assert int(r["f1/clean/step"]) == TP_FIT_BATCHES
        for name, w in want.items():
            np.testing.assert_allclose(r[f"f1/clean/param/{name}"], w,
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_deterministic_flag_holds_during_the_fit(runs):
    """trainer.deterministic=True runs every forward of the fit under
    torch's deterministic algorithms and sets them back after; False
    leaves them off."""
    for r in _results(runs, 2):
        assert r["f1/clean/deterministic"].size > 0
        assert r["f1/clean/deterministic"].all()
        assert not r["f1/noisy/deterministic"].any()
        assert not r["f1/clean/after"] and not r["f1/noisy/after"]
