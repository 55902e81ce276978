"""The text path of the PyTorch port against the JAX package, on the CPU in
f32: WordPiece, `Bert` (against a random-init HF `BertModel` and against
the JAX `Bert`: padded rows, packed rows equal to each text encoded alone,
LoRA, remat), `TextEncoder` and `OneProtModel("text")` unpacked and packed
with cls and mean pooling, `create_text_encoder`, `TextDataset` and the
data module batch for batch (padded and packed; its CSV reader against
pandas), `Trainer.fit` on seq<->text and `embed_texts`, and the import
boundary of the text modules.

Weights are the JAX models' init (perturbed where an init leaves
LayerNorms at 1/0 or LoRA's B at 0), carried over by
oneprot_tpu_torch.convert. The text tower is `bert_tiny` (2 layers of 128,
2 heads of 64, the heads of every BERT size) over the tiny WordPiece
vocabulary.
"""

import dataclasses
import json
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

from oneprot_tpu.data import tokenizers as jtok
from oneprot_tpu.data.datamodule import OneProtDataModule as JaxDataModule
from oneprot_tpu.data.datasets.text_dataset import TextDataset as JaxTextDataset
from oneprot_tpu.data.synthetic import generate_fixtures
from oneprot_tpu.models import bert as jbert
from oneprot_tpu.models import encoders as jenc
from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder
from oneprot_tpu.train.module import OneProtModule as JaxModule
from oneprot_tpu.train.optim import adam as jax_adam
from oneprot_tpu.train.trainer import Trainer as JaxTrainer
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.data import tokenizers
from oneprot_tpu_torch.data.datamodule import OneProtDataModule
from oneprot_tpu_torch.data.datasets import text_dataset
from oneprot_tpu_torch.models import bert, encoders, esm2
from oneprot_tpu_torch.serving import OneProtEmbedder
from oneprot_tpu_torch.train import optim
from oneprot_tpu_torch.train.module import OneProtModule
from oneprot_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
# f32 on the CPU: the two frameworks differ in summation order and in the
# last ulp of erf, exp and LayerNorm, nothing else
RTOL, ATOL = 1e-4, 1e-5
VOCAB = len(tokenizers.tiny_wordpiece_vocab())
WIDTH = 32
CORPUS = [
    "The catalytic site of the enzyme, (binding) membrane-protein.",
    "Naïve CAFÉ résumé: structures activity, domains 42 1.5",
    "unknownwordxyz zzz!? ### ÅÄÖ ∆ 中文 protein_binding",
    "",
    "   multiple   spaces\tand\nnewlines  ",
    "the " * 40 + "membrane",
    "x" * 120,
    "protease bindings catalyses structured",
]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed=1, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        x + scale * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])


# ---------------------------------------------------------------------------
# WordPiece


@pytest.mark.parametrize("kw", [
    dict(), dict(max_length=8), dict(max_length=8, padding="max_length"),
    dict(padding=48), dict(max_length=64, padding=16),
    dict(pad_to_multiple_of=8)])
def test_wordpiece_matches_jax(kw):
    port = tokenizers.resolve_text_tokenizer("tiny")
    ref = jtok.resolve_text_tokenizer("tiny")
    np.testing.assert_array_equal(port(CORPUS, **kw), ref(CORPUS, **kw))
    for text in CORPUS:
        assert port.encode_ids(text, 12) == ref.encode_ids(text, 12)
        assert port._basic_tokenize(text) == ref._basic_tokenize(text)


def test_wordpiece_vocabulary_and_cased_mode_match_jax(tmp_path):
    words = ["naive", "cafe", "##ase", "prot", "##ein", "Membrane", "[X]"]
    assert (tokenizers.tiny_wordpiece_vocab(words)
            == jtok.tiny_wordpiece_vocab(words))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(list(jtok.tiny_wordpiece_vocab(words))
                               + ["", "tail"]) + "\n")
    for lower in (True, False):
        port = tokenizers.WordPieceTokenizer.from_vocab_file(str(vocab), lower)
        ref = jtok.WordPieceTokenizer.from_vocab_file(str(vocab), lower)
        assert port.vocab == ref.vocab and port.vocab_size == ref.vocab_size
        np.testing.assert_array_equal(port(CORPUS), ref(CORPUS))
    for ch in "a.,;!?-_(){}[]#$%&*+/:<=>@\\^`|~¿«»–—·中 \t":
        assert tokenizers._is_punctuation(ch) == jtok._is_punctuation(ch), ch


def test_resolve_text_tokenizer_matches_jax(tmp_path):
    vocab = jtok.tiny_wordpiece_vocab(["ribosome"])
    (tmp_path / "txt").mkdir()
    (tmp_path / "txt" / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (tmp_path / "js").mkdir()
    (tmp_path / "js" / "vocab.json").write_text(json.dumps(vocab))
    for name in ("tiny", "synthetic", "", str(tmp_path / "txt"),
                 str(tmp_path / "js"), str(tmp_path / "txt" / "vocab.txt")):
        port = tokenizers.resolve_text_tokenizer(name)
        assert port.vocab == jtok.resolve_text_tokenizer(name).vocab, name
    name = "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract-fulltext"
    for mod in (tokenizers, jtok):
        with pytest.raises(FileNotFoundError, match="no local vocab"):
            mod.resolve_text_tokenizer(name)


# ---------------------------------------------------------------------------
# Bert


@pytest.mark.parametrize("name", ["bert_tiny", "bert_small", "bert_base",
                                  "microsoft/BiomedNLP-BiomedBERT-base-uncased-"
                                  "abstract-fulltext", "allenai/scibert"])
def test_resolve_bert_config_matches_jax(name):
    for vocab in (None, VOCAB):
        assert (dataclasses.asdict(bert.resolve_bert_config(name, vocab))
                == dataclasses.asdict(jbert.resolve_bert_config(name, vocab)))
    assert bert.resolve_bert_config(name).num_heads * 64 == (
        bert.resolve_bert_config(name).hidden_size)


def test_resolve_bert_config_reads_a_config_json(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "hidden_size": 96, "num_hidden_layers": 3, "num_attention_heads": 3,
        "intermediate_size": 192, "vocab_size": 500,
        "max_position_embeddings": 128, "layer_norm_eps": 1e-7}))
    for vocab in (None, 77):
        assert (dataclasses.asdict(bert.resolve_bert_config(str(tmp_path), vocab))
                == dataclasses.asdict(jbert.resolve_bert_config(str(tmp_path),
                                                                vocab)))


SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=96, max_position_embeddings=40)


def _text_ids(rng, B, L, lens=None):
    """[CLS] words [SEP] then [PAD] (0) rows of the tiny vocabulary."""
    ids = np.zeros((B, L), np.int32)
    for b in range(B):
        n = L if lens is None else lens[b]
        ids[b, :n] = rng.randint(5, VOCAB, size=n)
        ids[b, 0], ids[b, n - 1] = 2, 3
    return ids


@pytest.fixture(scope="module")
def small_bert():
    """(config, JAX params with LoRA rank 4, the same without the factors)."""
    cfg = jbert.BertConfig(**SMALL)
    ids = jnp.asarray(_text_ids(np.random.RandomState(0), 2, 12))
    params = _perturbed(jbert.Bert(cfg, lora_rank=4).init(
        jax.random.PRNGKey(0), ids)["params"])
    plain = jax.tree_util.tree_map(lambda x: x, params)
    for i in range(cfg.num_layers):
        for name in ("q", "k", "v"):
            plain[f"layer_{i}"]["attn"][name] = {
                "dense": params[f"layer_{i}"]["attn"][name]["dense"]}
    return cfg, params, plain


def _port_bert(lora=False, remat=False, state=None):
    model = bert.Bert(bert.BertConfig(**SMALL),
                      esm2.LoraConfig(4, 16.0, 0.0) if lora else None, remat,
                      device="cpu", dtype=torch.float32)
    if state is not None:
        model.load_state_dict(convert.bert_state_dict(_numpy_tree(state)))
    return model


def test_bert_matches_hf():
    """A random-init HF BertModel, through the JAX package's HF converter
    and then the port's: the same last hidden state on real tokens (the
    JAX test's case, tests/test_models.py)."""
    transformers = pytest.importorskip("transformers")
    from oneprot_tpu.models.hf_convert import convert_bert_state_dict

    hf_cfg = transformers.BertConfig(
        vocab_size=100, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, pad_token_id=0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    rng = np.random.RandomState(2)
    ids = rng.randint(5, 99, size=(3, 10)).astype(np.int32)
    ids[:, 0] = 2
    ids[0, 6:] = 0
    mask = ids != 0
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()
                  ).last_hidden_state.numpy()
    model = bert.Bert(bert.BertConfig(vocab_size=100, hidden_size=48,
                                      num_layers=2, num_heads=4,
                                      intermediate_size=96,
                                      max_position_embeddings=64),
                      device="cpu", dtype=torch.float32)
    model.load_state_dict(convert.bert_state_dict(_numpy_tree(
        convert_bert_state_dict(hf.state_dict(), 2))))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("lora", [False, True], ids=["float", "lora"])
def test_bert_padded_rows_match_jax(small_bert, lora):
    cfg, params, plain = small_bert
    tree = params if lora else plain
    ids = _text_ids(np.random.RandomState(1), 3, 20, lens=[20, 9, 14])
    ref = np.asarray(jbert.Bert(cfg, lora_rank=4 if lora else 0).apply(
        {"params": tree}, jnp.asarray(ids)))
    with torch.no_grad():
        got = _port_bert(lora, state=tree)(torch.from_numpy(ids)).numpy()
    # padded rows' outputs are don't-care: compare the real tokens
    real = ids != 0
    np.testing.assert_allclose(got[real], ref[real], rtol=RTOL, atol=ATOL)


def _packed(texts, row_len, pad_id=1):
    """One row packing `texts` (padding: pad_id, segment -1), as
    data/packing.py lays them out."""
    ids = np.full((1, row_len), pad_id, np.int32)
    seg = np.full((1, row_len), -1, np.int32)
    off = 0
    for s, t in enumerate(texts):
        ids[0, off:off + len(t)] = t
        seg[0, off:off + len(t)] = s
        off += len(t)
    return ids, seg


def test_bert_packed_rows_match_jax_and_each_text_alone(small_bert):
    """Three texts in one row of 40 (ESM's pad id 1 on the tail, as the
    packer writes it): each text's tokens equal the same text encoded
    alone, and the JAX Bert on the packed row."""
    cfg, params, _ = small_bert
    rng = np.random.RandomState(3)
    lens = [11, 17, 6]
    texts = [_text_ids(rng, 1, n)[0] for n in lens]
    ids, seg = _packed(texts, 40)
    ref = np.asarray(jbert.Bert(cfg, lora_rank=4).apply(
        {"params": params}, jnp.asarray(ids), segment_ids=jnp.asarray(seg)))
    model = _port_bert(lora=True, state=params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids),
                    segment_ids=torch.from_numpy(seg)).numpy()
        off = 0
        for t in texts:
            alone = model(torch.from_numpy(t[None])).numpy()[0]
            np.testing.assert_allclose(got[0, off:off + len(t)], alone,
                                       rtol=RTOL, atol=ATOL)
            off += len(t)
    np.testing.assert_allclose(got[0, :off], ref[0, :off], rtol=RTOL,
                               atol=ATOL)


def test_segment_positions_restart_and_clamp():
    seg = torch.tensor([[0, 0, 0, 1, 1, -1, -1, -1],
                        [3, 3, 3, 3, 3, 3, 3, 3]], dtype=torch.int32)
    pos = bert.segment_positions(seg, 6)
    assert pos.tolist() == [[0, 1, 2, 0, 1, 0, 1, 2], [0, 1, 2, 3, 4, 5, 5, 5]]


def test_bert_embeddings_sum_in_the_parameters_dtype(small_bert):
    """bf16 tables (a frozen tower after init): words + positions round to
    bf16, the token type adds in the f32 compute dtype, as XLA runs the
    JAX layer's sum (its last bf16 add and cast to f32 fold into one f32
    add); the JAX Bert on the same bf16 tables agrees."""
    _, _, plain = small_bert
    model = _port_bert(state=plain)
    for t in (model.word_embeddings, model.position_embeddings,
              model.token_type_embeddings):
        t.data = t.data.to(torch.bfloat16)
    ids = torch.from_numpy(_text_ids(np.random.RandomState(4), 2, 10))
    seen = {}
    model.emb_ln.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0]))
    with torch.no_grad():
        model(ids)
    want = ((model.word_embeddings[ids.long()]
             + model.position_embeddings[None, :10]).float()
            + model.token_type_embeddings[0].float())
    assert seen["x"].dtype == torch.float32
    assert torch.equal(seen["x"], want)
    tree = dict(plain)
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        tree[name] = plain[name].astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(jbert.Bert(jbert.BertConfig(**SMALL)).apply)(
        {"params": tree}, jnp.asarray(ids.numpy())))
    with torch.no_grad():
        got = model(ids).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_bert_remat_on_equals_off_under_lora_dropout(small_bert):
    """Each layer's LoRA dropout mask is drawn again in the recompute: the
    gradients with remat equal those without."""
    _, params, _ = small_bert
    ids = torch.from_numpy(_text_ids(np.random.RandomState(5), 2, 16,
                                     lens=[16, 9]))
    grads = []
    for remat in (False, True):
        model = bert.Bert(bert.BertConfig(**SMALL), esm2.LoraConfig(4, 16.0, 0.3),
                          remat, device="cpu", dtype=torch.float32)
        model.load_state_dict(convert.bert_state_dict(_numpy_tree(params)))
        model.train()
        esm2.set_lora_dropout_seed(model, 11)
        model(ids).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6,
                                   msg=name)
    lora_b = [n for n in grads[0] if n.endswith("lora_A")]
    assert len(lora_b) == 6 and all(grads[0][n].abs().sum() > 0 for n in lora_b)


def test_bert_refuses_float32_on_the_card():
    """float32 runs on the card only through the f32 flash-MHA instances
    (heads that are multiples of 8 up to 64, as bert_tiny's): BERT with
    wider heads in f32, or in another dtype, is refused when it is built
    on the card; the CPU takes any."""
    wide = bert.BertConfig(**{**SMALL, "num_heads": 1,
                              "hidden_size": 128})  # heads of 128
    with pytest.raises(ValueError, match="heads of 128"):
        bert.Bert(wide, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        encoders.create_text_encoder("bert_tiny", dtype=torch.float16)
    for cfg in (bert.BertConfig(**SMALL), wide):
        assert bert.Bert(cfg, dtype=torch.float32, device="cpu") is not None


def test_init_bert_weights_is_seeded():
    def make(seed):
        enc = encoders.create_text_encoder("bert_tiny", output_dim=16,
                                           vocab_size=VOCAB, dtype="float32",
                                           device="cpu", use_lora=True)
        bert.init_bert_weights_(enc, torch.Generator().manual_seed(seed))
        return enc.state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.word_embeddings"],
                           c["transformer.word_embeddings"])
    assert float(a["transformer.word_embeddings"].std()) == pytest.approx(
        0.02, rel=0.1)
    assert a["transformer.layers.0.attn.q.lora_B"].abs().sum() == 0
    assert torch.equal(a["transformer.emb_ln.weight"], torch.ones(128))


# ---------------------------------------------------------------------------
# TextEncoder and OneProtModel("text")


def _jax_text(pooling="cls", use_lora=False, frozen=True):
    return jenc.create_text_encoder(
        "bert_tiny", output_dim=WIDTH, pooling_type=pooling, vocab_size=VOCAB,
        use_lora=use_lora, lora_r=4, lora_alpha=8, lora_dropout=0.0,
        frozen=frozen, dtype="float32")


def _port_text(pooling="cls", use_lora=False, frozen=True, remat=False):
    return encoders.create_text_encoder(
        "bert_tiny", output_dim=WIDTH, pooling_type=pooling, vocab_size=VOCAB,
        use_lora=use_lora, lora_r=4, lora_alpha=8, lora_dropout=0.0,
        frozen=frozen, dtype="float32", device="cpu", remat=remat)


@pytest.fixture(scope="module", params=["cls", "mean"])
def text_pair(request):
    pooling = request.param
    jmodel = jenc.OneProtModel(encoders={"text": _jax_text(pooling, True)})
    ids = jnp.asarray(_text_ids(np.random.RandomState(0), 2, 16))
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), ids, "text")["params"])
    port = encoders.OneProtModel({"text": _port_text(pooling, True)})
    port.load_state_dict(convert.oneprot_state_dict(_numpy_tree(params)))
    return pooling, jmodel, params, port


def test_text_encoder_matches_jax(text_pair):
    _, jmodel, params, port = text_pair
    ids = _text_ids(np.random.RandomState(6), 4, 24, lens=[24, 5, 13, 20])
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), "text"))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), "text").numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # the fixed logit scale 1/0.07 of the shipped head
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1 / 0.07, rtol=1e-5)


def test_text_encoder_packed_matches_jax_and_unpacked(text_pair):
    pooling, jmodel, params, port = text_pair
    rng = np.random.RandomState(7)
    lens = [9, 14, 7, 12]
    texts = [_text_ids(rng, 1, n)[0] for n in lens]
    ids = np.full((2, 32), 1, np.int32)
    seg = np.full((2, 32), -1, np.int32)
    for r, members in enumerate(([0, 1], [2, 3])):
        off = 0
        for s, i in enumerate(members):
            ids[r, off:off + lens[i]] = texts[i]
            seg[r, off:off + lens[i]] = s
            off += lens[i]
    P = 3  # slot 2 of each row is empty
    ref, ref_counts = jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(seg), P, "text",
        method=jenc.OneProtModel.encode_packed)
    with torch.no_grad():
        got, counts = port.encode_packed(torch.from_numpy(ids),
                                         torch.from_numpy(seg), P, "text")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert counts.tolist() == [9, 14, 0, 7, 12, 0]
    # each packed text's features equal its features alone
    padded = np.zeros((4, 16), np.int32)
    for i, t in enumerate(texts):
        padded[i, :len(t)] = t
    with torch.no_grad():
        alone = port(torch.from_numpy(padded), "text").numpy()
    np.testing.assert_allclose(got.numpy()[[0, 1, 3, 4]], alone, rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        pooled, _ = port.encode_packed_pooled(
            torch.from_numpy(ids), torch.from_numpy(seg), P, "text")
    jpooled, _ = jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(seg), P, "text",
        method=jenc.OneProtModel.encode_packed_pooled)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("use_lora,frozen,cacheable", [
    (False, True, True), (True, True, False), (False, False, False)])
def test_text_encoder_cacheable_and_trainable_follow_jax(use_lora, frozen,
                                                         cacheable):
    port = _port_text(use_lora=use_lora, frozen=frozen)
    assert port.backbone_is_cacheable == cacheable
    assert _jax_text(use_lora=use_lora, frozen=frozen).backbone_is_cacheable \
        == cacheable
    mask = optim.trainable_mask({"text": port})
    trains = {n for n, m in mask.items() if m and ".transformer." in n}
    if not frozen:
        assert len(trains) == sum(1 for n in mask if ".transformer." in n)
    elif use_lora:
        assert trains and all(n.endswith(("lora_A", "lora_B", "bias"))
                              for n in trains)
    else:
        assert not trains


def test_create_text_encoder_like_jax(tmp_path):
    enc = encoders.create_text_encoder(device="cpu", dtype="float32",
                                       lora_target_modules=["query", "value"])
    assert dataclasses.asdict(enc.config) == dataclasses.asdict(
        jbert.BERT_SIZES["bert_base"])
    assert enc.pooling_type == "cls" and enc.frozen
    assert enc.head.logit_scale is not None
    assert encoders.create_text_encoder(
        "bert_tiny", vocab_size=VOCAB, device="cpu",
        dtype="float32").transformer.word_embeddings.shape == (VOCAB, 128)
    local = tmp_path / "biomedbert"
    local.mkdir()
    (local / "config.json").write_text(json.dumps({
        "hidden_size": 64, "num_hidden_layers": 1, "num_attention_heads": 1,
        "intermediate_size": 64}))
    assert encoders.create_text_encoder(str(local), device="cpu",
                                        dtype="float32").config.hidden_size == 64
    (local / "pytorch_model.bin").write_bytes(b"")
    assert encoders.create_text_encoder(
        str(local), device="cpu", dtype="float32").pretrained_dir == str(local)


def test_text_modality_is_ported():
    assert "text" in encoders.PORTED_MODALITIES
    with pytest.raises(NotImplementedError, match="no_such"):
        encoders.OneProtModel({"no_such": torch.nn.Linear(2, 2)})


# ---------------------------------------------------------------------------
# data: the CSV, TextDataset, the data module


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("text_fx"))
    generate_fixtures(d, n_train=12, n_eval=6)
    return d


def test_csv_reader_matches_pandas(data_dir, tmp_path):
    pd = pytest.importorskip("pandas")
    odd = tmp_path / "odd.csv"
    odd.write_text('p1,"quoted, with a comma"\n'
                   'p2,"a ""quoted"" word"\n'
                   "p3,\n"
                   "\n"
                   "p4,NA\n"
                   "p5,null\n"
                   'p6,"line one\nline two"\n'
                   "p7, leading space\n"
                   "p8,None\n", encoding="utf-8")
    for path in (odd, *(Path(data_dir) / f"{s}_text.csv"
                        for s in ("train", "val", "test"))):
        df = pd.read_csv(path, header=None)
        want = [[str(df[c].iloc[i]) for c in (0, 1)] for i in range(len(df))]
        assert text_dataset.read_text_csv(str(path)) == want, path


def test_numeric_text_column_is_kept_as_text(tmp_path):
    """The one deliberate difference from pandas: a column of numbers
    stays text (pandas would read 7 and 2.5 as numbers)."""
    path = tmp_path / "nums.csv"
    path.write_text("p1,7\np2,2.50\n")
    assert text_dataset.read_text_csv(str(path)) == [["p1", "7"], ["p2", "2.50"]]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_text_dataset_matches_jax(data_dir):
    for split in ("train", "val"):
        kw = dict(data_dir=data_dir, split=split, max_length=48,
                  text_max_length=12, buckets=[8, 16, 64])
        port, ref = text_dataset.TextDataset(**kw), JaxTextDataset(**kw)
        assert len(port) == len(ref)
        ids = [port[i] for i in range(len(port))]
        assert ids == [ref[i] for i in range(len(ref))]
        np.testing.assert_array_equal(port.lengths(), ref.lengths())
        for sid in ids + ["missing_id"]:
            _assert_same(port.tokenize_pair(sid), ref.tokenize_pair(sid))
        _assert_same(port.collate_fn(ids[:5] + ["missing_id"]),
                     ref.collate_fn(ids[:5] + ["missing_id"]))


def _dm_kwargs(d, packed=False, batch=4):
    return dict(
        modalities={"text": {
            "dataset": {"data_dir": d, "max_length": 64,
                        "text_max_length": 32},
            "batch_size": {"train": batch, "val": batch, "test": batch}}},
        buckets=[16, 32, 64], pack_sequences=packed, pack_rows=2,
        pack_row_len=64, pack_slots=4)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_datamodule_matches_jax(data_dir, packed):
    port = OneProtDataModule(**_dm_kwargs(data_dir, packed))
    ref = JaxDataModule(**_dm_kwargs(data_dir, packed))
    port.setup()
    ref.setup()
    _assert_same(port.example_batches(), ref.example_batches())
    for epoch in (0, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port.train_dataloader()), list(ref.train_dataloader())
        assert got
        _assert_same(got, want)
    _assert_same(list(port.val_dataloader()), list(ref.val_dataloader()))
    _assert_same(list(port.test_dataloader()), list(ref.test_dataloader()))


# ---------------------------------------------------------------------------
# Trainer.fit on seq<->text


def _jax_seq_text(loss_fn="CLIP", use_lora=False, frozen_param_dtype=None):
    hub = jenc.create_sequence_encoder(
        "esm2_tiny", output_dim=WIDTH, proj_type="mlp",
        frozen=True, dtype="float32")
    return JaxModule(components={"sequence": hub,
                                 "text": _jax_text(use_lora=use_lora)},
                     optimizer=lambda: jax_adam(1e-3), loss_fn=loss_fn,
                     use_l1_regularization=True, seed=0,
                     frozen_param_dtype=frozen_param_dtype)


def _port_seq_text(jax_module, loss_fn="CLIP", use_lora=False,
                   frozen_param_dtype=None):
    cfg = esm2.Esm2Config(**dataclasses.asdict(
        jax_module.encoders["sequence"].config))
    hub = encoders.SequenceEncoder(cfg, WIDTH, proj_type="mlp", frozen=True,
                                   device="cpu", dtype=torch.float32)
    module = OneProtModule({"sequence": hub, "text": _port_text(use_lora=use_lora)},
                           optimizer=lambda: optim.adam(1e-3), loss_fn=loss_fn,
                           use_l1_regularization=True,
                           frozen_param_dtype=frozen_param_dtype)
    module.model.load_state_dict(convert.oneprot_state_dict(
        _numpy_tree(jax_module.state.params)))
    return module


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("loss_fn,use_lora,packed,frozen_dtype", [
    ("CLIP", False, False, "bfloat16"), ("SigLIP", True, False, None),
    ("SigLIP", True, True, None)],
    ids=["fully-cached-clip", "lora-siglip", "packed-lora-siglip"])
def test_fit_seq_text_matches_jax(data_dir, tmp_path, loss_fn, use_lora,
                                  packed, frozen_dtype):
    """Two epochs of each trainer from the same weights: a frozen text
    tower trains only the two heads through the fully cached steps (frozen
    leaves stored bf16, the shipped default); a LoRA tower trains through
    train_step_cached (padded) or train_step_packed_cached (packed)."""
    kw = _dm_kwargs(data_dir, packed)
    jm = _jax_seq_text(loss_fn, use_lora, frozen_dtype)
    jt = JaxTrainer(max_epochs=2, log_every_n_steps=1, devices=1,
                    mesh={"data": 1, "model": 1},
                    default_root_dir=str(tmp_path / "jax"))
    jmet = jt.fit(jm, JaxDataModule(**kw))
    # the JAX trainer's seeded init is deterministic: re-run it for the port
    init = _jax_seq_text(loss_fn, use_lora, frozen_dtype)
    dm = JaxDataModule(**kw)
    dm.setup()
    init.init(dm.example_batches())
    pm = _port_seq_text(init, loss_fn, use_lora, frozen_dtype)
    calls = {"train_step_fully_cached": 0, "eval_step_fully_cached": 0}
    for name in calls:
        def spy(*a, _real=getattr(pm, name), _name=name):
            calls[_name] += 1
            return _real(*a)

        setattr(pm, name, spy)
    pt = Trainer(max_epochs=2, log_every_n_steps=1, accelerator="cpu",
                 default_root_dir=str(tmp_path / "port"))
    pmet = pt.fit(pm, OneProtDataModule(**kw))

    jrows, prows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in prows] == [r["step"] for r in jrows]
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    losses = [(p[k], j[k]) for p, j in zip(prows, jrows) for k in j
              if k.startswith(("train/loss", "val/loss"))]
    assert pmet["train/steps"] == jmet["train/steps"] > 0
    assert len(losses) >= 2 * pmet["train/steps"]
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=RTOL)
    exact = {k for k in jmet if "_R@" in k or k.startswith("cache/")}
    assert {k: pmet[k] for k in exact} == {k: jmet[k] for k in exact}
    assert pt._feature_cache.hits == jt._feature_cache.hits > 0
    fully = not use_lora
    assert (calls["train_step_fully_cached"] == pmet["train/steps"]) == fully
    assert (calls["eval_step_fully_cached"] > 0) == fully


# ---------------------------------------------------------------------------
# embed_texts


def test_embed_texts_matches_jax_embedder(text_pair):
    """Both embedders bucket by characters + 2 (buckets 16 and 64, a text
    of 120 characters cut to max_length 24), tokenize and batch alike."""
    _, jmodel, params, port = text_pair
    texts = CORPUS + ["the enzyme", "binding site of a membrane protein"]
    jax_module = types.SimpleNamespace(
        model=jmodel, state=types.SimpleNamespace(params=params))
    ref = JaxEmbedder(jax_module, buckets=(16, 64)).embed_texts(
        texts, max_length=24, batch_size=4)
    out = OneProtEmbedder(port, buckets=(16, 64)).embed_texts(
        texts, max_length=24, batch_size=4)
    assert out.shape == (len(texts), WIDTH) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# import boundary


def test_text_modules_load_no_pandas_h5py_yaml_or_jax():
    modules = ["oneprot_tpu_torch.data.datasets.text_dataset",
               "oneprot_tpu_torch.models.bert", "oneprot_tpu_torch.losses.siglip",
               "oneprot_tpu_torch.serving", "oneprot_tpu_torch.train.trainer",
               "oneprot_tpu_torch.data.datamodule"]
    banned = ("pandas", "h5py", "yaml", "jax", "flax", "oneprot_tpu")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
