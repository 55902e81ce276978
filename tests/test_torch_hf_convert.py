"""The port's checkpoint interop (`oneprot_tpu_torch/models/hf_convert.py`,
`OneProtModule.load_pretrained` and the int8 canary) against the JAX
package's, on the CPU, in f32.

Fixtures are random-init HF `EsmModel` / `BertModel` written with
`save_pretrained`, a peft-wrapped copy, a fair-esm `.pt` and a
reference-layout Lightning state dict built by hand. Every conversion of
the port must equal the JAX conversion passed through `convert.py`
exactly; forwards are checked against HF at 1e-4.
"""

import argparse
import dataclasses
import json
import logging
import os
import re

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
peft = pytest.importorskip("peft")
safetensors_torch = pytest.importorskip("safetensors.torch")

from oneprot_tpu.models import encoders as jenc  # noqa: E402
from oneprot_tpu.models import hf_convert as jhf  # noqa: E402
from oneprot_tpu.train.module import OneProtModule as JaxModule  # noqa: E402
from oneprot_tpu_torch import convert  # noqa: E402
from oneprot_tpu_torch.models import encoders as penc  # noqa: E402
from oneprot_tpu_torch.models import hf_convert as phf  # noqa: E402
from oneprot_tpu_torch.models.bert import Bert  # noqa: E402
from oneprot_tpu_torch.models.esm2 import Esm2, LoraConfig  # noqa: E402
from oneprot_tpu_torch.models.heads import EncoderHead  # noqa: E402
from oneprot_tpu_torch.models.msa_transformer import (  # noqa: E402
    MsaTransformer,
    MsaTransformerConfig,
)
from oneprot_tpu_torch.train.module import OneProtModule  # noqa: E402

ESM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=64)
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
MSA = dict(num_layers=1, hidden_size=32, num_heads=2, intermediate_size=64)
GRAPH = dict(hidden_size=16, num_layers=1, num_rbf=8, out_channels=32,
             level="backbone")
RTOL, ATOL = 1e-4, 1e-5


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


def assert_same(got, want):
    """Two state dicts with the same keys and bit-equal values."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def hf_esm_model(seed=0):
    cfg = transformers.EsmConfig(
        vocab_size=33, pad_token_id=1, mask_token_id=32,
        position_embedding_type="rotary", token_dropout=True,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        emb_layer_norm_before=False, layer_norm_eps=1e-5, **ESM)
    torch.manual_seed(seed)
    return transformers.EsmModel(cfg, add_pooling_layer=False).eval()


def hf_bert_model(seed=0):
    cfg = transformers.BertConfig(hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0, **BERT)
    torch.manual_seed(seed)
    return transformers.BertModel(cfg, add_pooling_layer=False).eval()


def with_lora(model, seed=1):
    """A peft-wrapped copy of `model` (r 4 on query/key/value) whose B
    factors are random, so the adapters change the output."""
    wrapped = peft.get_peft_model(model, peft.LoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0,
        target_modules=["query", "key", "value"])).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in wrapped.named_parameters():
            if "lora_B" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return wrapped


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{"esm": (dir, model), "esm_bin": dir, "bert": (dir, model)}."""
    root = tmp_path_factory.mktemp("hf")
    esm, bert = hf_esm_model(), hf_bert_model()
    esm.save_pretrained(str(root / "esm"))
    esm.save_pretrained(str(root / "esm_bin"), safe_serialization=False)
    bert.save_pretrained(str(root / "bert"))
    return {"esm": (str(root / "esm"), esm), "esm_bin": str(root / "esm_bin"),
            "bert": (str(root / "bert"), bert)}


def esm_ids(seed=0, batch=3, length=12, vocab=33):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, min(vocab, 24), size=(batch, length))
    ids[:, 0] = 0
    ids[0, -3] = 2
    ids[0, -2:] = 1  # a padded row
    ids[1:, -1] = 2
    return torch.from_numpy(ids)


# ---------------------------------------------------------------------------
# the readers


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64"])
def test_read_safetensors_like_library(dtype, tmp_path):
    """Exact against safetensors' own reader (and JAX's numpy reader where
    numpy has the dtype), with odd shapes so that offsets fall off the
    item size."""
    tdt = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64}[dtype]
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.odd": torch.randint(0, 255, (3,), generator=gen,
                                      dtype=torch.uint8),
               "b.main": (torch.randn(5, 7, generator=gen) * 100).to(tdt),
               "c.scalar": torch.tensor(3, dtype=tdt),
               "d.empty": torch.zeros(0, 4, dtype=tdt)}
    d = tmp_path / "ckpt"
    d.mkdir()
    safetensors_torch.save_file(tensors, str(d / "model.safetensors"),
                                metadata={"format": "pt"})
    got = phf.load_torch_state_dict(str(d))
    want = safetensors_torch.load_file(str(d / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    if dtype != "BF16":
        jax_sd = jhf.load_torch_state_dict(str(d))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), jax_sd[k])


def test_pytorch_model_bin_and_missing(hf_dirs, tmp_path):
    got = phf.load_torch_state_dict(hf_dirs["esm_bin"])
    want = hf_dirs["esm"][1].state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError):
        phf.load_torch_state_dict(str(tmp_path))


# ---------------------------------------------------------------------------
# ESM2, BERT, fair-esm


def test_esm2_conversion_like_jax_and_hf(hf_dirs):
    """Exact against the JAX conversion (the 21 new 3Di rows drawn from the
    seed included); the converted tower's forward against HF's."""
    d, hf = hf_dirs["esm"]
    got = phf.convert_esm2_state_dict(phf.load_torch_state_dict(d), 2,
                                      extra_vocab_rows=21, seed=5)
    want = convert.esm2_state_dict(jhf.convert_esm2_state_dict(
        jhf.load_torch_state_dict(d), 2, extra_vocab_rows=21, seed=5))
    assert_same(got, want)
    plain = phf.convert_esm2_state_dict(hf.state_dict(), 2)
    model = Esm2(penc.resolve_esm2_config(d), device="cpu",
                 dtype=torch.float32)
    model.load_state_dict(plain)
    ids = esm_ids()
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=(ids != 1).long())
        out = model(ids)
    mask = (ids != 1)[..., None]
    np.testing.assert_allclose((out * mask).numpy(),
                               (ref.last_hidden_state * mask).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_bert_conversion_like_jax_and_hf(hf_dirs):
    d, hf = hf_dirs["bert"]
    got = phf.convert_bert_state_dict(phf.load_torch_state_dict(d), 2)
    want = convert.bert_state_dict(jhf.convert_bert_state_dict(
        jhf.load_torch_state_dict(d), 2))
    assert_same(got, want)
    from oneprot_tpu_torch.models.bert import resolve_bert_config

    model = Bert(resolve_bert_config(d), device="cpu", dtype=torch.float32)
    model.load_state_dict(got)
    ids = torch.randint(1, 64, (3, 10), generator=torch.Generator().manual_seed(2))
    ids[0, 7:] = 0
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=(ids != 0).long())
        out = model(ids)
    mask = (ids != 0)[..., None]
    np.testing.assert_allclose((out * mask).numpy(),
                               (ref.last_hidden_state * mask).numpy(),
                               rtol=RTOL, atol=ATOL)


def fairesm_state(cfg: MsaTransformerConfig, seed=0) -> dict:
    """A fair-esm MSATransformer state dict of random tensors, with the
    keys the converter ignores (lm_head, contact_head)."""
    gen = torch.Generator().manual_seed(seed)
    H, F = cfg.hidden_size, cfg.intermediate_size

    def t(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    sd = {"embed_tokens.weight": t(cfg.vocab_size, H),
          "embed_positions.weight": t(cfg.max_positions + 2, H),
          "msa_position_embedding": t(1, cfg.max_rows, 1, H),
          "lm_head.weight": t(cfg.vocab_size, H),
          "contact_head.regression.weight": t(1, 4)}
    for ln in ("emb_layer_norm_before", "emb_layer_norm_after"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = 1 + t(H), t(H)
    for i in range(cfg.num_layers):
        for blk in ("row_self_attention", "column_self_attention"):
            p = f"layers.{i}.{blk}"
            sd[f"{p}.layer_norm.weight"], sd[f"{p}.layer_norm.bias"] = 1 + t(H), t(H)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{p}.layer.{proj}.weight"] = t(H, H)
                sd[f"{p}.layer.{proj}.bias"] = t(H)
        p = f"layers.{i}.feed_forward_layer"
        sd[f"{p}.layer_norm.weight"], sd[f"{p}.layer_norm.bias"] = 1 + t(H), t(H)
        sd[f"{p}.layer.fc1.weight"], sd[f"{p}.layer.fc1.bias"] = t(F, H), t(F)
        sd[f"{p}.layer.fc2.weight"], sd[f"{p}.layer.fc2.bias"] = t(H, F), t(H)
    return sd


def test_msa1b_conversion_like_jax(tmp_path):
    """A fair-esm `.pt` (with its argparse.Namespace) through both loaders
    and converters: exact, the 2-row position offset dropped and the 4-D
    row table reshaped; the port's tower loads it."""
    cfg = MsaTransformerConfig(**MSA)
    path = str(tmp_path / "esm_msa1b.pt")
    torch.save({"args": argparse.Namespace(layers=1), "model":
                {"encoder." + k: v for k, v in fairesm_state(cfg).items()}},
               path)
    got = phf.convert_msa1b_state_dict(phf.load_fairesm_checkpoint(path), 1)
    want = convert.msa_transformer_state_dict(jhf.convert_msa1b_state_dict(
        jhf.load_fairesm_checkpoint(path), 1))
    assert_same(got, want)
    assert got["embed_positions"].shape == (cfg.max_positions, 32)
    assert got["msa_position_embedding"].shape == (cfg.max_rows, 1, 32)
    MsaTransformer(cfg, device="cpu", dtype=torch.float32).load_state_dict(got)


# ---------------------------------------------------------------------------
# peft


def test_peft_split_import_export_like_jax(hf_dirs):
    """A peft-wrapped EsmModel's state dict: `_split_peft`, the import onto
    the converted tower and the export back, each exactly as in JAX; the
    port's LoRA tower then matches the peft model's forward, and the
    export round-trips bit for bit."""
    wrapped = with_lora(hf_esm_model())
    tsd = {k: v.detach() for k, v in wrapped.state_dict().items()}
    hf, lora = phf._split_peft(tsd)
    jhf_, jlora = jhf._split_peft({k: v.numpy() for k, v in tsd.items()})
    assert sorted(hf) == sorted(jhf_) and sorted(lora) == sorted(jlora)
    assert len(lora) == 2 * 3 * 2 and "embeddings.word_embeddings.weight" in hf
    got = phf.import_peft_lora(lora, phf.convert_esm2_state_dict(hf, 2), 2)
    want_tree = jhf.import_peft_lora(
        jlora, jhf.convert_esm2_state_dict(jhf_, 2), 2)
    assert_same(got, convert.esm2_state_dict(want_tree))
    exported = phf.export_peft_lora(got, 2)
    jexported = jhf.export_peft_lora(want_tree, 2)
    assert sorted(exported) == sorted(jexported)
    for k in jexported:
        np.testing.assert_array_equal(exported[k], jexported[k])
    back = phf.import_peft_lora(exported, dict(got), 2)
    for k in got:
        assert torch.equal(back[k], got[k]), k
    model = Esm2(penc.resolve_esm2_config(hf_dirs["esm"][0]),
                 lora=LoraConfig(4, 8.0, 0.0), device="cpu",
                 dtype=torch.float32).eval()
    model.load_state_dict(got)
    ids = esm_ids(1)
    with torch.no_grad():
        ref = wrapped(input_ids=ids, attention_mask=(ids != 1).long())
        out = model(ids)
    mask = (ids != 1)[..., None]
    np.testing.assert_allclose((out * mask).numpy(),
                               (ref.last_hidden_state * mask).numpy(),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Lightning checkpoints onto the whole model


def ref_head(prefix: str, d_model: int, out: int, proj: str, gen,
             logit_scale=False, attention1d=False) -> dict:
    """A reference BaseEncoder head's tensors: proj Sequential (LN, Linear
    / LN, Linear, GELU, LN, Linear), norm.1's learnable scale, the
    MaskedConv1d pooling layer."""
    def t(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    sd = {}
    if proj == "linear":
        sd.update({"proj.0.weight": 1 + t(d_model), "proj.0.bias": t(d_model),
                   "proj.1.weight": t(out, d_model)})
    else:
        hid = (d_model + out) // 2
        sd.update({"proj.0.weight": 1 + t(d_model), "proj.0.bias": t(d_model),
                   "proj.1.weight": t(hid, d_model),
                   "proj.3.weight": 1 + t(hid), "proj.3.bias": t(hid),
                   "proj.4.weight": t(out, hid)})
    if logit_scale:
        sd["norm.1.log_logit_scale"] = torch.tensor([2.5])
    if attention1d:
        sd["pooling.layer.weight"] = t(1, d_model, 1)
        sd["pooling.layer.bias"] = t(1)
    return {prefix + k: v for k, v in sd.items()}


def encoder_pairs(hf_dirs, quant: bool):
    """{modality: (JAX encoder, port encoder)} built by both factories from
    the same arguments: the hub from the local ESM dir with attention1d
    pooling and a learnable logit scale (LoRA, or int8 with `quant`), the
    struct-token tower (21 new rows), the LoRA text tower, the MSA tower
    and a graph tower."""
    esm_dir, bert_dir = hf_dirs["esm"][0], hf_dirs["bert"][0]
    seq_kw = dict(model_name_or_path=esm_dir, output_dim=16,
                  pooling_type="attention1d", proj_type="mlp",
                  use_logit_scale=True, learnable_logit_scale=True,
                  pretrained=False, dtype="float32")
    seq_kw.update(quantize="int8") if quant else seq_kw.update(
        use_lora=True, lora_r=4, lora_alpha=8, lora_dropout=0.0)
    args = {
        "sequence": ("create_sequence_encoder", seq_kw),
        "struct_token": ("create_struct_token_encoder", dict(
            model_name_or_path="esm2_tiny", output_dim=16, dtype="float32")),
        "text": ("create_text_encoder", dict(
            model_name_or_path=bert_dir, output_dim=16, use_lora=True,
            lora_r=4, lora_alpha=8, lora_dropout=0.0, dtype="float32")),
        "msa": ("create_msa_encoder", dict(output_dim=16, dtype="float32",
                                           **MSA)),
        "struct_graph": ("create_struct_graph_encoder", dict(
            encoder=dict(GRAPH), output_dim=16, dtype="float32")),
    }
    return {name: (getattr(jenc, factory)(**kw),
                   getattr(penc, factory)(device="cpu", **kw))
            for name, (factory, kw) in args.items()}


def lightning_state(hf_dirs, quant: bool) -> dict:
    """A reference OneProtLitModule state_dict (`model.network.<mod>.…`)
    for the towers of `encoder_pairs`."""
    gen = torch.Generator().manual_seed(7)
    sd = {}
    esm = hf_esm_model(3) if quant else with_lora(hf_esm_model(3))
    for k, v in esm.state_dict().items():
        sd[f"network.sequence.transformer.{k}"] = v
    sd.update(ref_head("network.sequence.", 32, 16, "mlp", gen,
                       logit_scale=True, attention1d=True))
    tiny = transformers.EsmConfig(
        vocab_size=33, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, pad_token_id=1,
        position_embedding_type="rotary", emb_layer_norm_before=False)
    torch.manual_seed(4)
    for k, v in transformers.EsmModel(tiny, add_pooling_layer=False
                                      ).state_dict().items():
        sd[f"network.struct_token.transformer.{k}"] = v
    sd.update(ref_head("network.struct_token.", 64, 16, "linear", gen))
    for k, v in with_lora(hf_bert_model(5), seed=6).state_dict().items():
        sd[f"network.text.transformer.{k}"] = v
    sd.update(ref_head("network.text.", 32, 16, "mlp", gen))
    for k, v in fairesm_state(MsaTransformerConfig(**MSA), 8).items():
        sd[f"network.msa.transformer.{k}"] = v
    sd.update(ref_head("network.msa.", 32, 16, "mlp", gen))
    sd["network.struct_graph.encoder.lin.weight"] = torch.zeros(2, 2)
    sd.update(ref_head("network.struct_graph.", 32, 16, "linear", gen))
    return {"model." + k: v.detach().clone() for k, v in sd.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_convert_oneprot_state_dict_like_jax(hf_dirs, quant, caplog,
                                             tmp_path):
    """The whole Lightning state dict onto the model, from the same start
    (the JAX init through `convert`): exactly the JAX conversion, with
    peft factors, attention1d, the learnable logit scale, the MSA tower,
    the 3Di rows and (int8) the quantized hub; the graph backbone warns.
    The LoRA hub's adapter file (`PeftCheckpoint`) equals the JAX one."""
    pairs = encoder_pairs(hf_dirs, quant)
    jmod = JaxModule({k: j for k, (j, _) in pairs.items()},
                     frozen_param_dtype=None)
    jmod.init_for_restore()
    params0 = jax_tree(jmod.state.params)
    pmod = OneProtModule({k: p for k, (_, p) in pairs.items()})
    start = convert.oneprot_state_dict(params0)
    pmod.model.load_state_dict(start)
    sd = lightning_state(hf_dirs, quant)
    with caplog.at_level(logging.WARNING):
        got = phf.convert_oneprot_state_dict(
            sd, pmod.encoders, pmod.model.state_dict(), seed=9)
    assert any("DIG ProNet" in r.getMessage() for r in caplog.records)
    want = convert.oneprot_state_dict(jax_tree(jhf.convert_oneprot_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        {k: j for k, (j, _) in pairs.items()}, params0, seed=9)))
    assert_same(got, want)
    changed = [k for k in got if not torch.equal(
        got[k].float(), pmod.model.state_dict()[k].float())]
    assert any("attention1d" in k for k in changed)
    assert "encoders.sequence.head.logit_scale.log_logit_scale" in changed
    assert any(k.startswith("encoders.msa.transformer.") for k in changed)
    assert not any(k.startswith("encoders.struct_graph.encoder.")
                   for k in changed)
    pmod.model.load_state_dict(got)
    if not quant:  # the hub's LoRA adapter file, as the JAX callback writes it
        from oneprot_tpu.train.checkpoint import PeftCheckpoint as JaxPeft

        from oneprot_tpu_torch.train.checkpoint import PeftCheckpoint

        out = PeftCheckpoint(str(tmp_path / "port"), num_layers=2) \
            .on_validation_end(pmod, {"val/loss": 1.0})
        jout = JaxPeft(str(tmp_path / "jax"), num_layers=2).on_validation_end(
            jax_tree(jhf.convert_oneprot_state_dict(
                {k: v.numpy() for k, v in sd.items()},
                {k: j for k, (j, _) in pairs.items()}, params0, seed=9)),
            {"val/loss": 1.0})
        got_npz, want_npz = np.load(out), np.load(jout)
        assert sorted(got_npz) == sorted(want_npz) and len(want_npz) == 12
        for k in want_npz:
            np.testing.assert_array_equal(got_npz[k], want_npz[k])
        assert PeftCheckpoint(str(tmp_path), num_layers=2).on_validation_end(
            pmod, {"val/loss": None}) is None
    # an unknown key and a wrong shape raise
    bad = dict(sd)
    bad["model.network.sequence.pooling.layer.weight"] = torch.zeros(1, 31, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        phf.convert_oneprot_state_dict(bad, pmod.encoders,
                                       pmod.model.state_dict())
    with pytest.raises(KeyError, match="not in the model"):
        phf._merge_converted({"a": torch.zeros(1)}, {"b": torch.zeros(1)})


def jax_tree(tree):
    """A JAX param tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# load_pretrained and the int8 canary


def test_load_pretrained_and_int8_canary_like_jax(hf_dirs, caplog):
    """`OneProtModule.load_pretrained` against JAX's `_load_pretrained` on
    an int8 hub, a struct-token tower and a LoRA text tower from local HF
    directories: the same converted weights (the 21 new rows from the
    module's seed, LoRA factors kept), and the canary's centred cosine and
    R@1 equal to the numbers of JAX's log line (16 rows up to 64 tokens)."""
    esm_dir, bert_dir = hf_dirs["esm"][0], hf_dirs["bert"][0]
    kw = {"sequence": ("create_sequence_encoder", dict(
              model_name_or_path=esm_dir, output_dim=16, proj_type="mlp",
              quantize="int8", dtype="float32")),
          "struct_token": ("create_struct_token_encoder", dict(
              model_name_or_path=esm_dir, output_dim=16, dtype="float32")),
          "text": ("create_text_encoder", dict(
              model_name_or_path=bert_dir, output_dim=16, use_lora=True,
              lora_r=4, dtype="float32"))}
    os.environ["ONEPROT_INT8_CANARY_LEN"] = "64"
    try:
        jmod = JaxModule({k: getattr(jenc, f)(**a) for k, (f, a) in kw.items()},
                         frozen_param_dtype=None, seed=4)
        with caplog.at_level(logging.INFO, logger="int8_canary"):
            jmod.init_for_restore()
        line = next(r.getMessage() for r in caplog.records
                    if "int8 canary 'sequence'" in r.getMessage())
        pmod = OneProtModule({k: getattr(penc, f)(device="cpu", **a)
                              for k, (f, a) in kw.items()}, seed=4)
        assert all(pmod.encoders[k].pretrained_dir for k in kw)
        lora_before = pmod.model.state_dict()[
            "encoders.text.transformer.layers.0.attn.q.lora_A"].clone()
        canaries = pmod.load_pretrained()
    finally:
        del os.environ["ONEPROT_INT8_CANARY_LEN"]
    numbers = dict(zip(("cos_min", "cos_mean", "r1"), map(float, re.findall(
        r"min=([0-9.]+) mean=([0-9.]+) .*R@1=([0-9.]+)", line)[0])))
    got = canaries["sequence"]
    assert got["rows"] == 16 and set(canaries) == {"sequence"}
    for k, v in numbers.items():
        assert f"{got[k]:.4f}" == f"{v:.4f}", (k, got, line)
    want = convert.oneprot_state_dict(jax_tree(jmod.state.params))
    state = pmod.model.state_dict()
    for k, v in want.items():
        if ".transformer." in k and "lora_" not in k:
            np.testing.assert_array_equal(_np(state[k]), _np(v), err_msg=k)
    assert torch.equal(state["encoders.text.transformer.layers.0.attn.q.lora_A"],
                       lora_before)
    assert state["encoders.struct_token.transformer.embed_tokens.weight"
                 ].shape == (54, 32)


def test_attention1d_pooling_like_jax():
    """`EncoderHead(pooling_type="attention1d")` on masked rows against the
    JAX head (its params through `convert`); the packed pooling refuses
    it."""
    import jax
    import jax.numpy as jnp
    from oneprot_tpu.models.heads import EncoderHead as JaxHead

    from oneprot_tpu_torch.models.heads import segment_pool

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 32).astype(np.float32)
    mask = np.ones((3, 7), bool)
    mask[0, 4:] = False
    mask[2, 1:] = False
    jhead = JaxHead(d_model=32, output_dim=16, proj_type="linear",
                    pooling_type="attention1d", use_logit_scale=True)
    params = jhead.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(jhead.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    head = EncoderHead(32, 16, "linear", "attention1d", True, device="cpu")
    head.load_state_dict(convert.head_state_dict(jax_tree(params["params"])))
    got = head(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="attention1d"):
        segment_pool(torch.zeros(1, 4, 8), torch.ones(1, 4),
                     torch.zeros(1, 4, dtype=torch.long), 1, "attention1d")


def test_resolve_esm2_config_vocab_override(hf_dirs):
    from oneprot_tpu.models.esm2 import resolve_esm2_config as jresolve

    from oneprot_tpu_torch.models.esm2 import resolve_esm2_config

    for name in (hf_dirs["esm"][0], "facebook/esm2_t12_35M_UR50D"):
        for vocab in (None, 54):
            assert dataclasses.asdict(resolve_esm2_config(name, vocab)) == \
                dataclasses.asdict(jresolve(name, vocab))
    with pytest.raises(ValueError, match="Unknown ESM2"):
        resolve_esm2_config("no_such_model")
    assert json.load(open(os.path.join(hf_dirs["esm"][0], "config.json")))[
        "num_hidden_layers"] == 2
