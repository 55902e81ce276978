"""Checkpoint interop: HF, fair-esm, peft and Lightning state dicts -> the
port's state dicts (counterpart of oneprot_tpu/models/hf_convert.py).

The JAX package converts each format into a flax tree; the port converts
straight into its own state-dict names (`layers.{i}.attn.q.weight`, ...),
with no tree in between. torch Linear weights [out, in] keep their layout,
since the port's layers are torch layers. Keys the JAX package ignores
(`lm_head.*`, `contact_head.*`, `position_ids`, rotary `inv_freq`) are
ignored here too; a key it needs and cannot find raises KeyError.

- `load_torch_state_dict`: a HF directory's `model.safetensors`, read by a
  reader of the port's own (an 8-byte little-endian header length, a JSON
  header, raw bytes; no `safetensors` package), else its
  `pytorch_model.bin` through `torch.load(weights_only=True)`;
- `convert_esm2_state_dict` (with the struct-token vocabulary's new rows,
  drawn as the JAX package draws them), `convert_bert_state_dict`;
- `load_fairesm_checkpoint` / `convert_msa1b_state_dict` (fair-esm's
  MSA Transformer `.pt`);
- `import_peft_lora` / `export_peft_lora`: peft's adapter layout
  (`lora_A.weight [r, in]`, `lora_B.weight [out, r]`), which is the port's
  own `LoraDense` layout;
- `load_lightning_checkpoint` / `convert_oneprot_state_dict`: a
  reference-trained OneProt Lightning `.ckpt` onto a `OneProtModel`'s
  state dict (every tower that transfers weight for weight, and every
  head; of the graph towers only the head).
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names -> (numpy dtype of the raw bytes, torch dtype)
_SAFETENSORS_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.asarray(x))


def read_safetensors(path: str) -> StateDict:
    """A `.safetensors` file -> {name: CPU tensor}, every tensor a view of
    one buffer read in a single pass (copied only where its offset is not
    a multiple of its item size). BF16 is read as uint16 and viewed as
    torch.bfloat16; `__metadata__` is skipped."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        size = os.fstat(f.fileno()).st_size - 8 - n
        buf = np.empty(size, np.uint8)
        f.readinto(memoryview(buf))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        np_dtype, torch_dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        raw = buf[start:end]
        if start % np.dtype(np_dtype).itemsize:
            raw = raw.copy()
        arr = raw.view(np_dtype).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t
    return out


def load_torch_state_dict(model_dir: str) -> StateDict:
    """Load a HF checkpoint directory (safetensors preferred, else .bin)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        return {k: _tensor(v) for k, v in torch.load(
            bin_path, map_location="cpu", weights_only=True).items()}
    raise FileNotFoundError(f"No checkpoint found in {model_dir}")


def _strip_prefix(sd: Mapping[str, Any]) -> StateDict:
    """Drop the model-root prefix ('esm.', 'bert.', 'model.') if present."""
    out = {}
    for k, v in sd.items():
        for pref in ("esm.", "bert.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
                break
        out[k] = _tensor(v)
    return out


def _pair(sd: StateDict, src: str, dst: str) -> StateDict:
    """A Linear's or LayerNorm's weight and bias, renamed."""
    return {dst + "weight": sd[f"{src}.weight"], dst + "bias": sd[f"{src}.bias"]}


# ---------------------------------------------------------------------------
# ESM2 and BERT


def convert_esm2_state_dict(state_dict: Mapping[str, Any], num_layers: int,
                            extra_vocab_rows: int = 0,
                            seed: int = 0) -> StateDict:
    """HF EsmModel state dict -> the port's `Esm2` state.

    extra_vocab_rows appends new embedding rows (the reference's
    `resize_token_embeddings(vocab + 21)` for 3Di tokens), drawn as the JAX
    package draws them: RandomState(seed).normal(0, 0.02), cast to the
    table's dtype."""
    sd = _strip_prefix(state_dict)
    emb = sd["embeddings.word_embeddings.weight"]
    if extra_vocab_rows:
        rng = np.random.RandomState(seed)
        new_rows = rng.normal(0.0, 0.02, (extra_vocab_rows, emb.shape[1]))
        emb = torch.cat([emb, torch.from_numpy(new_rows).to(emb.dtype)])
    out = {"embed_tokens.weight": emb}
    for i in range(num_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}."
        out.update(_pair(sd, f"{p}.attention.LayerNorm", q + "attn_ln."))
        for name, hf in (("q", "self.query"), ("k", "self.key"),
                         ("v", "self.value"), ("o", "output.dense")):
            out.update(_pair(sd, f"{p}.attention.{hf}", f"{q}attn.{name}."))
        out.update(_pair(sd, f"{p}.LayerNorm", q + "ffn_ln."))
        out.update(_pair(sd, f"{p}.intermediate.dense", q + "fc1."))
        out.update(_pair(sd, f"{p}.output.dense", q + "fc2."))
    out.update(_pair(sd, "encoder.emb_layer_norm_after", "final_ln."))
    return out


def convert_bert_state_dict(state_dict: Mapping[str, Any],
                            num_layers: int) -> StateDict:
    """HF BertModel state dict -> the port's `Bert` state."""
    sd = _strip_prefix(state_dict)
    out = {name: sd[f"embeddings.{name}.weight"] for name in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")}
    out.update(_pair(sd, "embeddings.LayerNorm", "emb_ln."))
    for i in range(num_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}."
        for name, hf in (("q", "self.query"), ("k", "self.key"),
                         ("v", "self.value"), ("o", "output.dense")):
            out.update(_pair(sd, f"{p}.attention.{hf}", f"{q}attn.{name}."))
        out.update(_pair(sd, f"{p}.attention.output.LayerNorm",
                                q + "attn_ln."))
        out.update(_pair(sd, f"{p}.intermediate.dense", q + "fc1."))
        out.update(_pair(sd, f"{p}.output.dense", q + "fc2."))
        out.update(_pair(sd, f"{p}.output.LayerNorm", q + "ffn_ln."))
    return out


# ---------------------------------------------------------------------------
# fair-esm MSA Transformer (.pt)


def load_fairesm_checkpoint(pt_path: str) -> StateDict:
    """A fair-esm `.pt` (its pickle holds an argparse.Namespace, so it loads
    with weights_only=False, as the JAX package loads it) -> its model
    state dict."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k: _tensor(v) for k, v in sd.items()}


def convert_msa1b_state_dict(state_dict: Mapping[str, Any],
                             num_layers: int) -> StateDict:
    """fair-esm MSATransformer state dict -> the port's `MsaTransformer`
    state. Each sublayer sits in a NormalizedResidualBlock
    (`layers.{i}.row_self_attention.{layer_norm, layer.{q,k,v,out}_proj}`).
    The learned column positions carry fair-esm's padding offset (2 more
    rows), which is dropped; a 4-D `msa_position_embedding` [1, R, 1, H]
    becomes [R, 1, H]."""
    sd = {k.removeprefix("encoder.").removeprefix("sentence_encoder."):
          _tensor(v) for k, v in state_dict.items()}
    msa_pos = sd["msa_position_embedding"]
    if msa_pos.ndim == 4:
        msa_pos = msa_pos.reshape(msa_pos.shape[-3], 1, msa_pos.shape[-1])
    out = {"embed_tokens.weight": sd["embed_tokens.weight"],
           "embed_positions": sd["embed_positions.weight"][2:],
           "msa_position_embedding": msa_pos}
    out.update(_pair(sd, "emb_layer_norm_before", "emb_ln_before."))
    out.update(_pair(sd, "emb_layer_norm_after", "emb_ln_after."))
    for i in range(num_layers):
        p, q = f"layers.{i}", f"layers.{i}."
        for attn, src in (("row", "row_self_attention"),
                          ("col", "column_self_attention")):
            out.update(_pair(sd, f"{p}.{src}.layer_norm",
                                    f"{q}{attn}_ln."))
            for name, proj in (("q", "q_proj"), ("k", "k_proj"),
                               ("v", "v_proj"), ("o", "out_proj")):
                out.update(_pair(sd, f"{p}.{src}.layer.{proj}",
                                   f"{q}{attn}_attn.{name}."))
        out.update(_pair(sd, f"{p}.feed_forward_layer.layer_norm",
                                q + "ffn_ln."))
        out.update(_pair(sd, f"{p}.feed_forward_layer.layer.fc1", q + "fc1."))
        out.update(_pair(sd, f"{p}.feed_forward_layer.layer.fc2", q + "fc2."))
    return out


# ---------------------------------------------------------------------------
# peft LoRA adapters (q/k/v)

_PEFT_NAME = {"q": "query", "k": "key", "v": "value"}


def import_peft_lora(adapter_state: Mapping[str, Any], state: StateDict,
                     num_layers: int) -> StateDict:
    """Merge a peft adapter state dict into a port transformer state dict
    in place: `...layer.{i}.attention.self.query.lora_A.weight [r, in]` and
    `lora_B.weight [out, r]` become `layers.{i}.attn.q.lora_A` / `lora_B`,
    the same layout. A layer and projection the adapter lacks is left as
    it was."""
    sd = {k: _tensor(v) for k, v in adapter_state.items()}

    def find(i: int, proj: str, which: str) -> Optional[torch.Tensor]:
        suffix = (f"layer.{i}.attention.self.{_PEFT_NAME[proj]}"
                  f".lora_{which}.weight")
        for k, v in sd.items():
            if k.endswith(suffix):
                return v
        return None

    for i in range(num_layers):
        for proj in ("q", "k", "v"):
            a, b = find(i, proj, "A"), find(i, proj, "B")
            if a is None or b is None:
                continue
            state[f"layers.{i}.attn.{proj}.lora_A"] = a
            state[f"layers.{i}.attn.{proj}.lora_B"] = b
    return state


def export_peft_lora(state: Mapping[str, torch.Tensor], num_layers: int,
                     prefix: str = "base_model.model.encoder"
                     ) -> Dict[str, np.ndarray]:
    """A port transformer state dict's LoRA factors -> a peft-layout adapter
    state dict of numpy arrays (the reference's PeftBestModelCheckpoint
    file)."""
    out: Dict[str, np.ndarray] = {}
    for i in range(num_layers):
        for proj in ("q", "k", "v"):
            key = f"layers.{i}.attn.{proj}."
            if key + "lora_A" in state:
                name = f"{prefix}.layer.{i}.attention.self.{_PEFT_NAME[proj]}"
                for which in ("A", "B"):
                    out[f"{name}.lora_{which}.weight"] = (
                        state[f"{key}lora_{which}"].detach().cpu().numpy())
    return out


# ---------------------------------------------------------------------------
# Reference-trained OneProt Lightning checkpoints


def load_lightning_checkpoint(path: str) -> StateDict:
    """A reference Lightning .ckpt -> its state_dict (reference
    eval.py:128-133 `torch.load(...)["state_dict"]`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: _tensor(v) for k, v in sd.items()}


def _split_peft(tsd: Mapping[str, torch.Tensor]):
    """Normalise a (possibly peft-wrapped) HF transformer state dict: strip
    `base_model.model.` and `.base_layer` (peft's Linear wrapping), and
    split out the LoRA factors as `<module>.lora_{A,B}.weight` (the adapter
    name infix, `.default.`, is dropped)."""
    hf, lora = {}, {}
    for k, v in tsd.items():
        k = k.removeprefix("base_model.model.").replace(".base_layer", "")
        m = re.match(r"(.*)\.lora_([AB])\.(?:[^.]+\.)?weight$", k)
        if m:
            lora[f"{m.group(1)}.lora_{m.group(2)}.weight"] = v
        else:
            hf[k] = v
    return hf, lora


def _convert_ref_head(sub: Mapping[str, torch.Tensor], enc) -> StateDict:
    """The reference BaseEncoder head (proj / norm / pooling Sequentials,
    base_encoder.py:129-194) -> the port's `EncoderHead` state."""
    head: StateDict = {}
    proj_type = getattr(getattr(enc, "head", None), "proj", None)
    proj_type = getattr(proj_type, "proj_type", None)
    if proj_type == "linear":
        head.update(_pair(sub, "proj.0", "proj.ln."))
        head["proj.dense.weight"] = sub["proj.1.weight"]
    elif proj_type == "mlp":
        head.update(_pair(sub, "proj.0", "proj.ln1."))
        head["proj.dense1.weight"] = sub["proj.1.weight"]
        head.update(_pair(sub, "proj.3", "proj.ln2."))
        head["proj.dense2.weight"] = sub["proj.4.weight"]
    scale = getattr(getattr(enc, "head", None), "logit_scale", None)
    if (scale is not None and isinstance(scale.log_logit_scale,
                                         torch.nn.Parameter)
            and "norm.1.log_logit_scale" in sub):
        head["logit_scale.log_logit_scale"] = (
            sub["norm.1.log_logit_scale"].reshape(()))
    if (getattr(enc, "pooling_type", "") == "attention1d"
            and "pooling.layer.weight" in sub):
        # MaskedConv1d(hidden, 1, kernel=1): weight [1, hidden, 1] is a
        # Linear(hidden -> 1) weight
        head["attention1d.attn.weight"] = sub["pooling.layer.weight"].reshape(
            1, -1)
        head["attention1d.attn.bias"] = sub["pooling.layer.bias"]
    return head


def _merge_converted(target: Mapping[str, torch.Tensor],
                     new: Mapping[str, torch.Tensor],
                     path: str = "") -> StateDict:
    """`target` with `new`'s tensors in place of its own, each cast to the
    target's dtype: keys the checkpoint does not cover keep their values;
    a key the target lacks raises KeyError, a shape that differs
    ValueError."""
    out = dict(target)
    for k, v in new.items():
        if k not in out:
            raise KeyError(f"checkpoint key {path}/{k} not in the model's "
                           "state dict")
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"shape mismatch at {path}/{k}: ckpt "
                             f"{tuple(v.shape)} vs model {tuple(out[k].shape)}")
        out[k] = v.to(out[k].dtype)
    return out


def convert_oneprot_state_dict(state_dict: Mapping[str, Any],
                               encoders: Mapping[str, Any],
                               state: Mapping[str, torch.Tensor],
                               seed: int = 0) -> StateDict:
    """A reference-trained OneProtLitModule state_dict onto a
    `OneProtModel` state dict (`encoders.<name>.…`; the reference's
    src/train.py:73-82 strips an optional `model.` prefix, src/eval.py
    loads it raw).

    Covers the towers that transfer weight for weight (sequence and
    struct_token: HF EsmModel with peft's LoRA factors, the int8 hub
    quantized from them; text: HF BertModel; msa: fair-esm's MSA
    Transformer) and every head (projection, learnable logit scale,
    attention1d pooling). The struct_graph / pocket ProNet is the JAX
    package's own design (dense padded kNN against DIG ProNet's
    torch_geometric graph), so only its head converts, with a warning."""
    from oneprot_tpu_torch.models.esm2 import quantize_esm2_int8_tree

    log = logging.getLogger(__name__)
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    if next(iter(sd), "").startswith("model."):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    out = dict(state)
    for name, enc in encoders.items():
        pref = f"network.{name}."
        sub = {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}
        key = f"encoders.{name}."
        if not sub or not any(k.startswith(key) for k in out):
            continue
        tsd = {k[len("transformer."):]: v for k, v in sub.items()
               if k.startswith("transformer.")}
        cls = type(enc).__name__
        conv = None
        if cls in ("SequenceEncoder", "StructTokenEncoder") and tsd:
            hf, lora = _split_peft(tsd)
            rows = hf["embeddings.word_embeddings.weight"].shape[0]
            conv = convert_esm2_state_dict(
                hf, enc.config.num_layers,
                extra_vocab_rows=max(enc.config.vocab_size - rows, 0),
                seed=seed)
            if lora:
                conv = import_peft_lora(lora, conv, enc.config.num_layers)
            if getattr(enc, "quant_int8", False):
                conv = quantize_esm2_int8_tree(conv)
        elif cls == "TextEncoder" and tsd:
            hf, lora = _split_peft(tsd)
            conv = convert_bert_state_dict(hf, enc.config.num_layers)
            if lora:
                conv = import_peft_lora(lora, conv, enc.config.num_layers)
        elif cls == "MsaEncoder" and tsd:
            conv = convert_msa1b_state_dict(tsd, enc.config.num_layers)
        elif tsd or any(k.startswith("encoder.") for k in sub):
            log.warning(
                f"{name}: reference GNN backbone (DIG ProNet) does not map "
                "onto the first-party graph encoder; converting head only")
        for part, new in (("transformer", conv),
                          ("head", _convert_ref_head(sub, enc))):
            if not new:
                continue
            prefix = f"{key}{part}."
            target = {k[len(prefix):]: v for k, v in out.items()
                      if k.startswith(prefix)}
            merged = _merge_converted(target, new, f"{name}/{part}")
            out.update({prefix + k: v for k, v in merged.items()})
    return out
