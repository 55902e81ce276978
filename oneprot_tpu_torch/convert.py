"""Carry weights from a JAX param tree into the port's state_dict.

The JAX package keeps parameters as nested dicts (flax); a tree saved as
numpy arrays converts here with no JAX installed. Mappings:

- flax Dense `kernel` [in, out] -> torch Linear `weight` [out, in];
- Int8Dense `kernel_q` [in, out] int8 and `kernel_scale` [1, out] ->
  `weight_q` [out, in] and `weight_scale` [out];
- LayerNorm `scale` -> `weight`; `bias` stays `bias`;
- the raw `embed_tokens` table [vocab, width] -> `embed_tokens.weight`;
- `layer_{i}` -> `layers.{i}`, and a LoraDense's inner `dense` level is
  dropped (q/k/v of the attention); its `lora_A` [in, r] and `lora_B`
  [r, out] become `lora_A` [r, in] and `lora_B` [out, r];
- the MSA Transformer's raw tables (`embed_tokens`, `embed_positions`,
  `msa_position_embedding` [max_rows, 1, H]) keep their shapes, the token
  table as `embed_tokens.weight`;
- BERT's raw tables (`word_embeddings`, `position_embeddings`,
  `token_type_embeddings`) keep their names and shapes;
- ProNet's `aa_embed` `embedding` [21, H] -> `aa_embed.weight`, its
  `layer_{i}` Dense and LayerNorm leaves as above;
- a head's attention pooling `attention1d/attn` Dense ->
  `attention1d.attn`;
- `encoders_<modality>` -> `encoders.<modality>` (sequence, struct_token,
  msa, text, struct_graph, pocket).

Values are copied as float32 (int8 codes as int8); load the result with
`module.load_state_dict(...)`, which casts to the module's dtype. A model
built as one model rank's shard (tensor parallelism) loads
`oneprot_shard_state_dict`'s cut of it (`core/partitioning.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from oneprot_tpu_torch.core import partitioning

Tree = Mapping[str, Any]


def _t(x, dtype=torch.float32) -> torch.Tensor:
    np_dtype = np.int8 if dtype == torch.int8 else np.float32
    return torch.from_numpy(np.array(x, dtype=np_dtype, copy=True))


def _dense(tree: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    if "dense" in tree:  # LoraDense wraps the Dense (or Int8Dense)
        out = _dense(tree["dense"], prefix)
        if "lora_A" in tree:
            out[prefix + "lora_A"] = _t(tree["lora_A"]).T.contiguous()
            out[prefix + "lora_B"] = _t(tree["lora_B"]).T.contiguous()
        return out
    out = {}
    if "kernel_q" in tree:
        out[prefix + "weight_q"] = _t(tree["kernel_q"], torch.int8).T.contiguous()
        out[prefix + "weight_scale"] = _t(tree["kernel_scale"]).reshape(-1)
    else:
        out[prefix + "weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        out[prefix + "bias"] = _t(tree["bias"])
    return out


def _layer_norm(tree: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + "weight": _t(tree["scale"]), prefix + "bias": _t(tree["bias"])}


def esm2_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `Esm2` params (float or int8 tree) -> the port's `Esm2` state."""
    out = {prefix + "embed_tokens.weight": _t(tree["embed_tokens"])}
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        lt, lp = tree[f"layer_{i}"], f"{prefix}layers.{i}."
        out.update(_layer_norm(lt["attn_ln"], lp + "attn_ln."))
        for name in ("q", "k", "v", "o"):
            out.update(_dense(lt["attn"][name], f"{lp}attn.{name}."))
        out.update(_layer_norm(lt["ffn_ln"], lp + "ffn_ln."))
        out.update(_dense(lt["fc1"], lp + "fc1."))
        out.update(_dense(lt["fc2"], lp + "fc2."))
    out.update(_layer_norm(tree["final_ln"], prefix + "final_ln."))
    return out


def head_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `EncoderHead` params -> the port's `EncoderHead` state."""
    out = {}
    proj = tree.get("proj", {})
    for name, sub in proj.items():
        if name.startswith("ln"):
            out.update(_layer_norm(sub, f"{prefix}proj.{name}."))
        else:
            out.update(_dense(sub, f"{prefix}proj.{name}."))
    if "logit_scale" in tree:
        out[prefix + "logit_scale.log_logit_scale"] = _t(
            tree["logit_scale"]["log_logit_scale"])
    if "attention1d" in tree:
        out.update(_dense(tree["attention1d"]["attn"],
                          prefix + "attention1d.attn."))
    return out


def encoder_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `SequenceEncoder` or `StructTokenEncoder` params (an `Esm2`
    transformer, with the struct-token vocabulary's 21 extra embedding rows
    where it has them, and an `EncoderHead`) -> the port's encoder state."""
    out = esm2_state_dict(tree["transformer"], prefix + "transformer.")
    out.update(head_state_dict(tree.get("head", {}), prefix + "head."))
    return out


def msa_transformer_state_dict(tree: Tree,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `MsaTransformer` params -> the port's `MsaTransformer` state."""
    out = {prefix + "embed_tokens.weight": _t(tree["embed_tokens"]),
           prefix + "embed_positions": _t(tree["embed_positions"]),
           prefix + "msa_position_embedding": _t(tree["msa_position_embedding"])}
    out.update(_layer_norm(tree["emb_ln_before"], prefix + "emb_ln_before."))
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        lt, lp = tree[f"layer_{i}"], f"{prefix}layers.{i}."
        for attn in ("row", "col"):
            out.update(_layer_norm(lt[f"{attn}_ln"], f"{lp}{attn}_ln."))
            for name in ("q", "k", "v", "o"):
                out.update(_dense(lt[f"{attn}_attn"][name],
                                  f"{lp}{attn}_attn.{name}."))
        out.update(_layer_norm(lt["ffn_ln"], lp + "ffn_ln."))
        out.update(_dense(lt["fc1"], lp + "fc1."))
        out.update(_dense(lt["fc2"], lp + "fc2."))
    out.update(_layer_norm(tree["emb_ln_after"], prefix + "emb_ln_after."))
    return out


def msa_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `MsaEncoder` params (an `MsaTransformer` and an `EncoderHead`)
    -> the port's `MsaEncoder` state."""
    out = msa_transformer_state_dict(tree["transformer"], prefix + "transformer.")
    out.update(head_state_dict(tree.get("head", {}), prefix + "head."))
    return out


def bert_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `Bert` params (with or without LoRA on q/k/v) -> the port's
    `Bert` state."""
    out = {prefix + name: _t(tree[name]) for name in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")}
    out.update(_layer_norm(tree["emb_ln"], prefix + "emb_ln."))
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        lt, lp = tree[f"layer_{i}"], f"{prefix}layers.{i}."
        for name in ("q", "k", "v", "o"):
            out.update(_dense(lt["attn"][name], f"{lp}attn.{name}."))
        out.update(_layer_norm(lt["attn_ln"], lp + "attn_ln."))
        out.update(_dense(lt["fc1"], lp + "fc1."))
        out.update(_dense(lt["fc2"], lp + "fc2."))
        out.update(_layer_norm(lt["ffn_ln"], lp + "ffn_ln."))
    return out


def text_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `TextEncoder` params (a `Bert` and an `EncoderHead`) -> the
    port's `TextEncoder` state."""
    out = bert_state_dict(tree["transformer"], prefix + "transformer.")
    out.update(head_state_dict(tree.get("head", {}), prefix + "head."))
    return out


def pronet_state_dict(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `ProNet` params -> the port's `ProNet` state."""
    out = {prefix + "aa_embed.weight": _t(tree["aa_embed"]["embedding"])}
    for name in ("bb_proj", "sc_proj", "readout1", "readout2"):
        if name in tree:
            out.update(_dense(tree[name], f"{prefix}{name}."))
    n_layers = sum(1 for key in tree if key.startswith("layer_"))
    for i in range(n_layers):
        lt, lp = tree[f"layer_{i}"], f"{prefix}layers.{i}."
        for name in ("msg1", "msg2", "gate", "upd1", "upd2"):
            out.update(_dense(lt[name], f"{lp}{name}."))
        out.update(_layer_norm(lt["ln"], lp + "ln."))
    return out


def struct_graph_state_dict(tree: Tree,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `StructGraphEncoder` params (a `ProNet` named `encoder` and an
    `EncoderHead`) -> the port's `StructGraphEncoder` state."""
    out = pronet_state_dict(tree["encoder"], prefix + "encoder.")
    out.update(head_state_dict(tree.get("head", {}), prefix + "head."))
    return out


_ENCODERS = {"encoders_sequence": encoder_state_dict,
             "encoders_struct_token": encoder_state_dict,
             "encoders_msa": msa_state_dict,
             "encoders_text": text_state_dict,
             "encoders_struct_graph": struct_graph_state_dict,
             "encoders_pocket": struct_graph_state_dict}


def oneprot_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX `OneProtModel` params (the params of a `OneProtModule` state)
    with any of `encoders_sequence`, `encoders_struct_token`,
    `encoders_msa`, `encoders_text`, `encoders_struct_graph` and
    `encoders_pocket` -> the port's `OneProtModel` state."""
    unported = set(tree) - set(_ENCODERS)
    if unported:
        raise NotImplementedError(f"{sorted(unported)} are not ported yet")
    out = {}
    for key in sorted(tree):
        out.update(_ENCODERS[key](
            tree[key], "encoders." + key[len("encoders_"):] + "."))
    return out


def oneprot_shard_state_dict(tree: Tree, model_rank: int, model: int,
                             layout: Optional[Mapping[str, int]] = None
                             ) -> Dict[str, torch.Tensor]:
    """`oneprot_state_dict` cut to model rank `model_rank`'s shard of a
    model axis of `model` ranks: each split entry its block
    (`partitioning.shard_state_dict`; `layout` as there, the built
    module's `partitioning.layout_of` where its placement differs from the
    rules)."""
    return partitioning.shard_state_dict(oneprot_state_dict(tree),
                                         model_rank, model, layout)
