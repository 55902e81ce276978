"""Carry weights from a JAX param tree into the port's state_dict.

The JAX package keeps parameters as nested dicts (flax); a tree saved as
numpy arrays converts here with no JAX installed. Mappings:

- flax Dense `kernel` [in, out] -> torch Linear `weight` [out, in];
- Int8Dense `kernel_q` [in, out] int8 and `kernel_scale` [1, out] ->
  `weight_q` [out, in] and `weight_scale` [out];
- LayerNorm `scale` -> `weight`; `bias` stays `bias`;
- the raw `embed_tokens` table [vocab, width] -> `embed_tokens.weight`;
- `layer_{i}` -> `layers.{i}`, and a LoraDense's inner `dense` level is
  dropped (q/k/v of the attention).

Values are copied as float32 (int8 codes as int8); load the result with
`module.load_state_dict(...)`, which casts to the module's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _t(x, dtype=torch.float32) -> torch.Tensor:
    np_dtype = np.int8 if dtype == torch.int8 else np.float32
    return torch.from_numpy(np.array(x, dtype=np_dtype, copy=True))


def _dense(tree: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    if "lora_A" in tree or "lora_B" in tree:
        raise NotImplementedError("LoRA factors are not ported yet")
    if "dense" in tree:  # LoraDense wraps the Dense (or Int8Dense)
        return _dense(tree["dense"], prefix)
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
    return out


def sequence_encoder_state_dict(tree: Tree,
                                prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `SequenceEncoder` params -> the port's `SequenceEncoder` state."""
    out = esm2_state_dict(tree["transformer"], prefix + "transformer.")
    out.update(head_state_dict(tree.get("head", {}), prefix + "head."))
    return out


def oneprot_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX `OneProtModel` params (sequence encoder only) -> the port's
    `OneProtModel` state."""
    unported = set(tree) - {"encoders_sequence"}
    if unported:
        raise NotImplementedError(f"{sorted(unported)} are not ported yet")
    return sequence_encoder_state_dict(tree["encoders_sequence"],
                                       "encoders.sequence.")
