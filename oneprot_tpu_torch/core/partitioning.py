"""Parameter partitioning rules of tensor parallelism (counterpart of
oneprot_tpu/core/partitioning.py: `param_pspec`, `_divisible`, the
placement `shard_params` gives each leaf).

The rules are the JAX package's, copied: path-based over the flax param
tree, they split

  - attention q/k/v (`.../attn/{q,k,v}/dense/kernel` [in, out], and its
    bias) by columns: P(None, "model"), column-parallel;
  - attention o (`...attn/o/kernel`) by rows: P("model", None),
    row-parallel;
  - MLP fc1 (`...fc1/kernel` and its bias) by columns, fc2 by rows;
  - LoRA's `lora_B` [r, out] under `/attn/` by columns;

and replicate the rest (embeddings, LayerNorms, heads, `lora_A`, every
bias of a row-parallel layer), and any leaf whose split dimension the
model axis does not divide. Being suffix and substring matches, they hit
every tower whose names fit: ESM2 (q/k/v wrap their Dense as `dense`) and
BERT (its q/k/v are LoRA-ready Dense layers, with the `dense` level
whether or not LoRA is on) shard all six matrices; the MSA Transformer
shards its two attentions' `o` and its MLP, not its q/k/v (plain Dense);
ProNet and the heads shard nothing.

The port applies them to its own state-dict names through the inverse of
`convert.py`'s name map (`jax_path`), and turns a JAX spec into the torch
dimension it splits (`shard_dim`): `nn.Linear` stores [out, in], so a
kernel's P(None, "model") splits the port's dimension 0 and P("model",
None) its dimension 1. The layers of `models/layers.py` hold their shard
as built (`layout_of` reads it back); they differ from the rules in two
places: an attention whose heads the model axis does not divide keeps q,
k and v whole (documented in `models/layers.py`), and an int8 layer
(`Int8Dense`: `weight_q`, `weight_scale`, `bias`) is held whole. The JAX
rules leave its codes and scales replicated too (they split only leaves
named `kernel`) but split its q/k/v and fc1 biases; the port keeps those
biases whole beside their codes, with the same numbers, and so does
`rule_layout`.

A model rank's block of a split dimension is the rank's contiguous
chunk: `shard_state_dict` cuts a full state dict so, and
`gather_state_dict` joins the model group's blocks back into full tensors.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

MODEL_AXIS = "model"
Spec = Tuple[Optional[str], ...]  # a PartitionSpec; () replicates

_NORM = re.compile(r"(^|_)ln(\d|_|$)")  # the LayerNorms' module names


def param_pspec(path_names: Sequence[str], ndim: int) -> Spec:
    """The JAX package's rule on a flax path (its `param_pspec`)."""
    joined = "/".join(path_names)
    leaf = path_names[-1]
    if leaf == "kernel" and ndim == 2:
        if any(f"/attn/{p}/dense/kernel" in f"/{joined}" for p in "qkv"):
            return (None, MODEL_AXIS)
        if joined.endswith("attn/o/kernel"):
            return (MODEL_AXIS, None)
        if joined.endswith("fc1/kernel"):
            return (None, MODEL_AXIS)
        if joined.endswith("fc2/kernel"):
            return (MODEL_AXIS, None)
    if leaf == "bias" and ndim == 1:
        if any(f"/attn/{p}/dense/bias" in f"/{joined}" for p in "qkv"):
            return (MODEL_AXIS,)
        if joined.endswith("fc1/bias"):
            return (MODEL_AXIS,)
    if leaf == "lora_B" and ndim == 2:
        if "/attn/" in f"/{joined}":
            return (None, MODEL_AXIS)
    return ()


def _divisible(shape: Sequence[int], spec: Spec, model: int) -> bool:
    """Whether the model axis divides every dimension `spec` splits."""
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is not None and dim % model != 0:
            return False
    return True


def jax_path(name: str) -> Tuple[str, ...]:
    """The flax path of a port state-dict entry: `convert.py`'s name map
    inverted (`encoders.<m>` -> `encoders_<m>`, `layers.<i>` ->
    `layer_<i>`, a Linear's `weight` -> `kernel`, a LayerNorm's -> `scale`,
    the raw token table's -> the table itself, and the `dense` level of
    the q/k/v of an `attn` block put back)."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] in ("encoders", "layers") and i + 1 < len(parts):
            out.append(("encoders_" if parts[i] == "encoders" else "layer_")
                       + parts[i + 1])
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if len(out) >= 2 and out[-1] in ("weight", "bias"):
        owner = out[-2]
        if out[-1] == "weight":
            if owner == "embed_tokens":
                return tuple(out[:-1])
            out[-1] = ("scale" if _NORM.search(owner) else
                       "embedding" if owner == "aa_embed" else "kernel")
        if len(out) >= 3 and out[-3] == "attn" and owner in ("q", "k", "v"):
            out.insert(len(out) - 1, "dense")
    return tuple(out)


def jax_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """A port tensor's shape as the JAX tree holds it: 2-D tensors
    transposed (kernels and the LoRA factors), others as they are."""
    return tuple(reversed(shape)) if len(shape) == 2 else tuple(shape)


def spec_of(name: str, shape: Sequence[int], model: int) -> Spec:
    """The JAX placement of the leaf behind a port entry on a model axis of
    `model` (its `_placement_spec`): the rule's spec, or () without a
    model axis or where the axis does not divide the split dimension."""
    if model <= 1:
        return ()
    jshape = jax_shape(shape)
    spec = param_pspec(jax_path(name), len(jshape))
    if spec and not _divisible(jshape, spec, model):
        return ()
    return spec


def shard_dim(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The torch dimension of a port entry that the rules split over the
    model axis, or None where they replicate it."""
    spec = spec_of(name, shape, model)
    if MODEL_AXIS not in spec:
        return None
    dim = spec.index(MODEL_AXIS)
    return len(shape) - 1 - dim if len(shape) == 2 else dim


def rule_layout(state: Mapping[str, torch.Tensor],
                model: int) -> Dict[str, int]:
    """{name: split dimension} of a full state dict by the rules, an int8
    layer's entries (those beside a `weight_q`) left whole."""
    out = {}
    for name, t in state.items():
        if name.rsplit(".", 1)[0] + ".weight_q" in state:
            continue
        dim = shard_dim(name, tuple(t.shape), model)
        if dim is not None:
            out[name] = dim
    return out


def layout_of(module: torch.nn.Module) -> Dict[str, int]:
    """{state-dict name: split dimension} of the entries a module holds as
    a model rank's shard (the layers of `models/layers.py` mark them)."""
    return {name: t.tp_dim for name, t in
            list(module.named_parameters()) + list(module.named_buffers())
            if getattr(t, "tp_dim", None) is not None}


def shard_state_dict(full: Mapping[str, torch.Tensor], model_rank: int,
                     model: int, layout: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to model rank `model_rank`'s shard: each
    entry of `layout` (default: the rules' `rule_layout`; pass a built
    module's `layout_of` where it differs) becomes its contiguous block of
    the split dimension, the rest stays whole."""
    if layout is None:
        layout = rule_layout(full, model)
    out = {}
    for name, t in full.items():
        dim = layout.get(name)
        out[name] = (t if dim is None or model == 1
                     else t.chunk(model, dim)[model_rank].contiguous())
    return out


def gather_state_dict(shards: Mapping[str, torch.Tensor],
                      layout: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """The full state dict of a model group: this rank's `shards`, each
    entry of `layout` joined with the other model ranks' blocks (a
    collective of the model group, entry by entry in name order, so that
    one full tensor at a time is in flight)."""
    from oneprot_tpu_torch.core.collectives import gather_from_model_group

    out = dict(shards)
    for name in sorted(layout):
        if name in out:
            out[name] = gather_from_model_group(out[name], layout[name])
    return out
