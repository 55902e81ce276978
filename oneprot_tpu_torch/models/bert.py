"""BERT text encoder in PyTorch (counterpart of oneprot_tpu/models/bert.py).

The BiomedBERT / SciBERT layout of HF `BertModel` without its pooler:
learned absolute positions, one token type, post-LN blocks, LayerNorm eps
1e-12, exact-erf GELU. Attention is `kernels.flash_mha.mha_attention`
without rotary tables, with the key-padding bias (-1e9 on [PAD] keys) and,
on packed rows, the segment ids: the flash-MHA kernels on the card
(forward, and dq, dk/dv in the backward), their plain versions on the CPU.

The embeddings sum `words[ids] + positions` in the parameters' own dtype
and add `token_types[0]` in the compute dtype, as the JAX layer's
`(words[ids] + positions + token_types[0]).astype(dtype)` runs under XLA:
a frozen tower stores bf16 parameters, so the first sum rounds in bf16
there, and with an f32 compute dtype the last add is f32 (XLA drops the
bf16 round trip of an add followed by a cast to f32). On packed rows (several texts a row, `segment_ids` with -1 on
padding) each text restarts at position 0: a token's position is its
index less the index where its run of equal segment ids starts (padding is
a run too), clamped at the last position. So a packed text equals the same
text encoded alone.

With `lora`, q, k and v are `LoraDense` layers (streams 3 * layer + 0..2);
with `remat`, each layer runs under `torch.utils.checkpoint` when autograd
records. Modules are built on the card in bf16 unless the caller names
another device and dtype; the card takes bf16, or f32 with heads of at
most 64 (the attention kernels' f32 instances), and `Bert` refuses any
other compute dtype there when it is built.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from oneprot_tpu_torch.kernels.flash_mha import check_card_dtype, mha_attention
from oneprot_tpu_torch.models.esm2 import LoraConfig, LoraDense
from oneprot_tpu_torch.models.layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12


BERT_SIZES = {
    "bert_tiny": BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                            intermediate_size=512),
    "bert_small": BertConfig(hidden_size=512, num_layers=4, num_heads=8,
                             intermediate_size=2048),
    "bert_base": BertConfig(),  # BiomedBERT-base / SciBERT layout
}


def resolve_bert_config(name_or_path: str,
                        vocab_size: Optional[int] = None) -> BertConfig:
    """A local directory's HF `config.json`, else a preset whose name starts
    the last path part ('bert_small'), else bert_base: BiomedBERT, SciBERT
    and PubMedBERT are all bert-base layouts. `vocab_size` overrides the
    vocabulary."""
    cfg_json = os.path.join(name_or_path, "config.json")
    if os.path.isfile(cfg_json):
        with open(cfg_json) as f:
            hf = json.load(f)
        cfg = BertConfig(
            vocab_size=int(hf.get("vocab_size", 30522)),
            hidden_size=int(hf["hidden_size"]),
            num_layers=int(hf["num_hidden_layers"]),
            num_heads=int(hf["num_attention_heads"]),
            intermediate_size=int(hf["intermediate_size"]),
            max_position_embeddings=int(hf.get("max_position_embeddings", 512)),
            type_vocab_size=int(hf.get("type_vocab_size", 2)),
            pad_token_id=int(hf.get("pad_token_id", 0)),
            layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
        )
    else:
        key = name_or_path.rstrip("/").split("/")[-1].lower()
        cfg = next((c for prefix, c in BERT_SIZES.items()
                    if key.startswith(prefix)), BERT_SIZES["bert_base"])
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return cfg


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, lora: Optional[LoraConfig] = None,
                 layer_index: int = 0, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        H = config.hidden_size
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        if lora is None:
            self.q, self.k, self.v = (Dense(H, H, **kw) for _ in range(3))
        else:
            self.q, self.k, self.v = (
                LoraDense(H, H, lora, 3 * layer_index + i, **kw)
                for i in range(3))
        self.o = Dense(H, H, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx, _ = mha_attention(self.q(x), self.k(x), self.v(x),
                               self.config.num_heads, bias=bias,
                               segment_ids=segment_ids)
        return self.o(ctx)


class BertLayer(nn.Module):
    """Post-LN: x = LN(x + attn(x)); LN(x + fc2(gelu(fc1(x))))."""

    def __init__(self, config: BertConfig, lora: Optional[LoraConfig] = None,
                 layer_index: int = 0, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.attn = BertSelfAttention(config, lora, layer_index, **kw)
        self.attn_ln = LayerNorm(H, eps=eps, **kw)
        self.fc1 = Dense(H, config.intermediate_size, **kw)
        self.fc2 = Dense(config.intermediate_size, H, **kw)
        self.ffn_ln = LayerNorm(H, eps=eps, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn_ln(x + self.attn(x, bias, segment_ids))
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.ffn_ln(x + h)


def segment_positions(segment_ids: torch.Tensor, max_positions: int
                      ) -> torch.Tensor:
    """[B, L] absolute positions of packed rows: a token's index less the
    index where its run of equal ids starts (padding, -1, is a run too),
    clamped at max_positions - 1."""
    B, L = segment_ids.shape
    idx = torch.arange(L, device=segment_ids.device).expand(B, L)
    changed = torch.ones_like(segment_ids, dtype=torch.bool)
    changed[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    seg_start = torch.cummax(torch.where(changed, idx, 0), dim=1).values
    return (idx - seg_start).clamp_max(max_positions - 1)


class Bert(nn.Module):
    """Returns last_hidden_state [B, L, H] (like HF BertModel w/o pooler)."""

    def __init__(self, config: BertConfig, lora: Optional[LoraConfig] = None,
                 remat: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_card_dtype(device, dtype,
                         config.hidden_size // config.num_heads)
        self.config = config
        self.remat = remat
        self.compute_dtype = dtype
        pdt = param_dtype or dtype
        H = config.hidden_size
        table = lambda n: nn.Parameter(torch.zeros(n, H, device=device,
                                                   dtype=pdt))
        self.word_embeddings = table(config.vocab_size)
        self.position_embeddings = table(config.max_position_embeddings)
        self.token_type_embeddings = table(config.type_vocab_size)
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.emb_ln = LayerNorm(H, eps=config.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            BertLayer(config, lora, i, **kw) for i in range(config.num_layers))

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        input_ids = input_ids.long()
        L = input_ids.shape[1]
        if segment_ids is None:
            pos = self.position_embeddings[None, :L]
        else:
            pos = self.position_embeddings[segment_positions(
                segment_ids, cfg.max_position_embeddings)]
        # (words + positions) rounds to the parameters' dtype; the token
        # type is added in the compute dtype: XLA folds the JAX layer's last
        # bf16 add and its cast to f32 into one f32 add
        dt = self.compute_dtype
        x = ((self.word_embeddings[input_ids] + pos).to(dt)
             + self.token_type_embeddings[0].to(dt))
        x = self.emb_ln(x)
        attention_mask = input_ids != cfg.pad_token_id
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, bias, segment_ids, use_reentrant=False)
            else:
                x = layer(x, bias, segment_ids)
        return x


def init_bert_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator` with flax's initializers, made where
    the parameters live: Linear weights lecun-normal and biases zero, the
    three embedding tables N(0, 0.02), LayerNorms identity, LoRA factors as
    LoraDense makes them (A uniform, B zero). Every Linear of `model` is
    drawn, a head's too, as `esm2.init_esm2_weights_` does. Used where no
    checkpoint is available."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Bert):
                for t in (mod.word_embeddings, mod.position_embeddings,
                          mod.token_type_embeddings):
                    t.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
                if isinstance(mod, LoraDense):
                    bound = mod.in_features ** -0.5
                    mod.lora_A.uniform_(-bound, bound, generator=generator)
                    mod.lora_B.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
