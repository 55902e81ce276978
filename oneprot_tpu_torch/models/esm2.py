"""ESM2 protein language model in PyTorch (counterpart of
oneprot_tpu/models/esm2.py).

Numerics follow the JAX `Esm2`: rotary position embeddings on q and k
(rotate_half), pre-LN blocks with a final LayerNorm, the ESM2 token-dropout
rescale, exact-erf GELU, LayerNorm eps 1e-5. Attention takes one of the JAX
layer's two paths, by head width:

- heads of at most 64 (every preset up to ESM2-3B): the fused [B, L, H*D]
  `kernels.flash_mha.mha_attention`, with rotary inside the kernel;
- wider heads (ESM2-15B's 128, from a `config.json`): rotary in the compute
  dtype with the tables cast to it, then `kernels.flash_attention.
  dot_product_attention` over [B, H, L, D] (the FlashAttention-2 forward).

Each runs its CUDA kernel on the card and its plain version on the CPU,
forward and backward. With `quant_int8`, every dense layer of the blocks is
an `Int8Dense` (w8a8, frozen towers only) and the fc1 -> fc2 epilogue runs
the fused GELU -> int8 kernel. With `lora`, q, k and v are `LoraDense`
layers (peft's adapters; not o, as in the JAX layer). With `remat`, each
layer runs under `torch.utils.checkpoint` when autograd records: only its
input is kept, and its forward runs again in the backward (the JAX
package's `nn.remat(Esm2Layer)`).

Modules are built on the card in bf16 unless the caller names another
device and dtype: on the card the attention kernels take bf16, and f32
for heads that are multiples of 8 up to 64 (the f32 instances of #1-#3),
so `Esm2` refuses any other compute dtype there when it is built
(`flash_mha.check_card_dtype`); the CPU takes any. `param_dtype` (default:
the compute dtype) is the dtype the parameters are stored in: float32 for a
trainable bf16 tower, as flax keeps them (see `layers`).

With `tp = (ranks, rank)` above one rank (tensor parallelism over the
mesh's model group, `core/partitioning.py`), each layer holds its model
rank's shard: q, k and v column-parallel (this rank's `num_heads / ranks`
heads, a contiguous block of whole heads, so that [B, L, (H/m) D] goes
into the attention kernels as it is), o row-parallel (its partial sums
reduced over the group, the bias added once after), fc1 column- and fc2
row-parallel, a LoRA `lora_B` split with its q/k/v and `lora_A` whole
(its gradient is a sum of the ranks' parts: `tp_partial_grad`). Where
the model axis does not divide the heads (the JAX rules split q/k/v
wherever it divides H, across heads), q, k and v stay whole and o takes
its block of their whole output: a documented placement difference with
the same function. An int8 hub is held whole on every model rank, as the
JAX package places it (its rules split only leaves named `kernel`, so the
int8 codes and scales stay replicated; they do split the q/k/v and fc1
biases, which the port keeps whole beside their codes): no layer of it
runs a model-group collective, and the GELU -> int8 kernel quantizes whole
fc1 rows.

With `segment_ids` (packed rows: several proteins per row, padding -1), the
token-dropout rescale is taken per protein and attention is block-diagonal
per segment. Packed rows with heads wider than 64 take the JAX layer's dense
segment mask and plain attention on the CPU, and on the card the ids go
into the FlashAttention-2 kernels (`dot_product_attention(segment_ids=)`),
which visit only the tiles of equal ids.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from oneprot_tpu_torch.kernels.attention import packed_segment_bias
from oneprot_tpu_torch.kernels.flash_attention import dot_product_attention
from oneprot_tpu_torch.kernels.flash_mha import (  # noqa: F401  (re-exported)
    apply_rotary,
    check_card_dtype,
    fused_mha_applies,
    mha_attention,
    rotate_half,
)
from oneprot_tpu_torch.core import collectives
from oneprot_tpu_torch.kernels.gelu_quant import fused_gelu_quant
from oneprot_tpu_torch.models.layers import (
    TP,
    ColumnParallelDense,
    Dense,
    Embedding,
    LayerNorm,
    draw_,
    mark_shard,
    tensor_parallel_dense,
)

MASK_RATIO_TRAIN = 0.15 * 0.8  # ESM2 pretraining mask rate (token dropout)
# HF config.json files of published ESM2 sizes with no preset name (widths
# only, no weights): `resolve_esm2_config(HUB_CONFIG_DIR / name)`
HUB_CONFIG_DIR = Path(__file__).resolve().parents[1] / "hub_configs"
INT8_LAYERS = ("q", "k", "v", "o", "fc1", "fc2")  # the Int8Dense modules
# parameter names that train in a frozen transformer with LoRA (peft's
# bias="all"): the factors and every bias, LayerNorms' included
LORA_TRAINABLE_LEAVES = ("lora_A", "lora_B", "bias")


@dataclasses.dataclass(frozen=True)
class Esm2Config:
    vocab_size: int = 33
    hidden_size: int = 320
    num_layers: int = 6
    num_heads: int = 20
    intermediate_size: int = 1280
    pad_token_id: int = 1
    mask_token_id: int = 32
    token_dropout: bool = True
    layer_norm_eps: float = 1e-5
    max_length: int = 1026


# Published ESM2 model sizes, plus a 2-layer toy for tests
ESM2_SIZES = {
    "esm2_t6_8M": Esm2Config(hidden_size=320, num_layers=6, num_heads=20,
                             intermediate_size=1280),
    "esm2_t12_35M": Esm2Config(hidden_size=480, num_layers=12, num_heads=20,
                               intermediate_size=1920),
    "esm2_t30_150M": Esm2Config(hidden_size=640, num_layers=30, num_heads=20,
                                intermediate_size=2560),
    "esm2_t33_650M": Esm2Config(hidden_size=1280, num_layers=33, num_heads=20,
                                intermediate_size=5120),
    "esm2_t36_3B": Esm2Config(hidden_size=2560, num_layers=36, num_heads=40,
                              intermediate_size=10240),
    "esm2_tiny": Esm2Config(hidden_size=64, num_layers=2, num_heads=4,
                            intermediate_size=128),
}


def resolve_esm2_config(name_or_path,
                        vocab_size: Optional[int] = None) -> Esm2Config:
    """Map HF-style names ('facebook/esm2_t33_650M_UR50D') or a local HF
    directory holding a config.json (its keys as HF's EsmConfig names them;
    other keys are ignored) to a config; `vocab_size` overrides the
    vocabulary."""
    cfg_json = os.path.join(name_or_path, "config.json")
    if os.path.isfile(cfg_json):
        with open(cfg_json) as f:
            hf = json.load(f)
        cfg = Esm2Config(
            vocab_size=int(hf.get("vocab_size", 33)),
            hidden_size=int(hf["hidden_size"]),
            num_layers=int(hf["num_hidden_layers"]),
            num_heads=int(hf["num_attention_heads"]),
            intermediate_size=int(hf["intermediate_size"]),
            pad_token_id=int(hf.get("pad_token_id", 1)),
            mask_token_id=int(hf.get("mask_token_id", 32)),
            token_dropout=bool(hf.get("token_dropout", True)),
            layer_norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
        )
    else:
        key = str(name_or_path).rstrip("/").split("/")[-1]
        cfg = next((c for prefix, c in ESM2_SIZES.items()
                    if key.startswith(prefix)), None)
        if cfg is None:
            raise ValueError(f"Unknown ESM2 model name: {name_or_path}")
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    return cfg


def rotary_cos_sin(length: int, dim: int, device=None,
                   dtype: torch.dtype = torch.float32):
    """[length, dim] cos and sin tables of the rotary embedding."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def quantize_int8_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight [N, K] (torch Linear layout) -> (int8 [N, K], f32 scale [N]):
    symmetric per-output-channel abs-max quantization, computed in f32."""
    w = w.float()
    s_w = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    return torch.round(w / s_w[:, None]).to(torch.int8), s_w


def quantize_esm2_int8_tree(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Rewrite a float state_dict into the Int8Dense layout: the `weight` of
    every q/k/v/o/fc1/fc2 Linear becomes `weight_q` + `weight_scale` and its
    bias becomes f32. Everything else (embeddings, LayerNorms, a head's
    projections) passes unchanged, so the whole state of a SequenceEncoder
    can go through. Done once at weight-load time."""
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] in INT8_LAYERS:
            prefix = ".".join(parts[:-1])
            if parts[-1] == "weight":
                out[prefix + ".weight_q"], out[prefix + ".weight_scale"] = (
                    quantize_int8_kernel(t))
                continue
            if parts[-1] == "bias":
                out[key] = t.float()
                continue
        out[key] = t
    return out


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 weight [N, K] -> int32 [M, N] through
    torch._int_mm, which on the card needs M > 16 (rows are zero-padded up
    to 17 there) and K, N multiples of 8."""
    M = x_q.shape[0]
    if x_q.is_cuda and M <= 16:
        x_q = F.pad(x_q, (0, 0, 0, 17 - M))
    return torch._int_mm(x_q, w_q.t())[:M]


class Int8Dense(nn.Module):
    """Dense with w8a8 int8 quantization, for frozen towers only.

    Holds `weight_q` int8 [out, in] and `weight_scale` f32 [out] (made from a
    float weight by `quantize_esm2_int8_tree`) and an f32 bias (bf16 once
    `OneProtModule.init` stores frozen leaves in bf16), all as buffers:
    nothing here trains. The forward quantizes activations per token
    (symmetric abs-max), takes the int8 x int8 -> int32 product and
    dequantizes as `y * s_x * s_w + bias` in f32.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=torch.float32, device=device) if bias else None)

    def forward(self, x: Optional[torch.Tensor],
                pre_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """`pre_quant=(x_q int8 [..., K], s_x f32 [..., 1])` skips the
        activation quantization (the fused GELU -> int8 kernel feeds fc2
        this way); `x` is then ignored."""
        K = self.in_features
        if pre_quant is not None:
            x_q, s_x = pre_quant
            lead = x_q.shape[:-1]
            x_q, s_x = x_q.reshape(-1, K), s_x.reshape(-1, 1)
        else:
            lead = x.shape[:-1]
            x2 = x.float().reshape(-1, K)
            s_x = (x2.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
            x_q = torch.round(x2 / s_x).to(torch.int8)
        y = int8_matmul(x_q, self.weight_q).float() * s_x * self.weight_scale
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, self.out_features).to(self.dtype)


def _dense(quant_int8: bool, n_in: int, n_out: int, kind: str = "column",
           tp: TP = (1, 0), **kw) -> nn.Module:
    """Int8Dense, or a Dense split as `kind` ("column" / "row") over the
    model ranks of `tp` (`layers.tensor_parallel_dense`)."""
    if quant_int8:
        return Int8Dense(n_in, n_out, device=kw["device"], dtype=kw["dtype"])
    return tensor_parallel_dense(kind, n_in, n_out, tp, **kw)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """LoRA on q, k and v: rank r, y += (alpha / r) * dropout(x) A^T B^T."""
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0


class LoraDense(ColumnParallelDense):
    """Dense with LoRA factors (counterpart of the JAX `LoraDense`, peft's
    math): y = x W^T + b + (alpha / r) * dropout(x) A^T B^T, with `lora_A`
    [r, in] drawn from U(+-sqrt(1/in)) (peft's kaiming_uniform(a=sqrt(5)))
    and `lora_B` [out, r] at zero. Its `weight` and `bias` are the wrapped
    Dense's (the JAX layer's inner `dense`); only a float Dense is wrapped,
    as the JAX package refuses int8 with LoRA.

    Dropout is on the LoRA branch's input only and only in training mode:
    keep with probability 1 - p, kept values divided by 1 - p. Its mask
    comes from a generator seeded at each call from (`dropout_seed`,
    `stream`): the step's seed (`set_lora_dropout_seed`) and this layer's
    own number. So a layer that runs again under activation checkpointing
    draws the mask it drew the first time; a shared generator would have
    moved on and made the gradients silently wrong.

    Split over `tp` model ranks (column-parallel, as q/k/v are), a rank
    holds its block of the weight, the bias and `lora_B`, and the whole
    `lora_A`; the branch runs on the input the dense part sees (the model
    group's copy), so each rank's `lora_A` gradient is its part of the sum
    (`tp_partial_grad`: the optimizer sums it over the group)."""

    def __init__(self, in_features: int, out_features: int, lora: LoraConfig,
                 stream: int, *, tp: TP = (1, 0), copy_input: bool = True,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, tp=tp,
                         copy_input=copy_input, device=device, dtype=dtype,
                         param_dtype=param_dtype)
        pdt = param_dtype or dtype
        self.lora_A = nn.Parameter(torch.empty(lora.rank, in_features,
                                               device=device, dtype=pdt))
        self.lora_B = nn.Parameter(torch.zeros(self.out_features, lora.rank,
                                               device=device, dtype=pdt))
        bound = in_features ** -0.5
        nn.init.uniform_(self.lora_A, -bound, bound)
        mark_shard(self.lora_B, 0, tp)
        if tp[0] > 1:
            self.lora_A.tp_partial_grad = True
        self.lora_scale = lora.alpha / lora.rank
        self.lora_dropout = lora.dropout
        self.stream = stream
        self.dropout_seed = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.copy_input and self.ranks > 1:
            x = collectives.copy_to_model_group(x)
        y = Dense.forward(self, x)
        xl = x.to(dt)
        if self.training and self.lora_dropout > 0.0:
            keep = 1.0 - self.lora_dropout
            gen = torch.Generator(device=x.device)
            gen.manual_seed((self.dropout_seed * 65_537 + self.stream) % 2**63)
            kept = torch.rand(xl.shape, generator=gen, device=x.device) < keep
            xl = torch.where(kept, xl / keep, 0.0)
        return y + self.lora_scale * (
            (xl @ self.lora_A.to(dt).T) @ self.lora_B.to(dt).T)


def set_lora_dropout_seed(model: nn.Module, seed: int) -> None:
    """Seed every LoraDense's dropout for the next forward (and the
    checkpointed recompute in its backward)."""
    for mod in model.modules():
        if isinstance(mod, LoraDense):
            mod.dropout_seed = seed


def split_heads(num_heads: int, tp: TP) -> TP:
    """The model ranks that q, k and v of an attention of `num_heads` heads
    split over: `tp` where its ranks divide the heads (each rank whole
    heads), else (1, 0) (q, k and v whole)."""
    return tp if tp[0] > 1 and num_heads % tp[0] == 0 else (1, 0)


def qkv_projections(config, lora: Optional[LoraConfig], layer_index: int,
                    tp: TP, quant_int8: bool = False, **kw):
    """q, k and v of an ESM2 or BERT attention over model ranks `tp` (from
    `split_heads`): column-parallel Dense or LoraDense layers whose input
    the attention copies to the model group once; with LoRA, streams
    3 * layer_index + 0..2."""
    H = config.hidden_size
    if lora is None:
        return tuple(_dense(quant_int8, H, H, "column", tp, copy_input=False,
                            **kw) for _ in range(3))
    return tuple(LoraDense(H, H, lora, 3 * layer_index + i, tp=tp,
                           copy_input=False, **kw) for i in range(3))


class Esm2SelfAttention(nn.Module):
    def __init__(self, config: Esm2Config, quant_int8: bool = False,
                 lora: Optional[LoraConfig] = None, layer_index: int = 0, *,
                 tp: TP = (1, 0), device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if quant_int8 and lora is not None:
            raise ValueError("LoRA wraps a float Dense only, not Int8Dense")
        self.config = config
        H = config.hidden_size
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        qkv_tp = split_heads(config.num_heads, tp)
        self.heads_split = qkv_tp[0] > 1
        self.local_heads = config.num_heads // qkv_tp[0]
        self.q, self.k, self.v = qkv_projections(config, lora, layer_index,
                                                 qkv_tp, quant_int8, **kw)
        self.o = _dense(quant_int8, H, H, "row", tp,
                        input_is_parallel=self.heads_split, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        nh = self.local_heads
        if self.heads_split:
            x = collectives.copy_to_model_group(x)
        q2d, k2d, v2d = self.q(x), self.k(x), self.v(x)
        B, L, hd = q2d.shape
        D = hd // nh
        if fused_mha_applies(D):
            # [B, L, H*D] straight into the kernel: rotary is applied inside it
            ctx, _ = mha_attention(q2d, k2d, v2d, nh, bias=bias, rope_cos=cos,
                                   rope_sin=sin, segment_ids=segment_ids)
            return self.o(ctx)

        def heads(t):
            return t.reshape(B, L, nh, D).transpose(1, 2)

        # the JAX layer's reference path: rotary in the compute dtype
        cos, sin = cos.to(q2d.dtype), sin.to(q2d.dtype)
        q = apply_rotary(heads(q2d), cos, sin)
        k = apply_rotary(heads(k2d), cos, sin)
        if segment_ids is not None and not q.is_cuda:
            # the JAX layer's dense mask (-1e9 across segments) on the CPU;
            # the card's kernels take the ids themselves
            bias, segment_ids = packed_segment_bias(segment_ids, bias), None
        ctx = dot_product_attention(q, k, heads(v2d), bias=bias,
                                    segment_ids=segment_ids)
        return self.o(ctx.transpose(1, 2).reshape(B, L, hd))


class Esm2Layer(nn.Module):
    def __init__(self, config: Esm2Config, quant_int8: bool = False,
                 lora: Optional[LoraConfig] = None, layer_index: int = 0, *,
                 tp: TP = (1, 0), device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.quant_int8 = quant_int8
        self.attn_ln = LayerNorm(H, eps=eps, **kw)
        self.attn = Esm2SelfAttention(config, quant_int8, lora, layer_index,
                                      tp=tp, **kw)
        self.ffn_ln = LayerNorm(H, eps=eps, **kw)
        self.fc1 = _dense(quant_int8, H, config.intermediate_size, "column",
                          tp, **kw)
        self.fc2 = _dense(quant_int8, config.intermediate_size, H, "row", tp,
                          **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x), bias, cos, sin, segment_ids)
        h = self.fc1(self.ffn_ln(x))
        if self.quant_int8:
            # fused gelu -> per-token int8 in one pass over [tokens, 4H]
            return x + self.fc2(None, pre_quant=fused_gelu_quant(h))
        return x + self.fc2(F.gelu(h, approximate="none"))


class Esm2(nn.Module):
    """Returns last_hidden_state [B, L, H] (like HF EsmModel w/o pooler)."""

    def __init__(self, config: Esm2Config, quant_int8: bool = False,
                 lora: Optional[LoraConfig] = None, remat: bool = False, *,
                 tp: TP = (1, 0), device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if quant_int8:
            tp = (1, 0)  # held whole on every model rank (see above)
        check_card_dtype(device, dtype,
                         config.hidden_size // config.num_heads)
        self.config = config
        self.remat = remat
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList(
            Esm2Layer(config, quant_int8, lora, i, tp=tp, **kw)
            for i in range(config.num_layers))
        self.final_ln = LayerNorm(config.hidden_size,
                                  eps=config.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        attention_mask = input_ids != cfg.pad_token_id
        x = self.embed_tokens(input_ids)
        if cfg.token_dropout:
            is_mask = input_ids == cfg.mask_token_id
            x = x.masked_fill(is_mask[..., None], 0.0)
            if segment_ids is None:
                src_lengths = attention_mask.sum(-1).clamp_min(1)
                ratio = is_mask.float().sum(-1) / src_lengths
                scale = ((1.0 - MASK_RATIO_TRAIN) / (1.0 - ratio))[:, None]
            else:
                scale = _segment_dropout_scale(attention_mask, is_mask,
                                               segment_ids)
            x = x * scale[..., None].to(x.dtype)
        # zero out pad embeddings (HF EsmEmbeddings tail behaviour)
        x = x * attention_mask[..., None].to(x.dtype)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        L = input_ids.shape[1]
        cos, sin = rotary_cos_sin(L, cfg.hidden_size // cfg.num_heads,
                                  device=input_ids.device)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, bias, cos, sin, segment_ids,
                               use_reentrant=False)
            else:
                x = layer(x, bias, cos, sin, segment_ids)
        return self.final_ln(x)


def _segment_dropout_scale(attention_mask: torch.Tensor, is_mask: torch.Tensor,
                           segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, L] token-dropout scale of packed rows, per protein: each token
    takes its segment's non-pad length (clamped at 1) and <mask> count,
    summed exactly in f32 through a scatter into one slot per segment.
    Padding (segment -1) belongs to no segment: length 1, no masks, so its
    scale is 1 - 0.15 * 0.8, as in the JAX package."""
    B, L = segment_ids.shape
    seg = segment_ids.long()
    slot = torch.where(seg >= 0, seg, L)  # slot L gathers the padding
    sums = torch.zeros(2, B, L + 1, dtype=torch.float32,
                       device=segment_ids.device)
    sums[0].scatter_add_(1, slot, attention_mask.float())
    sums[1].scatter_add_(1, slot, is_mask.float())
    sums[:, :, L] = 0.0
    per_token = sums.gather(2, slot[None].expand(2, B, L))
    seg_len = per_token[0].clamp_min(1.0)
    return (1.0 - MASK_RATIO_TRAIN) / (1.0 - per_token[1] / seg_len)


def init_dense_(mod: nn.Linear, generator: torch.Generator) -> None:
    """A Linear's random weights: lecun-normal over its full fan-in, bias
    zero, LoRA factors as LoraDense makes them (A uniform, B zero); a
    shard draws the full weight and keeps its block (`layers.draw_`)."""
    fan_in = getattr(mod, "full_in", mod.in_features)
    draw_(mod.weight, lambda w: w.normal_(0.0, fan_in ** -0.5,
                                          generator=generator))
    if mod.bias is not None:
        mod.bias.zero_()
    if isinstance(mod, LoraDense):
        bound = fan_in ** -0.5
        mod.lora_A.uniform_(-bound, bound, generator=generator)
        mod.lora_B.zero_()


def init_esm2_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`, made where the parameters live:
    Linear weights lecun-normal and biases zero (`init_dense_`: a shard
    draws the unsharded model's numbers), an Int8Dense's the same float
    weight quantized (`quantize_int8_kernel`), embeddings N(0, 0.02),
    LayerNorms identity, LoRA factors as LoraDense makes them (A uniform,
    B zero). Used where no checkpoint is available."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                init_dense_(mod, generator)
            elif isinstance(mod, Int8Dense):
                w = torch.empty_like(mod.weight_q, dtype=torch.float32)
                w.normal_(0.0, mod.in_features ** -0.5, generator=generator)
                mod.weight_q, mod.weight_scale = quantize_int8_kernel(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)

