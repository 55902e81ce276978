"""ESM2 protein language model in PyTorch (counterpart of
oneprot_tpu/models/esm2.py).

Numerics follow the JAX `Esm2`: rotary position embeddings on q and k
(rotate_half), pre-LN blocks with a final LayerNorm, the ESM2 token-dropout
rescale, exact-erf GELU, LayerNorm eps 1e-5. Attention runs through
`kernels.flash_mha.mha_attention` (the CUDA kernel on the card, its plain
version on the CPU). With `quant_int8`, every dense layer of the blocks is
an `Int8Dense` (w8a8, frozen towers only) and the fc1 -> fc2 epilogue runs
the fused GELU -> int8 kernel.

Modules are built on the card in bf16 unless the caller names another
device and dtype: the flash-MHA kernel takes bf16 only, so `Esm2` refuses
another dtype on the card; the CPU takes any.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.kernels.flash_mha import (  # noqa: F401  (re-exported)
    apply_rotary,
    mha_attention,
    rotate_half,
)
from oneprot_tpu_torch.kernels.gelu_quant import fused_gelu_quant

MASK_RATIO_TRAIN = 0.15 * 0.8  # ESM2 pretraining mask rate (token dropout)
INT8_LAYERS = ("q", "k", "v", "o", "fc1", "fc2")  # the Int8Dense modules


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


def resolve_esm2_config(name: str) -> Esm2Config:
    """Map HF-style names ('facebook/esm2_t33_650M_UR50D') to configs."""
    key = name.rstrip("/").split("/")[-1]
    for prefix, cfg in ESM2_SIZES.items():
        if key.startswith(prefix):
            return cfg
    raise ValueError(f"Unknown ESM2 model name: {name}")


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
    float weight by `quantize_esm2_int8_tree`) and an f32 bias, all as
    buffers: nothing here trains. The forward quantizes activations per
    token (symmetric abs-max), takes the int8 x int8 -> int32 product and
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


def _dense(quant_int8: bool, n_in: int, n_out: int, device, dtype) -> nn.Module:
    if quant_int8:
        return Int8Dense(n_in, n_out, device=device, dtype=dtype)
    return nn.Linear(n_in, n_out, device=device, dtype=dtype)


class Esm2SelfAttention(nn.Module):
    def __init__(self, config: Esm2Config, quant_int8: bool = False, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.q, self.k, self.v, self.o = (
            _dense(quant_int8, H, H, device, dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        # [B, L, H*D] straight into the kernel: rotary is applied inside it
        ctx, _ = mha_attention(self.q(x), self.k(x), self.v(x),
                               self.config.num_heads, bias=bias,
                               rope_cos=cos, rope_sin=sin)
        return self.o(ctx)


class Esm2Layer(nn.Module):
    def __init__(self, config: Esm2Config, quant_int8: bool = False, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.quant_int8 = quant_int8
        self.attn_ln = nn.LayerNorm(H, eps=eps, **kw)
        self.attn = Esm2SelfAttention(config, quant_int8, **kw)
        self.ffn_ln = nn.LayerNorm(H, eps=eps, **kw)
        self.fc1 = _dense(quant_int8, H, config.intermediate_size, device, dtype)
        self.fc2 = _dense(quant_int8, config.intermediate_size, H, device, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x), bias, cos, sin)
        h = self.fc1(self.ffn_ln(x))
        if self.quant_int8:
            # fused gelu -> per-token int8 in one pass over [tokens, 4H]
            return x + self.fc2(None, pre_quant=fused_gelu_quant(h))
        return x + self.fc2(F.gelu(h, approximate="none"))


class Esm2(nn.Module):
    """Returns last_hidden_state [B, L, H] (like HF EsmModel w/o pooler)."""

    def __init__(self, config: Esm2Config, quant_int8: bool = False, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"dtype {dtype} on the card: the flash-MHA "
                             "kernel takes bfloat16 only")
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList(
            Esm2Layer(config, quant_int8, **kw)
            for _ in range(config.num_layers))
        self.final_ln = nn.LayerNorm(config.hidden_size,
                                     eps=config.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if segment_ids is not None:
            raise NotImplementedError(
                "packed rows (segment_ids) and their per-segment token-dropout "
                "rescale are not ported yet")
        cfg = self.config
        attention_mask = input_ids != cfg.pad_token_id
        x = self.embed_tokens(input_ids)
        if cfg.token_dropout:
            is_mask = input_ids == cfg.mask_token_id
            x = x.masked_fill(is_mask[..., None], 0.0)
            src_lengths = attention_mask.sum(-1).clamp_min(1)
            ratio = is_mask.float().sum(-1) / src_lengths
            scale = (1.0 - MASK_RATIO_TRAIN) / (1.0 - ratio)
            x = x * scale[:, None, None].to(x.dtype)
        # zero out pad embeddings (HF EsmEmbeddings tail behaviour)
        x = x * attention_mask[..., None].to(x.dtype)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        L = input_ids.shape[1]
        cos, sin = rotary_cos_sin(L, cfg.hidden_size // cfg.num_heads,
                                  device=input_ids.device)
        for layer in self.layers:
            x = layer(x, bias, cos, sin)
        return self.final_ln(x)


def init_esm2_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`, made where the parameters live:
    Linear weights lecun-normal and biases zero, embeddings N(0, 0.02),
    LayerNorms identity. Used where no checkpoint is available."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)

