"""MSA Transformer (axial attention) in PyTorch (counterpart of
oneprot_tpu/models/msa_transformer.py, the architecture of fair-esm's
esm_msa1b_t12_100M_UR50S).

Input tokens [B, R, L] (R MSA rows, L columns, row 0 the query); output
representations [B, R, L, H]. Each pre-LN block runs tied row attention
(one attention map shared by all R rows, scaled by (D * R)^-0.5, through
`kernels.attention.fused_tied_row`: the CUDA kernel on the card, its plain
version on the CPU), column attention (an R x R softmax per column, plain
PyTorch) and an exact-erf GELU MLP. Embeddings are the token table plus
learned column positions plus a per-row MSA position embedding, between
LayerNorms; eps 1e-5.

Padding follows the JAX package: pad tokens are zeroed after the first
LayerNorm, row 0 decides which columns are keys (col bias -1e9), a row with
no token decides which rows are keys of column attention, and q of the row
attention is zeroed at padded positions before the tied sum.

With `tp = (ranks, rank)` the JAX rules of `core/partitioning.py` split
the MLP (fc1 column-, fc2 row-parallel) and both attentions' `o` by rows;
their q, k and v are plain Dense layers the rules leave whole, so each `o`
takes its block of a whole input (`RowParallelDense(input_is_parallel=
False)`).

The tower is frozen wherever it is used, so its parameters are stored in
the compute dtype (bf16 on the card, where the tied-row kernel takes bf16
only) and modules are built on the card unless told otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.kernels.attention import fused_tied_row
from oneprot_tpu_torch.kernels.tied_row_attention import tied_scale
from oneprot_tpu_torch.models.esm2 import init_esm2_weights_
from oneprot_tpu_torch.models.layers import (
    TP,
    Dense,
    Embedding,
    LayerNorm,
    tensor_parallel_dense,
)


@dataclasses.dataclass(frozen=True)
class MsaTransformerConfig:
    vocab_size: int = 33
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pad_token_id: int = 1
    # column positions: fair-esm's table has 2 more (padding offset) rows,
    # which the checkpoint converter strips
    max_positions: int = 1024
    max_rows: int = 1024
    layer_norm_eps: float = 1e-5


def _projections(cfg: MsaTransformerConfig, tp: TP, **kw):
    """q, k, v whole and o row-parallel over `tp` on their whole output."""
    H = cfg.hidden_size
    return (*(Dense(H, H, **kw) for _ in range(3)),
            tensor_parallel_dense("row", H, H, tp, input_is_parallel=False,
                                  **kw))


class TiedRowAttention(nn.Module):
    def __init__(self, config: MsaTransformerConfig, *, tp: TP = (1, 0),
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        self.q, self.k, self.v, self.o = _projections(config, tp,
                                                      device=device,
                                                      dtype=dtype)

    def forward(self, x: torch.Tensor, col_bias: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """x [B, R, L, H]; col_bias [B, 1, 1, L] additive; pad_mask [B, R, L]
        True where a token is. A padded row's q is zeroed so that it adds
        nothing to the tied logits of the real rows."""
        R = x.shape[1]
        nh = self.config.num_heads
        q = self.q(x)
        q = q * pad_mask[..., None].to(q.dtype)
        ctx = fused_tied_row(q, self.k(x), self.v(x), nh, col_bias=col_bias,
                             scale=tied_scale(self.config.hidden_size // nh, R))
        return self.o(ctx)


class ColumnAttention(nn.Module):
    def __init__(self, config: MsaTransformerConfig, *, tp: TP = (1, 0),
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        self.q, self.k, self.v, self.o = _projections(config, tp,
                                                      device=device,
                                                      dtype=dtype)

    def forward(self, x: torch.Tensor, row_bias: torch.Tensor) -> torch.Tensor:
        """x [B, R, L, H]; row_bias [B, 1, 1, R] additive bias over the rows
        of each column. Logits and softmax in f32, probabilities in x's
        dtype, as in the JAX package."""
        B, R, L, _ = x.shape
        nh = self.config.num_heads
        hd = self.config.hidden_size // nh
        q = self.q(x).reshape(B, R, L, nh, hd) * (hd ** -0.5)
        k = self.k(x).reshape(B, R, L, nh, hd)
        v = self.v(x).reshape(B, R, L, nh, hd)
        logits = torch.einsum("brlhd,bslhd->blhrs", q.float(), k.float())
        logits = logits + row_bias[:, 0, 0, :].float()[:, None, None, None, :]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("blhrs,bslhd->brlhd", probs.float(), v.float())
        return self.o(ctx.to(v.dtype).reshape(B, R, L, nh * hd))


class MsaLayer(nn.Module):
    def __init__(self, config: MsaTransformerConfig, *, tp: TP = (1, 0),
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.row_ln = LayerNorm(H, eps=eps, **kw)
        self.row_attn = TiedRowAttention(config, tp=tp, **kw)
        self.col_ln = LayerNorm(H, eps=eps, **kw)
        self.col_attn = ColumnAttention(config, tp=tp, **kw)
        self.ffn_ln = LayerNorm(H, eps=eps, **kw)
        self.fc1 = tensor_parallel_dense("column", H, config.intermediate_size,
                                         tp, **kw)
        self.fc2 = tensor_parallel_dense("row", config.intermediate_size, H,
                                         tp, **kw)

    def forward(self, x, col_bias, row_bias, pad_mask):
        x = x + self.row_attn(self.row_ln(x), col_bias, pad_mask)
        x = x + self.col_attn(self.col_ln(x), row_bias)
        h = F.gelu(self.fc1(self.ffn_ln(x)), approximate="none")
        return x + self.fc2(h)


class MsaTransformer(nn.Module):
    """Tokens [B, R, L] -> representations [B, R, L, H]."""

    def __init__(self, config: MsaTransformerConfig, *, tp: TP = (1, 0),
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"dtype {dtype} on the card: the tied-row "
                             "kernel takes bfloat16 only")
        self.config = config
        H = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, H, **kw)
        self.embed_positions = nn.Parameter(
            torch.zeros(config.max_positions, H, **kw))
        # [max_rows, 1, H], as the JAX package stores it
        self.msa_position_embedding = nn.Parameter(
            torch.zeros(config.max_rows, 1, H, **kw))
        self.emb_ln_before = LayerNorm(H, eps=config.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            MsaLayer(config, tp=tp, **kw) for _ in range(config.num_layers))
        self.emb_ln_after = LayerNorm(H, eps=config.layer_norm_eps, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        R, L = tokens.shape[1:]
        pad_mask = tokens != cfg.pad_token_id
        x = self.embed_tokens(tokens)
        x = x + self.embed_positions[:L].to(x.dtype)[None, None]
        x = x + self.msa_position_embedding[:R].to(x.dtype)[None]
        x = self.emb_ln_before(x)
        x = x * pad_mask[..., None].to(x.dtype)
        # row 0 (the query) decides which columns are keys; a row with no
        # token is no key of column attention
        col_bias = (1.0 - pad_mask[:, 0, :].float())[:, None, None, :] * -1e9
        row_bias = (1.0 - pad_mask.any(dim=2).float())[:, None, None, :] * -1e9
        for layer in self.layers:
            x = layer(x, col_bias, row_bias, pad_mask)
        return self.emb_ln_after(x)


def init_msa_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`, made where the parameters live:
    `esm2.init_esm2_weights_` for the Linear, Embedding and LayerNorm
    layers, and N(0, 0.02) for both position tables. Used where no
    checkpoint is available."""
    init_esm2_weights_(model, generator)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MsaTransformer):
                mod.embed_positions.normal_(0.0, 0.02, generator=generator)
                mod.msa_position_embedding.normal_(0.0, 0.02,
                                                   generator=generator)
