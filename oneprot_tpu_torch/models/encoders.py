"""Encoders and the hub model (counterpart of
oneprot_tpu/models/encoders.py: `SequenceEncoder`, `StructTokenEncoder`,
`MsaEncoder`, `TextEncoder`, their factories, `OneProtModel`).

Encoders compute in `dtype` (bf16 on the card). A frozen transformer stores
its parameters in that dtype; a trainable one keeps float32 master
parameters, and heads always do, as flax stores them. A frozen transformer
with LoRA keeps its trainable leaves (the factors and the biases) in
float32 too, and has no gradient barrier: the adapters train through it.
`OneProtModel` routes 'sequence' and 'seqsim' to the sequence encoder and
'struct_token', 'msa', 'text', 'struct_graph' and 'pocket' to theirs. The
graph towers (`StructGraphEncoder`: ProNet, dropout, head) take a dict of
padded graph arrays rather than token ids, and compute in float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from oneprot_tpu_torch.models.bert import Bert, BertConfig, resolve_bert_config
from oneprot_tpu_torch.models.esm2 import (
    LORA_TRAINABLE_LEAVES,
    Esm2,
    Esm2Config,
    LoraConfig,
    resolve_esm2_config,
)
from oneprot_tpu_torch.models.heads import EncoderHead, segment_pool
from oneprot_tpu_torch.models.msa_transformer import (
    MsaTransformer,
    MsaTransformerConfig,
)
from oneprot_tpu_torch.models.pronet import (
    ProNet,
    ProNetConfig,
    dropout_stream,
    graph_dropout,
)

STRUCT_EXTRA_TOKENS = 21  # +21 3Di rows of the struct-token vocabulary
PORTED_MODALITIES = ("sequence", "struct_token", "msa", "text",
                     "struct_graph", "pocket")


def _segment_packed_pooled(transformer: Union[Esm2, Bert], pooling_type: str,
                           input_ids: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int, stop_grad: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed forward of a token encoder: segment-masked transformer ->
    per-segment pooling -> ([B*P, d_model], counts [B*P]). A token counts
    when it is not the transformer's pad id (ESM2's 1, BERT's 0) and lies
    in a segment. With `stop_grad` (a frozen transformer without LoRA) it
    runs under no_grad: no graph is kept for it (the JAX package's
    stop_gradient); the head after it still trains."""
    mask = (input_ids != transformer.config.pad_token_id) & (segment_ids >= 0)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_grad):
        hidden = transformer(input_ids, segment_ids=segment_ids)
    pooled, counts = segment_pool(hidden, mask, segment_ids, num_segments,
                                  pooling_type=pooling_type)
    B, P, H = pooled.shape
    return pooled.reshape(B * P, H), counts.reshape(B * P)


class _TokenEncoder(nn.Module):
    """A transformer + head, with the unpacked and packed paths the
    sequence, struct-token and text encoders share: ESM2, or BERT where a
    subclass's `_transformer` builds it."""

    def __init__(self, config, output_dim: int, pooling_type: str,
                 proj_type: Optional[str], use_logit_scale: bool,
                 learnable_logit_scale: bool, frozen: bool,
                 quant_int8: bool = False, lora: Optional[LoraConfig] = None,
                 remat: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 pretrained_dir: Optional[str] = None):
        super().__init__()
        self.config = config
        self.frozen = frozen
        self.quant_int8 = quant_int8
        self.lora_rank = 0 if lora is None else lora.rank
        self.pooling_type = pooling_type
        # a local HF checkpoint directory whose weights
        # `OneProtModule.load_pretrained` puts into the transformer
        self.pretrained_dir = pretrained_dir
        self.transformer = self._transformer(
            config, quant_int8, lora, remat, device=device, dtype=dtype,
            param_dtype=dtype if frozen else torch.float32)
        self.head = EncoderHead(config.hidden_size, output_dim, proj_type,
                                pooling_type, use_logit_scale,
                                learnable_logit_scale, device=device,
                                dtype=dtype)
        if frozen:
            self.transformer.requires_grad_(False)
            if lora is not None:
                for name, p in self.transformer.named_parameters():
                    if name.rsplit(".", 1)[-1] in LORA_TRAINABLE_LEAVES:
                        p.data = p.data.float()
                        p.requires_grad_(True)

    @staticmethod
    def _transformer(config, quant_int8, lora, remat, **kw) -> nn.Module:
        return Esm2(config, quant_int8, lora, remat, **kw)

    @property
    def _stop_grad(self) -> bool:
        """A frozen transformer without adapters: the gradient barrier."""
        return self.frozen and self.lora_rank == 0

    @property
    def backbone_is_cacheable(self) -> bool:
        """True when backbone_pooled(ids) stays the same for all training:
        a frozen transformer, no LoRA, parameter-free pooling."""
        return self._stop_grad and self.pooling_type in ("mean", "cls")

    def backbone_pooled(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Transformer -> pooling: the representation a frozen hub can cache."""
        mask = input_ids != self.config.pad_token_id
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self._stop_grad):
            hidden = self.transformer(input_ids)
        return self.head.pool(hidden, mask)

    def head_from_pooled(self, pooled: torch.Tensor) -> torch.Tensor:
        """The trainable tail: projection + norm on a pooled representation."""
        return self.head.project(pooled)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.head.project(self.backbone_pooled(input_ids))

    def packed_pooled(self, input_ids: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed transformer -> per-segment pooled [B*P, d_model] + counts
        [B*P] (count 0: an empty pack slot)."""
        return _segment_packed_pooled(self.transformer, self.pooling_type,
                                      input_ids, segment_ids, num_segments,
                                      self._stop_grad)

    def packed_features(self, input_ids: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed forward: (features [B*P, output_dim], counts [B*P])."""
        pooled, counts = self.packed_pooled(input_ids, segment_ids,
                                            num_segments)
        return self.head.project(pooled), counts


class SequenceEncoder(_TokenEncoder):
    """ESM2 hub encoder (sequence + seqsim modalities)."""

    def __init__(self, config: Esm2Config, output_dim: int,
                 pooling_type: str = "mean", proj_type: Optional[str] = None,
                 use_logit_scale: bool = False,
                 learnable_logit_scale: bool = False, frozen: bool = True,
                 quant_int8: bool = False, lora: Optional[LoraConfig] = None,
                 remat: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 pretrained_dir: Optional[str] = None):
        super().__init__(config, output_dim, pooling_type, proj_type,
                         use_logit_scale, learnable_logit_scale, frozen,
                         quant_int8, lora, remat, device=device, dtype=dtype,
                         pretrained_dir=pretrained_dir)


class StructTokenEncoder(_TokenEncoder):
    """A smaller ESM2 over SaProt 3Di structure tokens, trainable (the
    config's vocabulary already holds the 21 extra rows)."""

    def __init__(self, config: Esm2Config, output_dim: int,
                 pooling_type: str = "mean", proj_type: Optional[str] = "linear",
                 use_logit_scale: bool = True,
                 learnable_logit_scale: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 pretrained_dir: Optional[str] = None):
        super().__init__(config, output_dim, pooling_type, proj_type,
                         use_logit_scale, learnable_logit_scale, frozen=False,
                         device=device, dtype=dtype,
                         pretrained_dir=pretrained_dir)


class TextEncoder(_TokenEncoder):
    """BiomedBERT-style text encoder: `Bert` + head, CLS pooling and the mlp
    head with the fixed logit scale in the shipped config. Frozen by
    default; with LoRA its adapters and biases train through it."""

    def __init__(self, config: BertConfig, output_dim: int,
                 pooling_type: str = "cls", proj_type: Optional[str] = "mlp",
                 use_logit_scale: bool = True,
                 learnable_logit_scale: bool = False, frozen: bool = True,
                 lora: Optional[LoraConfig] = None, remat: bool = False, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 pretrained_dir: Optional[str] = None):
        super().__init__(config, output_dim, pooling_type, proj_type,
                         use_logit_scale, learnable_logit_scale, frozen,
                         lora=lora, remat=remat, device=device, dtype=dtype,
                         pretrained_dir=pretrained_dir)

    @staticmethod
    def _transformer(config, quant_int8, lora, remat, **kw) -> nn.Module:
        del quant_int8  # BERT is not quantized
        return Bert(config, lora, remat, **kw)


class StructGraphEncoder(nn.Module):
    """ProNet -> dropout -> head with identity pooling (the struct_graph and
    pocket towers), trainable, in float32. Dropout draws its mask from the
    step's seed (`pronet.set_graph_noise_seed`) in training mode only."""

    def __init__(self, config: ProNetConfig, output_dim: int,
                 proj_type: Optional[str] = "linear",
                 use_logit_scale: bool = True,
                 learnable_logit_scale: bool = False, dropout: float = 0.25,
                 *, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.frozen = False
        self.dropout = dropout
        self.encoder = ProNet(config, device=device, dtype=dtype)
        self.head = EncoderHead(
            config.out_channels, output_dim, proj_type, "identity",
            use_logit_scale, learnable_logit_scale, device=device,
            dtype=dtype)
        self.noise_seed = 0

    def forward(self, graph: Dict[str, torch.Tensor]) -> torch.Tensor:
        encoded = self.encoder(graph)
        if self.training and self.dropout > 0.0:
            encoded = graph_dropout(encoded, self.dropout, self.noise_seed,
                                    dropout_stream(self.config))
        return self.head.project(encoded)


class MsaEncoder(nn.Module):
    """The frozen MSA Transformer + head. The tower's output is averaged
    over every token of every row (in f32: ~10^4 summands) and the head
    does not pool again. The tower runs without an autograd graph, so its
    pooled output can be cached (`backbone_is_cacheable`): the trainer then
    trains the head alone on it (`head_from_pooled`)."""

    backbone_is_cacheable = True  # always frozen, parameter-free pooling

    def __init__(self, config: MsaTransformerConfig, output_dim: int,
                 proj_type: Optional[str] = "mlp", use_logit_scale: bool = True,
                 learnable_logit_scale: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        self.frozen = True  # always frozen, as in the reference
        self.transformer = MsaTransformer(config, device=device, dtype=dtype)
        self.transformer.requires_grad_(False)
        self.head = EncoderHead(
            config.hidden_size, output_dim, proj_type, "identity",
            use_logit_scale, learnable_logit_scale, device=device, dtype=dtype)

    def backbone_pooled(self, tokens: torch.Tensor) -> torch.Tensor:
        """Tokens [B, R, L] -> the all-MSA mean [B, H] in the tower's dtype."""
        with torch.no_grad():
            reps = self.transformer(tokens)
        m = (tokens != self.config.pad_token_id)[..., None].float()
        total = (reps.float() * m).sum(dim=(1, 2))
        return (total / m.sum(dim=(1, 2)).clamp_min(1.0)).to(reps.dtype)

    def head_from_pooled(self, pooled: torch.Tensor) -> torch.Tensor:
        """The trainable tail on a cached all-MSA mean."""
        return self.head.project(pooled)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head.project(self.backbone_pooled(tokens))


_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _local_hf_dir(name_or_path: str) -> Optional[str]:
    """A local HF checkpoint directory (config.json + weights) or None: hub
    names still select the architecture, and the weights then come from
    the seed (or a run's checkpoint)."""
    if name_or_path and os.path.isdir(name_or_path) and any(
            os.path.isfile(os.path.join(name_or_path, name))
            for name in ("model.safetensors", "pytorch_model.bin")):
        return name_or_path
    return None


def create_sequence_encoder(
    model_name_or_path: str = "facebook/esm2_t33_650M_UR50D",
    output_dim: int = 1024,
    pooling_type: str = "mean",
    proj_type: Optional[str] = None,
    use_logit_scale: bool = False,
    learnable_logit_scale: bool = False,
    pretrained: bool = True,
    use_lora: bool = False,
    lora_r: int = 8,
    lora_alpha: int = 16,
    lora_dropout: float = 0.1,
    lora_target_modules=None,
    frozen: bool = True,
    dtype: Union[str, torch.dtype] = "bfloat16",
    remat: bool = False,
    quantize: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> SequenceEncoder:
    """Build a SequenceEncoder from the config keys of
    configs/model/components/sequence.yaml. `dtype` defaults to that
    config's bfloat16, which the card takes at every head width (float32
    runs there on heads of at most 64, anywhere on the CPU). `use_lora`
    puts rank-`lora_r` adapters on q, k and v (the only target set, as in
    the JAX package: the target list is accepted and not read); `remat`
    checkpoints each layer. Weights
    are PyTorch's default init: load a state_dict (see `convert`) or call
    `esm2.init_esm2_weights_`. A local HF directory with weights sets
    `pretrained_dir` (unless `pretrained` is false), and
    `OneProtModule.load_pretrained` loads them."""
    del lora_target_modules  # q/k/v is the only supported target set
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize={quantize!r}: only 'int8' is supported")
    quant_int8 = quantize == "int8"
    if quant_int8 and (not frozen or use_lora):
        # round() has zero gradient: quantized products are only right
        # under the frozen tower's gradient barrier
        raise ValueError("quantize='int8' requires frozen=True, use_lora=False")
    lora = (LoraConfig(lora_r, float(lora_alpha), lora_dropout) if use_lora
            else None)
    return SequenceEncoder(
        resolve_esm2_config(model_name_or_path), output_dim=output_dim,
        pooling_type=pooling_type, proj_type=proj_type,
        use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, frozen=frozen,
        quant_int8=quant_int8, lora=lora, remat=remat, device=device,
        dtype=_dtype(dtype),
        pretrained_dir=_local_hf_dir(model_name_or_path) if pretrained
        else None)


def create_struct_token_encoder(
    model_name_or_path: str = "facebook/esm2_t12_35M_UR50D",
    output_dim: int = 1024,
    pooling_type: str = "mean",
    proj_type: Optional[str] = "linear",
    use_logit_scale: bool = True,
    learnable_logit_scale: bool = False,
    dtype: Union[str, torch.dtype] = "bfloat16",
    device: Union[str, torch.device] = "cuda",
) -> StructTokenEncoder:
    """Build a StructTokenEncoder from the config keys of
    configs/model/components/struct_token.yaml: the named ESM2 with 21
    more embedding rows. Defaults to bf16 on the card, as
    `create_sequence_encoder`, and takes a local HF directory's weights as
    it does (the new rows drawn from the module's seed)."""
    cfg = resolve_esm2_config(model_name_or_path)
    cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + STRUCT_EXTRA_TOKENS)
    return StructTokenEncoder(
        cfg, output_dim=output_dim, pooling_type=pooling_type,
        proj_type=proj_type, use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, device=device,
        dtype=_dtype(dtype), pretrained_dir=_local_hf_dir(model_name_or_path))


def create_text_encoder(
    model_name_or_path: str = "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract-fulltext",
    output_dim: int = 1024,
    pooling_type: str = "cls",
    proj_type: Optional[str] = "mlp",
    use_logit_scale: bool = True,
    learnable_logit_scale: bool = False,
    use_lora: bool = False,
    lora_r: int = 8,
    lora_alpha: int = 8,
    lora_dropout: float = 0.1,
    lora_target_modules=None,
    frozen: bool = True,
    vocab_size: Optional[int] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
    remat: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> TextEncoder:
    """Build a TextEncoder from the config keys of
    configs/model/components/text.yaml: the BERT size the name resolves to
    (`resolve_bert_config`; BiomedBERT is bert_base), `vocab_size`
    overriding its vocabulary, rank-`lora_r` adapters on q, k and v with
    `use_lora` (the target list is accepted and not read, as in the JAX
    package), per-layer remat with `remat`. `dtype` defaults to the
    config's bfloat16 (the JAX factory defaults to float32, which the card
    runs on heads of at most 64, as the debug `bert_tiny`'s). Weights are
    as built (the layers' default init, zero embedding tables): load a
    state_dict
    (`convert.text_state_dict`) or call `bert.init_bert_weights_`; a local
    HF directory's weights are loaded by `OneProtModule.load_pretrained`."""
    del lora_target_modules  # q/k/v is the only supported target set
    lora = (LoraConfig(lora_r, float(lora_alpha), lora_dropout) if use_lora
            else None)
    return TextEncoder(
        resolve_bert_config(model_name_or_path, vocab_size=vocab_size),
        output_dim=output_dim, pooling_type=pooling_type, proj_type=proj_type,
        use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, frozen=frozen, lora=lora,
        remat=remat, device=device, dtype=_dtype(dtype),
        pretrained_dir=_local_hf_dir(model_name_or_path))


def create_struct_graph_encoder(
    encoder: Optional[Dict] = None,
    output_dim: int = 1024,
    proj_type: Optional[str] = "linear",
    use_logit_scale: bool = True,
    learnable_logit_scale: bool = False,
    dtype: Union[str, torch.dtype] = "float32",
    device: Union[str, torch.device] = "cuda",
) -> StructGraphEncoder:
    """Build a StructGraphEncoder from the config keys of
    configs/model/components/struct_graph.yaml (and pocket.yaml): `encoder`
    holds ProNet's keys (level, out_channels, euler_noise,
    data_augment_eachlayer, dropout, hidden_size, num_layers, num_rbf,
    cutoff). float32 by default, as the JAX factory. Weights are PyTorch's
    default init: load a state_dict (`convert.struct_graph_state_dict`) or
    call `esm2.init_esm2_weights_`."""
    enc = dict(encoder or {})
    enc.pop("_target_", None)
    dropout = float(enc.pop("dropout", 0.25))
    cfg = ProNetConfig(
        out_channels=int(enc.pop("out_channels", output_dim)),
        level=str(enc.pop("level", "backbone")),
        euler_noise=bool(enc.pop("euler_noise", True)),
        data_augment_eachlayer=bool(enc.pop("data_augment_eachlayer", True)),
        hidden_size=int(enc.pop("hidden_size", 128)),
        num_layers=int(enc.pop("num_layers", 4)),
        num_rbf=int(enc.pop("num_rbf", 32)),
        cutoff=float(enc.pop("cutoff", 10.0)))
    return StructGraphEncoder(
        cfg, output_dim=output_dim, proj_type=proj_type,
        use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, dropout=dropout,
        device=device, dtype=_dtype(dtype))


def create_msa_encoder(
    model_name_or_path: str = "esm_msa1b_t12_100M_UR50S",
    output_dim: int = 1024,
    pooling_type: str = "identity",
    proj_type: Optional[str] = "mlp",
    use_logit_scale: bool = True,
    learnable_logit_scale: bool = False,
    num_layers: int = 12,
    hidden_size: int = 768,
    num_heads: int = 12,
    intermediate_size: Optional[int] = None,
    use_all_msa: bool = True,
    dtype: Union[str, torch.dtype] = "bfloat16",
    device: Union[str, torch.device] = "cuda",
) -> MsaEncoder:
    """Build an MsaEncoder with the settings of
    configs/model/components/msa.yaml: esm_msa1b at its published widths
    (12 layers of 768, 12 heads of 64, FFN 4 x 768), identity pooling over
    the all-MSA mean, mlp head, fixed logit scale 1/0.07, bf16 on the card.
    Weights are PyTorch's default init: load a state_dict (see
    `convert.msa_state_dict`) or call `msa_transformer.init_msa_weights_`.
    `pooling_type` is read only without `use_all_msa`, which is not ported
    (pooling the query row alone) and raises."""
    del model_name_or_path, pooling_type  # weights: the checkpoint converter
    if not use_all_msa:
        raise NotImplementedError(
            "MsaEncoder(use_all_msa=False), pooling the query row alone, is "
            "not ported")
    cfg = MsaTransformerConfig(
        num_layers=num_layers, hidden_size=hidden_size, num_heads=num_heads,
        intermediate_size=intermediate_size or 4 * hidden_size)
    return MsaEncoder(
        cfg, output_dim=output_dim, proj_type=proj_type,
        use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, device=device,
        dtype=_dtype(dtype))


def _route(modality: str) -> str:
    return "sequence" if modality in ("sequence", "seqsim") else modality


class OneProtModel(nn.Module):
    """Multi-modal hub: a dict of encoders; 'seqsim' routes to 'sequence'."""

    def __init__(self, encoders: Dict[str, nn.Module]):
        super().__init__()
        unported = set(encoders) - set(PORTED_MODALITIES)
        if unported:
            raise NotImplementedError(
                f"modalities {sorted(unported)} are not ported yet")
        self.encoders = nn.ModuleDict(encoders)

    def forward(self, inputs: torch.Tensor,
                modality: str = "sequence") -> torch.Tensor:
        return self.encoders[_route(modality)](inputs)

    def encode_packed(self, inputs: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, modality: str = "sequence"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed forward of a token encoder: (features [B*P, d], counts)."""
        return self.encoders[_route(modality)].packed_features(
            inputs, segment_ids, num_segments)

    def encode_packed_pooled(self, inputs: torch.Tensor,
                             segment_ids: torch.Tensor, num_segments: int,
                             modality: str = "sequence"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed frozen-cacheable representation: per-segment pooled
        [B*P, d_model] + counts."""
        return self.encoders[_route(modality)].packed_pooled(
            inputs, segment_ids, num_segments)

    def encode_pooled(self, inputs: torch.Tensor,
                      modality: str = "sequence") -> torch.Tensor:
        """Frozen-cacheable representation (transformer + pooling) of
        padded rows: [B, d_model]."""
        return self.encoders[_route(modality)].backbone_pooled(inputs)

    def head_from_pooled(self, pooled: torch.Tensor,
                         modality: str = "sequence") -> torch.Tensor:
        """Trainable head on a cached pooled representation."""
        return self.encoders[_route(modality)].head_from_pooled(pooled)

