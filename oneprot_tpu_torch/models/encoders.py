"""Sequence encoder and the hub model (counterpart of
oneprot_tpu/models/encoders.py: `SequenceEncoder`, `create_sequence_encoder`,
`OneProtModel`).

Only the sequence modality is ported so far; `OneProtModel` routes
'sequence' and 'seqsim' to it and raises for the other modalities.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from oneprot_tpu_torch.models.esm2 import Esm2, Esm2Config, resolve_esm2_config
from oneprot_tpu_torch.models.heads import EncoderHead


class SequenceEncoder(nn.Module):
    """ESM2 hub encoder (sequence + seqsim modalities)."""

    def __init__(self, config: Esm2Config, output_dim: int,
                 pooling_type: str = "mean", proj_type: Optional[str] = None,
                 use_logit_scale: bool = False,
                 learnable_logit_scale: bool = False, frozen: bool = True,
                 quant_int8: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.transformer = Esm2(config, quant_int8, **kw)
        self.head = EncoderHead(config.hidden_size, output_dim, proj_type,
                                pooling_type, use_logit_scale,
                                learnable_logit_scale, **kw)
        if frozen:
            # a gradient barrier: no autograd graph is kept for the hub
            self.transformer.requires_grad_(False)

    def backbone_pooled(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Transformer -> pooling: the representation a frozen hub can cache."""
        mask = input_ids != self.config.pad_token_id
        return self.head.pool(self.transformer(input_ids), mask)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.head.project(self.backbone_pooled(input_ids))


_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def create_sequence_encoder(
    model_name_or_path: str = "facebook/esm2_t33_650M_UR50D",
    output_dim: int = 1024,
    pooling_type: str = "mean",
    proj_type: Optional[str] = None,
    use_logit_scale: bool = False,
    learnable_logit_scale: bool = False,
    frozen: bool = True,
    dtype: Union[str, torch.dtype] = "bfloat16",
    quantize: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> SequenceEncoder:
    """Build a SequenceEncoder from the config keys of
    configs/model/components/sequence.yaml. `dtype` defaults to that
    config's bfloat16, the one dtype the card's flash-MHA kernel takes
    (float32 runs on the CPU). Weights are PyTorch's default init: load a
    state_dict (see `convert`) or call `esm2.init_esm2_weights_`."""
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize={quantize!r}: only 'int8' is supported")
    quant_int8 = quantize == "int8"
    if quant_int8 and not frozen:
        # round() has zero gradient: quantized products are only right
        # under the frozen tower's gradient barrier
        raise ValueError("quantize='int8' requires frozen=True")
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    return SequenceEncoder(
        resolve_esm2_config(model_name_or_path), output_dim=output_dim,
        pooling_type=pooling_type, proj_type=proj_type,
        use_logit_scale=use_logit_scale,
        learnable_logit_scale=learnable_logit_scale, frozen=frozen,
        quant_int8=quant_int8, device=device, dtype=dtype)


class OneProtModel(nn.Module):
    """Multi-modal hub: a dict of encoders; 'seqsim' routes to 'sequence'."""

    def __init__(self, encoders: Dict[str, nn.Module]):
        super().__init__()
        unported = set(encoders) - {"sequence"}
        if unported:
            raise NotImplementedError(
                f"modalities {sorted(unported)} are not ported yet")
        self.encoders = nn.ModuleDict(encoders)

    def forward(self, inputs: torch.Tensor,
                modality: str = "sequence") -> torch.Tensor:
        if modality in ("sequence", "seqsim"):
            modality = "sequence"
        return self.encoders[modality](inputs)
