"""Symmetric InfoNCE (CLIP) losses, single process (counterpart of
oneprot_tpu/losses/clip.py: `clip_loss` with axis_name=None,
`clip_loss_masked`). The all-gather variant over several processes is not
ported yet.

Logits come from one f32 product (`_f32_logits`), so every path scales the
same f32 values.
"""

from __future__ import annotations

from typing import Union

import torch

Scale = Union[float, torch.Tensor]


def _f32_logits(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """rows @ cols.T in f32."""
    return rows.float() @ cols.float().T


def clip_loss(modality_features: torch.Tensor, sequence_features: torch.Tensor,
              logit_scale: Scale = 1.0) -> torch.Tensor:
    """Mean of the two directions' softmax cross entropies, label i for row
    i. Features [B, D] (L2-normalised, maybe scaled)."""
    logits = logit_scale * _f32_logits(modality_features, sequence_features)
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(logits, labels)
                  + ce(logit_scale * _f32_logits(sequence_features,
                                                 modality_features), labels))


def clip_loss_masked(modality_features: torch.Tensor,
                     sequence_features: torch.Tensor, valid: torch.Tensor,
                     logit_scale: Scale = 1.0) -> torch.Tensor:
    """Symmetric InfoNCE over a PACKED batch: rows of empty pack slots
    (valid 0) weigh nothing as positives and their logit columns sit at
    -1e9 as negatives. With every row valid this equals `clip_loss`."""
    valid = valid.float()
    neg_mask = (1.0 - valid) * -1e9

    def masked_ce(logits):
        logits = logits + neg_mask[None, :]
        per_row = (torch.logsumexp(logits, dim=-1)
                   - torch.diagonal(logits)) * valid
        return per_row.sum() / valid.sum().clamp_min(1.0)

    return 0.5 * (
        masked_ce(logit_scale * _f32_logits(modality_features,
                                            sequence_features))
        + masked_ce(logit_scale * _f32_logits(sequence_features,
                                              modality_features)))
