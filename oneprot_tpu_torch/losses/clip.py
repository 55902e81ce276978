"""Symmetric InfoNCE (CLIP) losses (counterpart of
oneprot_tpu/losses/clip.py: `clip_loss`, `clip_loss_masked`).

With `axis_name` set (the JAX functions' "data" axis: here the mesh's data
group, the whole world without a model axis) the negatives are the global
batch's: each rank
gathers every rank's features with `all_gather_with_grad`. A rank then
returns its share of the global loss: the mean of the shares over the
ranks is the loss of the JAX function on the concatenated batch, and the
gradient all-reduce-mean of `ClippedOptimizer` turns the ranks' gradients
into that loss's gradient (the JAX function's `pmean` is that mean).

- `clip_loss(local_loss=True)`: this rank's rows against the global
  columns, labels arange(b) + b * rank: its CE mean is its share.
- `clip_loss(local_loss=False)`: the full global logits on every rank;
  the share is the whole loss.
- `clip_loss_masked`: the packed batch's loss over the global pack, as
  the JAX step computes it on the concatenated batch: the valid flags are
  gathered with the features, the normaliser is the global valid count,
  and the share is world x this rank's rows' sum / that count.

Logits come from one f32 product (`_f32_logits`), so every path scales the
same f32 values.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from oneprot_tpu_torch.core.collectives import all_gather_with_grad
from oneprot_tpu_torch.core.mesh import data_world

Scale = Union[float, torch.Tensor]


def _f32_logits(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """rows @ cols.T in f32."""
    return rows.float() @ cols.float().T


def _gathered(axis_name: Optional[str]):
    """(this rank, the gather) of the loss: with an axis, the data rank and
    `all_gather_with_grad` over the data group; without, rank 0 and an
    identity node in its
    place, so that both build one graph (a world of one then computes,
    and accumulates its gradients, exactly as one process does)."""
    if axis_name is None:
        return 0, lambda x: x.view_as(x)
    return data_world()[1], all_gather_with_grad


def clip_loss(modality_features: torch.Tensor, sequence_features: torch.Tensor,
              logit_scale: Scale = 1.0, axis_name: Optional[str] = None,
              local_loss: bool = True) -> torch.Tensor:
    """Mean of the two directions' softmax cross entropies, label i for row
    i. Features [B, D] (L2-normalised, maybe scaled). The gather always
    carries the gradient, as in the JAX package."""
    ce = torch.nn.functional.cross_entropy
    rank, gather = _gathered(axis_name)
    all_mod, all_seq = gather(modality_features), gather(sequence_features)
    if local_loss or axis_name is None:
        b = modality_features.shape[0]
        labels = torch.arange(b, device=modality_features.device) + b * rank
        return 0.5 * (
            ce(logit_scale * _f32_logits(modality_features, all_seq), labels)
            + ce(logit_scale * _f32_logits(sequence_features, all_mod), labels))
    logits = logit_scale * _f32_logits(all_mod, all_seq)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (ce(logits, labels) + ce(logits.T, labels))


def clip_loss_masked(modality_features: torch.Tensor,
                     sequence_features: torch.Tensor, valid: torch.Tensor,
                     logit_scale: Scale = 1.0,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """Symmetric InfoNCE over a PACKED batch: rows of empty pack slots
    (valid 0) weigh nothing as positives and their logit columns sit at
    -1e9 as negatives. With every row valid this equals `clip_loss`. With
    `axis_name`, this rank's share of the loss over every rank's pack
    (each rank holds the same number of slots)."""
    valid = valid.float()
    rank, gather = _gathered(axis_name)
    n = data_world()[0] if axis_name else 1
    all_mod, all_seq = gather(modality_features), gather(sequence_features)
    all_valid = gather(valid)
    b = valid.shape[0]
    rows = slice(rank * b, (rank + 1) * b)
    neg_mask = (1.0 - all_valid) * -1e9

    def masked_ce(logits):
        logits = logits + neg_mask[None, :]
        picked = torch.diagonal(logits[:, rows])
        per_row = (torch.logsumexp(logits, dim=-1) - picked) * valid
        return per_row.sum() * float(n) / all_valid.sum().clamp_min(1.0)

    return 0.5 * (
        masked_ce(logit_scale * _f32_logits(modality_features, all_seq))
        + masked_ce(logit_scale * _f32_logits(sequence_features, all_mod)))
