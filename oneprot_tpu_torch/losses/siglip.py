"""SigLIP (pairwise sigmoid) losses, single process (counterpart of
oneprot_tpu/losses/siglip.py: `_pair_loss`, `siglip_loss`,
`_pair_loss_masked`, `siglip_loss_masked` without an axis name).

Every pair of a batch is a binary problem: label +1 on the diagonal, -1
off it, loss -sum(log_sigmoid(label * logit)) / B over f32 logits from the
clip module's `_f32_logits`. The logit scale defaults to 1.0 and the bias
to None: the towers' heads scale their features already. The ring of
negatives over several processes (each process's features meet every
other's once) is ROADMAP.md Queue 1 item 6: under an initialised
torch.distributed group of more than one process the losses raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from oneprot_tpu_torch.losses.clip import Scale, _f32_logits


def _labels(n: int, m: int, negative_only: bool, device) -> torch.Tensor:
    """f32 [n, m]: -1 everywhere, +1 on the diagonal unless negative_only."""
    labels = -torch.ones(n, m, device=device)
    if not negative_only:
        labels = labels + 2.0 * torch.eye(n, m, device=device)
    return labels


def _logits(modality_features, sequence_features, logit_scale, logit_bias):
    logits = logit_scale * _f32_logits(modality_features, sequence_features)
    return logits if logit_bias is None else logits + logit_bias


def _pair_loss(modality_features: torch.Tensor,
               sequence_features: torch.Tensor, logit_scale: Scale,
               logit_bias: Optional[torch.Tensor],
               negative_only: bool = False) -> torch.Tensor:
    """-sum(log_sigmoid(labels * logits)) / B."""
    logits = _logits(modality_features, sequence_features, logit_scale,
                     logit_bias)
    labels = _labels(*logits.shape, negative_only, logits.device)
    return -F.logsigmoid(labels * logits).sum() / modality_features.shape[0]


def _pair_loss_masked(modality_features: torch.Tensor,
                      sequence_features: torch.Tensor,
                      valid_rows: torch.Tensor, valid_cols: torch.Tensor,
                      logit_scale: Scale, logit_bias: Optional[torch.Tensor],
                      negative_only: bool = False) -> torch.Tensor:
    """`_pair_loss` over a PACKED block: each pair weighs valid_row x
    valid_col, and the sum is divided by max(valid rows, 1). With every
    slot valid this is `_pair_loss`."""
    valid_rows, valid_cols = valid_rows.float(), valid_cols.float()
    logits = _logits(modality_features, sequence_features, logit_scale,
                     logit_bias)
    labels = _labels(*logits.shape, negative_only, logits.device)
    w = valid_rows[:, None] * valid_cols[None, :]
    return (-(w * F.logsigmoid(labels * logits)).sum()
            / valid_rows.sum().clamp_min(1.0))


def _one_process() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world > 1:
            raise NotImplementedError(
                f"SigLIP over {world} processes (the ring of negatives) is "
                "not ported yet: ROADMAP.md Queue 1 item 6 (several cards)")


def siglip_loss(modality_features: torch.Tensor,
                sequence_features: torch.Tensor, logit_scale: Scale = 1.0,
                logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SigLIP over one process's batch: features [B, D]."""
    _one_process()
    return _pair_loss(modality_features, sequence_features, logit_scale,
                      logit_bias)


def siglip_loss_masked(modality_features: torch.Tensor,
                       sequence_features: torch.Tensor, valid: torch.Tensor,
                       logit_scale: Scale = 1.0,
                       logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SigLIP over a PACKED batch's slots (valid [N], 1 = a real pair):
    empty slots are neither rows nor columns. With every slot valid this
    equals `siglip_loss`."""
    _one_process()
    return _pair_loss_masked(modality_features, sequence_features, valid,
                             valid, logit_scale, logit_bias)
