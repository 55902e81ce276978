"""SigLIP (pairwise sigmoid) losses (counterpart of
oneprot_tpu/losses/siglip.py: `_pair_loss`, `siglip_loss`,
`_pair_loss_masked`, `siglip_loss_masked`).

Every pair of a batch is a binary problem: label +1 on the diagonal, -1
off it, loss -sum(log_sigmoid(label * logit)) / B over f32 logits from the
clip module's `_f32_logits`. The logit scale defaults to 1.0 and the bias
to None: the towers' heads scale their features already.

With `axis_name` set, the negatives ring over the ranks of the mesh's data
group (the whole world without a model axis): the local block (positives
and negatives), then ranks - 1 negative-only blocks, one per other rank's
sequence features,
passed along by `ring_shift` (the JAX `ppermute`). `bidir=True` runs two
counter-rotating chains and a last hop for an odd remainder;
`bidir=False` one chain. Each hop of the masked variant carries a rank's
features and valid flags together (one tensor). A rank returns its own
sum, normalised by its own (valid) rows as in the JAX function; the JAX
`pmean` over ranks is the gradient all-reduce-mean of `ClippedOptimizer`
and the trainer's mean of the logged value.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from oneprot_tpu_torch.core.collectives import ring_shift
from oneprot_tpu_torch.core.mesh import data_world
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


def _ring(loss: torch.Tensor, carried: torch.Tensor,
          negatives: Callable[[torch.Tensor], torch.Tensor],
          bidir: bool) -> torch.Tensor:
    """Add the negative-only block of every other rank's `carried` tensor,
    in the JAX function's schedule."""
    n, _ = data_world()
    if bidir:
        to_left = to_right = carried
        num_bidir, remainder = divmod(n - 1, 2)
        for _ in range(num_bidir):
            from_right = ring_shift(to_left, -1)   # the left-moving chain
            from_left = ring_shift(to_right, +1)   # the right-moving chain
            loss = loss + negatives(from_right) + negatives(from_left)
            to_left, to_right = from_right, from_left
        if remainder:
            loss = loss + negatives(ring_shift(to_right, +1))
    else:
        for _ in range(n - 1):
            carried = ring_shift(carried, +1)
            loss = loss + negatives(carried)
    return loss


def siglip_loss(modality_features: torch.Tensor,
                sequence_features: torch.Tensor, logit_scale: Scale = 1.0,
                logit_bias: Optional[torch.Tensor] = None,
                axis_name: Optional[str] = None,
                bidir: bool = True) -> torch.Tensor:
    """SigLIP over a batch, features [B, D]; with `axis_name`, this rank's
    rows against every rank's sequence features (the ring)."""
    loss = _pair_loss(modality_features, sequence_features, logit_scale,
                      logit_bias)
    if axis_name is None or data_world()[0] == 1:
        return loss
    return _ring(loss, sequence_features,
                 lambda f: _pair_loss(modality_features, f, logit_scale,
                                      logit_bias, negative_only=True), bidir)


def siglip_loss_masked(modality_features: torch.Tensor,
                       sequence_features: torch.Tensor, valid: torch.Tensor,
                       logit_scale: Scale = 1.0,
                       logit_bias: Optional[torch.Tensor] = None,
                       axis_name: Optional[str] = None,
                       bidir: bool = True) -> torch.Tensor:
    """SigLIP over a PACKED batch's slots (valid [N], 1 = a real pair):
    empty slots are neither rows nor columns. With every slot valid this
    equals `siglip_loss`."""
    loss = _pair_loss_masked(modality_features, sequence_features, valid,
                             valid, logit_scale, logit_bias)
    if axis_name is None or data_world()[0] == 1:
        return loss
    d = sequence_features.shape[-1]

    def negatives(pair: torch.Tensor) -> torch.Tensor:
        return _pair_loss_masked(modality_features, pair[:, :d], valid,
                                 pair[:, d], logit_scale, logit_bias,
                                 negative_only=True)

    pair = torch.cat([sequence_features,
                      valid.to(sequence_features.dtype)[:, None]], 1)
    return _ring(loss, pair, negatives, bidir)
