"""Segment and neighbourhood reductions of graph message passing
(counterpart of oneprot_tpu/kernels/segment_ops.py).

The JAX module is plain jnp with no Pallas kernel: ProNet runs on dense
padded neighbourhoods [B, N, K] (gather, batched matmul, masked sum), and
the ragged `segment_*` functions delegate to `jax.ops.segment_*`. So these
are plain PyTorch ops too (`gather`, `index_add_`, `scatter_reduce`), on
any device. Means and the softmax's denominator accumulate in f32.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of `data` into `num_segments` buckets (ids outside
    [0, num_segments) are dropped, as `jax.ops.segment_sum` drops them)."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids[keep], data[keep])


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 1e-9) -> torch.Tensor:
    """Per-segment mean, totals and counts in f32 (a bf16 count stops at
    256), cast back to the data's dtype; an empty segment gives 0."""
    totals = segment_sum(data.float(), segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[0], device=data.device),
                         segment_ids, num_segments)
    return (totals / counts.clamp_min(eps)[..., None]).to(data.dtype)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; an empty segment gives -inf (the identity of max,
    as in `jax.ops.segment_max` on floats)."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = ids[keep].reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(
        data[keep])
    return out.scatter_reduce_(0, idx, data[keep], "amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax within each segment, stable by the segment's max, with the
    exponentials and their sum in f32; cast back to the logits' dtype."""
    ids = segment_ids.long()
    maxes = segment_max(logits, segment_ids, num_segments)
    exp = torch.exp((logits - maxes[ids]).float())
    denom = segment_sum(exp, segment_ids, num_segments)
    return (exp / denom[ids].clamp_min(1e-9)).to(logits.dtype)


def masked_neighbor_sum(messages: torch.Tensor,
                        neighbor_mask: torch.Tensor) -> torch.Tensor:
    """messages [B, N, K, D], mask [B, N, K] -> the sum over the real
    neighbours, [B, N, D]."""
    return (messages * neighbor_mask[..., None].to(messages.dtype)).sum(2)


def masked_neighbor_mean(messages: torch.Tensor, neighbor_mask: torch.Tensor,
                         eps: float = 1e-9) -> torch.Tensor:
    """The mean over the real neighbours, the count in f32."""
    totals = masked_neighbor_sum(messages, neighbor_mask)
    counts = neighbor_mask.float().sum(2)[..., None]
    return (totals / counts.clamp_min(eps)).to(messages.dtype)


def gather_neighbors(node_feats: torch.Tensor,
                     neighbor_idx: torch.Tensor) -> torch.Tensor:
    """out[b, n, k] = node_feats[b, neighbor_idx[b, n, k]]: [B, N, D] and
    [B, N, K] -> [B, N, K, D]."""
    B, N, K = neighbor_idx.shape
    D = node_feats.shape[-1]
    flat = neighbor_idx.reshape(B, N * K, 1).long().expand(B, N * K, D)
    return torch.gather(node_feats, 1, flat).reshape(B, N, K, D)
