"""The residue-graph encoder (counterpart of oneprot_tpu/models/pronet.py:
`ProNetConfig`, `rbf_expand`, `backbone_frames`, `GeoMPLayer`, `ProNet`).

Graphs are dense and padded: node arrays [B, N], fixed-K neighbour lists
[B, N, K] built on the host (`data/graphs.py`). Message passing is a
gather, batched matmuls and a masked sum (`kernels/segment_ops.py`); the
JAX package has no Pallas kernel here, so neither does the port. Edge
features are SE(3)-invariant: a Gaussian RBF of the CA-CA distance, the
neighbour's direction in the residue's backbone frame, the relative frame
rotation and the clipped sequence separation.

Training noise, as ProNet's options: `euler_noise` adds N(0, 0.025^2) to
the relative rotations, `data_augment_eachlayer` to the node states after
each layer; both only in training mode. Their draws come from generators
seeded at each call from (`noise_seed`, stream), the step's seed
(`set_graph_noise_seed`) and a stream number per draw, as `LoraDense`
seeds its dropout; they cannot be JAX's draws.

The struct_graph and pocket components set no dtype, so they compute in
float32, as in the JAX package. On the card that is true float32:
`torch.backends.cuda.matmul.allow_tf32` is left at its default (False).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.kernels.segment_ops import (
    gather_neighbors,
    masked_neighbor_sum,
)
from oneprot_tpu_torch.models.layers import Dense, Embedding, LayerNorm

NUM_AA_TYPES = 21  # 20 amino acids + the unknown/mask token 20
NOISE_STD = 0.025
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
SEP_CLIP = 32


@dataclasses.dataclass(frozen=True)
class ProNetConfig:
    hidden_size: int = 128
    out_channels: int = 1024
    num_layers: int = 4
    num_rbf: int = 32
    cutoff: float = 10.0
    level: str = "backbone"  # "aminoacid" | "backbone" | "allatom"
    dropout: float = 0.25
    euler_noise: bool = True
    data_augment_eachlayer: bool = True

    @property
    def edge_dim(self) -> int:
        """rbf + local direction (3) + relative rotation (9) + separation."""
        return self.num_rbf + 3 + 9 + 1


def rbf_expand(d: torch.Tensor, num_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis over [0, cutoff]: [...] -> [..., num_rbf]."""
    centers = torch.linspace(0.0, cutoff, num_rbf, device=d.device)
    width = cutoff / num_rbf
    return torch.exp(-((d[..., None] - centers) ** 2) / (2.0 * width ** 2))


def backbone_frames(coords_n: torch.Tensor, coords_ca: torch.Tensor,
                    coords_c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-residue orthonormal frames [B, N, 3, 3] whose rows are the local
    axes: e1 along CA->C, e2 the part of CA->N orthogonal to it, e3 =
    e1 x e2. The epsilon is added to each norm, not inside it."""
    u = coords_c - coords_ca
    v = coords_n - coords_ca
    e1 = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + eps)
    w = v - (v * e1).sum(-1, keepdim=True) * e1
    e2 = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + eps)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-2)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one draw: seeded by (the step's seed, the draw's
    stream), so the same step draws the same numbers."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 65_537 + stream) % 2**63)
    return gen


def _normal(shape, seed: int, stream: int, device) -> torch.Tensor:
    """N(0, 1) f32 draws of one (seed, stream)."""
    return torch.randn(shape, generator=_generator(seed, stream, device),
                       device=device)


class GeoMPLayer(nn.Module):
    """One message-passing layer over dense padded neighbourhoods: gated
    messages from [h_i, h_j, e_ij], their masked sum over the degree
    (clamped at 1), an update MLP and a residual LayerNorm."""

    def __init__(self, hidden_size: int, edge_dim: int, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = hidden_size
        kw = dict(device=device, dtype=dtype, param_dtype=torch.float32)
        self.msg1 = Dense(2 * H + edge_dim, H, **kw)
        self.msg2 = Dense(H, H, **kw)
        self.gate = Dense(2 * H + edge_dim, H, **kw)
        self.upd1 = Dense(2 * H, H, **kw)
        self.upd2 = Dense(H, H, **kw)
        self.ln = LayerNorm(H, eps=LN_EPS, **kw)

    def forward(self, h: torch.Tensor, edge_feats: torch.Tensor,
                neighbor_idx: torch.Tensor,
                neighbor_mask: torch.Tensor) -> torch.Tensor:
        h_j = gather_neighbors(h, neighbor_idx)
        h_i = h[:, :, None, :].expand_as(h_j)
        msg_in = torch.cat([h_i, h_j, edge_feats.to(h.dtype)], dim=-1)
        msg = self.msg2(F.silu(self.msg1(msg_in)))
        msg = msg * torch.sigmoid(self.gate(msg_in))
        agg = masked_neighbor_sum(msg, neighbor_mask)
        deg = neighbor_mask.to(h.dtype).sum(-1, keepdim=True)
        agg = agg / deg.clamp_min(1.0)
        upd = self.upd2(F.silu(self.upd1(torch.cat([h, agg], dim=-1))))
        return self.ln(h + upd)


class ProNet(nn.Module):
    """Graph dict -> pooled embedding [B, out_channels]. The dict holds
    `aa` [B, N], `coords_ca`, `coords_n`, `coords_c` [B, N, 3], `bb_embs`
    [B, N, 6], optionally `side_chain_embs` [B, N, 8], `node_mask` [B, N],
    `neighbor_idx` and `neighbor_mask` [B, N, K]."""

    def __init__(self, config: ProNetConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        H = config.hidden_size
        kw = dict(device=device, dtype=dtype, param_dtype=torch.float32)
        self.aa_embed = Embedding(NUM_AA_TYPES, H, **kw)
        if config.level in ("backbone", "allatom"):
            self.bb_proj = Dense(6, H, **kw)
        if config.level == "allatom":
            self.sc_proj = Dense(8, H, **kw)
        self.layers = nn.ModuleList(
            GeoMPLayer(H, config.edge_dim, device=device, dtype=dtype)
            for _ in range(config.num_layers))
        self.readout1 = Dense(H, H, **kw)
        self.readout2 = Dense(H, config.out_channels, **kw)
        self.compute_dtype = dtype
        self.noise_seed = 0

    def edge_features(self, graph: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, N, K, edge_dim] invariant edge features, zero on padded
        neighbours (with the Euler-angle noise in training mode)."""
        cfg = self.config
        ca, n, c = (graph[k].float() for k in ("coords_ca", "coords_n",
                                               "coords_c"))
        idx = graph["neighbor_idx"].long()
        B, N, K = idx.shape
        frames = backbone_frames(n, ca, c)
        rel = gather_neighbors(ca, idx) - ca[:, :, None, :]
        dist = torch.linalg.norm(rel + 1e-12, dim=-1)
        rbf = rbf_expand(dist, cfg.num_rbf, cfg.cutoff)
        # the neighbour's direction in the residue's frame
        local_dir = torch.einsum("bnij,bnkj->bnki", frames, rel) / (
            dist[..., None] + 1e-8)
        # the relative orientation R_i R_j^T
        frames_j = gather_neighbors(frames.reshape(B, N, 9), idx).reshape(
            B, N, K, 3, 3)
        rel_rot = torch.einsum("bnij,bnkmj->bnkim", frames, frames_j).reshape(
            B, N, K, 9)
        if cfg.euler_noise and self.training:
            rel_rot = rel_rot + NOISE_STD * _normal(
                rel_rot.shape, self.noise_seed, 0, rel_rot.device)
        sep = idx - torch.arange(N, device=idx.device)[None, :, None]
        sep = sep.clamp(-SEP_CLIP, SEP_CLIP).float() / SEP_CLIP
        edge = torch.cat([rbf, local_dir, rel_rot, sep[..., None]], dim=-1)
        return edge * graph["neighbor_mask"][..., None].to(edge.dtype)

    def forward(self, graph: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        dt = self.compute_dtype
        node_mask = graph["node_mask"][..., None].to(dt)
        h = self.aa_embed(graph["aa"].long())
        if cfg.level in ("backbone", "allatom"):
            h = h + self.bb_proj(graph["bb_embs"])
        if cfg.level == "allatom" and "side_chain_embs" in graph:
            h = h + self.sc_proj(graph["side_chain_embs"])
        h = h * node_mask
        edge = self.edge_features(graph)
        idx, nmask = graph["neighbor_idx"], graph["neighbor_mask"]
        for i, layer in enumerate(self.layers):
            h = layer(h, edge, idx, nmask)
            if cfg.data_augment_eachlayer and self.training:
                h = h + NOISE_STD * _normal(h.shape, self.noise_seed, 1 + i,
                                            h.device).to(dt)
            h = h * node_mask
        pooled = (h * node_mask).sum(1) / node_mask.sum(1).clamp_min(1.0)
        return self.readout2(F.silu(self.readout1(pooled)))


def graph_dropout(x: torch.Tensor, rate: float, seed: int,
                  stream: int) -> torch.Tensor:
    """Inverted dropout (keep 1 - rate, kept values / (1 - rate)) with its
    mask from the (seed, stream) generator."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=_generator(seed, stream, x.device),
                      device=x.device) < keep
    return torch.where(kept, x / keep, 0.0)


def set_graph_noise_seed(model: nn.Module, seed: int) -> None:
    """Seed the training noise and dropout of every graph tower for the
    next forward."""
    for mod in model.modules():
        if hasattr(mod, "noise_seed"):
            mod.noise_seed = seed


def dropout_stream(config: ProNetConfig) -> int:
    """The encoder dropout's stream: after the Euler noise (0) and the
    per-layer noise (1..num_layers)."""
    return config.num_layers + 1

