"""Serving API: embed sequences with a hub model and retrieve by cosine.

Counterpart of oneprot_tpu/serving.py for the sequence modality:

    embedder = OneProtEmbedder(model)          # a models.encoders.OneProtModel
    feats = embedder.embed_sequences(["MKTAY...", ...])
    scores, idx = embedder.retrieve(feats, pool_feats, k=10)

Batches are padded to length buckets, so the model sees a few fixed shapes.
The embedder runs where the model's weights live.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from oneprot_tpu_torch.data.common import pick_bucket
from oneprot_tpu_torch.data.tokenizers import esm2_tokenizer
from oneprot_tpu_torch.models.heads import l2_normalize

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024)

Array = Union[np.ndarray, torch.Tensor]


class OneProtEmbedder:
    def __init__(self, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.model = model
        self.buckets = list(buckets)
        self.seq_tok = esm2_tokenizer()
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def embed_sequences(self, sequences: Sequence[str], max_length: int = 1024,
                        batch_size: int = 32) -> np.ndarray:
        """[n, output_dim] f32 embeddings, one forward per batch of
        `batch_size`, each padded to the smallest bucket that fits it."""
        out = []
        for start in range(0, len(sequences), batch_size):
            chunk = list(sequences[start:start + batch_size])
            pad = pick_bucket(max(len(s) + 2 for s in chunk), self.buckets,
                              max_length)
            ids = torch.from_numpy(
                self.seq_tok(chunk, max_length=max_length, padding=pad))
            feats = self.model(ids.to(self.device, torch.long), "sequence")
            out.append(feats.float().cpu().numpy())
        return np.concatenate(out, axis=0)

    @torch.inference_mode()
    def retrieve(self, queries: Array, pool: Array,
                 k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k cosine retrieval on the model's device. For repeated queries
        against one pool, pass the pool as a tensor already on the device."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        p = torch.as_tensor(pool, dtype=torch.float32).to(self.device)
        scores, idx = torch.topk(l2_normalize(q) @ l2_normalize(p).T, k, dim=-1)
        return scores.cpu().numpy(), idx.cpu().numpy()
