"""Serving API: embed sequences or MSAs with a hub model and retrieve by
cosine.

Counterpart of oneprot_tpu/serving.py for the sequence and MSA modalities:

    embedder = OneProtEmbedder(model)          # a models.encoders.OneProtModel
    feats = embedder.embed_sequences(["MKTAY...", ...])
    msa_feats = embedder.embed_msas(["a.a3m", "b.a3m"])
    scores, idx = embedder.retrieve(feats, pool_feats, k=10)

Batches are padded to length buckets (MSAs: columns to a bucket, rows to
the MSA depth), so the model sees a few fixed shapes. The embedder runs
where the model's weights live, in eval mode (no LoRA dropout), as the JAX
embedder runs deterministic.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from oneprot_tpu_torch.data.common import pick_bucket
from oneprot_tpu_torch.data.msa_io import greedy_select, read_msa
from oneprot_tpu_torch.data.tokenizers import MsaBatchConverter, esm2_tokenizer
from oneprot_tpu_torch.models.heads import l2_normalize

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024)

Array = Union[np.ndarray, torch.Tensor]


class OneProtEmbedder:
    def __init__(self, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.model = model.eval()
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
    def embed_msas(self, a3m_paths: Sequence[str], msa_depth: int = 16,
                   max_length: int = 1024, batch_size: int = 4) -> np.ndarray:
        """[n, output_dim] f32 embeddings of .a3m MSAs: each is read with
        its insertions removed and cut to `msa_depth` rows by greedy
        Hamming diversity (query first); a batch of `batch_size` pads its
        rows to `msa_depth` and its columns to the smallest bucket that
        fits (<cls> + at most max_length - 2 residues), and runs the MSA
        tower once."""
        converter = MsaBatchConverter()
        out = []
        for start in range(0, len(a3m_paths), batch_size):
            msas = [greedy_select(read_msa(p), num_seqs=msa_depth)
                    for p in a3m_paths[start:start + batch_size]]
            longest = max((min(len(s), max_length - 2) + 1
                           for m in msas for _, s in m), default=2)
            cols = pick_bucket(longest, self.buckets, max_length)
            tokens = converter(msas, max_rows=msa_depth,
                               pad_rows_to=msa_depth, pad_cols_to=cols)
            ids = torch.from_numpy(tokens[:, :, :max_length])
            feats = self.model(ids.to(self.device, torch.long), "msa")
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
