"""Serving API: embed sequences, texts, MSAs or structure graphs with a
hub model and retrieve by cosine.

Counterpart of oneprot_tpu/serving.py for every modality:

    embedder = OneProtEmbedder(model)          # a models.encoders.OneProtModel
    embedder = OneProtEmbedder.from_run_dir("logs/train/runs/<stamp>")
    feats = embedder.embed_sequences(["MKTAY...", ...])
    st_feats = embedder.embed_struct_tokens(["dpvlqwd...", ...])
    text_feats = embedder.embed_texts(["a membrane protein ...", ...])
    msa_feats = embedder.embed_msas(["a.a3m", "b.a3m"])
    graph_feats = embedder.embed_graphs("seqstruc.h5", ["P1", "P2"])
    scores, idx = embedder.retrieve(feats, pool_feats, k=10)

Batches are padded to length buckets (MSAs: columns to a bucket, rows to
the MSA depth), so the model sees a few fixed shapes. A text batch's
bucket is picked from its longest text's characters + 2, not its tokens,
as the JAX embedder picks it; a text whose tokens outrun the bucket is
cut to it. The embedder runs
where the model's weights live, in eval mode (no LoRA dropout), as the JAX
embedder runs deterministic. `from_run_dir` rebuilds a trained run's
model on the device of its `trainer.accelerator` and restores `best` (or
`ckpt`: a checkpoint name, directory or a reference Lightning `.ckpt`); a
checkpoint that is not there raises FileNotFoundError, where the JAX
embedder warns and serves random weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from oneprot_tpu_torch.data.common import H5, pick_bucket
from oneprot_tpu_torch.data.graphs import protein_to_padded_graph, stack_graphs
from oneprot_tpu_torch.data.msa_io import greedy_select, read_msa
from oneprot_tpu_torch.data.tokenizers import (
    MsaBatchConverter,
    esm2_tokenizer,
    resolve_text_tokenizer,
    struct_token_tokenizer,
)
from oneprot_tpu_torch.models.heads import l2_normalize

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024)

Array = Union[np.ndarray, torch.Tensor]


class OneProtEmbedder:
    def __init__(self, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 text_vocab: str = "tiny"):
        self.model = model.eval()
        self.buckets = list(buckets)
        self.seq_tok = esm2_tokenizer()
        self.struct_tok = struct_token_tokenizer()
        self.text_tok = resolve_text_tokenizer(text_vocab)
        self.device = next(model.parameters()).device

    @classmethod
    def from_run_dir(cls, run_dir: str, ckpt: str = "best",
                     device=None) -> "OneProtEmbedder":
        """The embedder of a trained run: its model restored from `ckpt`,
        its training buckets (else the defaults) and its `text_vocab`."""
        from oneprot_tpu_torch.evaluation.retrieval_eval import (
            load_trained_module,
        )
        from oneprot_tpu_torch.train.checkpoint import restore_any
        from oneprot_tpu_torch.utils.loggers import get_pylogger

        module, cfg = load_trained_module(run_dir, device)
        get_pylogger(__name__).info(
            f"loaded {restore_any(module, run_dir, ckpt)}")
        buckets = (cfg.get("data", {}) or {}).get("buckets") or DEFAULT_BUCKETS
        text_vocab = str((cfg.get("paths", {}) or {}).get("text_vocab",
                                                           "tiny"))
        return cls(module.model, buckets=[int(b) for b in buckets],
                   text_vocab=text_vocab)

    @torch.inference_mode()
    def _embed_tokens(self, modality: str, tok, items: Sequence[str],
                      max_length: int, batch_size: int) -> np.ndarray:
        """[n, output_dim] f32 embeddings, one forward per batch of
        `batch_size`, each padded to the smallest bucket that fits its
        longest item's characters + 2."""
        out = []
        for start in range(0, len(items), batch_size):
            chunk = list(items[start:start + batch_size])
            pad = pick_bucket(max(len(s) + 2 for s in chunk), self.buckets,
                              max_length)
            ids = torch.from_numpy(tok(chunk, max_length=max_length,
                                       padding=pad))
            feats = self.model(ids.to(self.device, torch.long), modality)
            out.append(feats.float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def embed_sequences(self, sequences: Sequence[str], max_length: int = 1024,
                        batch_size: int = 32) -> np.ndarray:
        """Protein sequences through the hub: [n, output_dim] f32."""
        return self._embed_tokens("sequence", self.seq_tok, sequences,
                                  max_length, batch_size)

    def embed_struct_tokens(self, tdi_strings: Sequence[str],
                            max_length: int = 1024,
                            batch_size: int = 32) -> np.ndarray:
        """SaProt 3Di structure-token strings through the struct-token
        tower: [n, output_dim] f32."""
        return self._embed_tokens("struct_token", self.struct_tok,
                                  tdi_strings, max_length, batch_size)

    def embed_texts(self, texts: Sequence[str], max_length: int = 512,
                    batch_size: int = 32) -> np.ndarray:
        """Texts through the text tower (WordPiece, at most `max_length`
        tokens): [n, output_dim] f32."""
        return self._embed_tokens("text", self.text_tok, texts, max_length,
                                  batch_size)

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

    def embed_graphs(self, h5_path: str, ids: Sequence[str],
                     modality: str = "struct_graph", max_residues: int = 256,
                     max_neighbors: int = 24,
                     batch_size: int = 16) -> np.ndarray:
        """[n, output_dim] f32 embeddings of residue graphs (struct_graph)
        or pocket cut-outs (pocket) read from a `seqstruc.h5`-layout file
        (chain A of each id; `structure_io.ingest_files` writes one from
        PDB or mmCIF files)."""
        h5 = H5.get(h5_path)
        structures = []
        for pid in ids:
            node = h5[pid]["structure"]["0"]["A"]
            poly = node["polypeptide"]
            structures.append((node["residues"]["seq1"][()].decode("utf-8"),
                               poly["type"][()], poly["atom_amino_id"][()],
                               np.asarray(poly["xyz"][()], np.float64)))
        return self.embed_structures(structures, modality, max_residues,
                                     max_neighbors, batch_size)

    @torch.inference_mode()
    def embed_structures(self, structures: Sequence[Tuple], modality: str =
                         "struct_graph", max_residues: int = 256,
                         max_neighbors: int = 24,
                         batch_size: int = 16) -> np.ndarray:
        """`embed_graphs` on structures in memory: (sequence, atom names,
        atom residue ids, xyz) each, as `structure_io.Chain` holds them. A
        batch pads every graph to `max_residues`, so the tower sees one
        shape."""
        out = []
        for start in range(0, len(structures), batch_size):
            batch = stack_graphs([
                protein_to_padded_graph(*record, max_residues=max_residues,
                                        max_neighbors=max_neighbors)
                for record in structures[start:start + batch_size]])
            graph = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            out.append(self.model(graph, modality).float().cpu().numpy())
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
