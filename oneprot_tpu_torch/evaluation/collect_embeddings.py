"""Frozen embeddings for downstream probes (counterpart of
oneprot_tpu/evaluation/collect_embeddings.py).

For each model x task x split CSV, embed every sequence, write shard
files, then combine them into `{task}_{split}_embeddings_labels.npz`
(`embeddings`, `labels_fitness`). Label types: classification,
regression, multi-label (a Python list a cell) and ppi (the two
sequences' embeddings side by side). Backbones: a first-party ESM2 (`esm2`,
or `saprot` over the struct-token vocabulary; the mean of the last hidden
state over non-pad tokens), with HF weights from `checkpoint_dir` or
weights from `seed`, or a trained OneProt run's sequence tower (`oneprot`
/ `custom`; its projected, normalised features).

    python -m oneprot_tpu_torch.cli.collect_embeddings tasks=[ToyCls] \\
        +models.esm2.checkpoint_dir=<HF dir> downstream_dir=<csvs>

It differs from the JAX package in these ways:

- The CSVs are read with `csv` (no pandas).
- Everything runs on `device` (the card unless the caller asks for the
  CPU). Under a process group each rank embeds rows rank::world into its
  own shards, `embeddings_rank{r}_batch{b}.npz`, and rank 0 alone
  combines them after a barrier (the rows come out grouped by rank, as
  in the JAX package).
- Before a split is embedded, rank 0 removes every
  `embeddings_rank*_batch*.npz` in its directory, and the other ranks wait
  for it before they write; the JAX package has each rank remove only its
  own, so a stale shard of a rank that no longer runs is merged into the
  combined file.
- A `oneprot` run without `checkpoints/best` raises FileNotFoundError;
  the JAX package embeds random weights.
"""

from __future__ import annotations

import ast
import csv
import glob
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from oneprot_tpu_torch.core.collectives import barrier
from oneprot_tpu_torch.core.mesh import is_main_process, world
from oneprot_tpu_torch.data.common import pick_bucket
from oneprot_tpu_torch.data.tokenizers import (
    esm2_tokenizer,
    struct_token_tokenizer,
)
from oneprot_tpu_torch.downstream.mlp_probe import TASK_REGISTRY
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)


class SequenceDataset:
    """A CSV with `sequence` (`sequence_1` and `sequence_2` for ppi) and
    `label/fitness` (or `label`) columns."""

    def __init__(self, csv_file: str, label_type: str = "classification"):
        with open(csv_file, newline="") as f:
            self.rows = list(csv.DictReader(f))
        self.label_type = label_type
        columns = self.rows[0].keys() if self.rows else ()
        label_col = "label/fitness" if "label/fitness" in columns else "label"
        col = [row[label_col] for row in self.rows]
        if label_type in ("classification", "ppi"):
            self.labels = np.array([float(v) for v in col]).astype(np.int64)
        elif label_type == "regression":
            self.labels = np.array([float(v) for v in col], np.float32)
        elif label_type == "multi-label":
            self.labels = np.array([ast.literal_eval(v) for v in col],
                                   np.int32)
        else:
            raise ValueError(f"Unsupported label_type: {label_type}")

    def __len__(self) -> int:
        return len(self.rows)

    def batch(self, idxs) -> Tuple[List[str], Optional[List[str]], np.ndarray]:
        rows = [self.rows[i] for i in idxs]
        if self.label_type == "ppi":
            return ([r["sequence_1"] for r in rows],
                    [r["sequence_2"] for r in rows], self.labels[idxs])
        return [r["sequence"] for r in rows], None, self.labels[idxs]


class EmbeddingBackbone:
    """Embeds sequences with ESM2 (mean of the last hidden state over the
    non-pad tokens) or a trained OneProt run's sequence tower, on
    `device`."""

    def __init__(self, kind: str = "esm2",
                 model_name_or_path: str = "facebook/esm2_t33_650M_UR50D",
                 run_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 max_length: int = 1024, seed: int = 0,
                 dtype: str = "bfloat16", device="cuda"):
        from oneprot_tpu_torch.models.encoders import _dtype

        self.kind = kind
        self.max_length = max_length
        self.device = torch.device(device)
        if kind in ("esm2", "saprot"):
            from oneprot_tpu_torch.models.esm2 import (
                Esm2,
                init_esm2_weights_,
                resolve_esm2_config,
            )
            from oneprot_tpu_torch.models.hf_convert import (
                convert_esm2_state_dict,
                load_torch_state_dict,
            )

            self.tok = (struct_token_tokenizer() if kind == "saprot"
                        else esm2_tokenizer())
            cfg = resolve_esm2_config(model_name_or_path,
                                      vocab_size=self.tok.vocab_size)
            self.model = Esm2(cfg, device=self.device,
                              dtype=_dtype(dtype)).eval()
            self.model.requires_grad_(False)
            if checkpoint_dir:
                extra = self.tok.vocab_size - 33 if kind == "saprot" else 0
                self.model.load_state_dict(convert_esm2_state_dict(
                    load_torch_state_dict(checkpoint_dir), cfg.num_layers,
                    extra_vocab_rows=extra))
            else:
                init_esm2_weights_(self.model, torch.Generator(
                    device=self.device).manual_seed(seed))
        elif kind in ("custom", "oneprot"):
            from oneprot_tpu_torch.evaluation.retrieval_eval import (
                load_trained_module,
            )
            from oneprot_tpu_torch.train.checkpoint import restore_any

            module, _ = load_trained_module(run_dir, self.device)
            log.info(f"restored {restore_any(module, run_dir, 'best')}")
            self.tok = esm2_tokenizer()
            self.model = module.model.eval()
        else:
            raise ValueError(f"Unknown backbone kind: {kind}")

    @torch.inference_mode()
    def __call__(self, sequences: List[str], pad: int) -> np.ndarray:
        ids = torch.from_numpy(self.tok(sequences, max_length=self.max_length,
                                        padding=pad)).to(self.device,
                                                         torch.long)
        if self.kind in ("custom", "oneprot"):
            out = self.model(ids, "sequence")
        else:
            hidden = self.model(ids)
            mask = (ids != 1).to(hidden.dtype)[..., None]
            out = (hidden * mask).sum(1) / mask.sum(1)
        return out.float().cpu().numpy()


def generate_embeddings(
    csv_file: str,
    output_dir: str,
    backbone: EmbeddingBackbone,
    label_type: str = "classification",
    batch_size: int = 32,
    buckets: Optional[List[int]] = None,
) -> None:
    """Embed this rank's rows (rank::world) of one split CSV into shard
    files `embeddings_rank{rank}_batch{b}.npz`, after rank 0 removed every
    stale shard of the directory."""
    nproc, rank = world()
    ds = SequenceDataset(csv_file, label_type)
    if rank == 0:
        os.makedirs(output_dir, exist_ok=True)
        for stale in glob.glob(os.path.join(output_dir,
                                            "embeddings_rank*_batch*.npz")):
            os.remove(stale)
    barrier()
    idxs = np.arange(len(ds))[rank::nproc]
    for b, start in enumerate(range(0, len(idxs), batch_size)):
        seqs, seqs2, labels = ds.batch(idxs[start:start + batch_size])
        pad = pick_bucket(max(len(s) + 2 for s in seqs), buckets,
                          backbone.max_length)
        emb = backbone(seqs, pad)
        if seqs2 is not None:  # ppi: the pair's embeddings side by side
            pad2 = pick_bucket(max(len(s) + 2 for s in seqs2), buckets,
                               backbone.max_length)
            emb = np.concatenate([emb, backbone(seqs2, pad2)], axis=1)
        np.savez(os.path.join(output_dir,
                              f"embeddings_rank{rank}_batch{b}.npz"),
                 embeddings=emb, labels_fitness=labels)


def combine_embeddings_for_split(split_dir: str, output_file: str) -> None:
    """Concatenate a split's shard files, in sorted file-name order (the
    JAX package's order)."""
    files = sorted(glob.glob(os.path.join(split_dir,
                                          "embeddings_rank*_batch*.npz")))
    embs, labels = [], []
    for f in files:
        data = np.load(f, allow_pickle=True)
        embs.append(data["embeddings"])
        labels.append(data["labels_fitness"])
    np.savez(output_file, embeddings=np.concatenate(embs, 0),
             labels_fitness=np.concatenate(labels, 0))
    log.info(f"combined {len(files)} shards -> {output_file} "
             f"({sum(len(e) for e in embs)} rows)")


def run_collection(cfg: Dict[str, Any], device=None) -> List[str]:
    """The whole collection from a composed `collect_embeddings` config,
    on `device` (default: the config's `device`, else the current CUDA
    device, which must exist). Returns the combined files."""
    from oneprot_tpu_torch.train.trainer import select_device

    device = select_device(str(device or cfg.get("device") or "gpu"))
    outputs = []
    out_root = str(cfg["output_dir"])
    for model_name, model_cfg in dict(cfg["models"]).items():
        backbone = EmbeddingBackbone(
            kind=str(model_cfg.get("type", "esm2")),
            model_name_or_path=str(model_cfg.get(
                "model_name_or_path", "facebook/esm2_t33_650M_UR50D")),
            run_dir=model_cfg.get("run_dir"),
            checkpoint_dir=model_cfg.get("checkpoint_dir"),
            max_length=int(cfg.get("max_length", 1024)), device=device)
        for task in cfg.get("tasks", []):
            for split in cfg.get("splits", ["train", "valid", "test"]):
                csv_file = os.path.join(str(cfg["downstream_dir"]),
                                        f"{task}_{split}.csv")
                if not os.path.isfile(csv_file):
                    log.warning(f"missing {csv_file}; skipping")
                    continue
                shard_dir = os.path.join(out_root, model_name, task, split)
                generate_embeddings(
                    csv_file, shard_dir, backbone,
                    label_type=_task_label_type(task, cfg),
                    batch_size=int(cfg.get("batch_size", 32)),
                    buckets=_bucket_list(cfg))
                out = os.path.join(out_root, model_name,
                                   f"{task}_{split}_embeddings_labels.npz")
                barrier()  # every rank's shards are on disk
                if is_main_process():
                    combine_embeddings_for_split(shard_dir, out)
                outputs.append(out)
        del backbone
    return outputs


def _task_label_type(task: str, cfg: Dict[str, Any]) -> str:
    """The task's label family from the registry, else the config's
    `label_type` (default classification)."""
    info = TASK_REGISTRY.get(task)
    if info is not None:
        return str(info["type"])
    return str(cfg.get("label_type", "classification"))


def _bucket_list(cfg: Dict[str, Any]) -> List[int]:
    """The config's length buckets, else the serving defaults."""
    from oneprot_tpu_torch.serving import DEFAULT_BUCKETS

    buckets = cfg.get("buckets") or list(DEFAULT_BUCKETS)
    return [int(b) for b in buckets]
