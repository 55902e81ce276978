"""Cross-modal retrieval evaluation (counterpart of
oneprot_tpu/evaluation/retrieval_eval.py).

One CSV with every modality's column (ids, msa_files, text, struct_token,
struct_graph, sequence, pocket) -> each modality the trained model has an
encoder for embedded on the model's device -> R@{1,10,100,500} and the
median rank for every pair of modalities, both directions -> the
fixed-width results CSV.

    python -m oneprot_tpu_torch.cli.eval run_dir=<run> [csv_file=...]

The model is rebuilt from the run dir's `resolved_config.yaml` on the
device of its `trainer.accelerator` and restored by
`checkpoint.restore_any` (`best` by default, a `ckpt_path`, or a
reference Lightning `.ckpt`). It differs from the JAX package in these
ways:

- The CSV is read with `csv`, positionally as pandas reads it there
  (`names=COLUMN_NAMES`, the header row dropped); an empty cell reads as
  pandas' NaN does, "nan".
- The JAX loop runs `eval_step` once per modality, so each batch runs the
  hub once per modality; here the hub runs once a batch and every other
  tower alone. The embeddings are the same.
- A checkpoint that is not there raises FileNotFoundError; the JAX
  package warns and evaluates random weights.

Under a process group every rank evaluates every row, as the JAX eval
does (it shards nothing), and rank 0 alone writes the CSV.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from oneprot_tpu_torch.core.mesh import is_main_process
from oneprot_tpu_torch.data.common import H5, pick_bucket
from oneprot_tpu_torch.data.graphs import protein_to_padded_graph, stack_graphs
from oneprot_tpu_torch.data.tokenizers import (
    esm2_tokenizer,
    resolve_text_tokenizer,
    struct_token_tokenizer,
)
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

COLUMN_NAMES = ["ids", "msa_files", "text", "struct_token", "struct_graph",
                "sequence", "pocket"]
# the modalities a batch carries, in the JAX batch's order (msa_files is
# not embedded, as in the JAX package)
BATCH_MODALITIES = ("sequence", "struct_token", "text", "struct_graph",
                    "pocket")


def read_combined_csv(csv_file: str) -> List[Dict[str, str]]:
    """The rows after the first, each cell by its position in
    COLUMN_NAMES; a missing or empty cell is "nan"."""
    with open(csv_file, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return [{name: (row[i] if i < len(row) and row[i] != "" else "nan")
             for i, name in enumerate(COLUMN_NAMES)} for row in rows]


class CombinedDataset:
    """Every modality of the eval rows of one CSV (reference
    eval.py:27-112). A row whose ids one of the h5 files lacks is skipped
    with a warning. The sequence and struct_token columns of a batch share
    one length bucket; texts pad to their longest."""

    def __init__(self, csv_file: str, data_dir: str, max_length: int = 1024,
                 text_max_length: int = 512, text_tokenizer: str = "tiny",
                 remove_hash: bool = True, max_residues: int = 256,
                 max_neighbors: int = 24, buckets: Optional[List[int]] = None):
        self.data = read_combined_csv(csv_file)
        self.data_dir = data_dir
        self.max_length = max_length
        self.text_max_length = text_max_length
        self.remove_hash = remove_hash
        self.max_residues = max_residues
        self.max_neighbors = max_neighbors
        self.buckets = buckets
        self.struct_h5 = f"{data_dir}/seqstruc.h5"
        self.pocket_h5 = f"{data_dir}/pockets_100_residues.h5"
        self.seq_tok = esm2_tokenizer()
        self.struct_tok = struct_token_tokenizer()
        self.text_tok = resolve_text_tokenizer(text_tokenizer)

    def __len__(self) -> int:
        return len(self.data)

    def read_structure(self, h5_path: str, pid: str):
        """(sequence, atom names, atom residue ids, xyz) of chain A of `pid`
        in a `seqstruc.h5`-layout file; KeyError when the file lacks it."""
        node = H5.get(h5_path)[pid]["structure"]["0"]["A"]
        poly = node["polypeptide"]
        return (node["residues"]["seq1"][()].decode("utf-8"),
                poly["type"][()], poly["atom_amino_id"][()],
                np.asarray(poly["xyz"][()], np.float64))

    def _graph(self, h5_path: str, pid: str, max_residues: int):
        return protein_to_padded_graph(
            *self.read_structure(h5_path, pid), max_residues=max_residues,
            max_neighbors=self.max_neighbors)

    def batches(self, batch_size: int):
        """Batches of `batch_size` rows: {"sequence", "struct_token",
        "text": int32 token ids, "struct_graph", "pocket": padded graph
        dicts}."""
        for start in range(0, len(self.data), batch_size):
            seqs, structs, texts, graphs, pockets = [], [], [], [], []
            for row in self.data[start:start + batch_size]:
                try:
                    seq = self.read_structure(self.struct_h5,
                                              row["sequence"])[0]
                    graph = self._graph(self.struct_h5, row["struct_graph"],
                                        self.max_residues)
                    pocket = self._graph(self.pocket_h5, row["pocket"],
                                         min(self.max_residues, 128))
                except KeyError:
                    log.warning(f"KeyError: {row['sequence']} missing in h5")
                    continue
                seqs.append(seq)
                st = row["struct_token"]
                structs.append(st.replace("#", "") if self.remove_hash else st)
                texts.append(row["text"])
                graphs.append(graph)
                pockets.append(pocket)
            if not seqs:
                continue
            pad = pick_bucket(max(len(s) + 2 for s in seqs + structs),
                              self.buckets, self.max_length)
            yield {
                "sequence": self.seq_tok(seqs, max_length=self.max_length,
                                         padding=pad),
                "struct_token": self.struct_tok(
                    structs, max_length=self.max_length, padding=pad),
                "text": self.text_tok(texts, max_length=self.text_max_length),
                "struct_graph": stack_graphs(graphs),
                "pocket": stack_graphs(pockets),
            }


def load_trained_module(run_dir: str, device: Optional[torch.device] = None):
    """(module, run config): the run's model rebuilt from its
    `resolved_config.yaml` (read by `core.yaml_io`) on `device`, by default
    that of the run's `trainer.accelerator`, and initialised as training
    initialised it (frozen leaves in bf16, as its checkpoints hold them).
    Its weights are the seeded draw until a checkpoint is restored into
    it."""
    from oneprot_tpu_torch.cli.train import build_model
    from oneprot_tpu_torch.core import yaml_io
    from oneprot_tpu_torch.core.config import to_config
    from oneprot_tpu_torch.train.trainer import select_device

    path = os.path.join(run_dir, "resolved_config.yaml")
    with open(path) as f:
        cfg = to_config(yaml_io.load(f.read(), path))
    if device is None:
        device = select_device(str(
            (cfg.get("trainer") or {}).get("accelerator", "auto")))
    module = build_model(cfg["model"], device, int(cfg.get("seed", 0)))
    module.init()
    return module, cfg


@torch.inference_mode()
def embed_all(module, dataset: CombinedDataset, batch_size: int = 16,
              run_dir: Optional[str] = None,
              ckpt: str = "best") -> Dict[str, np.ndarray]:
    """{modality: [n, output_dim] f32} for every modality of the batches
    the model has an encoder for ('sequence' always), after restoring
    `ckpt` (`restore_any`) when a run dir or a checkpoint file is given.
    The hub runs once a batch, each other tower once a batch."""
    from oneprot_tpu_torch.train.checkpoint import restore_any

    available = [m for m in BATCH_MODALITIES
                 if m == "sequence" or m in module.encoders]
    skipped = sorted(set(BATCH_MODALITIES) - set(available))
    if skipped:
        log.warning(f"model has no encoder for {skipped}; skipping")
    if run_dir is not None or os.path.isfile(str(ckpt)):
        log.info(f"restored {restore_any(module, run_dir, ckpt)}")
    module.model.eval()
    out: Dict[str, List[np.ndarray]] = {m: [] for m in available}
    for batch in dataset.batches(batch_size):
        for modality in available:
            feats = module.model(module._inputs(batch[modality]), modality)
            out[modality].append(feats.float().cpu().numpy())
    return {m: np.concatenate(v, 0) for m, v in out.items() if v}


def calculate_retrieval_metrics(
    embeddings: Dict[str, np.ndarray],
    ks: Sequence[int] = (1, 10, 100, 500),
) -> Dict[str, Dict[str, float]]:
    """All-pairs retrieval metrics (reference eval.py:158-184): ranks by a
    stable argsort of the cosine, median rank floor(median) + 1."""
    modalities = list(embeddings.keys())
    results: Dict[str, Dict[str, float]] = {}
    for i, mod1 in enumerate(modalities):
        for mod2 in modalities[i + 1:]:
            sim = _unit(embeddings[mod1]) @ _unit(embeddings[mod2]).T
            metrics: Dict[str, float] = {}
            for name, logit in (("seq_to_mod", sim), ("mod_to_seq", sim.T)):
                ranking = np.argsort(-logit, axis=1, kind="stable")
                preds = np.argmax(
                    ranking == np.arange(len(logit))[:, None], axis=1)
                metrics[f"{name}_median_rank"] = int(
                    np.floor(np.median(preds)) + 1)
                for k in ks:
                    metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
            results[f"{mod1}-{mod2}"] = metrics
    return results


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def write_results_to_csv(results: Dict[str, Dict[str, float]],
                         output_path: str,
                         ks: Sequence[int] = (1, 10, 100, 500)) -> None:
    """The reference's fixed-width CSV (eval.py:185-208), byte for byte."""
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, delimiter=",", quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(["Modality Pair           "]
                        + [f"R@{k}".ljust(11) for k in ks] + ["MR         "])
        for modality_pair, metrics in results.items():
            mod1, mod2 = modality_pair.split("-")
            for direction in ("seq_to_mod", "mod_to_seq"):
                pair = (f"{mod1}-{mod2}" if direction == "seq_to_mod"
                        else f"{mod2}-{mod1}")
                writer.writerow(
                    [f"{pair:<25}"]
                    + [f"{metrics[f'{direction}_R@{k}']:.3f}      "
                       for k in ks]
                    + [f"{metrics[f'{direction}_median_rank']:<11}"])


def run_eval(cfg, device: Optional[torch.device] = None
             ) -> Dict[str, Dict[str, float]]:
    """The whole eval from a composed `eval` config: the run's model (on
    `device`, by default the run's accelerator's), its training buckets
    (else the serving defaults), the metrics, and `run_dir/output_csv`."""
    from oneprot_tpu_torch.serving import DEFAULT_BUCKETS

    run_dir = str(cfg["run_dir"])
    module, run_cfg = load_trained_module(run_dir, device)
    buckets = ((run_cfg.get("data", {}) or {}).get("buckets")
               or list(DEFAULT_BUCKETS))
    dataset = CombinedDataset(
        csv_file=str(cfg["csv_file"]), data_dir=str(cfg["paths"]["data_dir"]),
        text_tokenizer=str(cfg["paths"].get("text_vocab", "tiny")),
        buckets=[int(b) for b in buckets])
    embeddings = embed_all(module, dataset,
                           batch_size=int(cfg.get("batch_size", 16)),
                           run_dir=run_dir,
                           ckpt=str(cfg.get("ckpt_path") or "best"))
    ks = [int(k) for k in cfg.get("recall_ks", [1, 10, 100, 500])]
    results = calculate_retrieval_metrics(embeddings, ks)
    out_csv = os.path.join(run_dir, str(cfg.get("output_csv",
                                                "retrieval_results.csv")))
    if is_main_process():
        write_results_to_csv(results, out_csv, ks)
        log.info(f"retrieval results written to {out_csv}")
    return results
