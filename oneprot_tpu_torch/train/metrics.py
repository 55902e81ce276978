"""Retrieval and running metrics (counterpart of
oneprot_tpu/train/metrics.py: `gather_features`, `RetrievalMetric`,
`retrieval_metrics`, `MeanMetric`, `MinMetric`).

Validation features are ranked on the host with numpy: R@k and the median
rank, sequence -> modality and back. Val and test pools are capped at 1000
rows, where a [1k, 1k] argsort takes microseconds. Across processes the
features are gathered over the data group first (`gather_features`; the
ranks of a model group hold the same rows), so every rank computes the
same metrics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from oneprot_tpu_torch.core.collectives import gather_rows


def gather_features(x) -> np.ndarray:
    """Eval features as an f32 host array: under a process group, every
    data rank's rows in rank order (their counts may differ), so that every
    rank ranks the same global pool, each row once."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return gather_rows(x.detach()).float().cpu().numpy()


class RetrievalMetric:
    def __init__(self, ks: Sequence[int] = (1, 10, 100)):
        self.ks = list(ks)
        self.reset()

    def reset(self) -> None:
        self._preds: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def update(self, sequence_features, modality_features) -> None:
        self._preds.append(np.asarray(sequence_features, dtype=np.float32))
        self._targets.append(np.asarray(modality_features, dtype=np.float32))

    def compute(self) -> Dict[str, float]:
        if not self._preds:
            return {}
        return retrieval_metrics(np.concatenate(self._preds, axis=0),
                                 np.concatenate(self._targets, axis=0),
                                 self.ks)


def retrieval_metrics(seq: np.ndarray, mod: np.ndarray,
                      ks: Sequence[int] = (1, 10, 100)) -> Dict[str, float]:
    """R@k and median rank for seq->mod and mod->seq. The rank of item i is
    the position of column i in the stable descending sort of row i; the
    median rank is floor(median(0-based positions)) + 1."""
    logits_per_sequence = seq @ mod.T
    out: Dict[str, float] = {}
    for name, logits in (("seq_to_mod", logits_per_sequence),
                         ("mod_to_seq", logits_per_sequence.T)):
        ranking = np.argsort(-logits, axis=1, kind="stable")
        n = logits.shape[0]
        positions = np.argmax(ranking == np.arange(n)[:, None], axis=1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(positions)) + 1)
        for k in ks:
            out[f"{name}_R@{k}"] = float(np.mean(positions < k))
    return out


class MeanMetric:
    """Streaming mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def update(self, value: float, weight: int = 1) -> None:
        self._total += float(value) * weight
        self._count += weight

    def compute(self) -> float:
        return self._total / max(self._count, 1)


class MinMetric:
    """Running minimum (val/loss_best)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._best = float("inf")

    def update(self, value: float) -> None:
        self._best = min(self._best, float(value))

    def compute(self) -> float:
        return self._best
