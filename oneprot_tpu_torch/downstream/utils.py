"""Downstream-probe utilities (counterpart of oneprot_tpu/downstream/utils.py)
and the task metrics in numpy.

`count_f1_max` (TorchDrug's threshold-optimal F1), `load_data` (a combined
`.npz` from collect_embeddings, with optional label binarisation) and
`save_results_to_csv` (the fixed-width results row) are the JAX package's,
copied. The metrics that the JAX package takes from sklearn and scipy
(`oneprot_tpu/downstream/mlp_probe.py:compute_metrics`) are computed here
with numpy alone, so that the probes run where neither is installed:

- `accuracy` is sklearn's `accuracy_score`;
- `macro_f1` is `f1_score(average="macro")`: the mean over the sorted union
  of the labels in `labels` and `pred` of 2tp / (2tp + fp + fn), which is
  0 where precision or recall is undefined;
- `roc_auc` is `roc_auc_score` on 1-D scores (the positive class is the
  larger label) and `roc_auc_score(multi_class="ovr")`, macro, on 2-D
  probabilities (column c is the c-th of the sorted labels): the
  Mann-Whitney U over average ranks, so ties count one half. It returns
  None wherever sklearn raises ValueError: scores that are not finite,
  more than two labels with 1-D scores, and, on 2-D scores, rows that do
  not sum to 1 or a number of labels other than the number of columns.
  One label alone gives NaN, as sklearn 1.6 and later return it (with a
  warning; earlier versions raised);
- `spearman` is `scipy.stats.spearmanr(a, b).statistic`: Pearson's r of
  the average ranks, NaN where an input is constant or holds a NaN.

`softmax_f32` computes the probabilities as jax.nn.softmax does on the CPU
(float32, the row's largest logit subtracted, XLA's exp, the row summed in
order), so that scores tie, and rank, where sklearn sees them in the JAX
package: bit for bit up to 32 classes. Over 32, XLA sums a row in another
order, and a score may differ by an ulp.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np


def count_f1_max(pred: np.ndarray, target: np.ndarray) -> float:
    """F1 at the optimal global threshold (TorchDrug algorithm).

    pred: [B, N] scores; target: [B, N] binary. Sweeps every distinct score
    as a threshold; precision averages only over samples that have at least
    one prediction at the threshold, recall averages over all samples.
    """
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    b, n = pred.shape

    order = np.argsort(-pred, axis=1, kind="stable")
    target_sorted = np.take_along_axis(target, order, axis=1)
    cum = target_sorted.cumsum(1)
    precision = cum / np.arange(1, n + 1)[None, :]
    recall = cum / (target.sum(1, keepdims=True) + 1e-10)

    is_start = np.zeros_like(target_sorted, dtype=bool)
    is_start[:, 0] = True
    is_start_scattered = np.zeros_like(is_start)
    np.put_along_axis(is_start_scattered, order, is_start, axis=1)

    all_order = np.argsort(-pred.flatten(), kind="stable")
    order_flat = (order + np.arange(b)[:, None] * n).flatten()
    inv_order = np.zeros_like(order_flat)
    inv_order[order_flat] = np.arange(b * n)
    is_start_f = is_start_scattered.flatten()[all_order]
    all_order = inv_order[all_order]

    precision_f = precision.flatten()
    recall_f = recall.flatten()
    all_precision = precision_f[all_order] - np.where(
        is_start_f, 0.0, precision_f[all_order - 1])
    all_precision = np.cumsum(all_precision) / np.cumsum(is_start_f)
    all_recall = recall_f[all_order] - np.where(
        is_start_f, 0.0, recall_f[all_order - 1])
    all_recall = np.cumsum(all_recall) / b
    all_f1 = 2 * all_precision * all_recall / (
        all_precision + all_recall + 1e-10)
    return float(np.max(all_f1))


def load_data(
    path: str, binarize_threshold: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Load a combined embeddings file (.npz from collect_embeddings)."""
    data = np.load(path, allow_pickle=True)
    emb = np.asarray(data["embeddings"], np.float32)
    labels = np.asarray(data["labels_fitness"])
    if binarize_threshold is not None:
        labels = (labels > binarize_threshold).astype(np.int64)
    return emb, labels


def save_results_to_csv(results: Dict[str, float], output_path: str,
                        header_order: Optional[list] = None) -> None:
    """Append one fixed-width row per run; the header on the first."""
    keys = header_order or list(results.keys())
    exists = os.path.isfile(output_path)
    with open(output_path, "a", newline="") as f:
        writer = csv.writer(f)
        if not exists:
            writer.writerow([f"{k:<20}" for k in keys])
        writer.writerow([
            f"{results.get(k, ''):<20}" if not isinstance(results.get(k), float)
            else f"{results[k]:<20.5f}"
            for k in keys
        ])


# ---------------------------------------------------------------------------
# task metrics without sklearn or scipy


_F32 = np.float32
# Cephes's expf: ln 2 split in two, and the polynomial's coefficients
_EXP_LN2 = (_F32(-0.693359375), _F32(2.12194440e-4))
_EXP_POLY = tuple(map(_F32, (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)))


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def exp_f32(x: np.ndarray) -> np.ndarray:
    """float32 exp as XLA computes it on the CPU: Cephes's range reduction
    and polynomial with fused multiply-adds, results under the smallest
    normal float32 flushed to zero (bit for bit up to x = 88.37, past
    which XLA clamps elsewhere; a softmax passes x <= 0). numpy's own exp
    differs by up to 2 ulps."""
    x = np.clip(np.asarray(x, _F32), _F32(-88.376262664795),
                _F32(88.376262664795))
    n = np.floor(_fma(x, _F32(1.44269504088896341), _F32(0.5)))
    r = _fma(n, _EXP_LN2[1], _fma(n, _EXP_LN2[0], x))
    y = np.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + _F32(1)
    y = np.ldexp(y, n.astype(np.int32))
    return np.where(y < np.finfo(_F32).tiny, _F32(0), y).astype(_F32)


def softmax_f32(logits: np.ndarray) -> np.ndarray:
    """float32 softmax over the last axis, as jax.nn.softmax computes it."""
    x = np.asarray(logits, _F32)
    e = exp_f32(x - x.max(-1, keepdims=True))
    total = np.zeros(e.shape[:-1], _F32)
    for i in range(e.shape[-1]):
        total += e[..., i]
    return e / total[..., None]


def accuracy(labels: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(labels) == np.asarray(pred)))


def macro_f1(labels: np.ndarray, pred: np.ndarray) -> float:
    labels, pred = np.asarray(labels).ravel(), np.asarray(pred).ravel()
    classes = np.union1d(labels, pred)
    true = labels[None, :] == classes[:, None]
    hit = pred[None, :] == classes[:, None]
    tp = (true & hit).sum(1)
    denom = true.sum(1) + hit.sum(1)
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    return float(np.mean(f1))


def average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks, ties given the mean of their ranks (float64)."""
    x = np.asarray(x).ravel()
    order = np.argsort(x, kind="stable")
    inv = np.empty(len(x), np.intp)
    inv[order] = np.arange(len(x))
    xs = x[order]
    new = np.r_[True, xs[1:] != xs[:-1]]
    dense = np.cumsum(new)[inv]
    bounds = np.r_[np.nonzero(new)[0], len(new)]
    return 0.5 * (bounds[dense] + bounds[dense - 1] + 1)


def binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """ROC AUC of `score` for the boolean `positive`, by the Mann-Whitney U
    over average ranks; NaN with one class."""
    positive = np.asarray(positive, bool).ravel()
    n_pos = int(positive.sum())
    n_neg = len(positive) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    u = average_ranks(score)[positive].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> Optional[float]:
    """sklearn's roc_auc_score(labels, scores) (2-D: multi_class="ovr",
    macro), or None where it raises ValueError."""
    labels, scores = np.asarray(labels).ravel(), np.asarray(scores)
    if scores.size == 0 or not np.isfinite(scores).all():
        return None
    classes = np.unique(labels)
    if scores.ndim == 1:
        if len(classes) > 2:  # multiclass labels need 2-D scores
            return None
        return binary_auc(labels == classes[-1], scores)
    n_cols = scores.shape[1]
    if len(classes) <= 2 and n_cols <= 2:  # sklearn's binary route
        if n_cols != 1:
            return None
        return binary_auc(labels == classes[-1], scores[:, 0])
    if not np.allclose(1, scores.sum(axis=1)) or len(classes) != n_cols:
        return None
    return float(np.mean([binary_auc(labels == c, scores[:, i])
                          for i, c in enumerate(classes)]))


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman's rho of two 1-D arrays (scipy.stats.spearmanr's)."""
    x = np.column_stack((np.asarray(a), np.asarray(b)))
    if x.shape[0] <= 1:
        return float("nan")
    if (x[:, 0] == x[0, 0]).all() or (x[:, 1] == x[0, 1]).all():
        return float("nan")
    if np.isnan(x).any():
        return float("nan")
    ranks = np.column_stack([average_ranks(x[:, 0]), average_ranks(x[:, 1])])
    return float(np.corrcoef(ranks, rowvar=False)[1, 0])
