"""MLP probe on frozen embeddings (counterpart of
oneprot_tpu/downstream/mlp_probe.py).

The SaProt task registry, the per-task losses (BCE with logits on float
labels for multi-label tasks, MSE on the first logit for regression,
cross-entropy for classification and ppi), early stopping on the
validation loss, the grid sweep and the task-family metrics (accuracy,
macro F1 and ROC AUC; f1_max for GO and EC; MSE, R^2 and Spearman),
the last with numpy alone (`downstream.utils`).

    metrics = fit_mlp_probe(train, valid, test, "EC")   # on the card
    metrics = fit_mlp_probe(train, valid, test, "EC", device="cpu")

The probe's parameters, the embeddings and the labels live on `device`
(the current CUDA device unless the caller asks for the CPU; there is no
fallback); the batch order (`np.random.RandomState(seed).permutation`,
the JAX package's) and the metrics are on the host. Products are f32 with
TF32 off. AdamW is optax.adamw's: betas (0.9, 0.999), eps 1e-8, the
config's weight decay on every parameter (torch's fused kernel on the
card). It differs from the JAX package
in one way: dropout draws from a torch generator on the probe's device,
seeded from `seed`, since JAX's PRNG stream cannot be reproduced; with
dropout 0 both packages train the same function from the same weights
(`convert.mlp_probe_state_dict`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from oneprot_tpu_torch.downstream.utils import (
    accuracy,
    count_f1_max,
    macro_f1,
    roc_auc,
    softmax_f32,
    spearman,
)
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

# the SaProt tasks' output widths and types (reference saprot_fit_mlp.py)
TASK_REGISTRY: Dict[str, Dict[str, Any]] = {
    "EC": {"output_dim": 585, "type": "multi-label"},
    "GO-BP": {"output_dim": 1943, "type": "multi-label"},
    "GO-MF": {"output_dim": 489, "type": "multi-label"},
    "GO-CC": {"output_dim": 320, "type": "multi-label"},
    "DeepLoc10": {"output_dim": 10, "type": "classification"},
    "DeepLoc2": {"output_dim": 2, "type": "classification"},
    "TopEnzyme": {"output_dim": 826, "type": "classification"},
    "MetalIonBinding": {"output_dim": 2, "type": "classification"},
    "ThermoStability": {"output_dim": 1, "type": "regression"},
    "HumanPPI": {"output_dim": 2, "type": "ppi"},
    "ToyCls": {"output_dim": 3, "type": "classification"},
    "ToyReg": {"output_dim": 1, "type": "regression"},
}


@dataclasses.dataclass
class MLPProbeConfig:
    hidden_dims: Sequence[int] = (512,)
    dropout: float = 0.2
    lr: float = 1e-3
    batch_size: int = 128
    max_epochs: int = 50
    weight_decay: float = 0.0
    patience: int = 5
    seed: int = 0


class MLPProbe(nn.Module):
    """Linear, then ReLU and dropout after every layer but the last."""

    def __init__(self, dims: Sequence[int], dropout: float = 0.0,
                 device: Any = "cpu", seed: int = 0):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out, device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        self.dropout = dropout
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def reset_parameters(self, seed: int) -> None:
        """Weights N(0, 2 / d_in) and zero biases, drawn on the CPU from
        `seed` (the same on every device)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                d_out, d_in = layer.weight.shape
                w = torch.randn(d_out, d_in, generator=gen) * (2.0 / d_in) ** 0.5
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
                if self.training and self.dropout > 0:
                    keep = torch.rand(x.shape, generator=self.generator,
                                      device=x.device) < 1 - self.dropout
                    x = torch.where(keep, x / (1 - self.dropout), 0.0)
        return x


def loss_fn(task_type: str):
    if task_type == "multi-label":
        return lambda logits, y: F.binary_cross_entropy_with_logits(
            logits, y.float())
    if task_type == "regression":
        return lambda logits, y: torch.mean((logits[:, 0] - y) ** 2)
    return lambda logits, y: F.cross_entropy(logits, y)


def compute_metrics(task_type: str, logits: np.ndarray,
                    labels: np.ndarray) -> Dict[str, float]:
    """Task-family metrics: MSE, R^2, Spearman (regression); f1_max
    (multi-label); accuracy, macro F1 and ROC AUC (classification, ppi;
    `auc` absent where sklearn would refuse it)."""
    out: Dict[str, float] = {}
    if task_type == "regression":
        pred = logits[:, 0]
        out["mse"] = float(np.mean((pred - labels) ** 2))
        ss_res = np.sum((labels - pred) ** 2)
        ss_tot = np.sum((labels - labels.mean()) ** 2) + 1e-12
        out["r2"] = float(1 - ss_res / ss_tot)
        out["spearman"] = spearman(pred, labels)
        return out
    if task_type == "multi-label":
        probs = 1.0 / (1.0 + np.exp(-logits))
        out["f1_max"] = count_f1_max(probs, labels)
        return out
    pred = logits.argmax(-1)
    out["accuracy"] = accuracy(labels, pred)
    out["f1"] = macro_f1(labels, pred)
    probs = softmax_f32(logits)
    auc = roc_auc(labels, probs[:, 1] if logits.shape[1] == 2 else probs)
    if auc is not None:
        out["auc"] = auc
    return out


@contextlib.contextmanager
def _exact_f32():
    """f32 products without TF32 for the block, then the caller's setting."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _device(device: Any) -> torch.device:
    from oneprot_tpu_torch.train.trainer import select_device

    if isinstance(device, torch.device):
        return device
    return select_device(str(device or "gpu"))


def _labels(y: np.ndarray, task_type: str, device) -> torch.Tensor:
    y = np.asarray(y)
    if task_type == "regression":
        return torch.as_tensor(y, dtype=torch.float32, device=device)
    if task_type == "multi-label":  # BCE's targets, cast once
        return torch.as_tensor(y, dtype=torch.float32, device=device)
    return torch.as_tensor(y.astype(np.int64), device=device)


def fit_mlp_probe(
    train: Tuple[np.ndarray, np.ndarray],
    valid: Tuple[np.ndarray, np.ndarray],
    test: Tuple[np.ndarray, np.ndarray],
    task: str,
    config: Optional[MLPProbeConfig] = None,
    output_dim: Optional[int] = None,
    device: Any = None,
    init: Optional[Mapping[str, torch.Tensor]] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, float]:
    """Train the probe with early stopping on the validation loss; report
    the test metrics of the best epoch's weights and `val_loss`, the best
    validation loss. `init` is a state dict to start from (else weights
    drawn from `config.seed`); `stats`, if given, receives the epochs run,
    the best epoch, each epoch's validation loss, the steps, the seconds
    of training, validation and the test forward (the card synchronised)
    and of the metrics on the host, the test logits and the devices of the
    parameters and the data."""
    cfg = config or MLPProbeConfig()
    info = TASK_REGISTRY.get(task, {"output_dim": output_dim or 2,
                                    "type": "classification"})
    task_type = info["type"]
    out_dim = output_dim or info["output_dim"]
    dev = _device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    x_tr, y_tr = train
    dims = [x_tr.shape[1], *cfg.hidden_dims, out_dim]
    model = MLPProbe(dims, cfg.dropout, device=dev, seed=cfg.seed)
    if init is None:
        model.reset_parameters(cfg.seed)
    else:
        model.load_state_dict(init)
    # on the card one fused kernel a step: the step is launch-bound
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            fused=dev.type == "cuda")
    loss = loss_fn(task_type)

    x_tr = torch.as_tensor(np.asarray(x_tr, np.float32), device=dev)
    y_tr = _labels(y_tr, task_type, dev)
    x_va = torch.as_tensor(np.asarray(valid[0], np.float32), device=dev)
    y_va = _labels(valid[1], task_type, dev)
    best_val = float("inf")
    best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    best_epoch, bad, steps, epochs = -1, 0, 0, 0
    val_losses: List[float] = []
    train_s = val_s = 0.0
    rng_np = np.random.RandomState(cfg.seed)
    with _exact_f32():
        for epoch in range(cfg.max_epochs):
            sync()
            t = time.perf_counter()
            model.train()
            order = torch.from_numpy(rng_np.permutation(len(x_tr))).to(dev)
            for start in range(0, len(order), cfg.batch_size):
                idx = order[start:start + cfg.batch_size]
                opt.zero_grad(set_to_none=True)
                loss(model(x_tr[idx]), y_tr[idx]).backward()
                opt.step()
                steps += 1
            sync()
            t_val = time.perf_counter()
            model.eval()
            with torch.no_grad():
                val_loss = float(loss(model(x_va), y_va))
            val_s += time.perf_counter() - t_val
            train_s += t_val - t
            val_losses.append(val_loss)
            epochs += 1
            if val_loss < best_val - 1e-6:
                best_val, best_epoch, bad = val_loss, epoch, 0
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
            else:
                bad += 1
                if bad >= cfg.patience:
                    break
        t = time.perf_counter()
        model.load_state_dict(best_state)
        model.eval()
        with torch.no_grad():
            logits = model(torch.as_tensor(np.asarray(test[0], np.float32),
                                           device=dev)).cpu().numpy()
        test_s = time.perf_counter() - t
    t = time.perf_counter()
    metrics = compute_metrics(task_type, logits, np.asarray(test[1]))
    metrics_s = time.perf_counter() - t
    metrics["val_loss"] = best_val
    if stats is not None:
        stats.update(epochs=epochs, best_epoch=best_epoch, steps=steps,
                     val_losses=val_losses, train_s=train_s, val_s=val_s,
                     test_s=test_s, metrics_s=metrics_s, test_logits=logits,
                     params_device=str(next(model.parameters()).device),
                     data_device=str(x_tr.device))
    return metrics


def sweep_mlp_probe(train, valid, test, task: str,
                    sweep: Dict[str, List[Any]],
                    base: Optional[MLPProbeConfig] = None,
                    device: Any = None) -> List[Dict]:
    """Grid sweep over `sweep` (MLPProbeConfig field -> values); a row per
    combination, its metrics and `sweep/<field>` keys."""
    base = base or MLPProbeConfig()
    keys = list(sweep.keys())
    results = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        cfg = dataclasses.replace(base, **dict(zip(keys, combo)))
        metrics = fit_mlp_probe(train, valid, test, task, cfg, device=device)
        metrics.update({f"sweep/{k}": v for k, v in zip(keys, combo)})
        results.append(metrics)
        log.info(f"sweep {dict(zip(keys, combo))} -> {metrics}")
    return results
