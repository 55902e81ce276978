"""ReduceLROnPlateau on a validation metric (counterpart of
oneprot_tpu/train/scheduler.py: `ReduceLROnPlateau`, `get_learning_rate`,
`set_learning_rate`).

After each validation the callback compares the monitored value with its
best; after more than `patience` validations without an improvement beyond
`threshold` it multiplies the learning rate by `factor` (floored at
`min_lr`). The rate lives in the torch optimizer's `param_groups`, where
the JAX package keeps it in the injected optimizer state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)


class ReduceLROnPlateau:
    def __init__(
        self,
        monitor: str = "val/loss_best",
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
        **unused: Any,
    ):
        self.monitor = monitor
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.threshold
        return value > self.best + self.threshold

    def on_validation_end(self, module, metrics: Dict[str, float]) -> Optional[float]:
        """Returns the new lr if reduced, else None."""
        value = metrics.get(self.monitor)
        if value is None:
            return None
        if self._improved(float(value)):
            self.best = float(value)
            self.bad_epochs = 0
            return None
        self.bad_epochs += 1
        if self.bad_epochs <= self.patience:
            return None
        self.bad_epochs = 0
        current = get_learning_rate(module.opt)
        if current is None:
            log.warning("the optimizer has no learning rate; plateau "
                        "scheduler inactive")
            return None
        new_lr = max(current * self.factor, self.min_lr)
        set_learning_rate(module.opt, new_lr)
        log.info(f"ReduceLROnPlateau: lr {current:.2e} -> {new_lr:.2e}")
        return new_lr


def _param_groups(opt) -> list:
    """The param_groups of a torch optimizer or of the port's
    ClippedOptimizer around one."""
    base = getattr(opt, "base", opt)
    return getattr(base, "param_groups", [])


def get_learning_rate(opt) -> Optional[float]:
    groups = [g for g in _param_groups(opt) if "lr" in g]
    return float(groups[0]["lr"]) if groups else None


def set_learning_rate(opt, new_lr: float) -> None:
    for group in _param_groups(opt):
        if "lr" in group:
            group["lr"] = float(new_lr)
