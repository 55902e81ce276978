"""Experiment loggers (counterpart of oneprot_tpu/utils/loggers.py:
`get_pylogger`, `CsvLogger`, `WandbLogger`, `MultiLogger`).

`CsvLogger` appends every metrics row to `metrics.jsonl` and `metrics.csv`
in the run directory, with the JAX package's file names and columns (step,
time, then the metrics), on rank 0 only: the other ranks of a process
group hold the same metrics and write nothing. `WandbLogger` imports
`wandb` when it is built (offline by default, as configs/logger/wandb.yaml
says) and, where wandb is not installed, writes `wandb_fallback.csv` and
`wandb_fallback.jsonl` through a `CsvLogger`, as the JAX package does;
it too logs on rank 0 only (the JAX one starts a wandb run in every
process).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


def _main_process() -> bool:
    from oneprot_tpu_torch.core.mesh import is_main_process

    return is_main_process()


class _NonZeroRankFilter(logging.Filter):
    """Demote INFO on every rank but 0 of an initialised process group."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno >= logging.WARNING or _main_process()


def get_pylogger(name: str = __name__) -> logging.Logger:
    """A stdout logger at INFO that speaks on rank 0 only."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.addFilter(_NonZeroRankFilter())
    return logger


def _to_float(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class CsvLogger:
    """Appends metrics to <name>.csv and <name>.jsonl in the run dir."""

    def __init__(self, save_dir: str, name: str = "metrics"):
        self.save_dir = save_dir
        self.csv_path = os.path.join(save_dir, f"{name}.csv")
        self.jsonl_path = os.path.join(save_dir, f"{name}.jsonl")
        self._fieldnames: Optional[list] = None
        if _main_process():
            os.makedirs(save_dir, exist_ok=True)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not _main_process():
            return
        row = {"step": step, "time": time.time()}
        row.update({k: _to_float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        # the csv header must hold every key: rewrite it when one is new
        if self._fieldnames is None or any(k not in self._fieldnames for k in row):
            self._rewrite_csv(row)
        else:
            with open(self.csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)

    def _rewrite_csv(self, new_row: Dict[str, Any]) -> None:
        rows = [new_row]
        if os.path.isfile(self.jsonl_path):
            with open(self.jsonl_path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        keys: list = []
        for r in rows:
            keys.extend(k for k in r if k not in keys)
        self._fieldnames = keys
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not _main_process():
            return
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def finalize(self) -> None:
        pass


class WandbLogger:
    """wandb's run where wandb is importable, else a CsvLogger named
    `wandb_fallback` in `save_dir`; on rank 0 only, as CsvLogger."""

    def __init__(self, save_dir: str, project: str = "oneprot",
                 offline: bool = True, **kwargs: Any):
        wandb = None
        if _main_process():
            try:
                import wandb
            except ImportError:
                pass
        if wandb is None:
            self._run = None
            self._fallback = CsvLogger(save_dir, name="wandb_fallback")
            return
        mode = "offline" if offline else "online"
        self._run = wandb.init(project=project, dir=save_dir, mode=mode, **kwargs)
        self._fallback = None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._run is None:
            self._fallback.log_metrics(metrics, step)
        else:
            self._run.log({k: _to_float(v) for k, v in metrics.items()}, step=step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(params, allow_val_change=True)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log_metrics(self, metrics, step):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params):
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def finalize(self):
        for lg in self.loggers:
            lg.finalize()
