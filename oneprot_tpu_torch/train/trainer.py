"""Trainer: the epoch, validation and checkpoint loop (counterpart of
oneprot_tpu/train/trainer.py: `Trainer`, `EarlyStopping`).

    trainer = Trainer(max_epochs=2, accelerator="gpu",
                      default_root_dir=run_dir)
    metrics = trainer.fit(module, datamodule)
    trainer = Trainer(max_epochs=3, accelerator="gpu",
                      default_root_dir=run_dir)
    trainer.fit(module, datamodule,
                ckpt_path=f"{run_dir}/checkpoints/last")

`fit` drives the combined train loader through the module's steps, one
optimizer step per modality per batch: packed batches through
`train_step_packed_cached` on the frozen-feature cache (or
`train_step_packed`), padded ones through `train_step_cached` (or
`train_step`), and padded ones of a frozen modality tower (text) through
`train_step_fully_cached` with both towers' pooled features from the
cache; validation takes the matching eval step. Each epoch ends in a validation (R@k, median rank,
val/loss, cache statistics), a checkpoint (`last`, and `best` on
improvement), the plateau scheduler and early stopping, with the JAX
trainer's Lightning-parity accounting: `max_epochs` counts epochs across
resumes, an int `val_check_interval` counts batches, early stopping is
consulted after every validation (at epoch end only on epochs that
validated), the epoch offset comes from the checkpoint's sidecar, and
losses stay on the device until a logging point.

The trainer runs on the card unless `accelerator="cpu"`; "auto" and "gpu"
raise without a CUDA device, and a module whose parameters sit on another
device than the trainer's is refused. One difference from the JAX
trainer: a resumed run takes the checkpoint callback's best value from the
sidecar's `checkpoint/best_value`, not from the last monitored value.
`callbacks=peft_checkpoint` writes the hub's LoRA adapter in peft's layout
on each val/loss improvement (`checkpoint.PeftCheckpoint`).
`profiler="jax"` writes a torch.profiler trace of `fit` to
`<run>/profile/trace_rank<r>.json`. `deterministic=True` runs `fit` and
`test` under torch's deterministic algorithms, as Lightning's flag does.

Over a process group (`core/mesh.py:init_distributed`, one process per
card) laid out as `mesh` says (`check_mesh`: `model` ranks a model group,
tensor parallelism; `data` -1 or world / model): `devices: auto` is this
process's card and an int must equal the world size. The ranks of a model
group step together on the same rows; each data group's rank on its own
share of every batch; validation gathers the features over the data
group and rank 0's metrics reach every rank, so that early stopping, the
scheduler and the checkpoint callback decide alike; rank 0 alone writes
the logs, the trace and the checkpoints (full tensors, gathered over its
model group).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from oneprot_tpu_torch.core import collectives
from oneprot_tpu_torch.core.mesh import check_mesh, world
from oneprot_tpu_torch.train.checkpoint import (
    BEST_VALUE_KEY,
    CheckpointManager,
    PeftCheckpoint,
)
from oneprot_tpu_torch.train.metrics import (
    MeanMetric,
    MinMetric,
    RetrievalMetric,
    gather_features,
)
from oneprot_tpu_torch.utils.loggers import CsvLogger, get_pylogger

log = get_pylogger(__name__)

class EarlyStopping:
    """Stop on a plateau of the monitored metric, or on a non-finite
    value."""

    def __init__(self, monitor: str = "val/loss_best", min_delta: float = 0.0,
                 patience: int = 3, mode: str = "min",
                 check_finite: bool = True, **unused: Any):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.check_finite = check_finite
        self.best: Optional[float] = None
        self.bad = 0

    def should_stop(self, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        if self.check_finite and not np.isfinite(value):
            log.warning(f"EarlyStopping: {self.monitor} is non-finite")
            return True
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best - self.min_delta)
                    or (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.bad = 0
            return False
        self.bad += 1
        if self.bad > self.patience:
            log.info(f"EarlyStopping: no {self.monitor} improvement for "
                     f"{self.bad} validations")
            return True
        return False


def select_device(accelerator: str) -> torch.device:
    """The device of `accelerator`: "cpu", or "auto" / "gpu" / "cuda" for
    the current CUDA device, which must exist (no fallback to the CPU)."""
    if accelerator == "cpu":
        return torch.device("cpu")
    if accelerator not in ("auto", "gpu", "cuda"):
        raise ValueError(
            f"accelerator={accelerator!r}: 'auto', 'gpu' or 'cpu' (the pod "
            "recipes, experiment=train_pod, train_pod_packed and "
            "train_3b_tp, name trainer=tpu: run them with trainer=gpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"accelerator={accelerator!r} needs a CUDA device "
                           "and none is available; pass accelerator='cpu' "
                           "to train on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Trainer:
    def __init__(
        self,
        min_epochs: int = 1,
        max_epochs: int = 10,
        accelerator: str = "auto",
        devices: Any = "auto",
        precision: str = "bf16",
        val_check_interval: Optional[int] = None,
        check_val_every_n_epoch: int = 1,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        num_sanity_val_steps: int = 0,
        deterministic: bool = False,
        gradient_clip_val: float = 1.0,
        log_every_n_steps: int = 10,
        mesh: Optional[Dict[str, int]] = None,
        profiler: Optional[str] = None,
        default_root_dir: Optional[str] = None,
        detect_anomaly: bool = False,
        cache_frozen_features: bool = True,
        cache_max_entries: Optional[int] = None,
        cache_persist_dir: Optional[str] = None,
        **unused: Any,
    ):
        check_mesh(mesh)
        n = world()[0]
        if devices not in ("auto", None) and int(devices) != n:
            raise ValueError(
                f"devices={devices!r} but this world has {n} process(es): "
                "the port runs one process per device; launch them with "
                f"`python -m torch.distributed.run --nproc_per_node "
                f"{devices} -m oneprot_tpu_torch.cli.train ...`")
        if profiler not in (None, "jax"):
            raise ValueError(f"profiler={profiler!r}: 'jax' (a torch.profiler "
                             "trace), or null")
        self.device = select_device(accelerator)
        if detect_anomaly:
            torch.autograd.set_detect_anomaly(True)
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        self.accelerator = accelerator
        self.devices = devices
        self.precision = precision
        self.val_check_interval = val_check_interval
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.num_sanity_val_steps = num_sanity_val_steps
        self.deterministic = deterministic
        self.gradient_clip_val = gradient_clip_val
        self.log_every_n_steps = log_every_n_steps
        self.profiler = profiler
        self.cache_frozen_features = cache_frozen_features
        self.cache_max_entries = cache_max_entries
        self.cache_persist_dir = cache_persist_dir
        self._feature_cache = None
        self.output_dir = default_root_dir or "."
        self.global_step = 0
        self.callbacks: Dict[str, Any] = {}
        self.logger = None
        self.metrics_history: Dict[str, float] = {}

    def _get_feature_cache(self, module):
        """Build the frozen-feature cache at first use; with
        cache_persist_dir its disk store is guarded by a digest of the
        module's frozen weights."""
        if self._feature_cache is None:
            from oneprot_tpu_torch.train.feature_cache import FrozenFeatureCache

            fp = None
            if self.cache_persist_dir and module.mask is not None:
                fp = module.frozen_digest()
            self._feature_cache = FrozenFeatureCache(
                self.cache_max_entries, persist_dir=self.cache_persist_dir,
                fingerprint=fp)
            if self.cache_persist_dir:
                log.info(
                    f"feature cache persists to {self.cache_persist_dir} "
                    f"({len(self._feature_cache._disk)} rows warm-loaded)")
        return self._feature_cache

    # ------------------------------------------------------------------
    def setup(self, module, datamodule, callbacks: Optional[Dict] = None,
              logger=None, output_dir: Optional[str] = None):
        if output_dir:
            self.output_dir = output_dir
        if module.device.type != self.device.type:
            raise ValueError(
                f"the module's parameters are on {module.device}, the "
                f"trainer runs on {self.device}: build the module on the "
                "trainer's device")
        module.gradient_clip_val = self.gradient_clip_val
        if self.precision in ("fp32", "32", 32):
            bf16 = [name for name, enc in module.encoders.items()
                    if any(getattr(m, "dtype", None) == torch.bfloat16
                           for m in enc.modules())]
            if bf16:
                log.warning(
                    f"trainer.precision={self.precision!r} but encoders "
                    f"{bf16} compute in bf16: each encoder's dtype governs "
                    "its precision; the trainer knob is advisory")
        datamodule.setup()
        module.init()
        total, trainable = module.num_params()
        log.info(f"params: total={total:,} trainable={trainable:,} "
                 f"device={self.device}")
        self.logger = logger or CsvLogger(self.output_dir)
        cb_cfg = callbacks or {}
        ckpt_cfg = dict(cb_cfg.get("model_checkpoint", {}))
        dirpath = ckpt_cfg.pop("dirpath",
                               os.path.join(self.output_dir, "checkpoints"))
        ckpt_cfg.pop("filename", None)
        ckpt_cfg.pop("auto_insert_metric_name", None)
        self.callbacks["checkpoint"] = CheckpointManager(dirpath, **ckpt_cfg)
        if "peft_checkpoint" in cb_cfg:
            seq_enc = module.encoders.get("sequence")
            self.callbacks["peft"] = PeftCheckpoint(
                dirpath=(cb_cfg["peft_checkpoint"] or {}).get(
                    "dirpath", os.path.join(dirpath, "peft")),
                num_layers=seq_enc.config.num_layers if seq_enc is not None
                else 0)
        if "early_stopping" in cb_cfg:
            self.callbacks["early_stopping"] = EarlyStopping(
                **dict(cb_cfg["early_stopping"]))
        if module.scheduler_cfg:
            from oneprot_tpu_torch.train.scheduler import ReduceLROnPlateau

            self.callbacks["scheduler"] = ReduceLROnPlateau(
                **dict(module.scheduler_cfg))
        return module

    def _resume(self, module, ckpt_path: str) -> Optional[float]:
        """Restore weights, optimizer and step; take the epoch offset and
        the best values from the sidecar. Returns the stored val/loss_best."""
        CheckpointManager.restore_path(ckpt_path, module)
        self.global_step = module.step
        sidecar = f"{ckpt_path.rstrip(os.sep)}.metrics.json"
        resume_best = None
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                side = json.load(f) or {}
            saved = side.get("trainer/epoch")
            if saved is not None:
                # an end-of-epoch save resumes at the next epoch; a
                # mid-epoch one replays its epoch (the loader position is
                # not saved: batches may repeat, none are skipped)
                complete = bool(side.get("trainer/epoch_complete", 1.0))
                self._epoch0 = int(saved) + (1 if complete else 0)
            ckpt_cb = self.callbacks.get("checkpoint")
            if ckpt_cb is not None and side.get(BEST_VALUE_KEY) is not None:
                ckpt_cb.best_value = float(side[BEST_VALUE_KEY])
            resume_best = side.get("val/loss_best")
        log.info(f"resumed from {ckpt_path} at step {self.global_step} "
                 f"(epoch offset {self._epoch0})")
        return resume_best

    def _sanity_validation(self, module, datamodule) -> None:
        """A few val batches before the first epoch (-1: all of them); no
        logging, no checkpoint."""
        saved_limit = self.limit_val_batches
        if self.num_sanity_val_steps > 0:
            self.limit_val_batches = (
                self.num_sanity_val_steps if saved_limit is None
                else min(saved_limit, self.num_sanity_val_steps))
        try:
            self.validate(module, datamodule, split="val")
        finally:
            self.limit_val_batches = saved_limit

    def _train_one(self, module, modality: str, batch) -> torch.Tensor:
        """One optimizer step on one modality's batch; the loss stays on
        the device."""
        seq_in, mod_in, _, extra = batch
        cached = self.cache_frozen_features and module.hub_is_cacheable()
        if isinstance(seq_in, dict) and "segment_ids" in seq_in:
            if cached:
                pooled = self._get_feature_cache(module).get_pooled_packed(
                    module, seq_in["ids"], seq_in["segment_ids"], extra)
                loss, _ = module.train_step_packed_cached(modality, pooled,
                                                          mod_in, extra)
            else:
                loss, _ = module.train_step_packed(modality, seq_in, mod_in,
                                                   extra)
        elif cached:
            cache = self._get_feature_cache(module)
            pooled = cache.get_pooled(module, seq_in)
            if module.modality_is_cacheable(modality):
                # a frozen modality tower (text): both backbones cached
                loss, _ = module.train_step_fully_cached(
                    modality, pooled, cache.get_pooled(module, mod_in,
                                                       modality))
            else:
                loss, _ = module.train_step_cached(modality, pooled, mod_in)
        else:
            loss, _ = module.train_step(modality, seq_in, mod_in)
        return loss

    @contextlib.contextmanager
    def _algorithms(self):
        """torch's deterministic algorithms for the block when
        `deterministic` is set, as the reference's Lightning trainer sets
        them (with cuBLAS's reproducible workspace, unless the environment
        names one); the previous setting after it. The model group's
        replicas do not depend on it (`optim.ClippedOptimizer`)."""
        if not self.deterministic:
            yield
            return
        before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])

    # ------------------------------------------------------------------
    def fit(self, module, datamodule, ckpt_path: Optional[str] = None,
            callbacks: Optional[Dict] = None, logger=None,
            output_dir: Optional[str] = None):
        with self._algorithms():
            return self._fit(module, datamodule, ckpt_path, callbacks, logger,
                             output_dir)

    def _fit(self, module, datamodule, ckpt_path, callbacks, logger,
             output_dir):
        self.setup(module, datamodule, callbacks, logger, output_dir)
        self._epoch0 = 0
        resume_best = self._resume(module, ckpt_path) if ckpt_path else None
        train_loss = MeanMetric()
        val_loss_best = MinMetric()
        if resume_best is not None:
            val_loss_best.update(float(resume_best))
        if self.num_sanity_val_steps:
            self._sanity_validation(module, datamodule)
        pending = []  # (step, modality, loss on the device)
        stop = False
        profile = self._start_profile()
        try:
            # `epoch` is the GLOBAL index: a resumed run continues at the
            # sidecar's epoch and stops at max_epochs in total
            for epoch in range(self._epoch0, self.max_epochs):
                if stop:
                    break
                t_epoch = time.time()
                n_batches = 0
                train_loss = MeanMetric()  # per epoch
                datamodule.set_epoch(epoch)
                for batch in datamodule.train_dataloader():
                    if (self.limit_train_batches is not None
                            and n_batches >= self.limit_train_batches):
                        break
                    n_batches += 1
                    for modality in module.modalities_to_train(
                            self.global_step, batch.keys()):
                        loss = self._train_one(module, modality,
                                               batch[modality])
                        self.global_step += 1
                        pending.append((self.global_step, modality, loss))
                        if self.global_step % self.log_every_n_steps == 0:
                            for _, _, l in pending:
                                train_loss.update(float(l))
                            last_mod, last_loss = (pending[-1][1],
                                                   float(pending[-1][2]))
                            pending.clear()
                            self.logger.log_metrics(
                                {"train/loss": train_loss.compute(),
                                 f"train/loss_{last_mod}": last_loss,
                                 "epoch": epoch},
                                self.global_step)
                    # an int val_check_interval counts BATCHES
                    if (self.val_check_interval
                            and n_batches % self.val_check_interval == 0):
                        for _, _, l in pending:
                            train_loss.update(float(l))
                        pending.clear()
                        self._run_validation(module, datamodule,
                                             val_loss_best, epoch)
                        es = self.callbacks.get("early_stopping")
                        if (es is not None and epoch >= self.min_epochs
                                and es.should_stop(self.metrics_history)):
                            stop = True
                            break
                if n_batches == 0:
                    log.warning(
                        "epoch produced ZERO combined batches: check that "
                        "per-modality batch sizes do not exceed dataset "
                        "sizes (min_size + drop_last drops short loaders)")
                for _, _, l in pending:
                    train_loss.update(float(l))
                pending.clear()
                ran_epoch_end_val = (
                    not stop
                    and (epoch + 1) % self.check_val_every_n_epoch == 0)
                if ran_epoch_end_val:
                    self._run_validation(module, datamodule, val_loss_best,
                                         epoch, epoch_end=True)
                # only epochs that validated count toward patience
                es = self.callbacks.get("early_stopping")
                if (ran_epoch_end_val and es is not None
                        and epoch + 1 >= self.min_epochs
                        and es.should_stop(self.metrics_history)):
                    stop = True
                log.info(
                    f"epoch {epoch}: steps={self.global_step} "
                    f"train/loss={train_loss.compute():.4f} "
                    f"({time.time() - t_epoch:.1f}s)")
        finally:
            if profile is not None:
                self._stop_profile(profile)
            if self._feature_cache is not None:
                # persist write-behind rows even when fit raises
                self._feature_cache.flush()
        self.metrics_history["train/steps"] = float(self.global_step)
        return self.metrics_history

    def _start_profile(self):
        """A started torch.profiler (CPU, and the card's activity on one),
        or None without `profiler`."""
        if not self.profiler:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        prof.stop()
        out = os.path.join(self.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_rank{world()[1]}.json")
        prof.export_chrome_trace(path)
        log.info(f"profile trace written to {path}")

    # ------------------------------------------------------------------
    def _run_validation(self, module, datamodule, val_loss_best: MinMetric,
                        epoch: int, epoch_end: bool = False):
        # rank 0's metrics on every rank: every rank's callbacks decide alike
        metrics = collectives.broadcast_object(
            self.validate(module, datamodule, split="val"))
        if "val/loss" in metrics:
            val_loss_best.update(metrics["val/loss"])
            metrics["val/loss_best"] = val_loss_best.compute()
        if self._feature_cache is not None:
            metrics.update(self._feature_cache.stats())
            self._feature_cache.flush()
        self.logger.log_metrics(metrics, self.global_step)
        self.metrics_history.update(metrics)
        if "checkpoint" in self.callbacks:
            # the sidecar carries the global epoch and whether it completed
            self.callbacks["checkpoint"].on_validation_end(
                module, {**metrics, "trainer/epoch": float(epoch),
                         "trainer/epoch_complete": float(epoch_end)})
        if "peft" in self.callbacks:
            self.callbacks["peft"].on_validation_end(module, metrics)
        if "scheduler" in self.callbacks:
            new_lr = self.callbacks["scheduler"].on_validation_end(
                module, metrics)
            if new_lr is not None:
                self.logger.log_metrics({"lr": new_lr}, self.global_step)

    def validate(self, module, datamodule, split: str = "val") -> Dict[str, float]:
        loader = (datamodule.val_dataloader() if split == "val"
                  else datamodule.test_dataloader())
        loss_metric = MeanMetric()
        retrieval: Dict[str, RetrievalMetric] = {}
        n_per_modality: Dict[str, int] = {}
        limit = (self.limit_val_batches if split == "val"
                 else self.limit_test_batches)
        for seq_in, mod_in, modality, _ in loader:
            # the limit applies per modality
            if limit is not None and n_per_modality.get(modality, 0) >= limit:
                continue
            n_per_modality[modality] = n_per_modality.get(modality, 0) + 1
            if (self.cache_frozen_features and module.hub_is_cacheable()
                    and (self._feature_cache is not None
                         or self.cache_persist_dir)):
                # the val pool repeats every epoch; an eval-only run without
                # a disk store gains nothing from caching
                cache = self._get_feature_cache(module)
                pooled = cache.get_pooled(module, seq_in)
                if module.modality_is_cacheable(modality):
                    seq_f, mod_f, loss = module.eval_step_fully_cached(
                        modality, pooled, cache.get_pooled(module, mod_in,
                                                           modality))
                else:
                    seq_f, mod_f, loss = module.eval_step_cached(
                        modality, pooled, mod_in)
            else:
                seq_f, mod_f, loss = module.eval_step(modality, seq_in, mod_in)
            loss_metric.update(float(loss))
            retrieval.setdefault(modality, RetrievalMetric()).update(
                gather_features(seq_f), gather_features(mod_f))
        metrics = {f"{split}/loss": loss_metric.compute()}
        for modality, metric in retrieval.items():
            for key, value in metric.compute().items():
                metrics[f"{split}/{key}/{split}_{modality}"] = value
        return metrics

    def test(self, module, datamodule) -> Dict[str, float]:
        with self._algorithms():
            metrics = self.validate(module, datamodule, split="test")
        self.logger.log_metrics(metrics, self.global_step)
        self.metrics_history.update(metrics)
        return metrics
