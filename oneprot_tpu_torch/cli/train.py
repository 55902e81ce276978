"""Training entry point of the port (counterpart of oneprot_tpu/cli/train.py).

    python -m oneprot_tpu_torch.cli.train experiment=debug_struct_token \\
        trainer=cpu paths.data_dir=data/synthetic
    python -m oneprot_tpu_torch.cli.train experiment=train_packed trainer=gpu \\
        data=struct_token_only model.components.sequence.dtype=bfloat16 ...
    python -m oneprot_tpu_torch.cli.train -m seed=1,2 ...          # multirun
    python -m oneprot_tpu_torch.cli.train -m hydra/sweeper=optuna \\
        hydra.sweeper.n_trials=4 \\
        "hydra.sweeper.params.model.optimizer.lr=tag(log, interval(1e-4, 1e-2))"

Composes the config from `configs/` (`core/config.py`), writes the resolved
snapshot into the run dir, builds the data module, the model and the
trainer from it, and runs `Trainer.fit`, then `Trainer.test`. It differs
from the JAX package's `train()` in these ways:

- The device comes from `trainer.accelerator` before the model is built:
  "auto" and "gpu" mean the current CUDA device (and raise without one),
  "cpu" the CPU. Every encoder is built there.
- The weights are drawn from `cfg.seed` by one `torch.Generator` on that
  device, encoder by encoder in the config's order, so two runs with one
  seed train identically (the JAX package draws them from the seed in
  `OneProtModule.init`).
- A test-only run (`train=false test=true`) with a `ckpt_path` tests that
  checkpoint; the JAX CLI then restores the run dir's `checkpoints/best`
  over it (ROADMAP.md Queue 3).
- The run dir's CsvLogger is made once: the JAX CLI makes it again for
  `logger: csv` and writes every metrics row twice.
- No compilation cache and no distributed bootstrap: one process
  (several are ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import itertools
import os
import sys

import torch

from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.core.config import (
    instantiate,
    load_config,
    prepare_run_dir,
    to_plain,
)
from oneprot_tpu_torch.utils.loggers import CsvLogger, MultiLogger, get_pylogger
from oneprot_tpu_torch.utils.utils import extras, task_wrapper

log = get_pylogger("train")


def build_model(model_cfg, device: torch.device, seed: int):
    """`model.components` built on `device` with weights drawn from `seed`
    (one generator, encoder by encoder), then the module around them; an
    encoder built from a local HF directory then takes its weights
    (`OneProtModule.load_pretrained`, after the seeded draw, which would
    overwrite them)."""
    from oneprot_tpu_torch.models.bert import init_bert_weights_
    from oneprot_tpu_torch.models.encoders import MsaEncoder, TextEncoder
    from oneprot_tpu_torch.models.esm2 import init_esm2_weights_
    from oneprot_tpu_torch.models.msa_transformer import init_msa_weights_

    model_cfg = dict(model_cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    components = {}
    for name, comp_cfg in (model_cfg.pop("components", None) or {}).items():
        encoder = instantiate({**comp_cfg, "device": device})
        if isinstance(encoder, MsaEncoder):
            init_msa_weights_(encoder, generator)
        elif isinstance(encoder, TextEncoder):
            init_bert_weights_(encoder, generator)
        else:
            init_esm2_weights_(encoder, generator)
        components[name] = encoder
    module = instantiate({**model_cfg, "seed": seed}, components=components)
    module.load_pretrained()
    return module


@task_wrapper
def train(cfg) -> dict:
    """Run one training task from a resolved config."""
    from oneprot_tpu_torch.train.checkpoint import CheckpointManager
    from oneprot_tpu_torch.train.trainer import select_device

    seed = int(cfg.get("seed", 0))
    output_dir = cfg["paths"]["output_dir"]
    log.info(f"output_dir: {output_dir}")

    data_dir = str(cfg["paths"]["data_dir"])
    if data_dir.endswith("synthetic") or not (
            os.path.isdir(data_dir) and os.listdir(data_dir)):
        from oneprot_tpu_torch.data.synthetic import ensure_fixtures

        log.info(f"generating synthetic fixtures in {data_dir}")
        ensure_fixtures(data_dir)

    log.info("Instantiating datamodule")
    datamodule = instantiate({**dict(cfg["data"]), "seed": seed})

    device = select_device(str(cfg["trainer"].get("accelerator", "auto")))
    log.info(f"Instantiating model on {device}")
    module = build_model(cfg["model"], device, seed)

    log.info("Instantiating trainer")
    trainer = instantiate(cfg["trainer"])

    loggers = [CsvLogger(output_dir)]
    for name, lg_cfg in (cfg.get("logger") or {}).items():
        if isinstance(lg_cfg, dict) and "_target_" in lg_cfg:
            try:
                lg = instantiate(lg_cfg)
            except ImportError as e:  # an optional dependency is absent
                log.warning(f"logger {name} unavailable: {e}")
                continue
            if not (isinstance(lg, CsvLogger) and os.path.abspath(lg.save_dir)
                    == os.path.abspath(output_dir)):
                loggers.append(lg)
    logger = MultiLogger(loggers)
    logger.log_hyperparams(to_plain(cfg))

    metrics = {}
    if cfg.get("train", True):
        log.info("Starting training")
        metrics = trainer.fit(module, datamodule,
                              ckpt_path=cfg.get("ckpt_path"),
                              callbacks=cfg.get("callbacks"), logger=logger,
                              output_dir=output_dir)

    if cfg.get("test", False):
        test_only = not cfg.get("train", True)
        if test_only:
            # fit() never ran: set the trainer and the module up here
            trainer.setup(module, datamodule, callbacks=cfg.get("callbacks"),
                          logger=logger, output_dir=output_dir)
        if test_only and cfg.get("ckpt_path"):
            # the checkpoint asked for is the one tested
            log.info(f"Starting testing ({cfg['ckpt_path']})")
            CheckpointManager.restore_path(str(cfg["ckpt_path"]), module)
        else:
            log.info("Starting testing (best checkpoint)")
            if os.path.isdir(os.path.join(output_dir, "checkpoints", "best")):
                trainer.callbacks["checkpoint"].restore(module, "best")
        metrics.update(trainer.test(module, datamodule))

    logger.finalize()
    return metrics


def expand_multirun(overrides):
    """hydra-style `-m a=1,2 b=x,y` -> the cartesian product of override sets."""
    choices = []
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if sep and "," in val and not val.startswith("["):
            choices.append([f"{key}={v}" for v in val.split(",")])
        else:
            choices.append([ov])
    return [list(combo) for combo in itertools.product(*choices)]


def extract_sweeper(argv):
    """Split the sweeper's overrides (`hydra/sweeper=optuna`,
    `hydra.sweeper.<opt>=...`, `hydra.sweeper.params.<key>=<space>`) from
    the others: (name, options, params, the rest)."""
    sweeper_name = None
    options, params, rest = {}, {}, []
    for ov in argv:
        key, sep, val = ov.partition("=")
        key = key.lstrip("+")
        if key == "hydra/sweeper":
            sweeper_name = val
        elif key.startswith("hydra.sweeper.params."):
            params[key[len("hydra.sweeper.params."):]] = val
        elif key.startswith("hydra.sweeper."):
            options[key[len("hydra.sweeper."):]] = val
        else:
            rest.append(ov)
    return sweeper_name, options, params, rest


def run_search(sweeper_name, options, params, base_overrides, config_dir):
    """Sequential ask/tell hyperparameter search over train()."""
    from oneprot_tpu_torch.core.sweep import make_sweeper

    objective = options.pop("objective", "val/loss")
    direction = options.pop("direction", "minimize")
    kwargs = {}
    for k in ("n_trials", "seed", "n_startup_trials", "n_candidates"):
        if k in options:
            kwargs[k] = int(float(options.pop(k)))
    if "gamma" in options:
        kwargs["gamma"] = float(options.pop("gamma"))
    sweeper = make_sweeper(sweeper_name, params, direction=direction, **kwargs)
    sign = 1.0 if direction == "minimize" else -1.0
    all_metrics = []
    best = (float("inf"), None)
    trial_idx = 0
    while True:
        trial = sweeper.ask()
        if trial is None:
            break
        combo = base_overrides + [f"{k}={v}" for k, v in trial.items()]
        log.info(f"search trial {trial_idx} ({sweeper_name}): {trial}")
        cfg = prepare_run_dir(load_config(config_dir, "train", overrides=combo))
        extras(cfg)
        metrics = dict(train(cfg))
        value = float(metrics.get(objective, float("nan")))
        sweeper.tell(trial, value)
        metrics["search/trial"] = trial_idx
        metrics.update({f"search/{k}": v for k, v in trial.items()})
        all_metrics.append(metrics)
        if sign * value < best[0]:
            best = (sign * value, trial)
        trial_idx += 1
    log.info(f"search best {objective}={sign * best[0]:.6f} params={best[1]}")
    return all_metrics


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = default_config_dir()
    multirun = False
    for flag in ("-m", "--multirun"):
        if flag in argv:
            argv.remove(flag)
            multirun = True
    if multirun:
        sweeper_name, options, params, rest = extract_sweeper(argv)
        if sweeper_name not in (None, "basic") and params:
            return run_search(sweeper_name, options, params, rest, config_dir)
        all_metrics = []
        for i, combo in enumerate(expand_multirun(rest)):
            log.info(f"multirun job {i}: {combo}")
            cfg = prepare_run_dir(load_config(config_dir, "train",
                                              overrides=combo))
            extras(cfg)
            all_metrics.append(train(cfg))
        return all_metrics
    cfg = prepare_run_dir(load_config(config_dir, "train", overrides=argv))
    extras(cfg)
    return train(cfg)


if __name__ == "__main__":
    metrics = main()
    for m in metrics if isinstance(metrics, list) else [metrics]:
        printable = {k: round(float(v), 4) for k, v in m.items()
                     if isinstance(v, (int, float))}
        log.info(f"final metrics: {printable}")
