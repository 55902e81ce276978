"""MLP downstream probe entry point of the port (counterpart of the root
saprot_fit_mlp.py). Config form, composing `configs/saprot_mlp.yaml`:

    python -m oneprot_tpu_torch.cli.saprot_fit_mlp emb_dir=<dir> \\
        task_name=EC [model.learning_rate=0.01] ['sweep.learning_rate=[1e-3,1e-2]']

Legacy flag form:

    python -m oneprot_tpu_torch.cli.saprot_fit_mlp --embeddings-dir <dir> \\
        --task EC [--lr 1e-3] [--sweep-lr 1e-3 1e-2]

Reads the `{task}_{split}_embeddings_labels.npz` files that
`cli.collect_embeddings` writes, fits the probe on the card (`+device=cpu`
or `--device cpu` for the CPU) and appends a row a run to
`results_dir/{task}_mlp_results.csv` (flag form: `--output-csv`).
"""

from __future__ import annotations

import argparse
import os
import sys

from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.downstream.mlp_probe import (
    MLPProbeConfig,
    fit_mlp_probe,
    sweep_mlp_probe,
)
from oneprot_tpu_torch.downstream.utils import load_data, save_results_to_csv

# saprot_mlp.yaml's model keys -> MLPProbeConfig fields
_KEYMAP = {
    "learning_rate": "lr",
    "dropout_rate": "dropout",
    "hidden_dims": "hidden_dims",
    "batch_size": "batch_size",
    "max_epochs": "max_epochs",
    "early_stopping_patience": "patience",
    "weight_decay": "weight_decay",
}


def load_splits(emb_dir: str, task: str, splits, threshold=None) -> dict:
    thr = None if threshold in (None, "null", "") else float(threshold)
    return {split: load_data(
        os.path.join(emb_dir, f"{task}_{split}_embeddings_labels.npz"),
        binarize_threshold=thr) for split in splits}


def _fit(splits: dict, task: str, base: MLPProbeConfig, sweep: dict,
         device) -> list:
    args = (splits["train"], splits["valid"], splits["test"], task)
    if sweep:
        return sweep_mlp_probe(*args, sweep=sweep, base=base, device=device)
    return [fit_mlp_probe(*args, base, device=device)]


def main_config(argv, device=None):
    from oneprot_tpu_torch.core.config import load_config, to_plain

    cfg = to_plain(load_config(default_config_dir(), "saprot_mlp.yaml",
                               overrides=argv))
    task = cfg["task_name"]
    splits = load_splits(cfg["emb_dir"], task,
                         cfg.get("evaluate_on", ["train", "valid", "test"]),
                         cfg.get("threshold"))
    model = cfg.get("model", {})
    base = MLPProbeConfig(**{field: model[key] for key, field in _KEYMAP.items()
                             if key in model})
    sweep = {_KEYMAP.get(k, k): v for k, v in (cfg.get("sweep") or {}).items()}
    results = _fit(splits, task, base, sweep, device or cfg.get("device"))
    results_dir = cfg.get("results_dir", ".")
    os.makedirs(results_dir, exist_ok=True)
    out_csv = os.path.join(results_dir, f"{task}_mlp_results.csv")
    for r in results:
        r["task"] = task
        r["model_type"] = cfg.get("model_type", "oneprot")
        save_results_to_csv(r, out_csv)
        print(r)
    return results


def main_flags(argv, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--embeddings-dir", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--output-csv", default="mlp_probe_results.csv")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--hidden-dims", type=int, nargs="*", default=[512])
    p.add_argument("--sweep-lr", type=float, nargs="*", default=None)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    splits = load_splits(args.embeddings_dir, args.task,
                         ("train", "valid", "test"))
    base = MLPProbeConfig(hidden_dims=args.hidden_dims, lr=args.lr,
                          batch_size=args.batch_size,
                          max_epochs=args.max_epochs)
    sweep = {"lr": args.sweep_lr} if args.sweep_lr else {}
    results = _fit(splits, args.task, base, sweep, device or args.device)
    for r in results:
        r["task"] = args.task
        save_results_to_csv(r, args.output_csv)
        print(r)
    return results


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a.startswith("--") for a in argv):
        return main_flags(argv, device)
    return main_config(argv, device)


if __name__ == "__main__":
    main()
