"""Boosted-classifier downstream probe entry point of the port
(counterpart of the root saprot_fit_cls.py). Config form, composing
`configs/saprot_sweep_xgboost_cls.yaml` (its `downstream_model` group
instantiated through the target rewrite):

    python -m oneprot_tpu_torch.cli.saprot_fit_cls emb_dir=<dir> \\
        task_name=TopEnzyme [downstream_model.max_depth=5]

Legacy flag form: `--embeddings-dir <dir> --task TopEnzyme`. Fits on the
host with xgboost, else sklearn's HistGradientBoosting; where neither is
installed (the card's host) it raises ImportError naming both. Appends the
row to `results_dir/{task}_xgb_results.csv` (flag form: `--output-csv`).
"""

from __future__ import annotations

import argparse
import os
import sys

from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.cli.saprot_fit_mlp import load_splits
from oneprot_tpu_torch.downstream.boosters import (
    fit_booster,
    make_classifier,
    make_regressor,
)
from oneprot_tpu_torch.downstream.utils import save_results_to_csv


def main_config(argv, config_name):
    from oneprot_tpu_torch.core.config import instantiate, load_config, to_plain

    cfg = to_plain(load_config(default_config_dir(), config_name,
                               overrides=argv))
    task = cfg["task_name"]
    splits = load_splits(cfg["emb_dir"], task,
                         cfg.get("evaluate_on", ["train", "valid", "test"]),
                         cfg.get("threshold"))
    model = instantiate(cfg["downstream_model"])
    result = fit_booster(splits["train"], splits["valid"], splits["test"],
                         task, model=model)
    results_dir = cfg.get("results_dir", ".")
    os.makedirs(results_dir, exist_ok=True)
    result["task"] = task
    result["model_type"] = cfg.get("model_type", "oneprot")
    save_results_to_csv(result, os.path.join(
        results_dir, f"{task}_xgb_results.csv"))
    print(result)
    return result


def main_flags(argv, regression: bool = False):
    p = argparse.ArgumentParser()
    p.add_argument("--embeddings-dir", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--output-csv", default="booster_results.csv")
    p.add_argument("--n-estimators", type=int, default=500)
    p.add_argument("--max-depth", type=int, default=6)
    p.add_argument("--learning-rate", type=float, default=0.1)
    args = p.parse_args(argv)

    splits = load_splits(args.embeddings_dir, args.task,
                         ("train", "valid", "test"))
    model = (make_regressor if regression else make_classifier)(
        n_estimators=args.n_estimators, max_depth=args.max_depth,
        learning_rate=args.learning_rate)
    result = fit_booster(splits["train"], splits["valid"], splits["test"],
                         args.task, model=model)
    result["task"] = args.task
    save_results_to_csv(result, args.output_csv)
    print(result)
    return result


def main(argv=None, regression: bool = False,
         config_name: str = "saprot_sweep_xgboost_cls.yaml"):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a.startswith("--") for a in argv):
        return main_flags(argv, regression=regression)
    return main_config(argv, config_name)


if __name__ == "__main__":
    main()
