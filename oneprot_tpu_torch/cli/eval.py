"""Retrieval evaluation entry point of the port (counterpart of
oneprot_tpu/cli/eval.py):

    python -m oneprot_tpu_torch.cli.eval run_dir=<run> [csv_file=...] \\
        [ckpt_path=<best|last|dir|lightning .ckpt>] [batch_size=16]

Composes `configs/eval.yaml`, loads the trained run on the device of its
`trainer.accelerator`, embeds every modality of the combined CSV, and
writes the all-pairs R@{1,10,100,500} and median ranks to
`run_dir/retrieval_results.csv` (`evaluation/retrieval_eval.py`).
"""

from __future__ import annotations

import sys

from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.core.config import load_config, prepare_run_dir
from oneprot_tpu_torch.evaluation.retrieval_eval import run_eval


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(default_config_dir(), "eval", overrides=argv)
    cfg = prepare_run_dir(cfg)
    return run_eval(cfg)


if __name__ == "__main__":
    main()
