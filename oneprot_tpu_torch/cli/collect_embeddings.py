"""Embedding-collection entry point of the port (counterpart of the root
collect_embeddings.py):

    python -m oneprot_tpu_torch.cli.collect_embeddings tasks=[ToyCls] \\
        +models.esm2.checkpoint_dir=<HF dir> downstream_dir=<csvs>

Composes `configs/collect_embeddings.yaml` and runs
`evaluation.collect_embeddings.run_collection` on the card (`+device=cpu`
for the CPU); prints the combined files.
"""

from __future__ import annotations

import sys

from oneprot_tpu_torch.cli import default_config_dir
from oneprot_tpu_torch.core.config import load_config, prepare_run_dir
from oneprot_tpu_torch.evaluation.collect_embeddings import run_collection


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(default_config_dir(), "collect_embeddings",
                      overrides=argv)
    cfg = prepare_run_dir(cfg)
    return run_collection(cfg, device)


if __name__ == "__main__":
    print("\n".join(main()))
