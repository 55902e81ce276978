"""Command-line entry points (counterpart of oneprot_tpu/cli/ and the root
collect_embeddings.py, saprot_fit_*.py and lmdb_csv_converter.py): the
console scripts `train_command_torch`, `eval_command_torch`,
`collect_embeddings_command_torch`, `saprot_fit_{mlp,cls,reg}_command_torch`
and `lmdb_csv_converter_command_torch`, and `python -m
oneprot_tpu_torch.cli.<name>`."""

import os


def default_config_dir() -> str:
    """The config tree: $ONEPROT_CONFIG_DIR, else the checkout's `configs/`
    (two levels above this package), else `./configs` under the caller's
    working directory (an installed wheel)."""
    env = os.environ.get("ONEPROT_CONFIG_DIR")
    if env:
        return env
    repo = os.path.abspath(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    cand = os.path.join(repo, "configs")
    if os.path.isdir(cand):
        return cand
    return os.path.join(os.getcwd(), "configs")
