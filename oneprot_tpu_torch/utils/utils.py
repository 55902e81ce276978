"""Run plumbing: extras, the task wrapper and the config tree (counterpart
of oneprot_tpu/utils/utils.py; its `log_hyperparameters`, which nothing
calls, is left out: the CLI logs the resolved config itself).

`print_config_tree` prints plain text, each top-level group as YAML through
`core.yaml_io`, where the JAX package draws a rich tree.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, Sequence

from oneprot_tpu_torch.core import yaml_io
from oneprot_tpu_torch.core.config import to_plain
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

_PRINT_ORDER = ("data", "model", "trainer", "callbacks", "logger", "paths",
                "extras")


def extras(cfg: Dict[str, Any]) -> None:
    """Optional pre-task behaviours: silence warnings, warn on missing tags,
    print the config tree."""
    ex = cfg.get("extras") or {}
    if ex.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags") and not cfg.get("tags"):
        log.warning("no tags provided (extras.enforce_tags=True)")
    if ex.get("print_config", True):
        print_config_tree(cfg)


def print_config_tree(cfg: Dict[str, Any],
                      order: Sequence[str] = _PRINT_ORDER) -> None:
    """Print the config, the groups of `order` first, each as YAML."""
    try:
        plain = to_plain(cfg)
        keys = [k for k in order if k in plain]
        keys += [k for k in plain if k not in keys]
        out = ["CONFIG"]
        for key in keys:
            value = plain[key]
            if isinstance(value, dict) and value:
                out.append(f"+-- {key}")
                out.extend("|   " + line
                           for line in yaml_io.dump(value).splitlines())
            else:
                out.append(f"+-- {key}: {yaml_io.dump(value).strip()}")
        print("\n".join(out), flush=True)
    except Exception as e:  # printing must never kill a run
        log.warning(f"config tree printing failed: {e}")


def task_wrapper(task_func: Callable) -> Callable:
    """Log and re-raise a task's failure; always log the output dir."""

    @functools.wraps(task_func)
    def wrap(cfg: Dict[str, Any], *args: Any, **kwargs: Any):
        try:
            return task_func(cfg, *args, **kwargs)
        except Exception:
            log.exception("task failed")
            raise
        finally:
            out = (cfg.get("paths") or {}).get("output_dir")
            if out:
                log.info(f"Output dir: {out}")

    return wrap

