"""Checkpoints: `last` after every validation, `best` on improvement
(counterpart of oneprot_tpu/train/checkpoint.py: `CheckpointManager`,
with torch.save where the JAX package uses Orbax).

A checkpoint is a directory `<dirpath>/<name>/` holding `state.pt`: the
model's whole state_dict, the optimizer's state (its learning rates
included) and the module's step. Beside it, `<name>.metrics.json` holds the
validation metrics it was saved with, the trainer's epoch and whether the
epoch had completed, and `checkpoint/best_value`, the best monitored value
so far, which a resumed run takes up. When `best` is saved with `last` it
is a hard link to the same file (a copy where links are refused).

`restore_any` takes such a checkpoint or a reference-trained Lightning
`.ckpt`; an Orbax directory written by the JAX package is refused (the
port has no Orbax reader: convert its params with
`convert.oneprot_state_dict`). `PeftCheckpoint` writes the hub's LoRA
factors in peft's layout on every improvement.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
BEST_VALUE_KEY = "checkpoint/best_value"


def state_of(module) -> dict:
    return {"model": module.model.state_dict(),
            "optimizer": module.opt.base.state_dict(),
            "step": int(module.step)}


def load_state(module, path: str, state: Optional[dict] = None) -> None:
    """Restore a checkpoint directory (or its state file, or that file's
    loaded `state`) into an initialised module, on the module's device."""
    if state is None:
        path = os.path.abspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, STATE_FILE)
        state = torch.load(path, map_location=module.device, weights_only=True)
    module.model.load_state_dict(state["model"])
    module.opt.base.load_state_dict(state["optimizer"])
    module.step = int(state["step"])


class CheckpointManager:
    def __init__(
        self,
        dirpath: str,
        monitor: str = "val/loss_best",
        mode: str = "min",
        save_last: bool = True,
        save_top_k: int = 1,
    ):
        del save_top_k  # one best checkpoint, as in the JAX package
        self.dirpath = os.path.abspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.best_value: Optional[float] = None

    def _improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value < self.best_value if self.mode == "min" else value > self.best_value

    def _write(self, name: str, state: Optional[dict], link_to: Optional[str],
               metrics: Dict[str, float]) -> str:
        """Write <name>/state.pt (torch.save of `state`, or a link to
        `link_to`) through a temporary file, then the sidecar."""
        path = os.path.join(self.dirpath, name)
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, STATE_FILE)
        tmp = target + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
        if link_to is None:
            torch.save(state, tmp)
        else:
            try:
                os.link(link_to, tmp)
            except OSError:
                shutil.copyfile(link_to, tmp)
        os.replace(tmp, target)
        with open(os.path.join(self.dirpath, f"{name}.metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
        return path

    def on_validation_end(self, module, metrics: Dict[str, float]) -> Dict[str, str]:
        """Save 'last' (always) and 'best' (on monitored improvement)."""
        value = metrics.get(self.monitor)
        improved = value is not None and self._improved(float(value))
        if improved:
            self.best_value = float(value)
        if self.best_value is not None:
            metrics = {**metrics, BEST_VALUE_KEY: self.best_value}
        saved = {}
        state = state_of(module)
        if self.save_last:
            saved["last"] = self._write("last", state, None, metrics)
        if improved:
            link = (os.path.join(saved["last"], STATE_FILE) if "last" in saved
                    else None)
            saved["best"] = self._write("best", state, link, metrics)
        return saved

    def restore(self, module, name: str = "last") -> None:
        path = name if os.path.isabs(name) else os.path.join(self.dirpath, name)
        load_state(module, path)

    @staticmethod
    def restore_path(path: str, module) -> None:
        load_state(module, path)


def restore_any(module, run_dir, ckpt) -> str:
    """Restore `module` from a checkpoint of the port (`best` / `last` under
    run_dir/checkpoints, a checkpoint directory or its state file) or a
    reference-trained Lightning `.ckpt` file (told apart by its contents).
    Returns what was restored. Raises FileNotFoundError when `ckpt` names
    nothing that exists, and ValueError on an Orbax directory of the JAX
    package."""
    from oneprot_tpu_torch.models.hf_convert import convert_oneprot_state_dict

    ckpt = str(ckpt)
    if os.path.isfile(ckpt):
        obj = torch.load(ckpt, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and {"model", "optimizer", "step"} <= set(obj):
            load_state(module, ckpt, obj)
            return f"checkpoint {ckpt}"
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        module.model.load_state_dict(convert_oneprot_state_dict(
            sd, module.encoders, module.model.state_dict(), seed=module.seed))
        return f"lightning checkpoint {ckpt}"
    path = ckpt if os.path.isdir(ckpt) else os.path.join(
        run_dir or "", "checkpoints", ckpt)
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        load_state(module, path)
        return f"checkpoint {path}"
    if os.path.isdir(path):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: an Orbax checkpoint of the JAX "
            "package? The port reads no Orbax; restore it with the JAX "
            "package and carry its params over with "
            "oneprot_tpu_torch.convert.oneprot_state_dict")
    raise FileNotFoundError(f"no checkpoint at {path}")


class PeftCheckpoint:
    """Save only the hub's LoRA adapter on each improvement of `monitor`
    (the reference's PeftBestModelCheckpoint), in peft's tensor layout, to
    `dirpath/adapter_model.npz`, the file the JAX package writes."""

    def __init__(self, dirpath: str, monitor: str = "val/loss",
                 encoder_name: str = "sequence", num_layers: int = 0):
        self.dirpath = dirpath
        self.monitor = monitor
        self.encoder_name = encoder_name
        self.num_layers = num_layers
        self.best: Optional[float] = None

    def on_validation_end(self, module,
                          metrics: Dict[str, Any]) -> Optional[str]:
        from oneprot_tpu_torch.models.hf_convert import export_peft_lora

        value = metrics.get(self.monitor)
        if value is None or (self.best is not None and value >= self.best):
            return None
        self.best = float(value)
        enc = module.encoders.get(self.encoder_name)
        if enc is None:
            return None
        adapter = export_peft_lora(enc.transformer.state_dict(),
                                   self.num_layers)
        if not adapter:
            return None
        os.makedirs(self.dirpath, exist_ok=True)
        out = os.path.join(self.dirpath, "adapter_model.npz")
        np.savez(out, **adapter)
        return out
