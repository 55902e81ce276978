"""Two run dirs on the same weights, one per package, for the eval and
serving tests of the port: `experiment=debug_all_modalities` at tiny
widths (ESM2 32 x 2, the MSA tower in f32, the graph towers' noise off),
its params from the JAX init, saved as a JAX Orbax `best` in one and as a
port `best` (through `convert.oneprot_state_dict`) in the other. Each dir
holds its package's `resolved_config.yaml`."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

CONFIG_DIR = str(Path(__file__).resolve().parents[2] / "configs")
TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
OVERRIDES = ["experiment=debug_all_modalities", "extras.print_config=false",
             "model.components.msa.dtype=float32",
             *[f"model.components.{m}.encoder.{k}={v}"
               for m in ("struct_graph", "pocket")
               for k, v in (("euler_noise", "false"),
                            ("data_augment_eachlayer", "false"),
                            ("dropout", "0.0"))]]


def tiny_sizes():
    """Put the tiny ESM2 under the debug configs' name in both packages;
    returns a function that puts the originals back."""
    from oneprot_tpu.models import esm2 as jax_esm2

    from oneprot_tpu_torch.models import esm2

    saved = (jax_esm2.ESM2_SIZES["esm2_t6_8M"], esm2.ESM2_SIZES["esm2_t6_8M"])
    jax_esm2.ESM2_SIZES["esm2_t6_8M"] = jax_esm2.Esm2Config(**TINY)
    esm2.ESM2_SIZES["esm2_t6_8M"] = esm2.Esm2Config(**TINY)

    def restore():
        jax_esm2.ESM2_SIZES["esm2_t6_8M"], esm2.ESM2_SIZES["esm2_t6_8M"] = saved

    return restore


def make_runs(root: str, n_eval: int = 6) -> dict:
    """{"data": fixtures dir, "jax": run dir, "port": run dir, "module":
    the port's module (its `best` weights)}. Call under `tiny_sizes`."""
    import jax

    from oneprot_tpu.core import config as jax_config
    from oneprot_tpu.train.checkpoint import CheckpointManager as JaxManager

    from oneprot_tpu_torch import convert
    from oneprot_tpu_torch.cli.train import build_model
    from oneprot_tpu_torch.core import config
    from oneprot_tpu_torch.data.synthetic import generate_fixtures
    from oneprot_tpu_torch.train.checkpoint import CheckpointManager

    data = os.path.join(root, "data")
    generate_fixtures(data, n_train=4, n_eval=n_eval, seed=0)
    ovs = OVERRIDES + [f"paths.data_dir={data}"]
    jax_run, port_run = os.path.join(root, "jax"), os.path.join(root, "port")
    jcfg = jax_config.prepare_run_dir(
        jax_config.load_config(CONFIG_DIR, "train", ovs), output_dir=jax_run)
    jmod = jax_config.instantiate(dict(jcfg["model"]))
    jmod.init_for_restore()
    JaxManager(os.path.join(jax_run, "checkpoints")).on_validation_end(
        jmod.state, {"val/loss_best": 1.0})
    params = jax.tree_util.tree_map(np.asarray, jmod.state.params)
    pcfg = config.prepare_run_dir(config.load_config(CONFIG_DIR, "train", ovs),
                                  output_dir=port_run)
    module = build_model(pcfg["model"], torch.device("cpu"), int(pcfg["seed"]))
    module.model.load_state_dict(convert.oneprot_state_dict(params))
    module.init()
    CheckpointManager(os.path.join(port_run, "checkpoints")).on_validation_end(
        module, {"val/loss_best": 1.0})
    return {"data": data, "jax": jax_run, "port": port_run, "module": module}
