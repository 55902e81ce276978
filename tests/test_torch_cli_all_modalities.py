"""`experiment=debug_all_modalities` through the port's CLI and the JAX
package's, on the CPU: all six modalities (struct_token, text,
struct_graph, pocket, msa, seqsim) on the shared synthetic fixtures, the
port starting from the JAX init (`convert.oneprot_state_dict` in a module
subclass aliased in for the config's target). The MSA tower runs in f32
and the graph towers' noise and dropout are off (their draws cannot be
JAX's); the graph augmentations and the seqsim mutations come from numpy
RandomStates in both. Every logged loss, val/loss and the test metrics
agree at 1e-4, the step counts exactly.
"""

import json
import os
from pathlib import Path

import jax
import numpy as np

from oneprot_tpu.models import esm2 as jax_esm2
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.core import config
from oneprot_tpu_torch.data.synthetic import generate_fixtures
from oneprot_tpu_torch.models import esm2
from oneprot_tpu_torch.train.module import OneProtModule

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = str(ROOT / "configs")
RTOL = 1e-4
TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
MODULE_TARGET = "oneprot_tpu.train.module.OneProtModule"
QUIET_GRAPHS = [f"model.components.{m}.encoder.{k}={v}"
                for m in ("struct_graph", "pocket")
                for k, v in (("euler_noise", "false"),
                             ("data_augment_eachlayer", "false"),
                             ("dropout", "0.0"))]


class JaxInitModule(OneProtModule):
    """OneProtModule whose weights are INITIAL['params'] (a JAX tree)."""

    INITIAL: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.load_state_dict(
            convert.oneprot_state_dict(self.INITIAL["params"]))


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f if line.strip()]


def test_cli_all_modalities_matches_jax(tmp_path, monkeypatch):
    """`experiment=debug_all_modalities` in both CLIs, the MSA tower in f32
    and the graph towers' noise and dropout off (the graph augmentations
    and the seqsim mutations come from numpy RandomStates in both): every
    logged loss, val/loss and the test metrics at 1e-4, the same steps."""
    from oneprot_tpu.cli import train as jax_cli
    from oneprot_tpu.core import config as jax_config
    from oneprot_tpu_torch.cli import train as port_cli

    data_dir = str(tmp_path / "data")
    generate_fixtures(data_dir, n_train=8, n_eval=4, seed=0)
    monkeypatch.setitem(jax_esm2.ESM2_SIZES, "esm2_t6_8M",
                        jax_esm2.Esm2Config(**TINY))
    monkeypatch.setitem(esm2.ESM2_SIZES, "esm2_t6_8M", esm2.Esm2Config(**TINY))
    ovs = ["experiment=debug_all_modalities", f"paths.data_dir={data_dir}",
           "model.components.msa.dtype=float32",
           "trainer.log_every_n_steps=1", "extras.print_config=false",
           *QUIET_GRAPHS]
    jcfg = jax_config.prepare_run_dir(
        jax_config.load_config(CONFIG_DIR, "train", ovs),
        output_dir=str(tmp_path / "jax"))
    jmet = jax_cli.train(jcfg)
    cfg = jax_config.resolve(jax_config.load_config(CONFIG_DIR, "train", ovs),
                             resolvers={"hydra": lambda a: "/unused"})
    dm = jax_config.instantiate({**cfg["data"], "seed": cfg.seed})
    dm.setup()
    jmod = jax_config.instantiate({**cfg["model"], "seed": cfg.seed})
    jmod.init(dm.example_batches())
    monkeypatch.setitem(JaxInitModule.INITIAL, "params",
                        jax.tree.map(np.asarray, jmod.state.params))
    monkeypatch.setitem(config.TARGET_ALIASES, MODULE_TARGET,
                        f"{__name__}.JaxInitModule")
    pcfg = config.prepare_run_dir(config.load_config(CONFIG_DIR, "train", ovs),
                                  output_dir=str(tmp_path / "port"))
    pmet = port_cli.train(pcfg)

    jrows, prows = _rows(tmp_path / "jax")[::2], _rows(tmp_path / "port")
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    assert pmet["train/steps"] == jmet["train/steps"] == 12  # 2 batches x 6
    for p, j in zip(prows, jrows):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)
    assert sorted(pmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(pmet[k], jmet[k], rtol=RTOL, err_msg=k)
