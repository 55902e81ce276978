"""The port's training CLI against the JAX package's, on the CPU.

Both packages' `train(cfg)` on the same `generate_fixtures` data, composed
from configs/ with the overrides of tests/test_train.py (tiny ESM2 towers,
2 epochs of 2 batches, a loss logged every step, then the test split):
`experiment=debug_struct_token` unpacked, and packed through the frozen
hub's feature cache. The port starts from the JAX init (the JAX module's
`init` on the data module's example batches), carried over by
`convert.oneprot_state_dict` in a module subclass the test aliases in for
the config's target. Every logged loss, val/loss and the test metrics
agree at 1e-4, train/steps, the checkpoint names and resolved_config.json
are equal. Then the port's own seeded init (two runs, identical losses),
the test-only `ckpt_path` divergence in both packages, multirun, the
sweeper search end to end and its trials against the JAX sweepers, the
refusal of `trainer=default` without CUDA, `logger=wandb` (its CSV fallback
against the JAX CLI's), pretrained weights, `experiment=seq_text` (the fully cached steps of a
frozen text tower) against the JAX CLI, and one
`python -m oneprot_tpu_torch.cli.train` process with `yaml` blocked that
imports neither jax nor oneprot_tpu.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oneprot_tpu.cli import train as jax_cli
from oneprot_tpu.core import config as jax_config
from oneprot_tpu.core import sweep as jax_sweep
from oneprot_tpu.data.synthetic import generate_fixtures
from oneprot_tpu.models import esm2 as jax_esm2
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.cli import train as port_cli
from oneprot_tpu_torch.core import config, sweep
from oneprot_tpu_torch.models import encoders
from oneprot_tpu_torch.models import esm2 as port_esm2
from oneprot_tpu_torch.train.module import OneProtModule

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = str(ROOT / "configs")
RTOL = 1e-4  # f32 on the CPU, the bar of tests/test_torch_trainer.py
TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
MODULE_TARGET = "oneprot_tpu.train.module.OneProtModule"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_fixtures"))
    generate_fixtures(d, n_train=8, n_eval=4, seed=0)
    return d


@pytest.fixture(autouse=True)
def tiny_esm2(monkeypatch):
    """esm2_t6_8M shrunk to 2 layers of 32 in both packages."""
    monkeypatch.setitem(jax_esm2.ESM2_SIZES, "esm2_t6_8M",
                        jax_esm2.Esm2Config(**TINY))
    monkeypatch.setitem(port_esm2.ESM2_SIZES, "esm2_t6_8M",
                        port_esm2.Esm2Config(**TINY))


def overrides(data_dir, *extra):
    """tests/test_train.py's overrides, 2 epochs, a loss a step, tested."""
    return ["experiment=debug_struct_token", f"paths.data_dir={data_dir}",
            "model.components.sequence.output_dim=32",
            "data.default_batch_size=4",
            "data.modalities.struct_token.batch_size.train=4",
            "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
            "trainer.max_epochs=2", "trainer.log_every_n_steps=1",
            "extras.print_config=false", "test=True", *extra]


PACKED = ["data.pack_sequences=true", "data.pack_rows=2",
          "data.pack_row_len=128", "data.pack_slots=4",
          "model.components.sequence.frozen=true",
          "trainer.cache_frozen_features=true"]


def run_port(ovs, out):
    cfg = config.prepare_run_dir(config.load_config(CONFIG_DIR, "train", ovs),
                                 output_dir=str(out))
    return port_cli.train(cfg)


def run_jax(ovs, out):
    cfg = jax_config.prepare_run_dir(
        jax_config.load_config(CONFIG_DIR, "train", ovs), output_dir=str(out))
    return jax_cli.train(cfg)


def rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f if line.strip()]


# the port's module from the JAX init: set by the test, read by the subclass
INITIAL = {}


class JaxInitModule(OneProtModule):
    """OneProtModule whose weights are INITIAL['params'] (a JAX tree)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.load_state_dict(
            convert.oneprot_state_dict(INITIAL["params"]))


def jax_initial_params(ovs):
    """The JAX package's init for these overrides, as its Trainer.setup
    makes it: the seeded module init on the data module's example batches."""
    cfg = jax_config.resolve(jax_config.load_config(CONFIG_DIR, "train", ovs),
                             resolvers={"hydra": lambda a: "/unused"})
    dm = jax_config.instantiate({**cfg["data"], "seed": cfg.seed})
    dm.setup()
    module = jax_config.instantiate({**cfg["model"], "seed": cfg.seed})
    module.init(dm.example_batches())
    return jax.tree.map(np.asarray, module.state.params)


@pytest.mark.parametrize("extra", [[], PACKED], ids=["unpacked", "packed-cache"])
def test_cli_matches_jax(data_dir, tmp_path, monkeypatch, extra):
    ovs = overrides(data_dir, *extra)
    jmet = run_jax(ovs, tmp_path / "jax")
    monkeypatch.setitem(INITIAL, "params", jax_initial_params(ovs))
    monkeypatch.setitem(config.TARGET_ALIASES, MODULE_TARGET,
                        f"{__name__}.JaxInitModule")
    pmet = run_port(ovs, tmp_path / "port")

    # the JAX CLI's two CsvLoggers write every row twice; the port's once
    jall = rows(tmp_path / "jax")
    jrows, prows = jall[::2], rows(tmp_path / "port")
    assert jall[1::2] == jrows
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in prows] == [r["step"] for r in jrows]
    steps = pmet["train/steps"]
    assert steps == jmet["train/steps"] == 4  # 2 epochs of 2 batches
    # train/loss and train/loss_struct_token at every step
    assert sum(k.startswith("train/loss") for r in prows for k in r) == 2 * steps
    assert any(k.startswith("test/") for r in prows for k in r)
    for p, j in zip(prows, jrows):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)
    assert sorted(pmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(pmet[k], jmet[k], rtol=RTOL, err_msg=k)
    if extra:
        assert pmet["cache/hit_rate"] == jmet["cache/hit_rate"] > 0
    assert (sorted(os.listdir(tmp_path / "port" / "checkpoints"))
            == sorted(os.listdir(tmp_path / "jax" / "checkpoints"))
            == ["best", "best.metrics.json", "last", "last.metrics.json"])
    with open(tmp_path / "jax" / "resolved_config.json") as f:
        want = f.read().replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    with open(tmp_path / "port" / "resolved_config.json") as f:
        assert json.loads(f.read()) == json.loads(want)


def test_seeded_runs_train_identically(data_dir, tmp_path):
    """The CLI draws the weights from cfg.seed: the same seed twice gives
    the same losses, another seed others."""
    runs = []
    for name, seed in (("a", 5), ("b", 5), ("c", 6)):
        run_port(overrides(data_dir, f"seed={seed}", "test=False"),
                 tmp_path / name)
        runs.append([r[k] for r in rows(tmp_path / name) for k in sorted(r)
                     if "loss" in k])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_test_only_ckpt_path_is_what_gets_tested(data_dir, tmp_path):
    """Run A (seed 1) and run B (seed 2), one epoch each, test on `best`
    (= `last`). Then a test-only run in B's run dir with ckpt_path = A's
    last: the port tests A's weights; the JAX CLI restores B's best over
    them (oneprot_tpu/cli/train.py:86-104) and tests B's."""
    def three_runs(run, root):
        out = {}
        for name, seed in (("A", 1), ("B", 2)):
            m = run(overrides(data_dir, f"seed={seed}", "trainer.max_epochs=1"),
                    root / name)
            out[name] = {k: v for k, v in m.items() if k.startswith("test/")}
        m = run(overrides(data_dir, "train=False",
                          f"ckpt_path={root / 'A' / 'checkpoints' / 'last'}"),
                root / "B")
        out["test_only"] = {k: v for k, v in m.items() if k.startswith("test/")}
        return out

    port = three_runs(run_port, tmp_path / "port")
    assert port["A"] != port["B"]
    assert port["test_only"] == pytest.approx(port["A"], rel=1e-6)
    jax_runs = three_runs(run_jax, tmp_path / "jax")
    assert jax_runs["A"] != jax_runs["B"]
    assert jax_runs["test_only"] == pytest.approx(jax_runs["B"], rel=1e-6)


def test_multirun_two_values(data_dir, tmp_path):
    metrics = port_cli.main([
        "-m", *overrides(data_dir, "test=False"), "seed=1,2",
        f"hydra.run.dir={tmp_path}/seed_${{seed}}"])
    assert len(metrics) == 2
    assert metrics[0]["val/loss"] != metrics[1]["val/loss"]
    for seed in (1, 2):
        with open(tmp_path / f"seed_{seed}" / "resolved_config.json") as f:
            assert json.load(f)["seed"] == seed


def test_search_sweep_end_to_end(data_dir, tmp_path):
    """tests/test_sweeps.py:111 on the port: a 3-trial TPE search."""
    metrics = port_cli.main([
        "-m", *overrides(data_dir, "test=False", "trainer.max_epochs=1"),
        "hydra/sweeper=optuna", "hydra.sweeper.n_trials=3",
        "hydra.sweeper.n_startup_trials=2",
        "hydra.sweeper.params.model.optimizer.lr="
        "tag(log, interval(0.0001, 0.01))",
        f"hydra.run.dir={tmp_path}/lr_${{model.optimizer.lr}}"])
    assert len(metrics) == 3
    want = jax_sweep.make_sweeper(
        "optuna", {"model.optimizer.lr": "tag(log, interval(0.0001, 0.01))"},
        n_trials=3, n_startup_trials=2)
    for i, m in enumerate(metrics):
        assert np.isfinite(m["val/loss"]) and m["search/trial"] == i
        trial = want.ask()
        assert m["search/model.optimizer.lr"] == trial["model.optimizer.lr"]
        want.tell(trial, m["val/loss"])
    assert len(os.listdir(tmp_path)) == 3


SPACES = {"x": "interval(0, 1)", "lr": "tag(log, interval(0.0001, 0.1))",
          "depth": "int(interval(2, 8))", "act": "choice(relu, gelu)",
          "w": "16,32,64"}


@pytest.mark.parametrize("name,kwargs", [
    ("grid", {}), ("random", dict(n_trials=12, seed=3)),
    ("optuna", dict(n_trials=24, seed=1, n_startup_trials=6)),
    ("tpe", dict(n_trials=16, seed=0, direction="maximize"))])
def test_sweepers_propose_jax_trials(name, kwargs):
    params = ({k: v for k, v in SPACES.items() if k in ("act", "w")}
              if name == "grid" else SPACES)
    mine = sweep.make_sweeper(name, params, **kwargs)
    theirs = jax_sweep.make_sweeper(name, params, **kwargs)
    n = 0
    while True:
        a, b = mine.ask(), theirs.ask()
        assert a == b
        if a is None:
            break
        value = (a.get("x", 0.5) - 0.3) ** 2 + len(str(a["act"]))
        mine.tell(a, value)
        theirs.tell(b, value)
        n += 1
    assert n == kwargs.get("n_trials", 6)


@pytest.mark.parametrize("spec", ["interval(0.001, 0.1)",
                                  "tag(log, interval(0.0001, 0.1))",
                                  "int(interval(2, 8))", "choice(relu, gelu)",
                                  "range(1, 7, 2)", "16,32,64", "x"])
def test_parse_space_matches_jax(spec):
    a, b = sweep.parse_space(spec), jax_sweep.parse_space(spec)
    assert vars(a) == vars(b)


def test_expand_and_extract_match_jax():
    argv = ["experiment=debug_struct_token", "seed=1,2", "data.buckets=[64,128]",
            "hydra/sweeper=optuna", "hydra.sweeper.n_trials=4",
            "hydra.sweeper.params.model.optimizer.lr=tag(log, interval(1e-4, 1e-2))",
            "model.optimizer.lr=0.1,0.01"]
    assert port_cli.extract_sweeper(argv) == jax_cli.extract_sweeper(argv)
    rest = port_cli.extract_sweeper(argv)[3]
    assert port_cli.expand_multirun(rest) == jax_cli.expand_multirun(rest)
    assert len(port_cli.expand_multirun(rest)) == 4


def test_default_trainer_without_cuda_names_the_accelerator(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ovs = [o for o in overrides(data_dir) if not o.startswith("experiment")]
    ovs = ["experiment=debug_struct_token", "trainer=default", *ovs]
    with pytest.raises(RuntimeError, match="accelerator='auto' needs a CUDA"):
        run_port(ovs, tmp_path / "run")


def test_unported_modality_refused_naming_item(data_dir, tmp_path,
                                              monkeypatch):
    """Every modality and every committed target is ported: the shipped
    debug_struct_token with `logger=wandb` and wandb absent trains to its
    end through the logger's CSV fallback, as the JAX CLI does."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    met = run_port(overrides(data_dir, "logger=wandb", "test=False"),
                   tmp_path / "run")
    assert met["train/steps"] == 4
    for name in ("metrics.jsonl", "wandb_fallback.csv", "wandb_fallback.jsonl"):
        assert os.path.isfile(tmp_path / "run" / name), name


# seq_text.yaml's towers (ESM2-35M hub, bert_small text tower) shrunk in
# both packages: 2 hub layers of 32; 2 BERT layers of 64 with one head of 64
# (the head width of every BERT size) over the tiny WordPiece vocabulary
TINY_BERT = dict(hidden_size=64, num_layers=2, num_heads=1,
                 intermediate_size=128)


def test_cli_seq_text_matches_jax(data_dir, tmp_path, monkeypatch):
    """`experiment=seq_text` in both CLIs (in f32, the frozen leaves stored
    bf16 as the model config says): the frozen text tower runs the fully
    cached steps, 2 epochs of 2 batches and the test split. Every logged
    loss, val/loss and the test metrics agree at 1e-4."""
    from oneprot_tpu.models import bert as jax_bert
    from oneprot_tpu_torch.models import bert as port_bert

    monkeypatch.setitem(jax_esm2.ESM2_SIZES, "esm2_t12_35M",
                        jax_esm2.Esm2Config(**TINY))
    monkeypatch.setitem(port_esm2.ESM2_SIZES, "esm2_t12_35M",
                        port_esm2.Esm2Config(**TINY))
    monkeypatch.setitem(jax_bert.BERT_SIZES, "bert_small",
                        jax_bert.BertConfig(**TINY_BERT))
    monkeypatch.setitem(port_bert.BERT_SIZES, "bert_small",
                        port_bert.BertConfig(**TINY_BERT))
    ovs = ["experiment=seq_text", "trainer=cpu", f"paths.data_dir={data_dir}",
           "model.components.sequence.output_dim=32",
           "model.components.sequence.dtype=float32",
           "model.components.text.dtype=float32",
           "data.modalities.text.batch_size.train=4",
           "data.modalities.text.batch_size.val=4",
           "data.modalities.text.batch_size.test=4",
           "trainer.limit_train_batches=2", "trainer.max_epochs=2",
           "trainer.log_every_n_steps=1", "extras.print_config=false",
           "test=True"]
    jmet = run_jax(ovs, tmp_path / "jax")
    monkeypatch.setitem(INITIAL, "params", jax_initial_params(ovs))
    monkeypatch.setitem(config.TARGET_ALIASES, MODULE_TARGET,
                        f"{__name__}.JaxInitModule")
    pmet = run_port(ovs, tmp_path / "port")

    jrows, prows = rows(tmp_path / "jax")[::2], rows(tmp_path / "port")
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    assert pmet["train/steps"] == jmet["train/steps"] == 4
    assert any(k.startswith("test/") for r in prows for k in r)
    for p, j in zip(prows, jrows):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)
    assert sorted(pmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(pmet[k], jmet[k], rtol=RTOL, err_msg=k)
    # epoch 2 and the validations come from the cache of both towers
    assert pmet["cache/hit_rate"] == jmet["cache/hit_rate"] > 0


def test_unported_logger_refused_naming_item(data_dir, tmp_path, monkeypatch):
    """`logger=wandb` without wandb in both CLIs from the JAX init: the
    port's `wandb_fallback` rows equal the JAX CLI's at 1e-4, and both
    write them beside metrics.jsonl."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    ovs = overrides(data_dir, "logger=wandb")
    run_jax(ovs, tmp_path / "jax")
    monkeypatch.setitem(INITIAL, "params", jax_initial_params(ovs))
    monkeypatch.setitem(config.TARGET_ALIASES, MODULE_TARGET,
                        f"{__name__}.JaxInitModule")
    run_port(ovs, tmp_path / "port")

    def fallback(run_dir):
        with open(os.path.join(run_dir, "wandb_fallback.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"}
                    for line in f if line.strip()]

    jrows, prows = fallback(tmp_path / "jax"), fallback(tmp_path / "port")
    assert [list(r) for r in prows] == [list(r) for r in jrows] and prows
    for p, j in zip(prows, jrows):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)
    with open(tmp_path / "jax" / "wandb_fallback.csv") as f:
        jheader = f.readline()
    with open(tmp_path / "port" / "wandb_fallback.csv") as f:
        assert f.readline() == jheader
    assert rows(tmp_path / "port") == prows


def test_pretrained_weights_refused_naming_item(tmp_path):
    """A local HF directory is no longer refused: a directory with weights
    becomes the encoder's `pretrained_dir` (loaded by
    `OneProtModule.load_pretrained`), one without stays a config."""
    hub = tmp_path / "esm2_local"
    hub.mkdir()
    (hub / "config.json").write_text(json.dumps({
        "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 64}))
    assert encoders.create_sequence_encoder(
        str(hub), device="cpu").pretrained_dir is None
    (hub / "model.safetensors").write_bytes(b"")
    for factory in (encoders.create_sequence_encoder,
                    encoders.create_struct_token_encoder):
        assert factory(str(hub), device="cpu").pretrained_dir == str(hub)
    assert encoders.create_sequence_encoder(
        str(hub), pretrained=False, device="cpu").pretrained_dir is None


def test_cli_process_without_yaml_or_jax(data_dir, tmp_path):
    """`python -m oneprot_tpu_torch.cli.train` through a wrapper that blocks
    yaml: it trains and tests, and imports neither jax nor oneprot_tpu."""
    run_dir = tmp_path / "run"
    code = f"""
import json, runpy, sys
sys.modules["yaml"] = None
from oneprot_tpu_torch.models import esm2
esm2.ESM2_SIZES["esm2_t6_8M"] = esm2.Esm2Config(**{TINY!r})
sys.argv = ["train"] + {overrides(data_dir, f"hydra.run.dir={run_dir}")!r}
runpy.run_module("oneprot_tpu_torch.cli.train", run_name="__main__")
bad = [m for m in sys.modules if m.split(".")[0] in ("yaml", "jax", "oneprot_tpu")
       and sys.modules[m] is not None]
print(json.dumps(bad))
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    names = os.listdir(run_dir)
    for name in ("resolved_config.json", "resolved_config.yaml",
                 "metrics.jsonl", "checkpoints"):
        assert name in names
    assert any("test/loss" in r for r in rows(run_dir))
