"""The port's config layer against the JAX package's, on the CPU.

`oneprot_tpu_torch.core.yaml_io` against PyYAML's safe_load on every file
under configs/ and on a table of scalars and override values, its writer
read back by PyYAML, and the subset's refusals; the port's `load_config`
against the JAX one on every top-level config, experiment, debug preset
and trainer, before and after interpolation at a fixed stamp and fixed
environment values; the cases of tests/test_config.py, ported; the probes
of the verify recipe; and `_target_` rewriting, with a refusal naming its
ROADMAP.md item for every committed target the port has no counterpart
for. PyYAML is imported by this test only; a subprocess with `yaml`
blocked composes every config and imports neither `yaml` nor the JAX
package.
"""

import datetime
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from oneprot_tpu.core import config as jax_config
from oneprot_tpu_torch.core import config, yaml_io
from oneprot_tpu_torch.core.config import (
    ConfigStore,
    apply_override,
    instantiate,
    load_config,
    merge,
    resolve,
    to_config,
    to_plain,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "configs"
YAML_FILES = sorted(CONFIG_DIR.rglob("*.yaml"))
STAMP = "2026-01-02_03-04-05"


def test_config_tree_has_71_files():
    assert len(YAML_FILES) == 71


@pytest.mark.parametrize("path", YAML_FILES,
                         ids=lambda p: str(p.relative_to(CONFIG_DIR)))
def test_reader_matches_pyyaml(path):
    text = path.read_text()
    assert yaml_io.load(text, source=str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("path", YAML_FILES,
                         ids=lambda p: str(p.relative_to(CONFIG_DIR)))
def test_writer_round_trips_config_file(path):
    tree = yaml_io.load(path.read_text(), source=str(path))
    text = yaml_io.dump(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_io.load(text) == tree


# scalars and override values: YAML 1.1 as PyYAML resolves it
SCALARS = [
    "1e-3", "1.0e-3", "1.0e3", "6.8523015e+5", "685.230_15e+03", "1E+10",
    "-1.5", "3.", ".5", "+12", "-0", "0.", "1_0.5", "yes", "no", "on", "off",
    "Off", "YES", "y", "n", "True", "TRUE", "false", "~", "null", "Null", "",
    "0x10", "-0x1F", "0b101", "010", "09", "0o10", "1_000", "12:30",
    "190:20:30", "1:30.5", ".inf", "-.inf", "+.inf", ".nan", ".NaN", "NaN",
    "2024-01-31", "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10",
    "2001-12-14 21:59:43.10 Z", "2001-1-2 3:04:05", "[64, 128]", "[64,128]",
    "['query', 'key', 'value']", "[]", "{}", "{a: 1, b: [x, y]}",
    "{train: 4, val: 4, test: 4}", "{a, b: }", "[a, [b, c], {d: e}]",
    "'quoted'", "'it''s'", '"dq \\n \\t \\x41 \\u00e9 \\/ \\\\"', "${paths.data_dir}",
    "${paths.data_dir}/train_saprot.h5", "${oc.env:PROJECT_ROOT,.}",
    "tag(log, interval(0.0001, 0.1))", "a:b", "http://x:1/y", "a#b",
    "abc # comment", "#only", "foo bar", "- a", "- [a, b]", "a: 1\nb: [2, 3]",
    "- - a\n  - b\n- c", "k:\n- a\n- b\nm: 1", "--- \na: 1", " a: 1\n b: 2",
    "a:\n  b:\n    c: 1\n  d: 2", "x'y", 'x"y', "?x", "-x", "é", "/tmp/a b",
]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_matches_pyyaml(text):
    assert _same(yaml_io.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("value", ["1e-3", "1.0e-3", "yes", "off", "~", "0x10",
                                   "1_000", ".inf", "[64, 128]", "'1e-3'",
                                   "${paths.data_dir}", "", "12:30",
                                   "2024-01-31", "{a: 1}", "foo"])
def test_override_value_matches_jax(value):
    mine = apply_override(to_config({"x": {"v": 0}}), f"x.v={value}")
    theirs = jax_config.apply_override(jax_config.to_config({"x": {"v": 0}}),
                                       f"x.v={value}")
    assert _same(mine["x"]["v"], theirs["x"]["v"]) or mine == theirs
    assert (config._looks_like_literal(value)
            == jax_config._looks_like_literal(value))


@pytest.mark.parametrize("text,what", [
    ("a: &x 1", "anchors"), ("a: *x", "aliases"), ("a: !tag x", "tags"),
    ("a: |\n  text", "block scalars"), ("a: >\n  text", "block scalars"),
    ("a: x\n  y", "several lines"), ("a: [1,\n 2]", "several lines"),
    ("a: 'x\n  y'", "several lines"), ("a: 1\n---\nb: 2", "several documents"),
    ("? a\n: b", "complex keys"), ("a:\n\tb: 1", "tabs"), ("a: 1\n...", "end"),
    ("[a: 1]", "flow sequence"), ("%YAML 1.1\n---\na: 1", "directives"),
])
def test_reader_refuses_outside_subset_naming_line(text, what):
    with pytest.raises(yaml_io.YamlError) as err:
        yaml_io.load(text, source="configs/x.yaml")
    msg = str(err.value)
    assert msg.startswith("configs/x.yaml, line ") and what in msg


def test_writer_round_trips_awkward_values():
    tree = {
        "strings": ["yes", "1", "1e-3", "", " a", "a ", "a: b", "#x", "x #y",
                    "null", "~", "-", "- a", "é", "new\nline", "tab\there",
                    "${x.y}", "[a]", "{a}", '"q"', "'s'", "---", "...", "a:",
                    "?x", "@x", "\x00", "\u2028", "2024-01-31", "0x10",
                    "true", "On", "12:30", ".inf"],
        "floats": [1e-5, 1e16, 0.1, -2.5, 100.0, float("inf"), float("-inf"),
                   1.5e-07],
        "ints": [0, -3, 10**20], "bools": [True, False], "none": None,
        "empty": {"d": {}, "l": []}, "nested": [[1, [2, []]], {"a": [{"b": 1}]}],
        "dates": [datetime.date(2024, 1, 31)],
        1: "int key", True: "bool key", None: "null key", "1": "str key",
    }
    text = yaml_io.dump(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_io.load(text) == tree
    nan = yaml.safe_load(yaml_io.dump({"x": float("nan")}))["x"]
    assert math.isnan(nan)
    assert yaml.safe_load(yaml_io.dump("top")) == "top"
    assert yaml.safe_load(yaml_io.dump([])) == []


# ---------------------------------------------------------------------------
# composition against the JAX package

TOP_LEVEL = ["train", "eval", "collect_embeddings", "saprot_mlp",
             "saprot_sweep_xgboost_cls", "saprot_sweep_xgboost_reg"]
EXPERIMENTS = sorted(p.stem for p in (CONFIG_DIR / "experiment").glob("*.yaml"))
COMPOSE_CASES = (
    [(name, []) for name in TOP_LEVEL]
    + [("train", [f"experiment={e}"]) for e in EXPERIMENTS]
    + [("train", [f"debug={p.stem}"])
       for p in sorted((CONFIG_DIR / "debug").glob("*.yaml"))]
    + [("train", [f"trainer={p.stem}"])
       for p in sorted((CONFIG_DIR / "trainer").glob("*.yaml"))]
    + [("train", ["experiment=debug_struct_token", "model.optimizer.lr=1e-3",
                  "data.buckets=[64,128]", "+foo.bar=yes",
                  "~callbacks.model_summary", "seed=0x10", "logger=many_loggers"]),
       ("train", ["experiment=train_packed", "trainer=gpu",
                  "data=struct_token_only",
                  "model.components.sequence.dtype=bfloat16"]),
       ("train", ["data=null", "+data.x=1"]),
       ("train", ["experiment=nope"]), ("train", ["trianer.x=1"]),
       ("nope", [])])


def test_twelve_experiments():
    assert len(EXPERIMENTS) == 12


def _compose(mod, name, overrides):
    try:
        cfg = mod.load_config(CONFIG_DIR, name, overrides)
        resolved = mod.resolve(cfg, resolvers={"hydra": lambda a: "/run/out",
                                               "now": lambda a: STAMP})
        return mod.to_plain(cfg), mod.to_plain(resolved)
    except Exception as e:  # the same failure in both packages
        return type(e)


@pytest.mark.parametrize("name,overrides", COMPOSE_CASES,
                         ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_compose_matches_jax(monkeypatch, name, overrides):
    monkeypatch.setenv("ONEPROT_DATA_DIR", "/data/fixed")
    monkeypatch.setenv("PROJECT_ROOT", "/project")
    monkeypatch.delenv("ONEPROT_TEXT_VOCAB", raising=False)
    assert _compose(config, name, overrides) == _compose(jax_config, name,
                                                         overrides)


def test_prepare_run_dir_matches_jax(tmp_path):
    overrides = ["experiment=debug_struct_token",
                 f"paths.data_dir={tmp_path / 'data'}"]
    mine = config.prepare_run_dir(load_config(CONFIG_DIR, "train", overrides),
                                  output_dir=str(tmp_path / "run"))
    snap_yaml = yaml.safe_load((tmp_path / "run" / "resolved_config.yaml").read_text())
    snap_json = json.loads((tmp_path / "run" / "resolved_config.json").read_text())
    theirs = jax_config.prepare_run_dir(
        jax_config.load_config(CONFIG_DIR, "train", overrides),
        output_dir=str(tmp_path / "run"))
    assert to_plain(mine) == jax_config.to_plain(theirs) == snap_yaml == snap_json
    assert mine.paths.output_dir == str(tmp_path / "run")


def test_prepare_run_dir_stamps_the_template(tmp_path):
    cfg = load_config(CONFIG_DIR, "train", [f"paths.log_dir={tmp_path}",
                                            "experiment=debug_struct_token"])
    resolved = config.prepare_run_dir(cfg)
    out = Path(resolved.paths.output_dir)
    assert out.parent == tmp_path / "train" / "runs" and out.is_dir()
    datetime.datetime.strptime(out.name, "%Y-%m-%d_%H-%M-%S")
    assert resolved.hydra.run.dir == str(out)


# ---------------------------------------------------------------------------
# the cases of tests/test_config.py


def test_merge_deep():
    out = merge(to_config({"x": {"y": 1, "z": 2}, "k": 3}),
                {"x": {"y": 10}, "new": 4})
    assert out.x.y == 10 and out.x.z == 2 and out.k == 3 and out.new == 4


def test_interpolation_absolute_and_relative():
    cfg = to_config({
        "model": {"sequence": {"output_dim": 1024},
                  "text": {"output_dim": "${..sequence.output_dim}"}},
        "paths": {"root": "/tmp/x", "log": "${paths.root}/logs"},
    })
    r = resolve(cfg)
    assert r.model.text.output_dim == 1024
    assert r.paths.log == "/tmp/x/logs"


def test_interpolation_env(monkeypatch):
    monkeypatch.setenv("ONEPROT_TEST_VAR", "hello")
    cfg = to_config({"a": "${oc.env:ONEPROT_TEST_VAR}",
                     "b": "${oc.env:MISSING_VAR,fallback}"})
    r = resolve(cfg)
    assert r.a == "hello" and r.b == "fallback"


def test_apply_override():
    cfg = to_config({"a": {"b": 1}})
    apply_override(cfg, "a.b=5")
    assert cfg.a.b == 5
    apply_override(cfg, "+a.c=hi")
    assert cfg.a.c == "hi"
    with pytest.raises(KeyError):
        apply_override(cfg, "a.missing=1")
    apply_override(cfg, "~a.c")
    assert "c" not in cfg.a


def test_compose_train_config():
    cfg = load_config(CONFIG_DIR, "train")
    for group in ("data", "model", "trainer", "callbacks", "paths", "extras"):
        assert group in cfg, f"missing group {group}"
    assert cfg.task_name == "train"
    assert cfg.seed == 1881
    assert "sequence" in cfg.model.components


def test_compose_group_override_and_value_override():
    cfg = load_config(CONFIG_DIR, "train", overrides=["trainer=cpu", "seed=7"])
    assert cfg.seed == 7
    assert cfg.trainer.accelerator == "cpu"


def test_output_dim_interpolation_ties_to_hub():
    cfg = load_config(CONFIG_DIR, "train",
                      overrides=["model.components.sequence.output_dim=128"])
    r = resolve(cfg, resolvers={"hydra": lambda a: "/tmp/out"})
    for comp in ("struct_token", "text"):
        if comp in r.model.components:
            assert r.model.components[comp]["output_dim"] == 128


def test_experiment_overlay():
    cfg = load_config(CONFIG_DIR, "train",
                      overrides=["experiment=debug_struct_token"])
    assert "struct_token" in cfg.data.modalities
    assert cfg.model.components.sequence.model_name_or_path.endswith(
        "esm2_t6_8M_UR50D")


def test_instantiate_with_target():
    out = instantiate({"_target_": "collections.OrderedDict", "a": 1})
    assert dict(out) == {"a": 1}
    p = instantiate({"_target_": "operator.add", "_partial_": True})
    assert p(2, 3) == 5


def test_reference_target_alias():
    enc = instantiate({
        "_target_": "src.models.components.struct_token_encoder.StructTokenEncoder",
        "model_name_or_path": "facebook/esm2_t6_8M_UR50D",
        "output_dim": 32, "device": "cpu",
    })
    assert type(enc).__module__ == "oneprot_tpu_torch.models.encoders"
    assert enc(torch.full((1, 8), 5)).shape == (1, 32)
    text = instantiate({
        "_target_": "src.models.components.text_encoder.TextEncoder",
        "model_name_or_path": "bert_tiny", "output_dim": 32, "device": "cpu",
        "dtype": "float32"})
    assert type(text).__name__ == "TextEncoder"
    graph = instantiate({
        "_target_": "src.models.components.struct_graph_encoder.StructEncoder",
        "encoder": {"hidden_size": 16, "num_layers": 1, "out_channels": 32},
        "output_dim": 32, "device": "cpu"})
    assert type(graph).__name__ == "StructGraphEncoder"
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        instantiate({"_target_": "oneprot_tpu.downstream.mlp_probe.MLPProbeConfig"})


# ---------------------------------------------------------------------------
# the verify recipe's probes


def test_typo_key_raises_key_error_naming_it():
    for mod in (config, jax_config):
        with pytest.raises(KeyError, match="trianer.max_epochs"):
            mod.load_config(CONFIG_DIR, "train", ["trianer.max_epochs=1"])


def test_unknown_experiment_lists_the_options():
    with pytest.raises(FileNotFoundError) as err:
        load_config(CONFIG_DIR, "train", ["experiment=nope"])
    msg = str(err.value)
    assert "'nope'" in msg and "group 'experiment'" in msg
    assert all(e in msg for e in EXPERIMENTS)


# ---------------------------------------------------------------------------
# targets


def _committed_targets():
    found = set()

    def walk(node):
        if isinstance(node, dict):
            if "_target_" in node:
                found.add(node["_target_"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    for path in YAML_FILES:
        walk(yaml.safe_load(path.read_text()))
    return sorted(found)


TARGETS = _committed_targets()
# the committed targets the port has: each rewritten to oneprot_tpu_torch
PORTED = {
    "oneprot_tpu.data.datamodule.OneProtDataModule",
    "oneprot_tpu.data.datasets.msa_dataset.MSADataset",
    "oneprot_tpu.data.datasets.seqsim_dataset.SequenceSimDataset",
    "oneprot_tpu.data.datasets.struct_graph_dataset.StructDataset",
    "oneprot_tpu.data.datasets.struct_token_dataset.StructTokenDataset",
    "oneprot_tpu.data.datasets.text_dataset.TextDataset",
    "oneprot_tpu.models.encoders.create_msa_encoder",
    "oneprot_tpu.models.encoders.create_struct_graph_encoder",
    "oneprot_tpu.models.encoders.create_sequence_encoder",
    "oneprot_tpu.models.encoders.create_struct_token_encoder",
    "oneprot_tpu.models.encoders.create_text_encoder",
    "oneprot_tpu.train.module.OneProtModule",
    "oneprot_tpu.train.optim.adam",
    "oneprot_tpu.train.trainer.Trainer",
    "oneprot_tpu.utils.loggers.CsvLogger",
}
ITEMS = {"downstream": 10, "WandbLogger": 11}


def test_committed_targets_are_known():
    assert len(TARGETS) == 19 and PORTED <= set(TARGETS)
    for target in set(TARGETS) - PORTED:
        assert any(part in target for part in ITEMS), target


@pytest.mark.parametrize("target", TARGETS)
def test_target_rewritten_or_refused_naming_item(target):
    assert config.port_target(target) == "oneprot_tpu_torch" + target[len(
        "oneprot_tpu"):]
    if target in PORTED:
        obj = config._locate(target)
        assert obj.__module__.startswith("oneprot_tpu_torch.")
        assert obj.__qualname__ == target.rsplit(".", 1)[1]
    else:
        item = next(n for part, n in ITEMS.items() if part in target)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md Queue 1 item {item} "):
            config._locate(target)


def test_alias_applies_before_the_rewrite(monkeypatch):
    monkeypatch.setitem(config.TARGET_ALIASES,
                        "oneprot_tpu.train.trainer.Trainer", "collections.Counter")
    assert config._locate("oneprot_tpu.train.trainer.Trainer") is __import__(
        "collections").Counter


def test_composes_and_locates_without_yaml_or_the_jax_package():
    """In a fresh process with `yaml` blocked: every config composes and
    resolves, every committed target is located or refused, and neither
    yaml, jax nor oneprot_tpu is imported."""
    cases = [[name, ovs] for name, ovs in COMPOSE_CASES[:-3]]
    code = f"""
import sys
sys.modules["yaml"] = None
from oneprot_tpu_torch.core import config
for name, ovs in {cases!r}:
    cfg = config.load_config({str(CONFIG_DIR)!r}, name, ovs)
    config.resolve(cfg, resolvers={{"hydra": lambda a: "/o", "now": lambda a: "s"}})
located = 0
for target in {TARGETS!r}:
    try:
        config._locate(target)
        located += 1
    except NotImplementedError:
        pass
bad = [m for m in sys.modules if m.split(".")[0] in ("yaml", "jax", "oneprot_tpu")
       and sys.modules[m] is not None]
print(located, bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[0] == str(len(PORTED))


def test_stamp_broadcast_and_rank0_snapshot(monkeypatch, tmp_path):
    """Under a process group the run stamp goes through the broadcast
    (rank 0's on every rank: two ranks in tests/test_torch_distributed.py)
    and rank 0 writes the snapshot; another rank writes nothing."""
    from oneprot_tpu_torch.core import collectives, mesh
    from tests.helpers.torch_dist_child import group_of_one

    cfg = load_config(CONFIG_DIR, "train", ["experiment=debug_struct_token",
                                            f"paths.log_dir={tmp_path}/logs"])
    sent = []
    monkeypatch.setattr(collectives, "broadcast_object",
                        lambda obj, src=0: sent.append(obj) or obj)
    with group_of_one(tmp_path):
        resolved = config.prepare_run_dir(cfg)
    out = resolved["paths"]["output_dir"]
    assert len(sent) == 1 and sent[0] in out
    assert os.path.isfile(os.path.join(out, "resolved_config.yaml"))
    monkeypatch.setattr(mesh, "world", lambda: (2, 1))
    config.snapshot_config(resolved, str(tmp_path / "rank1"))
    assert not os.path.exists(tmp_path / "rank1" / "resolved_config.yaml")


def test_store_refuses_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        ConfigStore(tmp_path / "nope")
