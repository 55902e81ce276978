"""The port's downstream probes (`oneprot_tpu_torch/downstream/`) against
the JAX package's, on the CPU.

f1_max on random and tied scores (1e-12); every `compute_metrics` branch
(sklearn's and scipy's numbers, as the JAX code takes them, against the
port's numpy ones: a missing class, labels that are not 0..C-1, one class
in the labels, tied scores, constant regression predictions; the same
keys present); the metric functions against sklearn and scipy directly;
`fit_mlp_probe` for the multi-label, classification, ppi and regression
families from the JAX initial weights (`convert.mlp_probe_state_dict`),
dropout 0: metrics and `val_loss` within rel 1e-4 and the same epochs
run; early stopping on a validation loss that turns; the sweep's rows;
the results CSV byte for byte; the boosters with sklearn's
HistGradientBoosting, their ImportError without xgboost and sklearn and
their ValueError on a multi-label task; the LMDB converter through one
fake `lmdb` module (through both converter entry points); the wandb
logger through a fake `wandb` module and its CSV fallback; the entry
points against the root scripts on the same
`{task}_{split}_embeddings_labels.npz` files (`saprot_fit_mlp` in config
form, a sweep over `saprot_mlp.yaml`'s learning rate and flag form, from
the JAX initial weights at dropout 0; `saprot_fit_cls` and
`saprot_fit_reg` in config form: the results CSVs' names, columns and
values within 1e-4). That importing them loads none of sklearn, xgboost,
lmdb, wandb and scipy is checked in tests/test_torch_config.py's process
with `yaml` blocked.
"""

import csv
import functools
import json
import os
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import saprot_fit_cls as root_cls
import saprot_fit_mlp as root_mlp
import saprot_fit_reg  # noqa: F401  (the root regressor entry imports)

from oneprot_tpu.downstream import boosters as jboost
from oneprot_tpu.downstream import lmdb_converter as jlmdb
from oneprot_tpu.downstream import mlp_probe as jprobe
from oneprot_tpu.downstream import utils as jutils
from oneprot_tpu.utils import loggers as jloggers
from oneprot_tpu_torch import convert
from oneprot_tpu_torch.cli import saprot_fit_cls as port_cls
from oneprot_tpu_torch.cli import saprot_fit_mlp as port_mlp
from oneprot_tpu_torch.cli import saprot_fit_reg as port_reg
from oneprot_tpu_torch.downstream import boosters as pboost
from oneprot_tpu_torch.downstream import lmdb_converter as plmdb
from oneprot_tpu_torch.downstream import mlp_probe as pprobe
from oneprot_tpu_torch.downstream import utils as putils
from oneprot_tpu_torch.utils import loggers as ploggers

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4  # the probe's f32 training, as tests/test_torch_trainer.py
pytestmark = pytest.mark.filterwarnings("ignore")


def assert_metrics_equal(got: dict, want: dict, rtol: float) -> None:
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# f1_max and the metrics


@pytest.mark.parametrize("case", ["random", "tied", "saturated"])
def test_count_f1_max_matches_jax(case):
    rng = np.random.RandomState(3)
    pred = rng.rand(12, 40)
    if case == "tied":
        pred = np.round(pred, 1)
    elif case == "saturated":  # float32 sigmoids of large logits tie at 1.0
        logits = (rng.randn(12, 40) * 20).astype(np.float32)
        pred = 1.0 / (1.0 + np.exp(-logits))
    target = (rng.rand(12, 40) > 0.7).astype(np.int32)
    target[0] = 0  # a sample with no positive label
    assert putils.count_f1_max(pred, target) == pytest.approx(
        jutils.count_f1_max(pred, target), rel=1e-12, abs=0)


def _cls(rng, n, c, labels=None):
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, n) if labels is None else labels)


def _metric_cases():
    rng = np.random.RandomState(7)
    dup = rng.randn(20, 4).astype(np.float32)
    cases = {
        "multiclass": ("classification",) + _cls(rng, 60, 5),
        "binary": ("classification",) + _cls(rng, 60, 2),
        "ppi": ("ppi",) + _cls(rng, 60, 2),
        # a class of the logits absent from the labels: no auc in either
        "missing class": ("classification",) + _cls(
            rng, 60, 3, rng.randint(0, 2, 60)),
        # labels {0, 1, 3} over 3 columns: columns map to the sorted labels
        "labels not 0..C-1": ("classification",) + _cls(
            rng, 60, 3, rng.choice([0, 1, 3], 60)),
        # one class: sklearn's auc is NaN (a warning) in both
        "one class": ("classification",) + _cls(rng, 60, 2, np.ones(60, int)),
        "one class, 3 columns": ("classification",) + _cls(
            rng, 60, 3, np.full(60, 2)),
        # equal logit rows: their scores tie in every column
        "tied rows": ("classification", np.repeat(dup, 3, axis=0),
                      rng.randint(0, 4, 60)),
        # a booster's float64 log-probabilities with -30 for absent classes
        "booster logits": ("classification", np.where(
            rng.rand(60, 4) < 0.2, -30.0, np.log(rng.rand(60, 4))),
            rng.randint(0, 4, 60)),
        "regression": ("regression", rng.randn(60, 1).astype(np.float32),
                       rng.randn(60).astype(np.float32)),
        "regression ties": ("regression",
                            np.round(rng.randn(60, 1), 1).astype(np.float32),
                            np.round(rng.randn(60), 1).astype(np.float32)),
        "regression constant": ("regression", np.full((60, 1), 0.5, np.float32),
                                rng.randn(60).astype(np.float32)),
        "multi-label": ("multi-label", rng.randn(30, 12).astype(np.float32),
                        (rng.rand(30, 12) > 0.8).astype(np.int32)),
    }
    return cases


METRIC_CASES = _metric_cases()


@pytest.mark.parametrize("name", list(METRIC_CASES))
def test_compute_metrics_matches_jax(name):
    task_type, logits, labels = METRIC_CASES[name]
    want = jprobe.compute_metrics(task_type, logits, labels)
    got = pprobe.compute_metrics(task_type, logits, labels)
    # the float32 softmax is XLA's bit for bit under 33 classes
    assert_metrics_equal(got, want, rtol=1e-9)
    if name in ("missing class", "one class, 3 columns"):
        assert "auc" not in got
    if name == "one class":
        assert np.isnan(got["auc"])
    if name == "regression constant":
        assert np.isnan(got["spearman"])


def test_metric_functions_match_sklearn_and_scipy():
    from scipy.stats import spearmanr
    from sklearn.metrics import accuracy_score, f1_score, roc_auc_score

    rng = np.random.RandomState(11)
    # the probabilities: XLA's exp and softmax bit for bit
    x = (rng.randn(64, 24) * 5).astype(np.float32)
    assert np.array_equal(putils.softmax_f32(x),
                          np.asarray(jax.nn.softmax(jax.numpy.asarray(x), -1)))
    x = -np.abs(rng.randn(4096) * 30).astype(np.float32)
    assert np.array_equal(putils.exp_f32(x), np.asarray(jax.numpy.exp(x)))
    for _ in range(20):
        n, c = rng.randint(5, 80), rng.randint(2, 6)
        y = rng.randint(0, c, n)
        pred = rng.randint(0, c + 1, n)  # a predicted label y lacks
        assert putils.accuracy(y, pred) == accuracy_score(y, pred)
        assert putils.macro_f1(y, pred) == pytest.approx(
            f1_score(y, pred, average="macro"), rel=1e-12)
        # heavily tied float32 scores
        score = np.round(rng.rand(n), 1).astype(np.float32)
        yb = rng.randint(0, 2, n) * 3 + 2  # labels {2, 5}
        if len(np.unique(yb)) == 2:
            assert putils.roc_auc(yb, score) == pytest.approx(
                roc_auc_score(yb, score), rel=1e-12)
        probs = putils.softmax_f32(np.round(rng.randn(n, c), 1))
        if len(np.unique(y)) == c and c > 2:
            assert putils.roc_auc(y, probs) == pytest.approx(
                roc_auc_score(y, probs, multi_class="ovr"), rel=1e-12)
        a = np.round(rng.randn(n), 1)
        b = np.round(rng.randn(n), 1)
        assert putils.spearman(a, b) == pytest.approx(
            spearmanr(a, b).statistic, rel=1e-12, nan_ok=True)
    # where sklearn raises, the port returns None
    with pytest.raises(ValueError):
        roc_auc_score([0, 1, 2], [0.1, 0.5, 0.9])
    assert putils.roc_auc(np.array([0, 1, 2]), np.array([0.1, 0.5, 0.9])) is None
    assert putils.roc_auc(np.array([0, 1]), np.array([np.nan, 0.5])) is None


# ---------------------------------------------------------------------------
# the probe


def jax_init(dims, seed=0):
    """The JAX probe's initial weights for `dims`, as the port's state."""
    params = jprobe._init_mlp(jax.random.key(seed), list(dims))
    return convert.mlp_probe_state_dict(jax.tree.map(np.asarray, params))


def jax_fit(monkeypatch, *args, **kwargs):
    """The JAX fit and the epochs it ran (its batch orders drawn)."""
    epochs = []

    class Counting(np.random.RandomState):
        def permutation(self, *a):
            epochs.append(1)
            return super().permutation(*a)

    with monkeypatch.context() as m:
        m.setattr(np.random, "RandomState", Counting)
        metrics = jprobe.fit_mlp_probe(*args, **kwargs)
    return metrics, len(epochs)


def teacher_data(task_type, out, d=24, n=(224, 80, 80), seed=0, noise=0.5):
    """Splits from a planted linear teacher, each task family's labels."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d, out)
    splits = []
    for rows in n:
        x = rng.randn(rows, d).astype(np.float32)
        z = x @ w / np.sqrt(d) + noise * rng.randn(rows, out)
        if task_type == "multi-label":
            y = (z > 1.0).astype(np.int32)
        elif task_type == "regression":
            y = z[:, 0].astype(np.float32)
        else:
            y = z.argmax(1).astype(np.int64)
        splits.append((x, y))
    return splits


FAMILIES = {"multi-label": ("EC", 20), "classification": ("DeepLoc10", 10),
            "ppi": ("HumanPPI", 2), "regression": ("ThermoStability", 1)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fit_mlp_probe_matches_jax(family, monkeypatch):
    task, out = FAMILIES[family]
    train, valid, test = teacher_data(family, out)
    cfg = dict(hidden_dims=[16], dropout=0.0, batch_size=32, max_epochs=6,
               lr=3e-3, weight_decay=1e-3)
    want, want_epochs = jax_fit(monkeypatch, train, valid, test, task,
                                jprobe.MLPProbeConfig(**cfg), output_dim=out)
    stats = {}
    got = pprobe.fit_mlp_probe(
        train, valid, test, task, pprobe.MLPProbeConfig(**cfg), output_dim=out,
        device="cpu", init=jax_init([24, 16, out]), stats=stats)
    assert_metrics_equal(got, want, RTOL)
    assert stats["epochs"] == want_epochs
    assert stats["steps"] == stats["epochs"] * 224 // 32
    assert stats["params_device"] == stats["data_device"] == "cpu"


def test_early_stopping_reports_the_best_epoch(monkeypatch):
    """A probe that overfits noisy labels (120 rows in batches of 16, the
    last one partial): the validation loss turns, the fit stops `patience`
    epochs after its best and reports the best epoch's weights, the
    metrics of a fit cut at that epoch; as the JAX fit."""
    train, valid, test = teacher_data("classification", 10, n=(120, 80, 80),
                                      noise=2.0)
    cfg = dict(hidden_dims=[64], dropout=0.0, batch_size=16, max_epochs=30,
               lr=3e-3, patience=2)
    init = jax_init([24, 64, 10])
    stats = {}
    got = pprobe.fit_mlp_probe(train, valid, test, "DeepLoc10",
                               pprobe.MLPProbeConfig(**cfg), device="cpu",
                               init=init, stats=stats)
    best = stats["best_epoch"]
    assert 0 < best < stats["epochs"] - 1 < cfg["max_epochs"] - 1
    assert stats["epochs"] == best + 1 + cfg["patience"]
    assert got["val_loss"] == min(stats["val_losses"]) == stats["val_losses"][best]
    cut = pprobe.fit_mlp_probe(
        train, valid, test, "DeepLoc10",
        pprobe.MLPProbeConfig(**{**cfg, "max_epochs": best + 1}),
        device="cpu", init=init)
    assert cut == got
    want, want_epochs = jax_fit(monkeypatch, train, valid, test, "DeepLoc10",
                                jprobe.MLPProbeConfig(**cfg))
    assert_metrics_equal(got, want, RTOL)
    assert want_epochs == stats["epochs"]


def test_sweep_matches_jax(monkeypatch):
    train, valid, test = teacher_data("classification", 10, n=(96, 48, 48))
    init = jax_init([24, 16, 10])
    monkeypatch.setattr(pprobe.MLPProbe, "reset_parameters",
                        lambda self, seed: self.load_state_dict(init))
    base = dict(hidden_dims=[16], dropout=0.0, batch_size=32, max_epochs=3)
    sweep = {"lr": [1e-3, 1e-2], "weight_decay": [0.1]}
    want = jprobe.sweep_mlp_probe(train, valid, test, "DeepLoc10", sweep,
                                  jprobe.MLPProbeConfig(**base))
    got = pprobe.sweep_mlp_probe(train, valid, test, "DeepLoc10", sweep,
                                 pprobe.MLPProbeConfig(**base), device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_metrics_equal(g, w, RTOL)
        assert list(g)[-2:] == ["sweep/lr", "sweep/weight_decay"]


def test_probe_init_dropout_and_device():
    """The port's own init: N(0, 2/d_in) weights from the seed on the CPU
    (so on every device), zero biases; dropout only in training, at its
    keep rate; no card and no device named -> no fallback to the CPU."""
    model = pprobe.MLPProbe([400, 300, 5], dropout=0.25, seed=1)
    model.reset_parameters(1)
    w = model.layers[0].weight.detach().numpy()
    assert abs(w.std() * np.sqrt(400 / 2) - 1) < 0.01
    assert not model.layers[0].bias.detach().numpy().any()
    again = pprobe.MLPProbe([400, 300, 5])
    again.reset_parameters(1)
    assert np.array_equal(again.layers[1].weight.detach().numpy(),
                          model.layers[1].weight.detach().numpy())
    import torch

    x = torch.ones(64, 400)
    hidden = torch.relu(model.layers[0](x))
    kept = model.layers[1]
    model.train()
    model.layers[1] = torch.nn.Identity()
    drop = model(x)
    model.layers[1] = kept
    live = hidden > 0
    share = (drop[live] != 0).float().mean().item()
    assert abs(share - 0.75) < 0.02
    torch.testing.assert_close(drop[drop != 0], (hidden / 0.75)[drop != 0])
    model.eval()
    model.layers[1] = torch.nn.Identity()
    torch.testing.assert_close(model(x), hidden)
    if not torch.cuda.is_available():
        data = teacher_data("regression", 1, n=(8, 8, 8))
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pprobe.fit_mlp_probe(*data, "ThermoStability")


# ---------------------------------------------------------------------------
# results CSV and embeddings files


def test_results_csv_and_load_data_match_jax(tmp_path):
    rows = [{"accuracy": 0.5, "f1": 1 / 3, "auc": float("nan"),
             "val_loss": 1.25, "task": "DeepLoc10", "model_type": "oneprot"},
            {"accuracy": 0.75, "f1": 0.1, "val_loss": 2.0, "sweep/lr": 0.01,
             "sweep/batch_size": 32, "task": "DeepLoc10"}]
    for mod, name in ((jutils, "jax.csv"), (putils, "port.csv")):
        for r in rows:
            mod.save_results_to_csv(dict(r), str(tmp_path / name))
        mod.save_results_to_csv(rows[1], str(tmp_path / name),
                                header_order=["task", "missing", "f1"])
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()

    np.savez(tmp_path / "e.npz", embeddings=np.arange(12.0).reshape(4, 3),
             labels_fitness=np.array([0.1, 2.5, -1.0, 3.0]))
    for thr in (None, 0.5):
        for got, want in zip(putils.load_data(str(tmp_path / "e.npz"), thr),
                             jutils.load_data(str(tmp_path / "e.npz"), thr)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# boosters


@pytest.fixture
def one_thread():
    """sklearn's OpenMP pool on one thread: beside other test workers its
    spinning threads slow the boosters down by orders of magnitude."""
    threadpoolctl = pytest.importorskip("threadpoolctl")
    with threadpoolctl.threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("family", ["classification", "ppi", "regression"])
def test_fit_booster_matches_jax(family, one_thread):
    pytest.importorskip("sklearn")
    task = {"classification": "DeepLoc10", "ppi": "HumanPPI",
            "regression": "ThermoStability"}[family]
    out = {"classification": 5, "ppi": 2, "regression": 1}[family]
    train, valid, test = teacher_data(family, out, n=(160, 40, 60))
    if family == "classification":  # a class the train split lacks
        keep = train[1] != 1
        train = (train[0][keep], train[1][keep])
    make = "make_regressor" if family == "regression" else "make_classifier"
    want = jboost.fit_booster(train, valid, test, task,
                              model=getattr(jboost, make)(n_estimators=15))
    model = getattr(pboost, make)(n_estimators=15)
    assert type(model).__module__.startswith("sklearn.")
    got = pboost.fit_booster(train, valid, test, task, model=model)
    assert_metrics_equal(got, want, 1e-9)


def test_boosters_refuse_without_libraries_and_multilabel(monkeypatch):
    for name in ("xgboost", "sklearn", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)
    for make in (pboost.make_classifier, pboost.make_regressor):
        with pytest.raises(ImportError, match="xgboost or scikit-learn"):
            make()
    train, valid, test = teacher_data("multi-label", 6, n=(20, 8, 8))
    with pytest.raises(ValueError, match="'EC' is multi-label"):
        pboost.fit_booster(train, valid, test, "EC", model=object())


# ---------------------------------------------------------------------------
# LMDB converter through one fake lmdb module


class FakeLmdb(types.ModuleType):
    """`lmdb.open(dir)` over {dir: {key bytes: value bytes}}, keys sorted
    as LMDB iterates them."""

    def __init__(self, dbs):
        super().__init__("lmdb")
        self.dbs = dbs

    def open(self, path, readonly=True, lock=False):
        items = sorted(self.dbs[os.path.abspath(path)].items())

        class Txn:
            def get(self, key):
                return dict(items).get(key)

            def cursor(self):
                return iter(items)

        class Env:
            def begin(self):
                class Ctx:
                    def __enter__(self):
                        return Txn()

                    def __exit__(self, *exc):
                        return False
                return Ctx()

        return Env()


def test_lmdb_converter_matches_jax(tmp_path, monkeypatch):
    import lmdb_csv_converter as root_cli

    from oneprot_tpu_torch.cli import lmdb_csv_converter as port_cli

    def entry(i, **kw):
        return json.dumps({"seq": f"MK{i}", **kw}).encode()

    dbs = {
        "DeepLoc/cls10/train": {
            b"length": b"3", b"0": entry(0, label=4), b"1": entry(1, label=2),
            b"2": b"\xff not json", b"3": entry(3, label=1),
            b"4": entry(4, label=0)},
        "Thermostability/test": {
            b"a": json.dumps({"sequence": "MA", "fitness": 0.25}).encode(),
            b"b": json.dumps({"sequence": "MV"}).encode()},
        "HumanPPI/valid": {
            b"0": json.dumps({"seq_1": "MA", "seq_2": "MK", "label": 1}).encode(),
            b"1": json.dumps({"seq_1": "MC"}).encode()},
    }
    fake = {}
    for rel, items in dbs.items():
        path = tmp_path / "lmdb" / rel
        path.mkdir(parents=True)
        (path / "data.mdb").write_bytes(b"")
        fake[os.path.abspath(path)] = items
    monkeypatch.setitem(sys.modules, "lmdb", FakeLmdb(fake))
    args = ["--root-dir", str(tmp_path / "lmdb")]
    want = root_cli.main(args + ["--output-dir", str(tmp_path / "jax")])
    got = port_cli.main(args + ["--output-dir", str(tmp_path / "port")])
    assert sorted(map(os.path.basename, got)) == sorted(
        map(os.path.basename, want)) == [
        "DeepLoc_cls10_train.csv", "HumanPPI_valid.csv",
        "Thermostability_test.csv"]
    for name in map(os.path.basename, want):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port" / "HumanPPI_valid.csv").read_text().startswith(
        "id,sequence_1,sequence_2,label/fitness")
    monkeypatch.setitem(sys.modules, "lmdb", None)
    for mod in (plmdb, jlmdb):
        with pytest.raises(ImportError, match="pip install lmdb"):
            mod.convert_lmdb_to_csv(str(tmp_path), str(tmp_path / "x.csv"))


# ---------------------------------------------------------------------------
# wandb


def fake_wandb(calls):
    mod = types.ModuleType("wandb")

    class Config:
        def update(self, params, allow_val_change=False):
            calls.append(("config.update", params, allow_val_change))

    class Run:
        config = Config()

        def log(self, data, step=None):
            calls.append(("log", data, step))

        def finish(self):
            calls.append(("finish",))

    def init(**kwargs):
        calls.append(("init", kwargs))
        return Run()

    mod.init = init
    return mod


def test_wandb_logger_matches_jax(tmp_path, monkeypatch):
    import torch

    calls = {"jax": [], "port": []}
    for name, mod in (("jax", jloggers), ("port", ploggers)):
        monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls[name]))
        lg = mod.WandbLogger(str(tmp_path / "wandb"), project="p", entity="e")
        lg.log_hyperparams({"lr": 1e-3, "model": {"dim": 8}})
        lg.log_metrics({"train/loss": np.float32(0.5), "tag": "x",
                        "n": torch.tensor(3)}, step=7)
        lg.finalize()
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", {"project": "p", "dir": str(
        tmp_path / "wandb"), "mode": "offline", "entity": "e"})

    monkeypatch.setitem(sys.modules, "wandb", None)
    for name, mod in (("jax", jloggers), ("port", ploggers)):
        lg = mod.WandbLogger(str(tmp_path / f"{name}_fb"), offline=False)
        lg.log_hyperparams({"lr": 1e-3})
        for step in (1, 2):
            lg.log_metrics({"loss": 1.0 / step, "new" * (step - 1): 2.0}
                           if step == 2 else {"loss": 1.0}, step=step)
        lg.finalize()

    def read(name):
        d = tmp_path / f"{name}_fb"
        with open(d / "wandb_fallback.jsonl") as f:
            jsonl = [{k: v for k, v in json.loads(x).items() if k != "time"}
                     for x in f]
        with open(d / "wandb_fallback.csv") as f:
            header = f.readline()
        return jsonl, header, sorted(os.listdir(d))

    assert read("port") == read("jax")
    assert read("port")[2] == ["wandb_fallback.csv", "wandb_fallback.jsonl"]


# ---------------------------------------------------------------------------
# the entry points against the root scripts, on the same .npz files

DIM = 16


@pytest.fixture(scope="module")
def emb_dir(tmp_path_factory):
    """ToyCls (3 classes) and ToyReg splits from a linear teacher."""
    root = tmp_path_factory.mktemp("embeddings")
    rng = np.random.RandomState(0)
    w = rng.randn(DIM, 3)
    for split, n in (("train", 96), ("valid", 32), ("test", 32)):
        x = rng.randn(n, DIM).astype(np.float32)
        z = x @ w + 0.5 * rng.randn(n, 3)
        np.savez(root / f"ToyCls_{split}_embeddings_labels.npz", embeddings=x,
                 labels_fitness=z.argmax(1).astype(np.int64))
        np.savez(root / f"ToyReg_{split}_embeddings_labels.npz", embeddings=x,
                 labels_fitness=z[:, 0].astype(np.float32))
    return str(root)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's probes start from the JAX init of their widths and seed."""

    def reset(self, seed):
        dims = [self.layers[0].in_features] + [
            layer.out_features for layer in self.layers]
        self.load_state_dict(jax_init(dims, seed))

    monkeypatch.setattr(pprobe.MLPProbe, "reset_parameters", reset)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    return [dict(zip(header, (v.strip() for v in r))) for r in rows[1:]]


def assert_rows_close(got, want):
    assert [list(r) for r in got] == [list(r) for r in want] and got
    for g, w in zip(got, want):
        for k in w:
            try:
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=1e-4, atol=1e-5, err_msg=k)
            except ValueError:
                assert g[k] == w[k], k


MLP_CONFIG = ["task_name=ToyCls", "model.hidden_dims=[16]",
              "model.dropout_rate=0.0", "model.max_epochs=4",
              "model.batch_size=32", "model_type=esm2"]


@pytest.mark.parametrize("form", ["config", "config sweep", "flags"])
def test_saprot_fit_mlp_matches_root_script(form, emb_dir, tmp_path,
                                            jax_weights, monkeypatch):
    if form == "flags":
        for mod in (root_mlp, port_mlp):  # the flag form sets no dropout
            monkeypatch.setattr(mod, "MLPProbeConfig", functools.partial(
                mod.MLPProbeConfig, dropout=0.0))
        args = ["--embeddings-dir", emb_dir, "--task", "ToyCls",
                "--hidden-dims", "16", "--max-epochs", "4",
                "--batch-size", "32", "--lr", "0.01"]
        want = root_mlp.main(args + ["--output-csv", str(tmp_path / "j.csv")])
        got = port_mlp.main(args + ["--output-csv", str(tmp_path / "p.csv"),
                                    "--device", "cpu"])
        paths = tmp_path / "p.csv", tmp_path / "j.csv"
    else:
        args = [f"emb_dir={emb_dir}", *MLP_CONFIG]
        if form == "config sweep":
            args.append("+sweep.learning_rate=[0.001,0.01]")
        want = root_mlp.main(args + [f"results_dir={tmp_path}/jax"])
        got = port_mlp.main(args + [f"results_dir={tmp_path}/port",
                                    "+device=cpu"])
        paths = (tmp_path / "port" / "ToyCls_mlp_results.csv",
                 tmp_path / "jax" / "ToyCls_mlp_results.csv")
    assert [list(r) for r in got] == [list(r) for r in want]
    assert len(got) == (2 if form == "config sweep" else 1)
    assert_rows_close(read_csv(paths[0]), read_csv(paths[1]))
    assert list(got[0])[-1] == ("task" if form == "flags" else "model_type")


@pytest.mark.parametrize("kind", ["cls", "reg"])
def test_saprot_fit_booster_matches_root_script(kind, emb_dir, tmp_path,
                                                one_thread):
    pytest.importorskip("sklearn")
    task = {"cls": "ToyCls", "reg": "ToyReg"}[kind]
    args = [f"emb_dir={emb_dir}", f"task_name={task}",
            "downstream_model.n_estimators=15"]
    if kind == "cls":
        want = root_cls.main(args + [f"results_dir={tmp_path}/jax"])
        got = port_cls.main(args + [f"results_dir={tmp_path}/port"])
    else:
        want = root_cls.main(args + [f"results_dir={tmp_path}/jax"],
                             regression=True,
                             config_name="saprot_sweep_xgboost_reg.yaml")
        got = port_reg.main(args + [f"results_dir={tmp_path}/port"])
    assert list(got) == list(want)
    name = f"{task}_xgb_results.csv"
    assert_rows_close(read_csv(tmp_path / "port" / name),
                      read_csv(tmp_path / "jax" / name))
