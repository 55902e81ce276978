"""The port's data layer against the JAX package's, on the CPU: the
struct-token dataset, `pack_stream`, the loaders (order, length grouping,
bucketed thread-pool collate, packed batches), `CombinedLoader` in both
modes, `OneProtDataModule`, and `CsvLogger`'s files. Fixtures from
`generate_fixtures`, written to a temporary directory. Batches must be
equal array for array.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from oneprot_tpu.data import datamodule as jdm
from oneprot_tpu.data import packing as jpacking
from oneprot_tpu.data.datasets.struct_token_dataset import (
    StructTokenDataset as JaxDataset,
)
from oneprot_tpu.data.synthetic import generate_fixtures
from oneprot_tpu.utils.loggers import CsvLogger as JaxCsvLogger
from oneprot_tpu_torch.data import datamodule, packing
from oneprot_tpu_torch.data.datasets.struct_token_dataset import (
    StructTokenDataset,
)
from oneprot_tpu_torch.utils.loggers import CsvLogger, MultiLogger

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = [32, 48, 64]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fx"))
    generate_fixtures(d, n_train=40, n_eval=10, modalities=["struct_token"],
                      seq_len_range=(10, 60))
    return d


def datasets(d, split="train", **kw):
    args = dict(data_dir=d, filename=f"{d}/train_saprot.h5", split=split,
                max_length=64, buckets=BUCKETS, **kw)
    return StructTokenDataset(**args), JaxDataset(**args)


def assert_same(a, b, where=""):
    """Nested batches (tuples, lists, dicts, arrays, strings) equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_dataset_matches_jax(data_dir):
    for remove_hash in (True, False):
        port, ref = datasets(data_dir, remove_hash=remove_hash)
        assert len(port) == len(ref) == 40
        np.testing.assert_array_equal(port.lengths(), ref.lengths())
        for i in range(len(port)):
            assert_same(port.tokenize_pair(port[i]), ref.tokenize_pair(ref[i]))
        ids = [port[i] for i in range(7)] + ["missing_id"]
        assert_same(port.collate_fn(ids), ref.collate_fn(ids))
        assert port.tokenize_pair("missing_id") is None


def test_pack_stream_matches_jax():
    rng = np.random.RandomState(0)
    pairs = []
    for n in rng.randint(3, 90, size=60):
        pairs.append((rng.randint(4, 24, n).astype(np.int32),
                      rng.randint(20, 53, n + rng.randint(-2, 3)).astype(np.int32)))
    got = list(packing.pack_stream(iter(pairs), 128, 3, 4))
    want = list(jpacking.pack_stream(iter(pairs), 128, 3, 4))
    assert len(got) == len(want) > 3
    assert_same(got, want)
    assert sum(b["n_pairs"] for b in got) == len(pairs)
    with pytest.raises(ValueError):
        list(packing.pack_stream(iter([(np.ones(129), np.ones(2))]), 128, 3, 4))


LOADERS = {
    "ordered": dict(batch_size=6),
    "shuffled": dict(batch_size=4, shuffle=True, seed=3, drop_last=True),
    "grouped-threads": dict(batch_size=2, shuffle=True, seed=1, prefetch=2,
                            num_workers=3),
    "ungrouped-inline": dict(batch_size=5, shuffle=True, group_by_length=False,
                             prefetch=0),
    "packed": dict(batch_size=4, shuffle=True, seed=2, pack_rows=2,
                   pack_row_len=128, pack_slots=4),
}


@pytest.mark.parametrize("kw", LOADERS.values(), ids=LOADERS.keys())
def test_loader_batches_match_jax(data_dir, kw):
    port_ds, ref_ds = datasets(data_dir)
    port = datamodule.DataLoader(port_ds, **kw)
    ref = jdm.DataLoader(ref_ds, **kw)
    assert len(port) == len(ref)
    for epoch in range(2):  # the epoch moves the shuffle on
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 1, epoch
        assert_same(got, want, f"epoch {epoch}")
    if kw.get("pack_rows"):
        assert isinstance(got[0][0], dict) and got[0][2] == "struct_token"


def test_combined_loader_matches_jax(data_dir):
    port_ds, ref_ds = datasets(data_dir)
    for mode in ("min_size", "sequential"):
        port = datamodule.CombinedLoader(
            {"a": datamodule.DataLoader(port_ds, 8, shuffle=True),
             "b": datamodule.DataLoader(port_ds, 16)}, mode)
        ref = jdm.CombinedLoader(
            {"a": jdm.DataLoader(ref_ds, 8, shuffle=True),
             "b": jdm.DataLoader(ref_ds, 16)}, mode)
        assert len(port) == len(ref) == (3 if mode == "min_size" else 8)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        assert_same(got, want, mode)


def module_kwargs(d, packed):
    return dict(modalities={"struct_token": {
        "dataset": {"data_dir": d, "filename": f"{d}/train_saprot.h5",
                    "max_length": 64},
        "batch_size": {"train": 4, "val": 3}}},
        buckets=BUCKETS, seed=5, pack_sequences=packed, pack_rows=2,
        pack_row_len=128, pack_slots=4)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_datamodule_matches_jax(data_dir, packed):
    port = datamodule.OneProtDataModule(**module_kwargs(data_dir, packed))
    ref = jdm.OneProtDataModule(**module_kwargs(data_dir, packed))
    port.setup()
    ref.setup()
    assert_same(port.example_batches(), ref.example_batches())
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert_same(list(port.train_dataloader()), list(ref.train_dataloader()))
    assert_same(list(port.val_dataloader()), list(ref.val_dataloader()))
    assert_same(list(port.test_dataloader()), list(ref.test_dataloader()))


def test_unported_modality_raises(data_dir):
    """No modality of the JAX package is left unported: the port serves
    each with the class of the same name (msa, seqsim, struct_graph and
    pocket are tests/test_torch_graph.py's and test_torch_msa_train.py's),
    and an unknown modality is skipped with an error logged, as there."""
    assert not hasattr(datamodule, "UNPORTED_MODALITIES")
    assert ({k: v.__name__ for k, v in datamodule.DATASET_CLASSES.items()}
            == {k: v.__name__ for k, v in jdm.DATASET_CLASSES.items()})
    dm = datamodule.OneProtDataModule({"no_such_modality": {"dataset": {}}})
    dm.setup()
    assert dm.datasets == {}


def test_world_without_process_group():
    assert datamodule.world() == (1, 0)


def test_csv_logger_files_match_jax(tmp_path):
    rows = [({"train/loss": 1.5, "epoch": 0}, 1),
            ({"train/loss": 1.25, "epoch": 0}, 2),
            ({"val/loss": np.float32(1.0), "cache/hits": 3}, 2),
            ({"lr": 1e-4}, 3)]
    port = MultiLogger([CsvLogger(str(tmp_path / "port"))])
    ref = JaxCsvLogger(str(tmp_path / "jax"))
    for metrics, step in rows:
        port.log_metrics(metrics, step)
        ref.log_metrics(metrics, step)

    def strip_time(path):
        with open(path) as f:
            text = f.read()
        if path.endswith(".jsonl"):
            return [{k: v for k, v in json.loads(line).items() if k != "time"}
                    for line in text.splitlines()]
        lines = text.splitlines()
        col = lines[0].split(",").index("time")
        return [",".join(c for i, c in enumerate(line.split(",")) if i != col)
                for line in lines]

    for name in ("metrics.jsonl", "metrics.csv"):
        assert (strip_time(str(tmp_path / "port" / name))
                == strip_time(str(tmp_path / "jax" / name)))


# ---------------------------------------------------------------------------
# h5py is optional: the port imports it only inside the function that opens
# a file (the card's host has no h5py)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "oneprot_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT / "oneprot_tpu_torch")))
def test_h5py_imported_inside_functions_only(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            if any(n.split(".")[0] == "h5py" for n in names):
                assert node not in top, f"{path}: module-level h5py import"


def test_port_data_layer_imports_without_h5py():
    code = ("import sys\n"
            "import oneprot_tpu_torch.data.datamodule\n"
            "import oneprot_tpu_torch.train.trainer\n"
            "sys.exit(1 if 'h5py' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
