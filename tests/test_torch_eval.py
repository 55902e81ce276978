"""The port's eval entry points (`evaluation/retrieval_eval.py`,
`cli/eval.py`, `OneProtEmbedder.from_run_dir`, `checkpoint.restore_any`)
against the JAX package's, on the CPU, in f32.

Two run dirs hold the same weights (the JAX init of
`experiment=debug_all_modalities` at tiny widths): a JAX Orbax `best` and
a port `best` (`tests/helpers/torch_eval_runs.py`). The combined CSV is
the synthetic fixtures' `test_all_modalities.csv`.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import reference_name
from oneprot_tpu.core import config as jax_config
from oneprot_tpu.evaluation import retrieval_eval as jeval
from oneprot_tpu_torch.cli import eval as cli_eval
from oneprot_tpu_torch.core import config
from oneprot_tpu_torch.evaluation import retrieval_eval as peval
from oneprot_tpu_torch.serving import OneProtEmbedder
from oneprot_tpu_torch.train import checkpoint as ckpt_lib
from tests.helpers.torch_eval_runs import CONFIG_DIR, make_runs, tiny_sizes

RTOL, ATOL = 1e-4, 1e-5
BATCH = 3
BUCKETS = [64, 128, 256, 512, 1024]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    restore = tiny_sizes()
    try:
        yield make_runs(str(tmp_path_factory.mktemp("eval_runs")))
    finally:
        restore()


def eval_overrides(runs, run_dir, log_dir):
    return [f"run_dir={run_dir}", f"paths.data_dir={runs['data']}",
            f"paths.log_dir={log_dir}", f"batch_size={BATCH}",
            f"csv_file={runs['data']}/test_all_modalities.csv"]


def test_combined_dataset_like_jax(runs):
    """Batch for batch: token ids exactly, graph arrays to f32 rounding."""
    kw = dict(csv_file=f"{runs['data']}/test_all_modalities.csv",
              data_dir=runs["data"], buckets=BUCKETS)
    got = list(peval.CombinedDataset(**kw).batches(BATCH))
    want = list(jeval.CombinedDataset(**kw).batches(BATCH))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for m in ("sequence", "struct_token", "text"):
            np.testing.assert_array_equal(g[m], w[m], err_msg=m)
        for m in ("struct_graph", "pocket"):
            assert sorted(g[m]) == sorted(w[m])
            for k in w[m]:
                np.testing.assert_allclose(g[m][k], w[m][k], rtol=1e-6,
                                           atol=1e-6, err_msg=f"{m}/{k}")


def test_csv_reader_positional_like_pandas(tmp_path):
    """The header row dropped and columns by position, as pandas with
    `names=` reads them; an empty cell reads "nan"."""
    import pandas as pd

    path = tmp_path / "combined.csv"
    path.write_text("a,b,c,d,e,f,g\n1,x.a3m,some text,dpvl#q,P1,P1,P1\n"
                    '2,y.a3m,"with, comma",,P2,P2,P2\n')
    rows = peval.read_combined_csv(str(path))
    frame = pd.read_csv(str(path), header=None, names=peval.COLUMN_NAMES)
    frame.drop(frame.index[0], inplace=True)
    assert [[r[c] for c in peval.COLUMN_NAMES] for r in rows] == [
        [str(v) for v in rec] for rec in frame.itertuples(index=False)]


def test_metrics_and_results_csv_like_jax(tmp_path):
    """Ties broken as the stable argsort breaks them, the median rank
    floor(median) + 1, and the results file byte for byte."""
    rng = np.random.RandomState(0)
    emb = {m: rng.randn(9, 8).astype(np.float32) for m in ("a", "b", "c")}
    emb["b"][3] = emb["b"][4]  # a tie
    emb["c"] = np.round(emb["c"])
    ks = [1, 2, 5]
    got = peval.calculate_retrieval_metrics(emb, ks)
    assert got == jeval.calculate_retrieval_metrics(emb, ks)
    peval.write_results_to_csv(got, str(tmp_path / "port.csv"), ks)
    jeval.write_results_to_csv(got, str(tmp_path / "jax.csv"), ks)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_cli_eval_like_jax(runs, tmp_path, monkeypatch):
    """`cli.eval.main` on the port's run dir against the JAX `run_eval` on
    the JAX one: every modality's embeddings at 1e-4, the same metrics and
    the same `retrieval_results.csv`, byte for byte. The hub runs once a
    batch (not once per modality)."""
    captured = {}
    for name, lib in (("port", peval), ("jax", jeval)):
        inner = lib.embed_all

        def wrapped(*a, _inner=inner, _name=name, **kw):
            captured[_name] = _inner(*a, **kw)
            return captured[_name]

        monkeypatch.setattr(lib, "embed_all", wrapped)
    hub_calls = []
    from oneprot_tpu_torch.models.encoders import SequenceEncoder

    orig = SequenceEncoder.forward
    monkeypatch.setattr(SequenceEncoder, "forward", lambda self, ids: (
        hub_calls.append(ids.shape), orig(self, ids))[1])
    got = cli_eval.main(eval_overrides(runs, runs["port"], tmp_path / "p"))
    jcfg = jax_config.prepare_run_dir(jax_config.load_config(
        CONFIG_DIR, "eval", eval_overrides(runs, runs["jax"], tmp_path / "j")),
        output_dir=str(tmp_path / "jax_eval"))
    want = jeval.run_eval(jcfg)
    assert len(hub_calls) == 2  # two batches of 3 rows
    assert list(captured["port"]) == list(captured["jax"]) == [
        "sequence", "struct_token", "text", "struct_graph", "pocket"]
    for m, e in captured["jax"].items():
        np.testing.assert_allclose(captured["port"][m], e, rtol=RTOL,
                                   atol=ATOL, err_msg=m)
    assert got == want and len(got) == 10
    name = "retrieval_results.csv"
    assert open(os.path.join(runs["port"], name), "rb").read() == \
        open(os.path.join(runs["jax"], name), "rb").read()


def test_from_run_dir_like_jax(runs):
    """`OneProtEmbedder.from_run_dir` of each package on its run dir: the
    run's buckets and text vocabulary, sequences, 3Di strings and texts at
    1e-4."""
    from oneprot_tpu.serving import OneProtEmbedder as JaxEmbedder

    port = OneProtEmbedder.from_run_dir(runs["port"])
    jax_emb = JaxEmbedder.from_run_dir(runs["jax"])
    assert port.buckets == list(jax_emb.buckets)
    assert port.device == torch.device("cpu")
    # one batch of each, one bucket: one compile of each JAX function
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "MVLSPADKTNVKAAW", "M" * 50]
    for method, items in (("embed_sequences", seqs),
                          ("embed_struct_tokens", ["dpvlqwdpc", "aaccd" * 9]),
                          ("embed_texts", ["a membrane protein", "enzyme"])):
        np.testing.assert_allclose(
            getattr(port, method)(items, batch_size=4),
            getattr(jax_emb, method)(items, batch_size=4),
            rtol=RTOL, atol=ATOL, err_msg=method)


# ---------------------------------------------------------------------------
# restore_any


def test_restore_any_formats(runs, tmp_path):
    """A port checkpoint by name, directory or state file; a reference
    Lightning `.ckpt` of the sequence and text towers (the same weights
    under the reference names, by chip_smoke's writer's map): those towers'
    embeddings equal; an Orbax directory
    is refused naming the way across; nothing there raises
    FileNotFoundError."""
    module, _ = peval.load_trained_module(runs["port"])
    state = runs["module"].model.state_dict()
    assert "checkpoint" in ckpt_lib.restore_any(module, runs["port"], "best")
    for k, v in module.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    path = os.path.join(runs["port"], "checkpoints", "best",
                        ckpt_lib.STATE_FILE)
    assert "checkpoint" in ckpt_lib.restore_any(module, None, path)
    sd = {reference_name(mod, k[len(f"encoders.{mod}."):]): v
          for mod in ("sequence", "text") for k, v in state.items()
          if k.startswith(f"encoders.{mod}.")}
    lightning = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, lightning)
    fresh, _ = peval.load_trained_module(runs["port"])
    assert "lightning" in ckpt_lib.restore_any(fresh, None, lightning)
    ids = torch.from_numpy(OneProtEmbedder(module.model).seq_tok(
        ["MKTAYIAKQR", "MVLSPA"], padding=64)).long()
    text = torch.from_numpy(OneProtEmbedder(module.model).text_tok(
        ["a membrane protein", "enzyme"])).long()
    with torch.no_grad():
        for x, m in ((ids, "sequence"), (text, "text")):
            assert torch.equal(fresh.model(x, m), module.model(x, m)), m
    with pytest.raises(ValueError, match="convert.oneprot_state_dict"):
        ckpt_lib.restore_any(module, runs["jax"], "best")
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore_any(module, runs["port"], "no_such")


def test_eval_without_checkpoint_raises(runs, tmp_path):
    """Where the JAX eval warns and evaluates random weights, the port
    raises."""
    cfg = config.load_config(CONFIG_DIR, "eval", eval_overrides(
        runs, runs["port"], tmp_path) + ["ckpt_path=no_such"])
    with pytest.raises(FileNotFoundError, match="no_such"):
        peval.run_eval(config.prepare_run_dir(cfg))


def test_collect_oneprot_backbone_like_jax(runs, tmp_path):
    """`collect_embeddings` with a `oneprot` backbone on each package's run
    dir: the shards' embeddings at 1e-4 and labels exactly."""
    from oneprot_tpu.evaluation import collect_embeddings as jcollect

    from oneprot_tpu_torch.evaluation import collect_embeddings as pcollect

    csv_file = tmp_path / "ToyCls_test.csv"
    csv_file.write_text("sequence,label\nMKTAYIAKQR,0\nMVLSPADKTN,2\n"
                        "MKVLAAGIVGLLLA,1\nMSDNGPQ,0\n")
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    pcollect.generate_embeddings(
        str(csv_file), str(got_dir), pcollect.EmbeddingBackbone(
            "oneprot", run_dir=runs["port"], device="cpu"), batch_size=2,
        buckets=BUCKETS)
    jcollect.generate_embeddings(
        str(csv_file), str(want_dir), jcollect.EmbeddingBackbone(
            "oneprot", run_dir=runs["jax"]), batch_size=2, buckets=BUCKETS)
    for b in (0, 1):
        got = np.load(got_dir / f"embeddings_rank0_batch{b}.npz")
        want = np.load(want_dir / f"embeddings_rank0_batch{b}.npz")
        np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got["labels_fitness"],
                                      want["labels_fitness"])
