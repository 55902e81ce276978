"""The port's embedding collection (`evaluation/collect_embeddings.py`,
`cli/collect_embeddings.py`) against the JAX package's, on the CPU, in
f32: the CSV reader, the ESM2 and SaProt backbones on a local HF
checkpoint, the shards and the combined files of `run_collection`, and
the stale shards of another rank, which the port removes and the JAX
package merges in."""

import functools
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from oneprot_tpu.core import config as jax_config  # noqa: E402
from oneprot_tpu.evaluation import collect_embeddings as jcollect  # noqa: E402
from oneprot_tpu_torch.cli import collect_embeddings as cli  # noqa: E402
from oneprot_tpu_torch.evaluation import collect_embeddings as pcollect  # noqa: E402
from tests.helpers.torch_eval_runs import CONFIG_DIR  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SEQS = ["MKTAYIAKQRQISFVK", "MVLSPADKTNVKAAWGKV", "MKVLAAGIVG",
        "MSDNGPQNQRNAPRITFGGPSDSTGSNQNGERS", "MA", "MKKLLPTAAAGLLLLAAQPAMA"]
CSVS = {
    "ToyCls": ("sequence,label", lambda i, s: f"{s},{i % 3}"),
    "ToyReg": ("sequence,label/fitness", lambda i, s: f"{s},{0.25 * i - 1}"),
    "EC": ("sequence,label", lambda i, s: f'{s},"[{i % 2}, 1, {1 - i % 2}]"'),
    "HumanPPI": ("sequence_1,sequence_2,label",
                 lambda i, s: f"{s},{SEQS[-1 - i]},{i % 2}"),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A local HF ESM2 dir (32 x 2) and the task CSVs: 6 rows a split."""
    root = tmp_path_factory.mktemp("collect")
    cfg = transformers.EsmConfig(
        vocab_size=33, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, pad_token_id=1,
        mask_token_id=32, position_embedding_type="rotary",
        token_dropout=True, emb_layer_norm_before=False, layer_norm_eps=1e-5)
    torch.manual_seed(0)
    transformers.EsmModel(cfg, add_pooling_layer=False).save_pretrained(
        str(root / "esm"))
    down = root / "downstream"
    down.mkdir()
    for task, (header, row) in CSVS.items():
        for split in ("train", "valid", "test"):
            (down / f"{task}_{split}.csv").write_text("\n".join(
                [header] + [row(i, s) for i, s in enumerate(SEQS)]) + "\n")
    return {"esm": str(root / "esm"), "downstream": str(down)}


@pytest.mark.parametrize("task", list(CSVS))
def test_sequence_dataset_like_jax(data, task):
    path = os.path.join(data["downstream"], f"{task}_train.csv")
    kind = pcollect.TASK_REGISTRY[task]["type"]
    got, want = pcollect.SequenceDataset(path, kind), \
        jcollect.SequenceDataset(path, kind)
    assert len(got) == len(want) == len(SEQS)
    assert got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.labels, want.labels)
    idxs = np.array([4, 0, 2])
    for g, w in zip(got.batch(idxs), want.batch(idxs)):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_registry_is_jax_registry():
    from oneprot_tpu.downstream.mlp_probe import TASK_REGISTRY

    assert pcollect.TASK_REGISTRY == TASK_REGISTRY


@pytest.mark.parametrize("kind", ["esm2", "saprot"])
def test_backbone_on_hf_checkpoint_like_jax(data, kind):
    """The mean-pooled last hidden state of the converted checkpoint (SaProt
    with its 21 new rows from the seed) at 1e-4."""
    kw = dict(kind=kind, model_name_or_path=data["esm"],
              checkpoint_dir=data["esm"], max_length=64, dtype="float32")
    seqs = ["MKTAYIAKQR", "MV"] if kind == "esm2" else ["dpvlqwdpcq", "aa"]
    got = pcollect.EmbeddingBackbone(device="cpu", **kw)(seqs, 64)
    want = jcollect.EmbeddingBackbone(**kw)(seqs, 64)
    assert got.shape == (2, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_run_collection_like_jax_and_stale_shards(data, tmp_path, monkeypatch):
    """`cli.collect_embeddings.main` against the JAX `run_collection` on
    the four tasks' three splits (batches of 4): every combined file's
    embeddings at 1e-4 and labels exactly. A stale shard of rank 1 in a
    split dir is removed by the port; the JAX package merges it in."""
    for lib in (jcollect, pcollect):  # f32 in both (the config's is bf16)
        monkeypatch.setattr(lib, "EmbeddingBackbone", functools.partial(
            lib.EmbeddingBackbone, dtype="float32"))
    ovs = ["tasks=[ToyCls,ToyReg,EC,HumanPPI]", "batch_size=4",
           f"downstream_dir={data['downstream']}", "max_length=64",
           f"models.esm2.model_name_or_path={data['esm']}",
           f"+models.esm2.checkpoint_dir={data['esm']}",
           f"paths.log_dir={tmp_path / 'logs'}"]
    outs = {}
    for name in ("port", "jax"):
        stale = tmp_path / name / "esm2" / "ToyCls" / "test"
        stale.mkdir(parents=True)
        np.savez(stale / "embeddings_rank1_batch7.npz",
                 embeddings=np.zeros((2, 32), np.float32),
                 labels_fitness=np.zeros(2, np.int64))
        outs[name] = [f"output_dir={tmp_path / name}"]
    got = cli.main(ovs + outs["port"], device="cpu")
    jcfg = jax_config.prepare_run_dir(jax_config.load_config(
        CONFIG_DIR, "collect_embeddings", ovs + outs["jax"]),
        output_dir=str(tmp_path / "jax_run"))
    want = jcollect.run_collection(jcfg)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert os.path.relpath(g, tmp_path / "port") == \
            os.path.relpath(w, tmp_path / "jax")
        g, w = np.load(g), np.load(w)
        n = len(g["labels_fitness"])
        assert n == len(SEQS)
        np.testing.assert_allclose(g["embeddings"], w["embeddings"][:n],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g["labels_fitness"],
                                      w["labels_fitness"][:n])
    stale_jax = np.load(tmp_path / "jax" / "esm2" /
                        "ToyCls_test_embeddings_labels.npz")
    assert len(stale_jax["labels_fitness"]) == len(SEQS) + 2
    assert not os.path.exists(tmp_path / "port" / "esm2" / "ToyCls" / "test" /
                              "embeddings_rank1_batch7.npz")
    ppi = np.load(tmp_path / "port" / "esm2" /
                  "HumanPPI_train_embeddings_labels.npz")
    assert ppi["embeddings"].shape == (len(SEQS), 64)


def test_collection_refuses_missing_card_and_run(data, tmp_path, monkeypatch):
    """No CUDA device: the default device raises rather than run on the
    CPU; a `oneprot` backbone on a dir that holds no run raises
    FileNotFoundError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcollect.run_collection({"output_dir": str(tmp_path), "models": {}})
    with pytest.raises(FileNotFoundError):
        pcollect.EmbeddingBackbone("oneprot", run_dir=str(tmp_path),
                                   device="cpu")
