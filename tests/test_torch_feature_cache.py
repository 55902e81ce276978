"""The port's frozen-feature cache, on the CPU at tiny sizes: cached ==
uncached for the packed and the unpacked step, the all-hit packed path's
filler bit for bit, LRU eviction, the disk store (round trip, torn writes,
the fingerprint guard, a store written by the JAX package read back), the
trainer warm-starting from a store, and the retrieval metrics against the
JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from oneprot_tpu.models.heads import empty_slot_filler as jax_filler
from oneprot_tpu.train.feature_cache import DiskFeatureStore as JaxStore
from oneprot_tpu.train.feature_cache import params_fingerprint as jax_fingerprint
from oneprot_tpu.train.metrics import retrieval_metrics as jax_retrieval
from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.data.datamodule import OneProtDataModule
from oneprot_tpu_torch.train.feature_cache import (
    DiskFeatureStore,
    FrozenFeatureCache,
    params_fingerprint,
)
from oneprot_tpu_torch.train.metrics import RetrievalMetric, retrieval_metrics
from oneprot_tpu_torch.train.trainer import Trainer
from tests.test_torch_trainer import (  # noqa: F401 - fixtures
    data_dir,
    dm_kwargs,
    init,
    port_module,
)


def packed_batch(seed=0, rows=2, row_len=96, slots=4):
    """Packed seq <-> struct-token rows with an empty slot or more."""
    rng = np.random.RandomState(seed)
    pairs = []
    for n in rng.randint(8, 40, size=5):
        a = rng.randint(4, 24, n).astype(np.int32)
        b = rng.randint(20, 53, n).astype(np.int32)
        a[0] = b[0] = 0
        a[-1] = b[-1] = 2
        pairs.append((a, b))
    (p,) = list(packing.pack_stream(iter(pairs), row_len, rows, slots))
    assert p["valid"].sum() < rows * slots  # at least one empty slot
    return ({"ids": p["ids_a"], "segment_ids": p["seg_a"]},
            {"ids": p["ids_b"], "segment_ids": p["seg_b"]}, p["valid"])


def padded_batch(seed, batch=4, length=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 24, (batch, length)).astype(np.int32)
    st = rng.randint(20, 53, (batch, length)).astype(np.int32)
    ids[:, 0] = st[:, 0] = 0
    ids[:, -1] = st[:, -1] = 2
    return ids, st


def params_of(module):
    return torch.cat([p.detach().reshape(-1) for p in module.model.parameters()])


def test_packed_cached_equals_uncached(init):
    seq, mod, valid = packed_batch()
    plain, cached = port_module(*init).init(), port_module(*init).init()
    cache = FrozenFeatureCache()
    for _ in range(3):  # a miss, then hits
        want, _ = plain.train_step_packed("struct_token", seq, mod, valid)
        pooled = cache.get_pooled_packed(cached, seq["ids"],
                                         seq["segment_ids"], valid)
        assert pooled.dtype == np.float32
        got, _ = cached.train_step_packed_cached("struct_token", pooled, mod,
                                                 valid)
        assert got.item() == want.item()
    assert cache.misses == cache.hits / 2 == valid.sum()
    assert torch.equal(params_of(plain), params_of(cached))


def test_unpacked_cached_equals_uncached(init):
    plain, cached = port_module(*init).init(), port_module(*init).init()
    cache = FrozenFeatureCache()
    batches = [padded_batch(s) for s in range(3)]
    for ids, st in batches * 2:  # two epochs: the second from the cache
        want, _ = plain.train_step("struct_token", ids, st)
        got, _ = cached.train_step_cached(
            "struct_token", cache.get_pooled(cached, ids), st)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert cache.hits == cache.misses == 12
    torch.testing.assert_close(params_of(cached), params_of(plain), rtol=1e-5,
                               atol=1e-7)


def test_all_hit_packed_path_reproduces_the_filler(init):
    seq, _, valid = packed_batch(1)
    module = port_module(*init).init()
    cache = FrozenFeatureCache()
    computed = cache.get_pooled_packed(module, seq["ids"], seq["segment_ids"],
                                       valid)
    served = cache.get_pooled_packed(module, seq["ids"], seq["segment_ids"],
                                     valid)
    assert cache.hits == cache.misses == valid.sum()
    assert computed.tobytes() == served.tobytes()
    empty = valid.reshape(-1) == 0
    filler = np.asarray(jax_filler(computed.shape[-1]), np.float32)
    assert (served[empty].view(np.uint32) == filler.view(np.uint32)).all()


def test_lru_eviction(init):
    module = port_module(*init).init()
    cache = FrozenFeatureCache(max_entries=4)
    a, b = padded_batch(0)[0], padded_batch(1)[0]
    cache.get_pooled(module, a)        # 4 rows
    cache.get_pooled(module, a[:2])    # hits: rows 0, 1 now most recent
    cache.get_pooled(module, b[:2])    # 2 new rows evict rows 2, 3 of a
    assert len(cache) == 4
    cache.get_pooled(module, a[:2])
    assert cache.hits == 4
    cache.get_pooled(module, a[2:])    # evicted: computed again
    assert (cache.hits, cache.misses) == (4, 8)


def test_disk_store_round_trip_and_torn_writes(tmp_path):
    rng = np.random.RandomState(0)
    rows = {f"k{i}".encode(): rng.randn(16).astype(np.float32) for i in range(5)}
    store = DiskFeatureStore(str(tmp_path), flush_every=2)
    for k, r in rows.items():
        store.append(k, r)
    assert np.array_equal(store.lookup(b"k4"), rows[b"k4"])  # own buffer
    store.close()
    again = DiskFeatureStore(str(tmp_path))
    assert len(again) == 5
    for k, r in rows.items():
        assert again.lookup(k).tobytes() == r.tobytes()
    # a writer killed between its two flushes: the last row's bytes are
    # missing and its key must not enter the index; a torn index tail is
    # ignored
    (idx,) = [p for p in os.listdir(tmp_path) if p.endswith(".idx")]
    stem = os.path.join(tmp_path, idx[:-4])
    with open(stem + ".bin", "r+b") as f:
        f.truncate(4 * 16 * 4 + 8)
    with open(stem + ".idx", "ab") as f:
        f.write(b"\x05\x00")
    torn = DiskFeatureStore(str(tmp_path))
    assert len(torn) == 4 and torn.lookup(b"k4") is None
    assert torn.lookup(b"k3").tobytes() == rows[b"k3"].tobytes()


def test_fingerprint_guard(tmp_path, init):
    module = port_module(*init).init()
    frozen = {k: v for k, v in module.model.state_dict().items()
              if not module.mask[k]}
    fp = params_fingerprint(frozen)
    assert fp == params_fingerprint(dict(reversed(frozen.items())))
    DiskFeatureStore(str(tmp_path / "s"), fingerprint=fp)
    DiskFeatureStore(str(tmp_path / "s"), fingerprint=fp)  # same weights
    changed = dict(frozen)
    name = next(iter(changed))
    changed[name] = changed[name] + 1
    with pytest.raises(ValueError, match="different frozen weights"):
        DiskFeatureStore(str(tmp_path / "s"),
                         fingerprint=params_fingerprint(changed))
    # a store the JAX package fingerprinted is refused: the digests differ
    # (state-dict names against flax tree paths), on the safe side
    JaxStore(str(tmp_path / "j"), fingerprint=jax_fingerprint(init[0]))
    with pytest.raises(ValueError, match="different frozen weights"):
        DiskFeatureStore(str(tmp_path / "j"), fingerprint=fp)


def test_reads_a_store_the_jax_package_wrote(tmp_path):
    rng = np.random.RandomState(1)
    keys = [b"packed|sequence|" + rng.randint(0, 33, n).astype(np.int32).tobytes()
            for n in (5, 9, 30)]
    rows = [rng.randn(24).astype(np.float32) for _ in keys]
    ref = JaxStore(str(tmp_path))
    for k, r in zip(keys, rows):
        ref.append(k, r)
    ref.close()
    port = DiskFeatureStore(str(tmp_path), fingerprint="port-digest")
    assert len(port) == 3
    for k, r in zip(keys, rows):
        assert port.lookup(k).tobytes() == r.tobytes()


def test_trainer_warm_starts_from_a_disk_store(data_dir, init, tmp_path):
    store = str(tmp_path / "store")
    hits = []
    for run in ("cold", "warm"):
        tr = Trainer(max_epochs=1, accelerator="cpu", cache_persist_dir=store,
                     default_root_dir=str(tmp_path / run))
        tr.fit(port_module(*init), OneProtDataModule(**dm_kwargs(data_dir, True)))
        hits.append(tr._feature_cache.stats())
    assert hits[0]["cache/disk_hits"] == 0 and hits[0]["cache/misses"] > 0
    # a fresh process' cache serves every train and val row from disk
    assert hits[1]["cache/misses"] == 0
    assert hits[1]["cache/disk_hits"] == hits[0]["cache/disk_entries"] > 0


def test_retrieval_metrics_match_jax():
    rng = np.random.RandomState(0)
    seq = rng.randn(40, 8).astype(np.float32)
    mod = seq + 0.8 * rng.randn(40, 8).astype(np.float32)
    mod[5] = mod[6]          # tied columns
    seq[10] = seq[11]        # tied rows
    seq[20:23] = 0.0         # rows of equal logits throughout
    want = jax_retrieval(seq, mod, (1, 5, 10))
    assert retrieval_metrics(seq, mod, (1, 5, 10)) == want
    metric = RetrievalMetric((1, 5, 10))
    for s in range(0, 40, 16):
        metric.update(seq[s:s + 16], mod[s:s + 16])
    assert metric.compute() == want
