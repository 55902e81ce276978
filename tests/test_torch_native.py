"""The port's host library (`oneprot_tpu_torch.native`) against the JAX
package's (`oneprot_tpu.native`, loaded), on the CPU.

Each entry point equals the JAX library's bit for bit: the kNN on random
coordinates and on an integer lattice, where most distances tie and only
the (distance, index) order decides; the tokenizers' `__call__` on ASCII,
3Di, unknown and non-ASCII input under every padding mode; the greedy MSA
selection in both modes on MSAs with duplicate rows. Each also equals its
plain numpy version beside its caller where that version is defined to
agree (kNN in general position). Then the refusals (`pad_to < 2`,
`num_seqs < 1`), the build (threads racing to the first call load one
library; no g++ raises) and four threads running the kNN at once. Last,
the tied-row launcher's choice of kernel instance for each head dim.
"""

import os
import sys
import threading
import warnings

import numpy as np
import pytest

from oneprot_tpu import native as jax_native
from oneprot_tpu.data.tokenizers import esm2_tokenizer as jax_esm2_tokenizer
from oneprot_tpu.data.tokenizers import (
    struct_token_tokenizer as jax_struct_tokenizer,
)
from oneprot_tpu.data.utils import graphs as jgraphs
from oneprot_tpu.data.utils import msa_io as jmsa_io
from oneprot_tpu_torch import native
from oneprot_tpu_torch.data import graphs, msa_io, tokenizers
from oneprot_tpu_torch.kernels import tied_row_attention as tra


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library, loaded: the reference here is its
    default path, not its numpy fallback."""
    assert jax_native.available(), "the JAX package's host library did not load"
    return jax_native


def _lattice(side: int) -> np.ndarray:
    """An integer lattice of side^3 points: most neighbour distances tie."""
    axis = np.arange(side, dtype=np.float32) * 3.0
    return np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)


# ---------------------------------------------------------------------------
# kNN


@pytest.mark.parametrize("k", [4, 24])
@pytest.mark.parametrize("n", [2, 5, 24, 25, 300])
def test_knn_matches_jax_library_and_plain(jax_lib, n, k):
    coords = (np.random.RandomState(n * 100 + k).randn(n, 3) * 8.0).astype(
        np.float32)
    idx, mask = graphs.knn_neighbors(coords, k, 10.0)
    want_idx, want_mask = jax_lib.knn_neighbors(coords, k, 10.0)
    assert idx.dtype == np.int32 and mask.dtype == bool
    assert idx.shape == mask.shape == (n, k)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(mask, want_mask.astype(bool))
    # general position: the numpy path orders the same neighbours alike
    plain_idx, plain_mask = graphs.knn_neighbors_plain(coords, k, 10.0)
    np.testing.assert_array_equal(idx, plain_idx)
    np.testing.assert_array_equal(mask, plain_mask)
    if n - 1 < k:  # past the other residues: index 0, masked
        assert not idx[:, n - 1:].any() and not mask[:, n - 1:].any()


@pytest.mark.parametrize("side,k,cutoff", [(4, 24, 3.0), (5, 24, 5.0),
                                           (6, 8, 10.0)])
def test_knn_ties_follow_the_jax_library(jax_lib, side, k, cutoff):
    coords = _lattice(side)
    idx, mask = graphs.knn_neighbors(coords, k, cutoff)
    want_idx, want_mask = jax_lib.knn_neighbors(coords, k, cutoff)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(mask, want_mask.astype(bool))
    # ties go to the lower index: within each run of equal distances the
    # neighbours come in ascending order
    d2 = ((coords[:, None] - coords[idx]) ** 2).sum(-1)
    assert (np.diff(d2, axis=1) >= 0).all()
    same = np.diff(d2, axis=1) == 0
    assert (np.diff(idx, axis=1)[same] > 0).all()
    # the padded-graph build takes the same neighbour lists
    assert jgraphs.knn_neighbors(coords, k, cutoff)[0].tolist() == idx.tolist()


def test_knn_short_chains_keep_the_numpy_results():
    for n in (0, 1):
        idx, mask = graphs.knn_neighbors(np.zeros((n, 3), np.float32), 4, 10.0)
        plain_idx, plain_mask = graphs.knn_neighbors_plain(
            np.zeros((n, 3), np.float32), 4, 10.0)
        assert idx.dtype == np.int32 and mask.dtype == bool
        np.testing.assert_array_equal(idx, plain_idx)
        np.testing.assert_array_equal(mask, plain_mask)
        assert idx.shape == (n, 4)


def test_knn_threads_agree():
    """Four threads at once (ctypes releases the GIL) return what one
    thread returns."""
    rng = np.random.RandomState(3)
    chains = [(rng.randn(400, 3) * 15).astype(np.float32) for _ in range(8)]
    want = [graphs.knn_neighbors(c, 24, 10.0) for c in chains]
    got = [None] * len(chains)

    def work(i):
        for j in range(i, len(chains), 4):
            got[j] = graphs.knn_neighbors(chains[j], 24, 10.0)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


# ---------------------------------------------------------------------------
# tokenization

SEQS = ["MKTAYIAKQR", "", "ACDEFGHIKLMNPQRSTVWYXBUZO", "mkJ*?", "M.-K",
        "MKÄV", "ΑΒ€K", "MK\ud800V", "A" * 40]
STRUCTS = ["pynwrqhgdlvtmfsaeikc#", "PYdd", "ddvvÄ", ""]


@pytest.mark.parametrize("kw", [
    {}, dict(max_length=12), dict(padding="max_length", max_length=30),
    dict(padding=16), dict(padding=16, max_length=8),
    dict(pad_to_multiple_of=8), dict(pad_to_multiple_of=8, max_length=20),
    dict(padding="max_length", max_length=3), dict(padding=2),
])
@pytest.mark.parametrize("which", ["esm2", "struct"])
def test_tokenizer_matches_jax_library(jax_lib, kw, which):
    if which == "esm2":
        tok, ref, seqs = tokenizers.esm2_tokenizer(), jax_esm2_tokenizer(), SEQS
    else:
        tok, ref, seqs = (tokenizers.struct_token_tokenizer(),
                          jax_struct_tokenizer(), STRUCTS + SEQS[:3])
    before = native.tokenize_batch.calls
    got = tok(seqs, **kw)
    assert native.tokenize_batch.calls == before + 1
    want = ref(seqs, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # <eos> closes every row, truncated or not
    assert ((got == tok.eos_token_id).sum(1) == 1).all()
    np.testing.assert_array_equal(got, tokenizers.tokenize_batch_plain(
        seqs, tok._lut, tok.cls_token_id, tok.eos_token_id, tok.pad_token_id,
        kw.get("max_length", got.shape[1]), got.shape[1]))


def test_tokenizer_non_ascii_gives_one_unk_per_byte(jax_lib):
    tok = tokenizers.esm2_tokenizer()
    row = tok(["MÄ€K"], padding=12)[0].tolist()
    # M, 2 bytes of Ä, 3 bytes of €, K
    assert row == [0, 20] + [3] * 5 + [15, 2] + [1] * 3
    assert row == jax_esm2_tokenizer()(["MÄ€K"], padding=12)[0].tolist()
    # "longest" counts characters, so the row is cut by bytes, <eos> kept
    row = tok(["MÄ€K"])[0].tolist()
    assert row == [0, 20, 3, 3, 3, 2]
    assert row == jax_esm2_tokenizer()(["MÄ€K"])[0].tolist()


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding=0),
                                dict(padding="max_length", max_length=1),
                                dict(max_length=1)])
def test_tokenizer_refuses_rows_without_room(kw):
    with pytest.raises(ValueError):
        tokenizers.esm2_tokenizer()(["MKV"], **kw)
    lut = tokenizers.esm2_tokenizer()._lut
    with pytest.raises(ValueError):
        native.tokenize_batch(["MKV"], lut, 0, 2, 1, 8, 1)
    with pytest.raises(ValueError):
        tokenizers.tokenize_batch_plain(["MKV"], lut, 0, 2, 1, 8, 1)


# ---------------------------------------------------------------------------
# greedy MSA selection


def _msa(rng, rows: int, cols: int, duplicates: bool):
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY-"))
    seqs = ["".join(rng.choice(letters, cols)) for _ in range(rows)]
    if duplicates:  # repeated rows and a row equal to the query: ties
        for i in range(1, rows, 3):
            seqs[i] = seqs[i - 1]
        seqs[rows // 2] = seqs[0]
    return [(f"row{i}", s) for i, s in enumerate(seqs)]


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("rows,cols,num_seqs,duplicates", [
    (64, 50, 16, False), (64, 50, 16, True), (30, 7, 29, True),
    (12, 20, 12, True), (12, 20, 40, False), (200, 3, 50, True),
    (5, 1, 2, True),
])
def test_greedy_select_matches_jax_library(jax_lib, mode, rows, cols,
                                           num_seqs, duplicates):
    msa = _msa(np.random.RandomState(rows + cols), rows, cols, duplicates)
    before = native.greedy_select_indices.calls
    got = msa_io.greedy_select(msa, num_seqs, mode)
    assert got == jmsa_io.greedy_select(msa, num_seqs, mode)
    assert len(got) == min(num_seqs, rows) and got[0] == msa[0]
    assert native.greedy_select_indices.calls == before + (num_seqs < rows)
    arr = np.array([list(s) for _, s in msa], dtype="S1").view(np.uint8)
    lib = native.greedy_select_indices(arr, num_seqs, mode)
    np.testing.assert_array_equal(
        lib, jax_lib.greedy_select_indices(arr, num_seqs, mode))
    np.testing.assert_array_equal(
        lib, msa_io.greedy_select_indices_plain(arr, num_seqs, mode))


def test_greedy_select_refusals():
    msa = _msa(np.random.RandomState(0), 6, 10, False)
    for n in (0, -1):
        with pytest.raises(ValueError):
            msa_io.greedy_select(msa, n)
        with pytest.raises(ValueError):
            native.greedy_select_indices(np.zeros((6, 10), np.uint8), n)
    with pytest.raises(ValueError):
        msa_io.greedy_select(msa, 2, mode="mid")
    with pytest.raises(ValueError):  # not [rows, cols]
        native.greedy_select_indices(np.zeros(6, np.uint8), 2)
    with pytest.raises(ValueError):  # not [N, 3]
        native.knn_neighbors(np.zeros((6, 2), np.float32), 2, 10.0)
    # no columns: every distance NaN, the first unpicked rows (numpy's pick)
    empty = np.zeros((6, 0), np.uint8)
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)  # mean of no columns
        plain = msa_io.greedy_select_indices_plain(empty, 3)
    np.testing.assert_array_equal(native.greedy_select_indices(empty, 3),
                                  plain)


# ---------------------------------------------------------------------------
# the build


def test_threads_racing_to_the_first_call_load_one_library(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    libs, errors = [], []
    gate = threading.Barrier(6)

    def first_call():
        try:
            gate.wait()
            libs.append(native.library())
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(libs) == 6
    assert all(lib is libs[0] for lib in libs)
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [native._target().name]  # no temporary file left
    assert native._target().name.startswith("liboneprot_host_")


def test_call_counters_lose_no_update_under_threads():
    """More threads than cores, switching as often as the interpreter
    allows: every call that reached the library is counted once."""
    coords = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    threads_n, calls_each = 4 * (os.cpu_count() or 1), 200
    before = native.knn_neighbors.calls

    def work():
        for _ in range(calls_each):
            native.knn_neighbors(coords, 2, 10.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert native.knn_neighbors.calls == before + threads_n * calls_each


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.library()
    with pytest.raises(RuntimeError):
        graphs.knn_neighbors(np.zeros((4, 3), np.float32), 2, 10.0)


def test_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
    assert not list((tmp_path / "build").glob("*.tmp"))


# ---------------------------------------------------------------------------
# #8's instances: which one a head dim launches


@pytest.mark.parametrize("head_dim,instance", [
    (8, 16), (16, 16), (24, 32), (32, 32), (40, 64), (48, 64), (56, 64),
    (64, 64)])
def test_tied_row_instance_for_each_head_dim(head_dim, instance):
    assert tra.instance_head_dim(head_dim) == instance
    assert instance in tra.INSTANCES


@pytest.mark.parametrize("head_dim", [0, 4, 12, 20, 63, 72, 128])
def test_tied_row_instance_refuses_other_head_dims(head_dim):
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        tra.instance_head_dim(head_dim)
