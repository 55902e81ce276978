"""The port's native host library (counterpart of oneprot_tpu/native):
ctypes bindings for `oneprot_host.cc`, beside this file.

Three collate functions of the input pipeline: `tokenize_batch` (ESM2
character tokens of a batch, behind `EsmTokenizer.__call__`),
`knn_neighbors` (a residue graph's neighbour lists, behind
`data.graphs.knn_neighbors`) and `greedy_select_indices` (MSA row
subselection, behind `data.msa_io.greedy_select`). Each has a plain numpy
version beside its caller (`tokenizers.tokenize_batch_plain`,
`graphs.knn_neighbors_plain`, `msa_io.greedy_select_indices_plain`), which
the tests and `chip_smoke.py` hold the library against; the data path never
takes them.

The source is compiled with g++ at first use, on the CPU host and on the
card's host alike, into `build/oneprot_tpu_torch/` at the root of the
checkout, under a name that carries the hash of the source and the flags;
the compiler writes a file named with the process id, which then replaces
the target (`os.replace`), under a lock, so concurrent first calls of
threads or processes load one whole library. There is no fallback: if g++
fails or the library does not load, `library()` raises. ctypes releases the
GIL for each call, so the loader's threads run side by side. Each entry
point counts the calls that reached the library in `.calls`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "oneprot_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "oneprot_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_LOCK = threading.Lock()
_LIB = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liboneprot_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    when g++ is missing or fails."""
    target = _target()
    if target.is_file():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of "
                           "oneprot_tpu_torch cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built if needed (once per process)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32 = ctypes.c_int32
            lib.tokenize_batch.argtypes = [u8p, i64p, i32, i32p, i32, i32, i32,
                                           i32, i32, i32p]
            lib.knn_neighbors.argtypes = [f32p, i32, i32, ctypes.c_float, i32p,
                                          u8p]
            lib.greedy_select.argtypes = [u8p, i32, i32, i32, i32, i32p]
            for fn in (lib.tokenize_batch, lib.knn_neighbors, lib.greedy_select):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _done(fn, rc: int) -> None:
    """Raise if the library refused the call; else count it on `fn`
    (loader threads call at once, hence the lock)."""
    if rc != 0:
        raise ValueError(f"{fn.__name__}: the host library refused its "
                         "arguments")
    with _LOCK:
        fn.calls += 1


def tokenize_batch(sequences: Sequence[str], lut: np.ndarray, cls_id: int,
                   eos_id: int, pad_id: int, max_len: int,
                   pad_to: int) -> np.ndarray:
    """[len(sequences), pad_to] int32: per sequence <cls>, its UTF-8 bytes
    (unencodable characters as '?') through the 256-entry table `lut`, cut
    to min(max_len, pad_to) - 2, <eos>, then `pad_id`. Raises ValueError
    for pad_to < 2, which leaves no room for <cls> and <eos>."""
    if pad_to < 2:
        raise ValueError(f"pad_to={pad_to}: a row needs room for <cls> and "
                         "<eos>")
    lut = np.ascontiguousarray(lut, np.int32)
    if lut.shape != (256,):
        raise ValueError(f"lut must have 256 entries, got {lut.shape}")
    blobs = [s.encode("utf-8", errors="replace") for s in sequences]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    data = np.frombuffer(b"".join(blobs) or b"\0", np.uint8)
    out = np.empty((len(blobs), pad_to), np.int32)
    _done(tokenize_batch,
          library().tokenize_batch(data, offsets, len(blobs), lut, cls_id,
                                   eos_id, pad_id, max_len, pad_to, out))
    return out


def knn_neighbors(coords: np.ndarray, k: int,
                  cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """(idx [N, k] int32, mask [N, k] bool): each residue's k nearest other
    residues of `coords` [N, 3] (as float32), nearest first, equal squared
    distances to the lower index; mask where within `cutoff`. Slots past
    the N - 1 others hold index 0, mask False."""
    coords = np.ascontiguousarray(coords, np.float32)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be [N, 3], got {coords.shape}")
    n = coords.shape[0]
    idx = np.empty((n, k), np.int32)
    mask = np.empty((n, k), np.uint8)
    _done(knn_neighbors,
          library().knn_neighbors(coords, n, k, cutoff, idx, mask))
    return idx, mask.view(bool)


def greedy_select_indices(msa_bytes: np.ndarray, num_seqs: int,
                          mode: str = "max") -> np.ndarray:
    """The rows `greedy_select` keeps of `msa_bytes` [rows, cols] uint8, in
    ascending order: row 0, then each time the row of largest ("max") or
    smallest ("min") mean Hamming distance to the picked rows, the first on
    a tie. Raises ValueError for num_seqs < 1 or an MSA without rows."""
    if mode not in ("max", "min"):
        raise ValueError(f"mode={mode!r}: 'max' or 'min'")
    msa_bytes = np.ascontiguousarray(msa_bytes, np.uint8)
    if msa_bytes.ndim != 2:
        raise ValueError(f"msa_bytes must be [rows, cols], got "
                         f"{msa_bytes.shape}")
    rows, cols = msa_bytes.shape
    if num_seqs < 1 or rows < 1:
        raise ValueError(f"num_seqs={num_seqs} of {rows} rows: at least one "
                         "row is kept, and there must be one")
    out = np.empty(min(num_seqs, rows), np.int32)
    _done(greedy_select_indices,
          library().greedy_select(msa_bytes, rows, cols, len(out),
                                  1 if mode == "max" else 0, out))
    return out


tokenize_batch.calls = 0
knn_neighbors.calls = 0
greedy_select_indices.calls = 0
