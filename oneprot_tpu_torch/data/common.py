"""Shared data-layer plumbing (counterpart of oneprot_tpu/data/common.py:
`H5Cache`, `pick_bucket`, `BaseDataset`).

HDF5 handles are opened once per (path, thread) and reused; `h5py` is
imported at the first `get`, so the package imports without it. Batches
are padded up to one of a few bucket lengths, so a step sees a small fixed
set of shapes.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np


class H5Cache:
    """Per-thread cache of open h5py.File handles (h5py handles are not
    thread-safe to share, but are cheap to hold per thread)."""

    def __init__(self):
        self._local = threading.local()

    def get(self, path: str):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover - h5py is optional
            raise ImportError("h5py is required for HDF5 datasets") from e
        files = getattr(self._local, "files", None)
        if files is None:
            files = {}
            self._local.files = files
        if path not in files:
            files[path] = h5py.File(path, "r")
        return files[path]


H5 = H5Cache()


def pick_bucket(length: int, buckets: Optional[Sequence[int]],
                max_length: int) -> int:
    """Smallest bucket >= length, else max bucket (inputs then truncate)."""
    cap = max_length
    if not buckets:
        return min(length, cap)
    for b in sorted(buckets):
        if length <= b:
            return min(b, cap)
    return min(sorted(buckets)[-1], cap)


class BaseDataset:
    """`__getitem__` returns an id; `collate_fn(ids)` does the IO and
    tokenization and returns the batch tuple (seq_tokens, modality_input,
    modality, raw_seqs). Val and test splits are capped at 1000 items."""

    modality: str = ""
    split: str = "train"
    val_test_cap: int = 1000

    def __len__(self) -> int:
        n = self.num_items()
        if self.split == "train":
            return n
        return min(n, self.val_test_cap) if n else 0

    def num_items(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx: int):  # pragma: no cover - abstract
        raise NotImplementedError

    def collate_fn(self, items, rng: Optional[np.random.RandomState] = None):
        raise NotImplementedError
