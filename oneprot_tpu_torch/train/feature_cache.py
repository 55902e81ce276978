"""Frozen-backbone feature cache (counterpart of
oneprot_tpu/train/feature_cache.py: `params_fingerprint`,
`DiskFeatureStore`, `FrozenFeatureCache`).

A frozen hub without LoRA gives the same pooled [d_model] representation
for a tokenized sequence all run long, so the trainer computes it once per
protein and trains through the hub's head from then on
(`OneProtModule.train_step_packed_cached`, `train_step_cached`); a frozen
modality tower (the text tower) is cached the same way, and then only the
two heads train (`train_step_fully_cached`). Rows live on the host as f32
numpy arrays; the step moves them to the card.

Keys: the raw bytes of the tokenized id row under an encoder namespace
(`sequence|`, `text|`; an MSA keys on its whole [R, L] token block under
`msa|`); a protein of a PACKED batch keys on its token subsequence
(`packed|sequence|`), so hits survive the re-packing of every epoch. Both
are the JAX package's keys. Eviction is LRU under `max_entries`.

With `persist_dir`, every computed row is also appended to an on-disk
store in the JAX package's byte format, and RAM misses look there before
recomputing. The store is guarded by a digest of the frozen weights; the
port's digest is its own (state-dict names), so a store the JAX package
fingerprinted is refused, while one it wrote without a fingerprint reads.
"""

from __future__ import annotations

import hashlib
import os
import struct
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from oneprot_tpu_torch.models.heads import empty_slot_filler


def params_fingerprint(state: Dict[str, torch.Tensor]) -> str:
    """Digest of (frozen) state-dict entries: per entry in name order, its
    name, shape, dtype and first 4 values as f32; only those 4 values leave
    the card."""
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name]
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        head = t.detach().reshape(-1)[:4].float().cpu().numpy()
        h.update(np.asarray(head, np.float32).tobytes())
    return h.hexdigest()


class DiskFeatureStore:
    """Append-only persistent shard store of pooled feature rows.

    Layout: `<dir>/shard-<pid>-<seq>.idx/.bin` pairs. `.bin` holds raw
    little-endian f32 rows back to back; `.idx` starts with MAGIC and frames
    each entry as `[key_len:u32][dim:u32][offset:u64][key bytes]`, offset
    in f32 elements. Each process appends to its own pair, so writers never
    contend; readers merge every shard's index at open. Rows whose bytes
    never reached the `.bin` (a writer killed between the two flushes) are
    left out, and a torn index tail is ignored. Reads go through np.memmap.
    """

    MAGIC = b"OPFC1\n"

    def __init__(self, directory: str, flush_every: int = 256,
                 fingerprint: Optional[str] = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._check_fingerprint(fingerprint)
        self._index: dict = {}  # key -> (bin_path, offset, dim)
        self._mmaps: dict = {}  # bin_path -> np.memmap
        self._load_existing()
        self._flush_every = max(int(flush_every), 1)
        self._pending = 0
        self._own_bin = None  # opened at the first append
        self._own_idx = None
        self._own_path = None
        self._own_off = 0

    def __len__(self) -> int:
        return len(self._index)

    def _check_fingerprint(self, fingerprint: Optional[str]) -> None:
        """Refuse a store built with other frozen weights; adopt an
        unmarked one."""
        if fingerprint is None:
            return
        path = os.path.join(self.dir, "FINGERPRINT")
        if os.path.exists(path):
            with open(path) as f:
                existing = f.read().strip()
            if existing and existing != fingerprint:
                raise ValueError(
                    f"feature store at {self.dir} was built with different "
                    f"frozen weights (fingerprint {existing[:12]}... != "
                    f"{fingerprint[:12]}...): serving it would train on "
                    "stale features. Delete the directory, or point "
                    "cache_persist_dir at a store built with these weights.")
        else:
            with open(path, "w") as f:
                f.write(fingerprint + "\n")

    def _load_existing(self) -> None:
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".idx"):
                continue
            idx_path = os.path.join(self.dir, name)
            bin_path = idx_path[:-4] + ".bin"
            try:
                with open(idx_path, "rb") as f:
                    data = f.read()
                bin_rows = os.path.getsize(bin_path) // 4
            except OSError:
                continue
            if not data.startswith(self.MAGIC):
                continue
            pos, n = len(self.MAGIC), len(data)
            while pos + 16 <= n:
                key_len, dim, off = struct.unpack_from("<IIQ", data, pos)
                pos += 16
                if pos + key_len > n:
                    break  # torn tail
                key = data[pos:pos + key_len]
                pos += key_len
                if off + dim <= bin_rows:
                    self._index[key] = (bin_path, off, dim)

    def _open_own_shard(self) -> None:
        seq = 0
        while True:
            stem = os.path.join(self.dir, f"shard-{os.getpid()}-{seq}")
            try:
                # never append to a file another writer made
                self._own_idx = open(stem + ".idx", "xb")
                break
            except FileExistsError:
                seq += 1
        self._own_bin = open(stem + ".bin", "wb")
        self._own_path = stem + ".bin"
        self._own_idx.write(self.MAGIC)
        self._own_off = 0

    def lookup(self, key: bytes) -> Optional[np.ndarray]:
        ent = self._index.get(key)
        if ent is None:
            return None
        bin_path, off, dim = ent
        if bin_path == self._own_path:
            self._own_bin.flush()  # our rows may sit in the stdio buffer
        mm = self._mmaps.get(bin_path)
        if mm is None or off + dim > mm.shape[0]:
            # (re)map: the shard may have grown past an earlier map
            try:
                mm = np.memmap(bin_path, dtype=np.float32, mode="r")
            except (OSError, ValueError):
                return None
            self._mmaps[bin_path] = mm
        if off + dim > mm.shape[0]:
            # torn row: drop the key so the recomputed row persists again
            del self._index[key]
            return None
        return np.array(mm[off:off + dim])

    def append(self, key: bytes, row: np.ndarray) -> None:
        if key in self._index:
            return
        if self._own_bin is None:
            self._open_own_shard()
        row32 = np.ascontiguousarray(np.asarray(row, np.float32))
        self._own_bin.write(row32.tobytes())
        self._own_idx.write(
            struct.pack("<IIQ", len(key), row32.shape[-1], self._own_off))
        self._own_idx.write(key)
        self._index[key] = (self._own_path, self._own_off, row32.shape[-1])
        self._own_off += row32.shape[-1]
        self._pending += 1
        if self._pending >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if self._own_bin is not None:
            self._own_bin.flush()
            self._own_idx.flush()
        self._pending = 0

    def close(self) -> None:
        self.flush()
        if self._own_bin is not None:
            self._own_bin.close()
            self._own_idx.close()
            self._own_bin = self._own_idx = self._own_path = None


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array (f32 for floats)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _encoder_name(modality: str) -> str:
    return "sequence" if modality in ("sequence", "seqsim") else modality


class FrozenFeatureCache:
    def __init__(self, max_entries: Optional[int] = None,
                 persist_dir: Optional[str] = None,
                 fingerprint: Optional[str] = None):
        self._store: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self.max_entries = max_entries
        self._disk = (DiskFeatureStore(persist_dir, fingerprint=fingerprint)
                      if persist_dir else None)
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict:
        """Hit, miss and occupancy counts, for logging at validation."""
        total = self.hits + self.misses
        out = {"cache/hits": float(self.hits),
               "cache/misses": float(self.misses),
               "cache/hit_rate": (self.hits / total) if total else 0.0,
               "cache/entries": float(len(self._store))}
        if self._disk is not None:
            out["cache/disk_hits"] = float(self.disk_hits)
            out["cache/disk_entries"] = float(len(self._disk))
        return out

    def host_bytes(self) -> int:
        """Host memory the RAM entries hold: each key's bytes and its f32
        row (an MSA's key is its whole [R, L] token block)."""
        return sum(len(k) + v.nbytes for k, v in self._store.items())

    def flush(self) -> None:
        """Push write-behind rows to disk (no-op without persist_dir)."""
        if self._disk is not None:
            self._disk.flush()

    def close(self) -> None:
        if self._disk is not None:
            self._disk.close()

    # -- LRU primitives -------------------------------------------------
    def _lookup(self, key: bytes) -> Optional[np.ndarray]:
        row = self._store.get(key)
        if row is not None:
            self._store.move_to_end(key)
            return row
        if self._disk is not None:
            row = self._disk.lookup(key)
            if row is not None:
                self.disk_hits += 1
                self._insert_ram(key, row)
                return row
        return None

    def _insert_ram(self, key: bytes, row: np.ndarray) -> None:
        if key in self._store:
            self._store.move_to_end(key)
            return
        if (self.max_entries is not None
                and len(self._store) >= self.max_entries):
            self._store.popitem(last=False)  # the least recently used
        self._store[key] = row

    def _insert(self, key: bytes, row: np.ndarray) -> None:
        self._insert_ram(key, row)
        if self._disk is not None:
            self._disk.append(key, row)

    # -- unpacked batches ----------------------------------------------
    def get_pooled(self, module, seq_inputs,
                   modality: str = "sequence") -> np.ndarray:
        """Pooled backbone rows [B, d_model] f32 for a padded batch [B, L].
        Any miss computes the whole batch in one forward and stores every
        row ('seqsim' shares the sequence encoder's entries)."""
        modality = _encoder_name(modality)
        ns = modality.encode() + b"|"
        seq_np = np.ascontiguousarray(_host(seq_inputs))
        keys = [ns + row.tobytes() for row in seq_np]
        rows = [self._lookup(k) for k in keys]
        if all(r is not None for r in rows):
            self.hits += len(keys)
            return np.stack(rows)
        self.misses += len(keys)
        pooled = _host(module.encode_pooled(modality, seq_np))
        for k, row in zip(keys, pooled):
            self._insert(k, row)
        return pooled

    # -- packed batches -------------------------------------------------
    def get_pooled_packed(self, module, ids, segment_ids, valid,
                          modality: str = "sequence") -> np.ndarray:
        """Per-protein pooled rows [R*P, d_model] f32 of a PACKED batch
        (ids, segment_ids [R, L], valid [R, P]), slot-aligned with the
        packed tower. Empty slots get `empty_slot_filler` bit for bit, as
        the packed forward pools them, so cached and uncached steps agree;
        their features are masked out of the loss."""
        modality = _encoder_name(modality)
        ns = b"packed|" + modality.encode() + b"|"
        ids_np = np.ascontiguousarray(_host(ids))
        seg_np = _host(segment_ids)
        valid_np = _host(valid)
        R, P = ids_np.shape[0], valid_np.shape[1]
        keys: list = [None] * (R * P)
        for r in range(R):
            seg_r = seg_np[r]
            for s in range(P):
                if valid_np[r, s] > 0:
                    keys[r * P + s] = ns + ids_np[r][seg_r == s].tobytes()
        n_valid = sum(1 for k in keys if k is not None)
        rows = [None if k is None else self._lookup(k) for k in keys]
        if all(r is not None for k, r in zip(keys, rows) if k is not None):
            self.hits += n_valid
            d = next(r for r in rows if r is not None).shape[-1]
            filler = empty_slot_filler(d).numpy()
            return np.stack([filler if r is None else r for r in rows])
        self.misses += n_valid
        pooled = _host(module.encode_packed_pooled(modality, ids_np, seg_np, P))
        for k, row in zip(keys, pooled):
            if k is not None:
                self._insert(k, row)
        return pooled
