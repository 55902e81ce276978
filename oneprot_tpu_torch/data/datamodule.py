"""OneProtDataModule: per-modality loaders and their combined iteration
(counterpart of oneprot_tpu/data/datamodule.py: `DataLoader`,
`CombinedLoader`, `OneProtDataModule`).

One loader per modality with its own batch size and the dataset's own
collate; "min_size" combination for train (one dict of batches per step,
ending at the shortest loader) and "sequential" for val/test. A loader
shuffles with a numpy RandomState seeded by (seed + epoch), groups shuffled
windows of 16 batches by item length, collates in a thread pool with
in-order delivery, or streams items through the first-fit packer
(`packing.pack_stream`) for packed training. Across several processes the
order is sharded rank::world (rank and world size from torch.distributed
when it is initialised); packed loaders then keep every process to the
same batch count.

Every modality of the JAX package is served: struct_token, text, msa,
seqsim, and struct_graph and pocket (one dataset class, the `pocket` flag
in its config).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from oneprot_tpu_torch.data.datasets.msa_dataset import MSADataset
from oneprot_tpu_torch.data.datasets.seqsim_dataset import SequenceSimDataset
from oneprot_tpu_torch.data.datasets.struct_graph_dataset import StructDataset
from oneprot_tpu_torch.data.datasets.struct_token_dataset import (
    StructTokenDataset,
)
from oneprot_tpu_torch.data.datasets.text_dataset import TextDataset
from oneprot_tpu_torch.data.packing import pack_stream
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

DATASET_CLASSES = {
    "msa": MSADataset,
    "struct_graph": StructDataset,
    "pocket": StructDataset,
    "text": TextDataset,
    "struct_token": StructTokenDataset,
    "seqsim": SequenceSimDataset,
}


def world() -> Tuple[int, int]:
    """(processes, this process's rank): torch.distributed's when it is
    initialised, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DataLoader:
    """Shuffling sampler -> dataset.collate_fn, with thread-pool collate."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 num_workers: int = 2, group_by_length: bool = True,
                 pack_rows: int = 0, pack_row_len: int = 1024,
                 pack_slots: int = 16):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        # packing engages when > 0 and the dataset has tokenize_pair
        self.pack_rows = pack_rows if hasattr(dataset, "tokenize_pair") else 0
        self.pack_row_len = pack_row_len
        self.pack_slots = pack_slots
        self.epoch = 0
        self.group_by_length = group_by_length
        self._lengths = None

    def __len__(self) -> int:
        """Batches on THIS process; packed: the lockstep cap."""
        nproc, rank = world()
        if self.pack_rows:
            return self._packed_lockstep_cap(nproc)
        n = len(self.dataset)
        n_local = len(range(rank, n, nproc)) if nproc > 1 else n
        if self.drop_last:
            return n_local // self.batch_size
        return -(-n_local // self.batch_size)

    def _item_lengths(self) -> Optional[np.ndarray]:
        if self._lengths is None and hasattr(self.dataset, "lengths"):
            try:
                self._lengths = np.asarray(self.dataset.lengths())
            except Exception:  # pragma: no cover - the probe is optional
                self._lengths = False
        return self._lengths if self._lengths is not False else None

    def _order(self, epoch: int) -> np.ndarray:
        """Seeded shuffle (the same on every process), then this process's
        interleaved shard."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        nproc, rank = world()
        if nproc > 1:
            order = order[rank::nproc]
        return order

    def _batches(self, epoch: int) -> Iterator[List[Any]]:
        order = self._order(epoch)
        rng = np.random.RandomState(self.seed + epoch)
        lengths = (self._item_lengths()
                   if (self.shuffle and self.group_by_length) else None)
        if lengths is not None and len(order) > self.batch_size:
            # windows of 16 batches sorted by length, batch order shuffled
            window = self.batch_size * 16
            batches = []
            for w0 in range(0, len(order), window):
                win = order[w0:w0 + window]
                win = win[np.argsort(lengths[win], kind="stable")]
                batches.extend(win[s:s + self.batch_size]
                               for s in range(0, len(win), self.batch_size))
            rng.shuffle(batches)
        else:
            batches = [order[s:s + self.batch_size]
                       for s in range(0, len(order), self.batch_size)]
        for idxs in batches:
            if self.drop_last and len(idxs) < self.batch_size:
                continue
            yield [self.dataset[int(i)] for i in idxs]

    def _packed_lockstep_cap(self, nproc: int) -> int:
        """The packed batch count every process agrees on without talking:
        total tokens / (processes x rows x row_len), the full-fill floor
        (lengths() already count cls/eos)."""
        lengths = self._item_lengths()
        if lengths is not None:
            cap = int(float(np.sum(lengths))
                      // (nproc * self.pack_rows * self.pack_row_len))
        else:
            cap = len(self.dataset) // (nproc * self.pack_rows)
        return max(cap, 1)

    def _packed_iter(self, epoch: int):
        """Packed batches: ({ids, segment_ids}, {ids, segment_ids},
        modality, valid [rows, slots]) at a fixed [rows, row_len]. Several
        processes each yield exactly the lockstep cap, re-streaming their
        shard if it runs dry."""
        modality = getattr(self.dataset, "modality", "struct_token")

        def items():
            for i in self._order(epoch):
                pair = self.dataset.tokenize_pair(self.dataset[int(i)])
                if pair is not None:
                    yield pair

        def packed():
            for p in pack_stream(items(), self.pack_row_len, self.pack_rows,
                                 self.pack_slots):
                yield ({"ids": p["ids_a"], "segment_ids": p["seg_a"]},
                       {"ids": p["ids_b"], "segment_ids": p["seg_b"]},
                       modality, p["valid"])

        nproc, _ = world()
        if nproc <= 1:
            yield from packed()
            return
        cap = self._packed_lockstep_cap(nproc)
        produced = 0
        while produced < cap:
            got_any = False
            for batch in packed():
                got_any = True
                yield batch
                produced += 1
                if produced >= cap:
                    return
            if not got_any:
                raise RuntimeError(
                    "packed loader produced no batches on this process; "
                    "dataset too small for several-process packing")

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        rng_seed = self.seed * 100003 + epoch
        if self.pack_rows:
            yield from self._packed_iter(epoch)
            return
        if self.prefetch <= 0:
            for b, items in enumerate(self._batches(epoch)):
                yield self.dataset.collate_fn(
                    items, rng=np.random.RandomState(rng_seed + b))
            return
        batches = list(self._batches(epoch))
        workers = max(1, self.num_workers)
        depth = max(self.prefetch, workers) * 2
        with ThreadPoolExecutor(max_workers=workers) as pool:

            def submit(b):
                return pool.submit(self.dataset.collate_fn, batches[b],
                                   rng=np.random.RandomState(rng_seed + b))

            futures = [submit(b) for b in range(min(depth, len(batches)))]
            for i in range(len(batches)):
                result = futures[i].result()
                futures[i] = None  # a done future would pin its batch
                if len(futures) < len(batches):
                    futures.append(submit(len(futures)))
                yield result


class CombinedLoader:
    """min_size: one dict {modality: batch} per step, ending at the shortest
    loader. sequential: the loaders' batches one loader after another."""

    def __init__(self, loaders: Dict[str, DataLoader], mode: str = "min_size"):
        self.loaders = loaders
        self.mode = mode

    def __len__(self) -> int:
        if not self.loaders:
            return 0
        if self.mode == "min_size":
            return min(len(l) for l in self.loaders.values())
        return sum(len(l) for l in self.loaders.values())

    def __iter__(self):
        if self.mode == "min_size":
            iters = {k: iter(v) for k, v in self.loaders.items()}
            while True:
                out = {}
                try:
                    for k, it in iters.items():
                        out[k] = next(it)
                except StopIteration:
                    return
                yield out
        else:
            for loader in self.loaders.values():
                yield from loader


class OneProtDataModule:
    def __init__(
        self,
        modalities: Dict[str, Any],
        num_workers: int = 4,
        pin_memory: bool = False,
        default_batch_size: int = 32,
        buckets: Optional[List[int]] = None,
        prefetch: int = 2,
        seed: int = 0,
        group_by_length: bool = True,
        pack_sequences: bool = False,
        pack_rows: int = 16,
        pack_row_len: int = 1024,
        pack_slots: int = 16,
        dataset_classes: Optional[Dict[str, Any]] = None,
    ):
        """`dataset_classes` overrides DATASET_CLASSES per modality (a
        dataset serving records from memory, for instance)."""
        del pin_memory  # batches are numpy; the step moves them
        self.modalities = modalities
        self.dataset_classes = {**DATASET_CLASSES, **(dataset_classes or {})}
        self.num_workers = num_workers
        self.default_batch_size = default_batch_size
        self.buckets = list(buckets) if buckets else None
        self.prefetch = prefetch
        self.seed = seed
        self.group_by_length = group_by_length
        # packing applies to the TRAIN loaders of token-pair datasets
        self.pack_sequences = pack_sequences
        self.pack_rows = pack_rows
        self.pack_row_len = pack_row_len
        self.pack_slots = pack_slots
        self.datasets: Dict[str, Any] = {}
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Seed the NEXT train_dataloader()'s shuffle, collate and packing
        with this global epoch index."""
        self._epoch = int(epoch)

    def setup(self, stage: Optional[str] = None) -> None:
        if self.datasets:
            return
        for modality, modality_cfg in self.modalities.items():
            if modality not in self.dataset_classes:
                log.error(f"Unknown modality: {modality}")
                continue
            cls = self.dataset_classes[modality]
            for split in ("train", "val", "test"):
                kwargs = dict(modality_cfg["dataset"])
                kwargs.pop("_target_", None)
                kwargs["split"] = split
                kwargs.setdefault("buckets", self.buckets)
                try:
                    self.datasets[f"{modality}_{split}"] = cls(**kwargs)
                except Exception as e:
                    log.error(f"Error creating dataset for {modality} {split}: {e}")
            log.info(
                f"{modality} Train/Val/Test sizes = "
                f"{len(self.datasets.get(f'{modality}_train', []))} / "
                f"{len(self.datasets.get(f'{modality}_val', []))} / "
                f"{len(self.datasets.get(f'{modality}_test', []))}")

    def _create_dataloader(self, split: str, shuffle: bool = False) -> CombinedLoader:
        iterables = {}
        for modality, modality_cfg in self.modalities.items():
            key = f"{modality}_{split}"
            if key not in self.datasets:
                continue
            batch_size = modality_cfg.get("batch_size", {}).get(
                split, self.default_batch_size)
            iterables[modality] = DataLoader(
                self.datasets[key], batch_size=int(batch_size),
                shuffle=shuffle, seed=self.seed, prefetch=self.prefetch,
                num_workers=self.num_workers,
                group_by_length=self.group_by_length,
                pack_rows=(self.pack_rows
                           if (self.pack_sequences and shuffle) else 0),
                pack_row_len=self.pack_row_len, pack_slots=self.pack_slots,
                drop_last=shuffle)
            if shuffle:
                # train continues the global epoch sequence; val/test stay
                # at epoch 0
                iterables[modality].epoch = self._epoch
        return CombinedLoader(iterables, "min_size" if shuffle else "sequential")

    def train_dataloader(self) -> CombinedLoader:
        return self._create_dataloader("train", shuffle=True)

    def val_dataloader(self) -> CombinedLoader:
        return self._create_dataloader("val")

    def test_dataloader(self) -> CombinedLoader:
        return self._create_dataloader("test")

    def example_batches(self) -> Dict[str, Any]:
        """One batch of two items per modality: {name: (seq, mod)}."""
        out = {}
        for modality in self.modalities:
            ds = (self.datasets.get(f"{modality}_train")
                  or self.datasets.get(f"{modality}_val"))
            if ds is None:
                continue
            items = [ds[i] for i in range(min(2, len(ds)))]
            seq, mod, name, _ = ds.collate_fn(items,
                                              rng=np.random.RandomState(0))
            out[name] = (seq, mod)
        return out
