"""Sequence <-> residue-graph pairs, the struct_graph and pocket modalities
(counterpart of oneprot_tpu/data/datasets/struct_graph_dataset.py).

One class serves both: `pocket` reads `pockets_100_residues.h5` and
`{split}_pocket.csv`, otherwise `seqstruc.h5` and `{split}_seqstruc.csv`
(ids in the first column). The paired sequence is always the full chain
of `seqstruc.h5`. Each structure becomes a padded graph dict
(`graphs.protein_to_padded_graph`); the train split applies the masking,
coordinate noise and deformation augmentations from the collate's
RandomState (`graphs.augment_graph_batch`). Every HDF5 read goes through
`read_structure`, so a subclass can serve records from memory; `h5py` is
imported at the first file open.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from oneprot_tpu_torch.data.common import H5, BaseDataset, pick_bucket
from oneprot_tpu_torch.data.graphs import (
    augment_graph_batch,
    protein_to_padded_graph,
    stack_graphs,
)
from oneprot_tpu_torch.data.tokenizers import esm2_tokenizer

# (full chain sequence, graph sequence, atom names, atom residue ids, xyz)
Structure = Tuple[str, str, np.ndarray, np.ndarray, np.ndarray]


class StructDataset(BaseDataset):
    def __init__(
        self,
        data_dir: str,
        split: str,
        max_length: int = 1024,
        seq_tokenizer: str = "facebook/esm2_t33_650M_UR50D",
        use_struct_mask: bool = False,
        use_struct_coord_noise: bool = False,
        use_struct_deform: bool = False,
        pocket: bool = False,
        max_residues: int = 1024,
        max_neighbors: int = 24,
        cutoff: float = 10.0,
        buckets: Optional[List[int]] = None,
    ):
        del seq_tokenizer  # every ESM2 size shares one alphabet
        self.split = split
        self.pocket = pocket
        self.modality = "pocket" if pocket else "struct_graph"
        name = "pockets_100_residues" if pocket else "seqstruc"
        self.h5_file = f"{data_dir}/{name}.h5"
        self.h5_file_seq = f"{data_dir}/seqstruc.h5"
        self.max_length = max_length
        self.max_residues = max_residues
        self.max_neighbors = max_neighbors
        self.cutoff = cutoff
        self.use_struct_mask = use_struct_mask
        self.use_struct_coord_noise = use_struct_coord_noise
        self.use_struct_deform = use_struct_deform
        self.buckets = buckets
        csv_file = f"{data_dir}/{split}_{'pocket' if pocket else 'seqstruc'}.csv"
        with open(csv_file) as f:
            self.id_list = [line.split(",")[0].strip() for line in f
                            if line.strip()]
        self.seq_tok = esm2_tokenizer()

    def num_items(self) -> int:
        return len(self.id_list)

    def __getitem__(self, idx: int) -> str:
        return self.id_list[idx]

    def read_structure(self, seq_id: str) -> Optional[Structure]:
        """The full chain's sequence (from seqstruc.h5) and the structure's
        sequence, atom names, residue ids and coordinates (from this
        dataset's file), or None when either file lacks the id."""
        try:
            full = H5.get(self.h5_file_seq)[seq_id]["structure"]["0"]["A"]
            full_seq = full["residues"]["seq1"][()].decode("utf-8")
            node = H5.get(self.h5_file)[seq_id]["structure"]["0"]["A"]
            seq = node["residues"]["seq1"][()].decode("utf-8")
            poly = node["polypeptide"]
            return (full_seq, seq, poly["type"][()],
                    poly["atom_amino_id"][()],
                    np.asarray(poly["xyz"][()], np.float64))
        except KeyError:
            return None

    def collate_fn(self, seq_ids: List[str],
                   rng: Optional[np.random.RandomState] = None):
        """(seq ids [B, L], graph dict of [B, N_max, ...] arrays, the
        modality, sequences); ids missing from a file are dropped."""
        sequences, graphs = [], []
        for seq_id in seq_ids:
            record = self.read_structure(seq_id)
            if record is None:
                continue
            full_seq, seq, names, amino_id, xyz = record
            sequences.append(full_seq)
            graphs.append(protein_to_padded_graph(
                seq, names, amino_id, xyz, max_residues=self.max_residues,
                max_neighbors=self.max_neighbors, cutoff=self.cutoff))
        if not graphs:
            raise ValueError(
                f"no valid structure ids in batch for {self.h5_file}: "
                f"first ids {seq_ids[:3]} missing from the HDF5")
        batch = stack_graphs(graphs)
        if self.split == "train" and rng is not None:
            batch = augment_graph_batch(
                batch, rng, use_mask=self.use_struct_mask,
                use_coord_noise=self.use_struct_coord_noise,
                use_deform=self.use_struct_deform)
        longest = max((len(s) + 2 for s in sequences), default=2)
        pad = pick_bucket(longest, self.buckets, self.max_length)
        seq_input = self.seq_tok(sequences, max_length=self.max_length,
                                 padding=pad)
        return seq_input, batch, self.modality, sequences
