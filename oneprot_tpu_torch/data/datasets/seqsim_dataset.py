"""Sequence-similarity (ClinVar triplet) pairs (counterpart of
oneprot_tpu/data/datasets/seqsim_dataset.py).

Each item gives three pairs of sequences, both sides through the ESM2
tokenizer and the sequence encoder: (the MSA's original sequence, its
aligned sequence), (the wild type, a benign mutant), (a pathogenic mutant,
another pathogenic mutant). Mutations are 'A123B' strings from
`clinvar_full_{benign,pathogenic}_mutations.json`; the candidates of a
protein are shuffled by the collate's RandomState and the first that
applies is taken, the wild type when none does. `{split}_seqsim.txt`
holds the protein ids, `{split}_msa_seqsim.csv` the `req_seq` and
`aligned_seq` columns. The CSV is read with the `csv` module as
`pandas.read_csv` reads it (a header row; a missing cell becomes "nan").
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from oneprot_tpu_torch.data.common import BaseDataset, pick_bucket
from oneprot_tpu_torch.data.datasets.text_dataset import PANDAS_NA
from oneprot_tpu_torch.data.tokenizers import esm2_tokenizer


def read_csv_columns(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV with a header row, each cell as `str(...)` makes
    of what pandas reads ("nan" for a missing value); blank lines are
    skipped."""
    with open(path, newline="", encoding="utf-8") as f:
        return [{k: "nan" if v is None or v in PANDAS_NA else v
                 for k, v in row.items()} for row in csv.DictReader(f)]


class SequenceSimDataset(BaseDataset):
    modality = "seqsim"

    def __init__(
        self,
        data_dir: str,
        split: str,
        seq_tokenizer: str = "facebook/esm2_t33_650M_UR50D",
        max_length: int = 1024,
        modality: str = "combined_seqsim_msa",
        buckets: Optional[List[int]] = None,
    ):
        del seq_tokenizer, modality  # one alphabet; the modality is seqsim
        self.split = split
        self.max_length = max_length
        self.buckets = buckets
        with open(os.path.join(data_dir, f"{split}_seqsim.txt")) as f:
            self.sequence_ids = [line.strip() for line in f if line.strip()]
        with open(os.path.join(data_dir,
                               "clinvar_full_benign_mutations.json")) as f:
            self.benign_mutations = json.load(f)
        with open(os.path.join(data_dir,
                               "clinvar_full_pathogenic_mutations.json")) as f:
            self.pathogenic_mutations = json.load(f)
        self.msa_data = read_csv_columns(
            os.path.join(data_dir, f"{split}_msa_seqsim.csv"))
        self.seq_tok = esm2_tokenizer()

    def num_items(self) -> int:
        return len(self.msa_data)

    def __getitem__(self, idx: int) -> Tuple[str, int]:
        return self.sequence_ids[idx % len(self.sequence_ids)], idx

    @staticmethod
    def _apply_mutation(sequence: str, mutation: str) -> str:
        """Apply 'A123B' (1-based position); raises ValueError when the
        sequence has no A there."""
        letter1, position, letter2 = (mutation[0], int(mutation[1:-1]),
                                      mutation[-1])
        position -= 1
        if position >= len(sequence) or sequence[position] != letter1:
            raise ValueError(
                f"Mutation mismatch: expected {letter1} at {position}")
        return sequence[:position] + letter2 + sequence[position + 1:]

    def _pick_mutation(self, seq_id: str, table, rng) -> str:
        """The first applicable mutation of the shuffled candidates, the
        wild type when none applies (or the id has none)."""
        candidates = list(table.get(seq_id, ()))
        rng.shuffle(candidates)
        for mutation in candidates:
            try:
                return self._apply_mutation(seq_id, mutation)
            except (ValueError, IndexError):
                continue
        return seq_id

    def collate_fn(self, items: List[Tuple[str, int]],
                   rng: Optional[np.random.RandomState] = None):
        """(side-1 ids [3B, L], side-2 ids [3B, L], 'seqsim', side-1
        sequences), both sides padded to one bucket."""
        rng = rng or np.random.RandomState(0)
        list1, list2 = [], []
        for seq_id, idx in items:
            row = self.msa_data[idx % len(self.msa_data)]
            list1.append(str(row["req_seq"]))
            list2.append(str(row["aligned_seq"]))
            list1.append(seq_id)
            list2.append(self._pick_mutation(seq_id, self.benign_mutations,
                                             rng))
            list1.append(self._pick_mutation(seq_id,
                                             self.pathogenic_mutations, rng))
            list2.append(self._pick_mutation(seq_id,
                                             self.pathogenic_mutations, rng))
        longest = max((len(s) + 2 for s in list1 + list2), default=2)
        pad = pick_bucket(longest, self.buckets, self.max_length)
        input1 = self.seq_tok(list1, max_length=self.max_length, padding=pad)
        input2 = self.seq_tok(list2, max_length=self.max_length, padding=pad)
        return input1, input2, "seqsim", list1
