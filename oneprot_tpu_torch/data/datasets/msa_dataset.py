"""Sequence <-> MSA pairs (counterpart of
oneprot_tpu/data/datasets/msa_dataset.py).

`{split}_msa.csv` lists the `.a3m` paths (the second column of the lines
that mention '.a3m'). A batch reads each MSA, keeps `msa_depth` rows by
greedy Hamming diversity (the query row first), and pairs the query row,
the protein's sequence, with the whole MSA. MSA rows are tokenized with a
<cls> and no <eos>, cut at 1022 residues; the columns pad to the bucket of
the longest row and are cut to `max_length`; the rows pad to a power of
two, capped at `msa_depth`, so a step sees few shapes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from oneprot_tpu_torch.data.common import BaseDataset, pick_bucket
from oneprot_tpu_torch.data.msa_io import (
    filter_and_create_msa_file_list,
    greedy_select,
    read_msa,
)
from oneprot_tpu_torch.data.tokenizers import MsaBatchConverter, esm2_tokenizer

MSA_TRUNCATION = 1022  # residues of an MSA row, as the MSA Transformer takes


class MSADataset(BaseDataset):
    modality = "msa"

    def __init__(
        self,
        data_dir: str,
        split: str,
        max_length: int = 1024,
        msa_depth: int = 100,
        seq_tokenizer: str = "facebook/esm2_t33_650M_UR50D",
        model_name_or_path: str = "",
        buckets: Optional[List[int]] = None,
    ):
        del seq_tokenizer, model_name_or_path  # one alphabet for every size
        self.split = split
        self.max_length = max_length
        self.msa_depth = msa_depth
        self.buckets = buckets
        self.msa_files = filter_and_create_msa_file_list(
            f"{data_dir}/{split}_msa.csv")
        self.converter = MsaBatchConverter(truncation_seq_length=MSA_TRUNCATION)
        self.seq_tok = esm2_tokenizer()

    def num_items(self) -> int:
        return len(self.msa_files)

    def __getitem__(self, idx: int) -> str:
        return self.msa_files[idx]

    def collate_fn(self, msa_files: List[str],
                   rng: Optional[np.random.RandomState] = None):
        """(seq ids [B, L], MSA ids [B, R, C], 'msa', query sequences)."""
        sequences, msas = [], []
        for path in msa_files:
            msa = greedy_select(read_msa(path), num_seqs=self.msa_depth)
            sequences.append(msa[0][1])
            msas.append(msa)
        longest_col = max((min(len(s), MSA_TRUNCATION) + 1
                           for m in msas for _, s in m), default=2)
        col_pad = pick_bucket(longest_col, self.buckets, self.max_length)
        max_rows = max((len(m) for m in msas), default=1)
        row_pad = 2
        while row_pad < min(max_rows, self.msa_depth):
            row_pad *= 2
        msa_input = self.converter(
            msas, max_rows=self.msa_depth,
            pad_rows_to=min(self.msa_depth, row_pad), pad_cols_to=col_pad)
        msa_input = msa_input[:, :, :self.max_length]
        longest = max((len(s) + 2 for s in sequences), default=2)
        pad = pick_bucket(longest, self.buckets, self.max_length)
        seq_input = self.seq_tok(sequences, max_length=self.max_length,
                                 padding=pad)
        return seq_input, msa_input, "msa", sequences
