"""Protein <-> biomedical-text dataset (counterpart of
oneprot_tpu/data/datasets/text_dataset.py).

`{split}_text.csv` holds (id, text) rows with no header; each id's protein
sequence is `[id]/structure/0/A/residues/seq1` of `seqstruc.h5`. Sequences
go through the ESM2 tokenizer (at most `max_length` tokens), texts through
WordPiece (at most `text_max_length`). Every HDF5 read goes through
`read_seq`, so a subclass can serve records from memory; `h5py` is
imported at the first file open.

The CSV is read with the `csv` module, as `pandas.read_csv(header=None)`
followed by `str(...)` reads it (the JAX dataset's way): quoted fields
unquote, blank lines are skipped, and a text cell that pandas reads as
missing (empty, "NA", "null", "nan", ...) becomes the string "nan". One
difference is kept on purpose: a column whose every cell looks like a
number stays text here, where pandas would parse it ("1" for an int
column, "1.0" for a float column).
"""

from __future__ import annotations

import csv
from typing import List, Optional

import numpy as np

from oneprot_tpu_torch.data.common import H5, BaseDataset, pick_bucket
from oneprot_tpu_torch.data.tokenizers import (
    esm2_tokenizer,
    resolve_text_tokenizer,
)

# pandas.read_csv's default missing-value strings (its `na_values`)
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_text_csv(path: str) -> List[List[str]]:
    """The rows of a headerless (id, text) CSV as pandas reads them, each
    cell as `str(...)` makes it ("nan" for a missing value, a row of one
    field included); blank lines are skipped."""
    with open(path, newline="", encoding="utf-8") as f:
        return [["nan" if cell in PANDAS_NA else cell
                 for cell in row + [""] * (2 - len(row))]
                for row in csv.reader(f) if row]


class TextDataset(BaseDataset):
    modality = "text"

    def __init__(
        self,
        data_dir: str,
        split: str,
        max_length: int = 1024,
        text_max_length: int = 512,
        text_tokenizer: str = "tiny",
        seq_tokenizer: str = "facebook/esm2_t33_650M_UR50D",
        buckets: Optional[List[int]] = None,
    ):
        del seq_tokenizer  # every ESM2 size shares one alphabet
        self.split = split
        self.max_length = max_length
        self.text_max_length = text_max_length
        self.h5_file = f"{data_dir}/seqstruc.h5"
        self.buckets = buckets
        rows = read_text_csv(f"{data_dir}/{split}_text.csv")
        self.ids = [row[0] for row in rows]
        self.texts = [row[1] for row in rows]
        self._index = {v: i for i, v in enumerate(self.ids)}
        self.seq_tok = esm2_tokenizer()
        self.text_tok = resolve_text_tokenizer(text_tokenizer)

    def read_seq(self, seq_id: str) -> Optional[str]:
        """The protein sequence of an id, None when the file lacks it."""
        h5 = H5.get(self.h5_file)
        if seq_id not in h5:
            return None
        return h5[seq_id]["structure"]["0"]["A"]["residues"]["seq1"][()].decode(
            "utf-8")

    def num_items(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> str:
        return self.ids[idx]

    def text_of(self, seq_id: str) -> str:
        return self.texts[self._index[seq_id]]

    def lengths(self) -> np.ndarray:
        """Tokenized sequence lengths for length-grouped batching: residues
        + cls/eos (2 for a missing id), capped at max_length; the JAX
        package reads the same count off the fixed-length byte string's
        dtype."""
        out = np.empty(len(self.ids), np.int32)
        for i, sid in enumerate(self.ids):
            seq = self.read_seq(sid)
            out[i] = 2 if seq is None else len(seq.encode("utf-8")) + 2
        return np.minimum(out, self.max_length)

    def tokenize_pair(self, seq_id: str):
        """Unpadded (seq tokens, text tokens) incl. specials for sequence
        packing, or None for a missing id."""
        seq = self.read_seq(seq_id)
        if seq is None:
            return None
        return (np.asarray(self.seq_tok.encode_ids(seq, self.max_length),
                           np.int32),
                np.asarray(self.text_tok.encode_ids(self.text_of(seq_id),
                                                    self.text_max_length),
                           np.int32))

    def collate_fn(self, seq_ids: List[str],
                   rng: Optional[np.random.RandomState] = None):
        """(seq ids [B, L], text ids [B, T], 'text', sequences): each side
        padded to its own bucket; missing ids are dropped."""
        sequences, texts = [], []
        for seq_id in seq_ids:
            seq = self.read_seq(seq_id)
            if seq is None:
                continue
            sequences.append(seq)
            texts.append(self.text_of(seq_id))
        seq_longest = max((len(s) + 2 for s in sequences), default=2)
        seq_pad = pick_bucket(seq_longest, self.buckets, self.max_length)
        seq_input = self.seq_tok(sequences, max_length=self.max_length,
                                 padding=seq_pad)
        text_ids = [self.text_tok.encode_ids(t, self.text_max_length)
                    for t in texts]
        text_longest = max((len(t) for t in text_ids), default=2)
        text_pad = pick_bucket(text_longest, self.buckets, self.text_max_length)
        text_input = np.full((len(text_ids), text_pad),
                             self.text_tok.pad_token_id, np.int32)
        for i, ids in enumerate(text_ids):
            text_input[i, :min(len(ids), text_pad)] = ids[:text_pad]
        return seq_input, text_input, "text", sequences
