"""SaProt structure-token dataset: sequence <-> foldseek 3Di pairs
(counterpart of oneprot_tpu/data/datasets/struct_token_dataset.py).

Ids come from `{split}_saprot.txt` (`_saprot_full.txt` for a full train
split); each id's HDF5 group holds `strucseq`, the amino acids and the 3Di
letters interleaved (even and odd characters). '#' is removed from the
sequence always and from the 3Di string when `remove_hash`. Every HDF5
read goes through `read_strucseq`, so a subclass can serve records from
memory.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from oneprot_tpu_torch.data.common import H5, BaseDataset, pick_bucket
from oneprot_tpu_torch.data.tokenizers import (
    esm2_tokenizer,
    struct_token_tokenizer,
)


class StructTokenDataset(BaseDataset):
    modality = "struct_token"

    def __init__(
        self,
        data_dir: str,
        filename: str,
        split: str,
        max_length: int = 1024,
        seq_tokenizer: str = "facebook/esm2_t33_650M_UR50D",
        remove_hash: bool = True,
        full: bool = False,
        buckets: Optional[List[int]] = None,
    ):
        del seq_tokenizer  # every ESM2 size shares one alphabet
        self.split = split
        self.remove_hash = remove_hash
        self.max_length = max_length
        self.buckets = buckets
        suffix = "_saprot_full.txt" if (split == "train" and full) else "_saprot.txt"
        with open(f"{data_dir}/{split}{suffix}") as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.filename = filename
        self.seq_tok = esm2_tokenizer()
        self.struct_tok = struct_token_tokenizer()

    def read_strucseq(self, seq_id: str) -> Optional[str]:
        """The interleaved strucseq string of an id, None when absent."""
        h5 = H5.get(self.filename)
        if seq_id not in h5:
            return None
        return h5[seq_id]["strucseq"][()].decode("utf-8")

    def num_items(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> str:
        return self.ids[idx]

    def lengths(self) -> np.ndarray:
        """Tokenized lengths for length-grouped batching: half the
        interleaved string + cls/eos (2 for a missing id), capped at
        max_length; the JAX package's dtype-itemsize read for the
        fixed-length byte strings SaProt stores."""
        out = np.empty(len(self.ids), np.int32)
        for i, sid in enumerate(self.ids):
            s = self.read_strucseq(sid)
            out[i] = 2 if s is None else len(s.encode("utf-8")) // 2 + 2
        return np.minimum(out, self.max_length)

    def _split(self, strucseq: str) -> Tuple[str, str]:
        sequence = strucseq[0::2].replace("#", "")
        structure = strucseq[1::2]
        if self.remove_hash:
            structure = structure.replace("#", "")
        return sequence, structure

    def tokenize_pair(self, seq_id: str):
        """Unpadded (seq tokens, struct tokens) incl. cls/eos for sequence
        packing, or None for a missing id."""
        strucseq = self.read_strucseq(seq_id)
        if strucseq is None:
            return None
        sequence, structure = self._split(strucseq)
        return (np.asarray(self.seq_tok.encode_ids(sequence, self.max_length),
                           np.int32),
                np.asarray(self.struct_tok.encode_ids(structure,
                                                      self.max_length),
                           np.int32))

    def collate_fn(self, seq_ids: List[str],
                   rng: Optional[np.random.RandomState] = None):
        """Bucket-padded (seq ids [B, L], struct ids [B, L], 'struct_token',
        sequences); missing ids are dropped."""
        sequences, structs = [], []
        for seq_id in seq_ids:
            strucseq = self.read_strucseq(seq_id)
            if strucseq is None:
                continue
            sequence, structure = self._split(strucseq)
            sequences.append(sequence)
            structs.append(structure)
        longest = max((len(s) + 2 for s in sequences + structs), default=2)
        pad = pick_bucket(longest, self.buckets, self.max_length)
        seq_input = self.seq_tok(sequences, max_length=self.max_length,
                                 padding=pad)
        struct_input = self.struct_tok(structs, max_length=self.max_length,
                                       padding=pad)
        return seq_input, struct_input, "struct_token", sequences
