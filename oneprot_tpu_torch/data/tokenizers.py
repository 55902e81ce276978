"""ESM2 tokenizers and the MSA batch converter (counterpart of
oneprot_tpu/data/tokenizers.py: `EsmTokenizer`, `esm2_tokenizer`,
`struct_token_tokenizer`, `MsaBatchConverter`).

Token ids are those of the published ESM2 alphabet (facebook/esm2_* vocab),
so converted checkpoints see the same inputs as under the JAX package; the
struct-token tokenizer appends the 21 SaProt 3Di tokens (ids 33..53).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

ESM2_TOKENS: Tuple[str, ...] = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
)

# SaProt 3Di structure tokens, appended after the ESM2 vocabulary
STRUCT_3DI_TOKENS: Tuple[str, ...] = (
    "p", "y", "n", "w", "r", "q", "h", "g", "d", "l",
    "v", "t", "m", "f", "s", "a", "e", "i", "k", "c", "#",
)


class EsmTokenizer:
    """Character-level protein tokenizer with the ESM2 vocabulary.

    Encodes as ``<cls> + residues + <eos>`` and pads with ``<pad>`` (id 1).
    """

    def __init__(self, extra_tokens: Sequence[str] = ()):
        self.tokens: List[str] = list(ESM2_TOKENS) + list(extra_tokens)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.cls_token_id = self.vocab["<cls>"]
        self.pad_token_id = self.vocab["<pad>"]
        self.eos_token_id = self.vocab["<eos>"]
        self.unk_token_id = self.vocab["<unk>"]
        self.mask_token_id = self.vocab["<mask>"]
        # byte -> id table for ASCII sequences (single-character tokens)
        self._lut = np.full(128, self.unk_token_id, np.int32)
        for tok, idx in self.vocab.items():
            if len(tok) == 1 and ord(tok) < 128:
                self._lut[ord(tok)] = idx

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode_ids(self, sequence: str,
                   max_length: Optional[int] = None) -> List[int]:
        body = sequence if max_length is None else sequence[:max_length - 2]
        if body.isascii():
            ids = self._lut[np.frombuffer(body.encode("ascii"), np.uint8)]
            mid = ids.tolist()
        else:
            mid = [self.vocab.get(ch, self.unk_token_id) for ch in body]
        return [self.cls_token_id] + mid + [self.eos_token_id]

    def __call__(
        self,
        sequences: Sequence[str],
        max_length: Optional[int] = None,
        padding: Union[str, int] = "longest",  # "longest" | "max_length" | bucket
        pad_to_multiple_of: Optional[int] = None,
    ) -> np.ndarray:
        """Tokenize a batch to a padded int32 array [B, L]."""
        if padding == "max_length":
            if max_length is None:
                raise ValueError("padding='max_length' requires max_length")
            target = max_length
        elif isinstance(padding, int):
            target = padding
        else:
            lengths = [len(s) + 2 for s in sequences]
            if max_length is not None:
                lengths = [min(n, max_length) for n in lengths]
            target = max(lengths) if lengths else 2
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        if max_length is not None and padding == "longest":
            target = min(target, max_length)
        out = np.full((len(sequences), target), self.pad_token_id,
                      dtype=np.int32)
        # the final target is the hard cap, so <eos> survives truncation
        cap = target if max_length is None else min(max_length, target)
        for i, seq in enumerate(sequences):
            ids = self.encode_ids(seq, cap)
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        specials = {self.cls_token_id, self.pad_token_id, self.eos_token_id}
        return "".join(self.tokens[i] for i in ids if i not in specials)


def esm2_tokenizer() -> EsmTokenizer:
    return EsmTokenizer()


def struct_token_tokenizer() -> EsmTokenizer:
    """ESM2 tokenizer + the 21 3Di tokens (ids 33..53)."""
    return EsmTokenizer(extra_tokens=STRUCT_3DI_TOKENS)


class MsaBatchConverter:
    """A batch of MSAs -> padded int32 tokens [B, R, C], in the MSA
    Transformer's alphabet (the ESM2 table): <cls> before each row, no
    <eos>, pad id 1, rows cut to `truncation_seq_length` residues.
    `max_rows` keeps the first rows of each MSA; `pad_rows_to` and
    `pad_cols_to` pad R and C up to at least those sizes."""

    def __init__(self, truncation_seq_length: int = 1022):
        self.tok = EsmTokenizer()
        self.truncation_seq_length = truncation_seq_length
        self.padding_idx = self.tok.pad_token_id

    def encode_row(self, seq: str) -> List[int]:
        seq = seq[:self.truncation_seq_length]
        return [self.tok.cls_token_id] + [
            self.tok.vocab.get(ch, self.tok.unk_token_id) for ch in seq]

    def __call__(self, msas: Sequence[Sequence[Tuple[str, str]]],
                 max_rows: Optional[int] = None,
                 pad_rows_to: Optional[int] = None,
                 pad_cols_to: Optional[int] = None) -> np.ndarray:
        batch_rows = []
        for msa in msas:
            rows = [self.encode_row(seq) for _, seq in msa]
            batch_rows.append(rows if max_rows is None else rows[:max_rows])
        R = max(len(rows) for rows in batch_rows)
        C = max(len(r) for rows in batch_rows for r in rows)
        if pad_rows_to:
            R = max(R, pad_rows_to)
        if pad_cols_to:
            C = max(C, pad_cols_to)
        out = np.full((len(batch_rows), R, C), self.padding_idx, dtype=np.int32)
        for b, rows in enumerate(batch_rows):
            for r, ids in enumerate(rows):
                out[b, r, :len(ids)] = ids
        return out
