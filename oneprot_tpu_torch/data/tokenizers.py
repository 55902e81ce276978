"""ESM2 tokenizer (counterpart of oneprot_tpu/data/tokenizers.py:EsmTokenizer).

Token ids are those of the published ESM2 alphabet (facebook/esm2_* vocab),
so converted checkpoints see the same inputs as under the JAX package.
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
