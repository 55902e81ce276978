"""ESM2 tokenizers, the MSA batch converter and the BERT WordPiece
tokenizer (counterpart of oneprot_tpu/data/tokenizers.py: `EsmTokenizer`,
`esm2_tokenizer`, `struct_token_tokenizer`, `MsaBatchConverter`,
`WordPieceTokenizer`, `tiny_wordpiece_vocab`, `resolve_text_tokenizer`).

Token ids are those of the published ESM2 alphabet (facebook/esm2_* vocab),
so converted checkpoints see the same inputs as under the JAX package; the
struct-token tokenizer appends the 21 SaProt 3Di tokens (ids 33..53). Text
goes through a `vocab.txt` (BiomedBERT's, when one is on disk) or the
built-in tiny vocabulary of the synthetic configs.
"""

from __future__ import annotations

import json
import os
import unicodedata
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


def _is_punctuation(ch: str) -> bool:
    """BERT's rule: every non-alphanumeric ASCII symbol, and the Unicode
    punctuation categories."""
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT's WordPiece: basic tokenization (lower case, accents stripped
    after NFD, split on whitespace and punctuation), then greedy
    longest-match subwords with the `##` prefix; a word with no split, or
    longer than `max_chars_per_word`, becomes [UNK]. Encodes as
    [CLS] + pieces + [SEP], the body cut to max_length - 2, and pads with
    [PAD]."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self.cls_token_id = vocab["[CLS]"]
        self.sep_token_id = vocab["[SEP]"]
        self.pad_token_id = vocab["[PAD]"]
        self.unk_token_id = vocab["[UNK]"]

    @classmethod
    def from_vocab_file(cls, path: str,
                        do_lower_case: bool = True) -> "WordPieceTokenizer":
        """One token a line; a token's id is its line number (empty lines
        take a number and no token)."""
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case=do_lower_case)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _basic_tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(ch for ch in text
                           if unicodedata.category(ch) != "Mn")
        else:
            text = unicodedata.normalize("NFC", text)
        out: List[str] = []
        word: List[str] = []
        for ch in text:
            if ch.isspace() or _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                if not ch.isspace():
                    out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[int] = None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            ids.append(cur)
            start = end
        return ids

    def encode_ids(self, text: str,
                   max_length: Optional[int] = None) -> List[int]:
        ids = [self.cls_token_id]
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        if max_length is not None:
            ids = ids[:max_length - 1]
        ids.append(self.sep_token_id)
        return ids

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None,
                 padding: Union[str, int] = "longest",
                 pad_to_multiple_of: Optional[int] = None) -> np.ndarray:
        """Tokenize a batch to a padded int32 array [B, L]: padded to the
        longest text, to `max_length` ("max_length") or to an int; rows
        longer than the target are cut (their [SEP] with them, as in the
        JAX tokenizer)."""
        encoded = [self.encode_ids(t, max_length) for t in texts]
        if padding == "max_length":
            target = max_length
        elif isinstance(padding, int):
            target = padding
        else:
            target = max(len(e) for e in encoded) if encoded else 2
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        out = np.full((len(encoded), target), self.pad_token_id, dtype=np.int32)
        for i, ids in enumerate(encoded):
            ids = ids[:target]
            out[i, :len(ids)] = ids
        return out


_BASE_BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# the words of the tiny vocabulary (besides letters, digits and a few marks)
TINY_WORDS = ("protein", "binding", "enzyme", "structure", "the", "a",
              "catalytic", "membrane", "site", "domain", "activity",
              "##ase", "##ing", "##s")


def tiny_wordpiece_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """The small deterministic vocabulary of the synthetic configs: the
    specials (so [PAD] is 0), letters, `##` letters, digits, five marks and
    a few words, then `extra_words`; ids in that order, duplicates once."""
    tokens = list(_BASE_BERT_SPECIALS)
    tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += [str(d) for d in range(10)]
    tokens += [".", ",", "-", "(", ")"]
    tokens += list(TINY_WORDS)
    tokens += list(extra_words)
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}


def resolve_text_tokenizer(name_or_path: Optional[str]) -> WordPieceTokenizer:
    """The text tokenizer of a config: "tiny" / "synthetic" (or empty) for
    the built-in vocabulary, a `vocab.txt` path, or a directory holding
    `vocab.txt` or `vocab.json`. A model name with no local vocabulary
    raises FileNotFoundError: nothing is downloaded, and the tiny
    vocabulary does not stand in for a real one."""
    if name_or_path in ("tiny", "synthetic", None, ""):
        return WordPieceTokenizer(tiny_wordpiece_vocab())
    if os.path.isdir(name_or_path):
        vocab_file = os.path.join(name_or_path, "vocab.txt")
        if os.path.isfile(vocab_file):
            return WordPieceTokenizer.from_vocab_file(vocab_file)
        vjson = os.path.join(name_or_path, "vocab.json")
        if os.path.isfile(vjson):
            with open(vjson) as f:
                return WordPieceTokenizer(json.load(f))
    if os.path.isfile(name_or_path):
        return WordPieceTokenizer.from_vocab_file(name_or_path)
    raise FileNotFoundError(
        f"text tokenizer {name_or_path!r}: no local vocab.txt/vocab.json "
        f"found and downloads are unavailable. Pass a local checkpoint "
        f"dir/vocab file, or use 'tiny' for synthetic debug runs.")
