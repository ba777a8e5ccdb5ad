"""WordPiece tokenizer (bert-base-uncased scheme), the port of ``r3m_tpu/text/tokenizer.py``.

Host-side, pure Python and numpy: it replaces the reference's HuggingFace ``AutoTokenizer``
call (``models_language.py:19,30``). The language encoder is frozen and tokenizing is host
work that feeds the device; its cost is small beside the image encode.

The standard BERT-uncased pipeline: NFD accent stripping and lowercasing, whitespace,
punctuation and CJK splitting, then greedy longest-match-first WordPiece with ``##``
continuation prefixes. Ids and masks equal the JAX package's tokenizer's, which matches
``transformers.BertTokenizer(vocab, do_lower_case=True)``. The vocab is the ``vocab.txt``
that `r3m_tpu_torch.prepare_language` writes.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges are treated as punctuation (BERT rule)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over an on-disk vocab."""

    def __init__(
        self,
        vocab: Dict[str, int] | None = None,
        vocab_file: str | None = None,
        do_lower_case: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        if vocab is None:
            if vocab_file is None:
                raise ValueError("need vocab or vocab_file")
            vocab = load_vocab(vocab_file)
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_token = "[UNK]"
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab["[PAD]"]
        self.unk_id = vocab["[UNK]"]

    # ---- basic tokenization -------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._split_cjk(self._clean(text))
        tokens: List[str] = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return tokens

    # ---- wordpiece ----------------------------------------------------------

    def wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        subtokens: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                piece = token[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            subtokens.append(cur)
            start = end
        return subtokens

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def encode(self, text: str, max_len: int | None = None) -> List[int]:
        """[CLS] toks [SEP], truncated to max_len if given."""
        ids = [self.cls_id] + [
            self.vocab.get(t, self.unk_id) for t in self.tokenize(text)
        ] + [self.sep_id]
        if max_len is not None and len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
        return ids

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch encode with padding.

        `max_len=None` pads to the longest sentence in the batch — the
        reference tokenizer's ``padding=True`` behavior
        (models_language.py:30). Passing a fixed `max_len` gives fixed
        shapes and batch-independent embeddings; the training pipeline
        uses `lang_max_len` from config.
        Returns (ids [B, T] int32, attention_mask [B, T] int32).
        """
        encoded = [self.encode(t, max_len) for t in texts]
        target = max_len if max_len is not None else max(len(e) for e in encoded)
        ids = np.full((len(texts), target), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), target), dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab
