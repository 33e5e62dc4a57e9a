"""Plain tokenizers: BERT WordPiece and CLIP's byte-level BPE.

Written from the published algorithms (HF ``BertTokenizer`` with
``do_lower_case=True``; OpenAI CLIP's ``simple_tokenizer``), for the ASCII
text the benchmark generates. They read the same vocabulary files that the
benchmark writes for the system under test, and share no code with it.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# WordPiece
# ---------------------------------------------------------------------------


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def basic_split(text: str) -> List[str]:
    """Lowercase, strip accents, split on whitespace and punctuation."""

    text = unicodedata.normalize("NFD", text.lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    for word in text.split():
        cur = ""
        for ch in word:
            if _is_punct(ch) or not (ch.isalnum() or ch == "_"):
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


class WordPiece:
    def __init__(self, vocab: Dict[str, int]) -> None:
        self.vocab = vocab
        self.unk, self.cls, self.sep, self.pad = (vocab[t] for t in
                                                  ("[UNK]", "[CLS]", "[SEP]", "[PAD]"))
        self._memo: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "WordPiece":
        with open(path, encoding="utf-8") as fh:
            return cls({line.rstrip("\n"): i for i, line in enumerate(fh)})

    def _word(self, word: str) -> List[int]:
        hit = self._memo.get(word)
        if hit is not None:
            return hit
        if len(word) > 100:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = ("##" if start else "") + word[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                pieces = [self.unk]
                break
            pieces.append(cur)
            start = end
        self._memo[word] = pieces
        return pieces

    def ids(self, text: str) -> List[int]:
        return [i for w in basic_split(text) for i in self._word(w)]

    def single(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """``[CLS] body [SEP]`` rows, the body cut to ``max_len - 2``,
        padded to the longest row."""

        rows = [[self.cls, *self.ids(t)[: max_len - 2], self.sep] for t in texts]
        return _pad(rows, self.pad)

    def pairs(self, firsts: Sequence[str], seconds: Sequence[str],
              max_len: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``[CLS] a [SEP] b [SEP]`` with longest-first truncation to
        ``max_len`` and token types; padded to the longest row."""

        rows, types = [], []
        for a_text, b_text in zip(firsts, seconds):
            a, b = self.ids(a_text), self.ids(b_text)
            while len(a) + len(b) > max_len - 3:  # HF's longest_first
                (a if len(a) > len(b) else b).pop()
            rows.append([self.cls, *a, self.sep, *b, self.sep])
            types.append([0] * (len(a) + 2) + [1] * (len(b) + 1))
        ids, mask = _pad(rows, self.pad)
        tt = np.zeros_like(ids)
        for i, t in enumerate(types):
            tt[i, : len(t)] = t
        return ids, mask, tt


def _pad(rows: List[List[int]], pad: int) -> Tuple[np.ndarray, np.ndarray]:
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), pad, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# CLIP BPE
# ---------------------------------------------------------------------------

_CLIP_SPLIT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def byte_table() -> Dict[int, str]:
    """GPT-2's reversible map from bytes to printable characters."""

    keep = (list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class ClipBPE:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]) -> None:
        self.vocab = vocab
        self.rank = {m: i for i, m in enumerate(merges)}
        self.bos, self.eot = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
        self.bytes = byte_table()
        self._memo: Dict[str, List[int]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "ClipBPE":
        with open(vocab_json, encoding="utf-8") as fh:
            vocab = json.load(fh)
        with open(merges_txt, encoding="utf-8") as fh:
            lines = fh.read().split("\n")[1:]
        return cls(vocab, [tuple(ln.split()) for ln in lines if len(ln.split()) == 2])

    def _word(self, token: str) -> List[int]:
        hit = self._memo.get(token)
        if hit is not None:
            return hit
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.rank.get((parts[i], parts[i + 1]), None), i)
                      for i in range(len(parts) - 1)]
            ranked = [r for r in ranked if r[0] is not None]
            if not ranked:
                break
            best = min(ranked)[0]
            pair = next((parts[i], parts[i + 1]) for r, i in ranked if r == best)
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        out = [self.vocab[p] for p in parts]
        self._memo[token] = out
        return out

    def ids(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        out: List[int] = []
        for tok in _CLIP_SPLIT.findall(text):
            out.extend(self._word("".join(self.bytes[b] for b in tok.encode("utf-8"))))
        return out

    def encode(self, texts: Sequence[str], max_len: int = 77) -> Tuple[np.ndarray, np.ndarray]:
        """``<|startoftext|> body <|endoftext|>`` padded with 0 to ``max_len``."""

        ids = np.zeros((len(texts), max_len), np.int64)
        mask = np.zeros((len(texts), max_len), np.int64)
        for i, t in enumerate(texts):
            row = [self.bos, *self.ids(t)[: max_len - 2], self.eot]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask
