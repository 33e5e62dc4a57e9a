"""Seeded text: the lexicon, the two vocabularies, sentences, chunks, queries.

The lexicon and the vocabularies are fixed (``LEXICON_SEED``), as a
deployed model's vocabulary is; the text drawn from them follows the run's
seed. Words follow a Zipf law over the lexicon. The WordPiece vocabulary
holds the 20,000 commonest words whole and splits the rest into a head and
``##`` tails, so the longest-match search runs as it does on a real
vocabulary's rarer words; CLIP's BPE table is 512 byte symbols, 48,894
merges learnt left to right over the lexicon, and the two markers, as
published (49,408 entries).
"""

from __future__ import annotations

import functools
import json
import os
import string
from typing import Dict, List, Optional, Tuple

import numpy as np

LEXICON_SEED = 1_000_003
LEXICON_WORDS = 24_000
WHOLE_WORDS = 20_000
WORDPIECE_SIZE = 30_522
CLIP_MERGES = 48_894

_ONSETS = ["", "b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r", "s", "t",
           "v", "w", "z", "br", "cr", "dr", "st", "tr", "ch", "sh", "th", "pl", "gr", "sp"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ea", "ou", "io", "y"]
_CODAS = ["", "", "n", "r", "s", "t", "l", "m", "nd", "st", "ng", "x", "ck"]


@functools.lru_cache(maxsize=1)
def lexicon() -> List[str]:
    rng = np.random.default_rng(LEXICON_SEED)
    words: Dict[str, None] = {}
    while len(words) < LEXICON_WORDS:
        n = 4096
        syll = rng.choice([1, 1, 2, 2, 2, 3, 3, 4], size=n)
        parts = np.char.add(np.char.add(np.asarray(_ONSETS)[rng.integers(len(_ONSETS), size=(n, 4))],
                                        np.asarray(_VOWELS)[rng.integers(len(_VOWELS), size=(n, 4))]),
                            np.asarray(_CODAS)[rng.integers(len(_CODAS), size=(n, 4))])
        for k, row in zip(syll, parts.tolist()):
            w = "".join(row[:k])
            if len(w) >= 2 and len(words) < LEXICON_WORDS:
                words.setdefault(w)
    # frequent words tend to be short, as in natural text: rank by length
    # with a spread
    jitter = dict(zip(words, rng.normal(0.0, 3.0, len(words))))
    return sorted(words, key=lambda w: len(w) + jitter[w])


def word_probs(n: int, s: float = 1.0) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


@functools.lru_cache(maxsize=1)
def lexicon_arrays() -> Tuple[np.ndarray, np.ndarray]:
    """The lexicon and the cumulative Zipf(1) law over it."""

    lex = np.asarray(lexicon())
    return lex, np.cumsum(word_probs(len(lex)))


def wordpiece_vocab(lex: List[str]) -> List[str]:
    """BERT's layout: [PAD] 0, [unused*] 1-99, [UNK] 100, [CLS] 101,
    [SEP] 102, [MASK] 103, then characters, whole words and pieces."""

    rng = np.random.default_rng(LEXICON_SEED + 1)
    pieces = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                 "[MASK]"]
    chars = string.ascii_lowercase + string.digits
    pieces += list(string.punctuation) + list(chars) + [f"##{c}" for c in chars]
    pieces += lex[:WHOLE_WORDS]
    for word in lex[WHOLE_WORDS:]:
        cut = int(rng.integers(2, 5))
        pieces.append(word[:cut])
        rest = word[cut:]
        while rest:
            step = int(rng.integers(2, 5))
            pieces.append(f"##{rest[:step]}")
            rest = rest[step:]
    pieces = list(dict.fromkeys(pieces))
    seen = set(pieces)
    while len(pieces) < WORDPIECE_SIZE:
        w = "".join(rng.choice(list(string.ascii_lowercase), int(rng.integers(2, 7))))
        w = w if rng.random() < 0.5 else f"##{w}"
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    return pieces[:WORDPIECE_SIZE]


def clip_bpe(lex: List[str]) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    from ..reference.tokenizers import byte_table

    symbols = list(byte_table().values())
    vocab: Dict[str, int] = {}
    for s in symbols + [s + "</w>" for s in symbols]:
        vocab[s] = len(vocab)
    merges: List[Tuple[str, str]] = []
    for word in lex:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        cur = parts[0]
        for p in parts[1:]:
            new = cur + p
            if new not in vocab and len(merges) < CLIP_MERGES:
                merges.append((cur, p))
                vocab[new] = len(vocab)
            cur = new
        if len(merges) >= CLIP_MERGES:
            break
    if len(merges) != CLIP_MERGES:
        raise RuntimeError(f"the lexicon gives {len(merges)} merges, not {CLIP_MERGES}")
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_vocabularies(bert_dirs: List[str], clip_dir: str) -> None:
    """``vocab.txt`` into each BERT model's directory; ``vocab.json`` and
    ``merges.txt`` into CLIP's."""

    lex = lexicon()
    wp = "\n".join(wordpiece_vocab(lex)) + "\n"
    for d in bert_dirs:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as fh:
            fh.write(wp)
    vocab, merges = clip_bpe(lex)
    os.makedirs(clip_dir, exist_ok=True)
    with open(os.path.join(clip_dir, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(clip_dir, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


class Text:
    """Sentences, chunks, titles and queries drawn from one seeded stream."""

    def __init__(self, rng: np.random.Generator, pool: int = 8192,
                 sentences: Optional[List[str]] = None) -> None:
        self.rng = rng
        self.lex, self.cdf = lexicon_arrays()
        self.sentences = (sentences if sentences is not None
                          else [self._sentence() for _ in range(pool)])

    def words(self, n: int) -> List[str]:
        idx = np.searchsorted(self.cdf, self.rng.random(n) * self.cdf[-1], side="right")
        return list(self.lex[np.minimum(idx, len(self.lex) - 1)])

    def _sentence(self) -> str:
        ws = self.words(int(self.rng.integers(6, 21)))
        for i in range(len(ws) - 1):
            r = self.rng.random()
            if r < 0.08:
                ws[i] += ","
            elif r < 0.11:
                ws[i] = str(int(self.rng.integers(2, 2100)))
        return " ".join(ws) + "."

    def passage(self, chars: int) -> str:
        """Whole sentences until ``chars`` characters, cut there, stripped."""

        out, n = [], 0
        idx = self.rng.integers(0, len(self.sentences), size=chars // 40 + 8)
        for i in idx:
            s = self.sentences[i]
            out.append(s)
            n += len(s) + 1
            if n >= chars:
                break
        return " ".join(out)[:chars].strip()

    def passages(self, n: int, chars: int) -> List[str]:
        """``n`` passages as :meth:`passage` makes them, drawn in one go."""

        per = chars // 40 + 8
        idx = self.rng.integers(0, len(self.sentences), size=(n, per))
        lens = np.asarray([len(s) + 1 for s in self.sentences])[idx].cumsum(axis=1)
        stop = (lens < chars).sum(axis=1) + 1
        pool = self.sentences
        return [" ".join(pool[j] for j in row[:k])[:chars].strip()
                for row, k in zip(idx.tolist(), stop.tolist())]

    def title(self) -> str:
        return " ".join(self.words(int(self.rng.integers(2, 6))))

    def query(self, n_words: int) -> str:
        return " ".join(self.words(n_words))


def sliding_chunks(text: str, size: int, overlap: int) -> List[str]:
    """Windows of ``size`` characters every ``size - overlap``, stripped."""

    step = size - overlap
    out = []
    for start in range(0, max(len(text) - overlap, 1), step):
        piece = text[start:start + size].strip()
        if piece:
            out.append(piece)
    return out
