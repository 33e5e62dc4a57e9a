"""Host-side tokenizers: BERT WordPiece and CLIP BPE, and Whisper's
byte-level BPE decoder.

Tokenization stays on host (it's branchy string work — the reference does it
inside sentence-transformers/CLIPProcessor, ``app/ml/embeddings.py:52-105``);
everything after id-lookup runs on the device. Outputs are padded numpy
arrays at caller-chosen static lengths (the runtime's buckets). WordPiece
takes the C++ kernel of :mod:`mmrag_tpu_torch.native` for ASCII text, as
``mmrag_tpu.models.tokenizer`` does, and its pure-Python path for the rest;
both give the JAX package's ids.

Vocabularies load from files (``vocab.txt`` for WordPiece; ``vocab.json`` +
``merges.txt`` for CLIP BPE) placed under ``WEIGHTS_DIR/<model>/`` by the
checkpoint conversion flow. With no vocab on disk (zero-egress environments)
a deterministic :class:`HashTokenizer` keeps every pipeline functional: stable
token ids from hashing, same padding/special-token contract.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pad_batch(
    seqs: Sequence[Sequence[int]], max_len: int, pad_id: int
) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(seqs), max_len), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), max_len), dtype=np.int32)
    for i, seq in enumerate(seqs):
        trimmed = list(seq)[:max_len]
        ids[i, : len(trimmed)] = trimmed
        mask[i, : len(trimmed)] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# BERT WordPiece
# ---------------------------------------------------------------------------

_PUNCT_SPLIT = re.compile(r"(\W)", re.UNICODE)


def _basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    tokens: List[str] = []
    for blob in text.split():
        for piece in _PUNCT_SPLIT.split(blob):
            piece = piece.strip()
            if piece:
                tokens.append(piece)
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match WordPiece with HF-BERT special-token layout."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
    ) -> None:
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word
        # the C++ WordPiece (mmrag_tpu_torch.native) replicates exactly the
        # lowercase / 100-char semantics below, so any other configuration,
        # and a vocabulary that is not a dense 0..n-1, stays pure Python
        self._native = None
        if lowercase and max_chars_per_word == 100:
            from .. import native

            self._native = native.wordpiece_create(vocab, self.unk_id)

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kwargs)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[int] = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def _py_tokenize_ids(self, text: str) -> List[int]:
        """The pure-Python WordPiece: the plain version of the native kernel,
        and the path of every row the kernel declines."""

        out: List[int] = []
        for word in _basic_tokenize(text, self.lowercase):
            out.extend(self._wordpiece(word))
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        if self._native is not None:
            ids = self._native.tokenize(text)
            if ids is not None:
                return ids
        return self._py_tokenize_ids(text)

    def tokenize_matrix(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """All texts tokenized into one padded matrix: ``(ids (n, L) int32,
        lengths (n,) int64)`` with rows padded by ``pad_id`` to the longest.

        The batched-ingest layout: callers assemble the final
        ``[CLS] body [SEP]`` rows with numpy. The native kernel writes every
        row in place in one call; a row it declines (non-ASCII) is redone in
        Python (a token never takes less than one byte, so it fits).
        """

        n = len(texts)
        if self._native is not None:
            data = [t.encode("utf-8") for t in texts]
            cap = max((len(d) for d in data), default=1) + 8
            buf = np.full((n, cap), self.pad_id, dtype=np.int32)
            lengths = self._native.tokenize_batch(data, buf)
            for i in np.flatnonzero(lengths < 0):
                ids = self._py_tokenize_ids(texts[i])
                buf[i] = self.pad_id
                buf[i, : len(ids)] = ids
                lengths[i] = len(ids)
            return buf, lengths
        lists = [self._py_tokenize_ids(t) for t in texts]
        width = max((len(t) for t in lists), default=1)
        buf = np.full((n, width), self.pad_id, dtype=np.int32)
        lengths = np.empty(n, dtype=np.int64)
        for i, ids in enumerate(lists):
            buf[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return buf, lengths

    def encode(
        self, texts: Sequence[str], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Single sequences: ``[CLS] tokens [SEP]`` padded to max_len."""

        seqs = []
        for text in texts:
            body = self.tokenize_ids(text)[: max_len - 2]
            seqs.append([self.cls_id, *body, self.sep_id])
        return _pad_batch(seqs, max_len, self.pad_id)

    def encode_pairs(
        self, firsts: Sequence[str], seconds: Sequence[str], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pairs: ``[CLS] a [SEP] b [SEP]`` + token_type ids (cross-encoder).

        Truncation is longest-first, matching HF ``truncation=True`` for
        pair inputs.
        """

        assert len(firsts) == len(seconds)
        seqs, types = [], []
        budget = max_len - 3
        for a_text, b_text in zip(firsts, seconds):
            a = self.tokenize_ids(a_text)
            b = self.tokenize_ids(b_text)
            while len(a) + len(b) > budget:
                if len(a) >= len(b):
                    a.pop()
                else:
                    b.pop()
            seq = [self.cls_id, *a, self.sep_id, *b, self.sep_id]
            seqs.append(seq)
            types.append([0] * (len(a) + 2) + [1] * (len(b) + 1))
        ids, mask = _pad_batch(seqs, max_len, self.pad_id)
        tt = np.zeros_like(ids)
        for i, t in enumerate(types):
            tt[i, : min(len(t), max_len)] = t[:max_len]
        return ids, mask, tt


# ---------------------------------------------------------------------------
# CLIP BPE
# ---------------------------------------------------------------------------

# HF CLIPTokenizer's pattern uses \p{L}/\p{N}; stdlib `re` equivalents:
# [^\W\d_] matches unicode letters, \d unicode digits, and the final class
# re-admits "_" (a letter/number/space in neither alphabet)
_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


def _clip_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class ClipBPETokenizer:
    """CLIP's lowercased BPE with ``</w>`` word-end markers.

    Layout per HF ``CLIPTokenizer``: ``<|startoftext|> tokens <|endoftext|>``
    padded to 77; EOT has the largest vocab id, which the text tower's argmax
    pooling depends on (``mmrag_tpu_torch.models.clip.clip_text_features``).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]) -> None:
        self.vocab = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_id = vocab["<|startoftext|>"]
        self.eot_id = vocab["<|endoftext|>"]
        self.pad_id = 0
        self.cache: Dict[str, List[str]] = {}
        # GPT-2/CLIP byte-level mapping: BPE operates on byte-mapped unicode
        # symbols, so non-ASCII text ("café") tokenizes exactly like HF
        self._b2u = _bytes_to_unicode()

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "ClipBPETokenizer":
        import json

        with open(vocab_json, encoding="utf-8") as fh:
            vocab = json.load(fh)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as fh:
            for line in fh.read().split("\n")[1:]:
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = [*token[:-1], token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _CLIP_PAT.findall(_clip_clean(text)):
            mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, self.vocab.get("</w>", 0)))
        return ids

    def encode(
        self, texts: Sequence[str], max_len: int = 77
    ) -> Tuple[np.ndarray, np.ndarray]:
        seqs = []
        for text in texts:
            body = self.tokenize_ids(text)[: max_len - 2]
            seqs.append([self.bos_id, *body, self.eot_id])
        return _pad_batch(seqs, max_len, self.pad_id)


# ---------------------------------------------------------------------------
# Offline fallback
# ---------------------------------------------------------------------------


class HashTokenizer:
    """Deterministic hashing tokenizer for vocab-less (zero-egress) runs.

    Keeps the exact special-token contract of the tokenizer it stands in for
    (BERT layout when ``style='bert'``, CLIP layout when ``style='clip'``) so
    downstream code paths — including EOT argmax pooling — are exercised
    identically; only the id assignment differs.
    """

    def __init__(self, style: str = "bert", vocab_size: int = 30522) -> None:
        if style not in ("bert", "clip"):
            raise ValueError(f"unknown style {style!r}")
        self.style = style
        self.vocab_size = vocab_size
        if style == "bert":
            self.pad_id, self.cls_id, self.sep_id = 0, 101, 102
            self._reserved = {0, 100, 101, 102, 103}
        else:
            self.pad_id = 0
            self.bos_id, self.eot_id = vocab_size - 2, vocab_size - 1
            self._reserved = {0, vocab_size - 2, vocab_size - 1}

    def _token_id(self, token: str) -> int:
        import hashlib

        digest = hashlib.md5(token.encode()).digest()
        tid = int.from_bytes(digest[:4], "little") % self.vocab_size
        while tid in self._reserved:
            tid = (tid + 1) % self.vocab_size
        return tid

    def tokenize_ids(self, text: str) -> List[int]:
        return [self._token_id(t) for t in _basic_tokenize(text)]

    def encode(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        first, last = (
            (self.cls_id, self.sep_id) if self.style == "bert" else (self.bos_id, self.eot_id)
        )
        seqs = [
            [first, *self.tokenize_ids(t)[: max_len - 2], last] for t in texts
        ]
        return _pad_batch(seqs, max_len, self.pad_id)

    def encode_pairs(
        self, firsts: Sequence[str], seconds: Sequence[str], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        assert self.style == "bert"
        seqs, types = [], []
        budget = max_len - 3
        for a_text, b_text in zip(firsts, seconds):
            a = self.tokenize_ids(a_text)
            b = self.tokenize_ids(b_text)
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
            seqs.append([self.cls_id, *a, self.sep_id, *b, self.sep_id])
            types.append([0] * (len(a) + 2) + [1] * (len(b) + 1))
        ids, mask = _pad_batch(seqs, max_len, self.pad_id)
        tt = np.zeros_like(ids)
        for i, t in enumerate(types):
            tt[i, : min(len(t), max_len)] = t[:max_len]
        return ids, mask, tt


# ---------------------------------------------------------------------------
# Byte-level table (CLIP BPE input side, Whisper's output side)
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->printable-unicode table."""

    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteLevelBPEDecoder:
    """ids -> text for GPT-2-style byte-level BPE vocabularies (Whisper).

    Decoding needs only the vocab (token string -> id), not the merge table:
    each token string is a sequence of byte-mapped unicode chars, so joining
    tokens and inverting the byte table reconstructs the utf-8 stream. Ids at
    or past ``special_base`` (Whisper: everything from <|endoftext|> up) are
    skipped.
    """

    def __init__(self, vocab: Dict[str, int], special_base: int) -> None:
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.special_base = special_base
        self._u2b = {c: b for b, c in _bytes_to_unicode().items()}

    @classmethod
    def from_vocab_file(cls, vocab_json: str, special_base: int) -> "ByteLevelBPEDecoder":
        import json

        with open(vocab_json, encoding="utf-8") as fh:
            return cls(json.load(fh), special_base)

    def decode(self, ids: Sequence[int]) -> str:
        chars = []
        for i in ids:
            if int(i) >= self.special_base:
                continue
            tok = self.id_to_token.get(int(i))
            if tok is not None:
                chars.append(tok)
        # chars outside the byte table can only come from a malformed
        # vocab.json; substitute a space rather than crash the transcript
        data = bytes(self._u2b.get(c, 32) for c in "".join(chars))
        return data.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Loading helpers
# ---------------------------------------------------------------------------


def load_bert_tokenizer(model_dir: str):
    """WordPiece from ``<model_dir>/vocab.txt`` if present, else HashTokenizer."""

    vocab_path = os.path.join(model_dir, "vocab.txt")
    if os.path.exists(vocab_path):
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    return HashTokenizer(style="bert")


def load_clip_tokenizer(model_dir: str):
    """CLIP BPE from ``vocab.json``+``merges.txt`` if present, else HashTokenizer."""

    vocab_json = os.path.join(model_dir, "vocab.json")
    merges_txt = os.path.join(model_dir, "merges.txt")
    if os.path.exists(vocab_json) and os.path.exists(merges_txt):
        return ClipBPETokenizer.from_files(vocab_json, merges_txt)
    return HashTokenizer(style="clip", vocab_size=49408)


def load_whisper_decoder(model_dir: str, eot_id: int) -> Optional[ByteLevelBPEDecoder]:
    """Whisper output detokenizer from ``<model_dir>/vocab.json``; None when
    absent (callers then fall back down the ASR ladder: text cannot be faked
    the way embedding ids can)."""

    vocab_json = os.path.join(model_dir, "vocab.json")
    if os.path.exists(vocab_json):
        return ByteLevelBPEDecoder.from_vocab_file(vocab_json, special_base=eot_id)
    return None
