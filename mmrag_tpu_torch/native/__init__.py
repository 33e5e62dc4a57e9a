"""Native host runtime: ctypes bindings over ``host_runtime.cpp``.

Port of ``mmrag_tpu/native``, with its own copy of the C++ source. The
reference gets its host-side native speed from third-party libraries
(LanceDB's Rust storage engine, OpenCV, imagehash); this package supplies
first-party C++ for the loops on the port's host paths:

  * ``f32_to_bf16`` / ``bf16_to_f32`` — the bf16 snapshot payload
    (``VectorIndex.save`` / ``load``), round to nearest even
  * ``gather_rows`` — compaction and snapshot rows (threaded memcpy)
  * ``hamming_dedup`` / ``hamming_matrix`` — 64-bit pHash popcounts
  * ``merge_topk`` — the host merge of per-slice top-k lists
    (:func:`mmrag_tpu_torch.parallel.sharded_index.merge_slices_host`)
  * ``l2_normalize_rows`` — zero-safe normalize-on-write
  * ``wordpiece_create`` / :class:`NativeWordPiece` — the ASCII WordPiece
    of every MiniLM and cross-encoder tokenization
    (:class:`mmrag_tpu_torch.models.tokenizer.WordPieceTokenizer`)

The library is compiled with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at
first use into ``mmrag_tpu_torch/_build/`` under a name that carries the
source's hash. Concurrent builds (several test workers) each write a
pid-unique temporary file and ``os.replace`` it into place. A build or load
that fails raises: unlike the JAX package, there is no numpy fallback and no
``MMRAG_NATIVE`` switch. The numpy forms live in :mod:`.plain`, the plain
versions the tests hold the library against.

Two declines are part of the contract, not fallbacks: the WordPiece kernel
returns ``None`` for text with a byte >= 0x80 (the caller tokenizes that row
in Python), and :func:`wordpiece_create` returns ``None`` for a vocabulary
whose ids are not the dense 0..n-1 of a vocab file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "host_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_ABI_VERSION = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(src: str = SOURCE) -> str:
    """``_build/libmmrag_torch_host-<hash>.so``: the hash covers the source
    and the flags, so an edited source never loads a stale library."""

    digest = hashlib.sha256()
    with open(src, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmmrag_torch_host-{digest.hexdigest()[:12]}.so")


def build(src: str = SOURCE, out: Optional[str] = None) -> str:
    """Compile ``src`` into ``out`` (default :func:`library_path`) and return
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when g++ fails or is missing."""

    out = out or library_path(src)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # pid-unique temp: a concurrent build in another process must never see
    # a library that this g++ is still writing
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"native host runtime: g++ did not run: {exc}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"native host runtime: g++ failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.mmrag_abi_version.restype = i32
    lib.mmrag_f32_to_bf16.argtypes = [f32p, u16p, i64]
    lib.mmrag_bf16_to_f32.argtypes = [u16p, f32p, i64]
    lib.mmrag_gather_rows_f32.argtypes = [f32p, i64p, i64, i64, f32p]
    lib.mmrag_hamming_dedup.argtypes = [u64p, i64, i32, u8p]
    lib.mmrag_hamming_dedup.restype = i64
    lib.mmrag_hamming_matrix.argtypes = [u64p, i64, u64p, i64, i32p]
    lib.mmrag_merge_topk.argtypes = [f32p, i64p, i64, i64, i64, f32p, i64p]
    lib.mmrag_l2_normalize_rows.argtypes = [f32p, i64, i64]
    lib.mmrag_wp_create.argtypes = [ctypes.c_char_p, i64]
    lib.mmrag_wp_create.restype = ctypes.c_void_p
    lib.mmrag_wp_destroy.argtypes = [ctypes.c_void_p]
    lib.mmrag_wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64, i32, i32p, i64]
    lib.mmrag_wp_tokenize.restype = i64
    lib.mmrag_wp_tokenize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, i64, i32, i32p, i64, i64p
    ]
    return lib


def load() -> ctypes.CDLL:
    """The native library, built first if this source has none. Raises
    when it cannot be built or loaded."""

    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            build(out=path)
        for attempt in range(2):
            try:
                # AttributeError: a library missing a bound symbol
                lib = _bind(ctypes.CDLL(path))
                if lib.mmrag_abi_version() != _ABI_VERSION:
                    raise OSError(f"ABI version {lib.mmrag_abi_version()} != {_ABI_VERSION}")
                _lib = lib
                return _lib
            except (OSError, AttributeError) as exc:
                # a damaged library (a partial copy of _build/) loads badly
                # though the source compiles: rebuild it once, then give up
                if attempt == 1:
                    raise RuntimeError(f"native host runtime: cannot load {path}: {exc}") from exc
                build(out=path)
    raise AssertionError("unreachable")


# ---- public API --------------------------------------------------------------


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16, as ``uint16`` bit patterns (NaN
    stays NaN)."""

    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint16)
    load().mmrag_f32_to_bf16(x.reshape(-1), out.reshape(-1), x.size)
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """``uint16`` bf16 bit patterns -> f32 (exact)."""

    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    out = np.empty(bits.shape, dtype=np.float32)
    load().mmrag_bf16_to_f32(bits.reshape(-1), out.reshape(-1), bits.size)
    return out


def gather_rows(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``src[rows]`` for a 2-D f32 array (threaded memcpy)."""

    src = np.ascontiguousarray(src, dtype=np.float32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if src.ndim != 2:
        raise ValueError(f"gather_rows takes a 2-D array, got shape {src.shape}")
    # the C loop is unchecked pointer arithmetic: refuse out-of-range ids
    # (numpy's negative wrap included) before they read arbitrary memory
    if rows.size and (rows.min() < 0 or rows.max() >= src.shape[0]):
        raise IndexError(
            f"gather_rows: ids outside [0, {src.shape[0]}) "
            f"(min {int(rows.min())}, max {int(rows.max())})"
        )
    out = np.empty((rows.size, src.shape[1]), dtype=np.float32)
    load().mmrag_gather_rows_f32(src, rows, rows.size, src.shape[1], out)
    return out


def hamming_dedup(hashes: np.ndarray, max_dist: int) -> np.ndarray:
    """Greedy in-order dedup of 64-bit hashes; returns a bool keep-mask: a
    hash is kept iff it differs by more than ``max_dist`` bits from every
    previously *kept* hash (reference ``app/ingest/frames.py:87-95``)."""

    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    keep = np.empty(hashes.size, dtype=np.uint8)
    if hashes.size:
        load().mmrag_hamming_dedup(hashes, hashes.size, int(max_dist), keep)
    return keep.astype(bool)


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) int32 popcounts of ``a[i] ^ b[j]``."""

    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty((a.size, b.size), dtype=np.int32)
    load().mmrag_hamming_matrix(a, a.size, b, b.size, out)
    return out


def merge_topk(scores: np.ndarray, ids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard top-k lists: (shards, q, k) -> global (q, k).

    Descending score, ties toward the smaller id, NaN ordered as -inf;
    filler slots (fewer than ``k`` candidates) carry -1e30 / -1."""

    scores = np.ascontiguousarray(scores, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    shards, q, kin = scores.shape
    if kin != k or ids.shape != scores.shape:
        raise ValueError(f"merge_topk takes (shards, q, {k}) lists, got {scores.shape} "
                         f"scores and {ids.shape} ids")
    out_s = np.empty((q, k), dtype=np.float32)
    out_i = np.empty((q, k), dtype=np.int64)
    load().mmrag_merge_topk(scores, ids, shards, q, k, out_s, out_i)
    return out_s, out_i


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Zero-safe row normalization of a 2-D array, in a fresh array
    (reference ``app/ml/embeddings.py:46-49``)."""

    x = np.ascontiguousarray(x, dtype=np.float32).copy()
    if x.ndim != 2:
        raise ValueError(f"l2_normalize_rows takes a 2-D array, got shape {x.shape}")
    load().mmrag_l2_normalize_rows(x, x.shape[0], x.shape[1])
    return x


class NativeWordPiece:
    """ASCII WordPiece over the C++ kernel in ``host_runtime.cpp`` (the role
    of HF's Rust ``tokenizers`` crate in the reference,
    ``app/ml/embeddings.py:52-105``). ``tokenize`` returns None for text the
    kernel declines (a byte >= 0x80): the caller tokenizes it in Python,
    whose unicode handling the kernel does not replicate."""

    def __init__(self, lib: ctypes.CDLL, handle: int, unk_id: int) -> None:
        self._lib = lib
        self._handle = handle
        self._unk_id = unk_id
        # a bound method survives the interpreter's teardown ordering
        self._destroy = lib.mmrag_wp_destroy

    def __del__(self) -> None:  # pragma: no cover - lifecycle
        handle, self._handle = self._handle, None
        if handle:
            self._destroy(handle)

    def tokenize(self, text: str) -> Optional[List[int]]:
        data = text.encode("utf-8")
        # every token consumes at least one input byte
        cap = len(data) + 8
        out = np.empty(cap, dtype=np.int32)
        n = self._lib.mmrag_wp_tokenize(self._handle, data, len(data), self._unk_id, out, cap)
        if n < 0:  # non-ASCII: the caller's Python path
            return None
        return out[:n].tolist()

    def tokenize_batch(self, data: List[bytes], out: np.ndarray) -> np.ndarray:
        """Tokenize every text into the rows of a preallocated C-contiguous
        ``(n, cap)`` int32 matrix in ONE C call (threaded across rows).
        Returns the ``(n,)`` int64 token counts; a negative entry is a row
        the kernel declined, which the caller redoes in Python."""

        n = len(data)
        if out.dtype != np.int32 or not out.flags.c_contiguous or out.shape[0] != n:
            raise ValueError("tokenize_batch takes a C-contiguous (n, cap) int32 matrix")
        lengths = np.empty(n, dtype=np.int64)
        if n == 0:
            return lengths
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(d) for d in data], out=offsets[1:])
        self._lib.mmrag_wp_tokenize_batch(self._handle, b"".join(data), offsets, n,
                                          self._unk_id, out, out.shape[1], lengths)
        return lengths


def wordpiece_create(vocab: Dict[str, int], unk_id: int) -> Optional[NativeWordPiece]:
    """A native WordPiece matcher, or None for a vocabulary the kernel
    cannot index: it numbers pieces by vocab-file line, so the ids must be
    the dense 0..n-1 of ``from_vocab_file``, with no newline in a piece."""

    n = len(vocab)
    tokens_by_id: List[Optional[str]] = [None] * n
    for tok, tid in vocab.items():
        if not 0 <= tid < n or tokens_by_id[tid] is not None or "\n" in tok:
            return None
        tokens_by_id[tid] = tok
    lib = load()
    blob = "\n".join(tokens_by_id).encode("utf-8")  # type: ignore[arg-type]
    handle = lib.mmrag_wp_create(blob, len(blob))
    if not handle:
        raise MemoryError("mmrag_wp_create returned no handle")
    return NativeWordPiece(lib, handle, unk_id)
