"""The numpy forms of :mod:`mmrag_tpu_torch.native`: the plain versions the
tests hold the C++ library against, bit for bit. Nothing in the package
calls them. The WordPiece kernel's plain version is the tokenizer's own
pure-Python path (``WordPieceTokenizer._py_tokenize_ids``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to nearest even on the bit pattern, NaN kept NaN (quiet bit
    set), as ``host_runtime.cpp::f32_to_bf16_rne``."""

    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (bits >> 16) & np.uint32(1)
    rounded = ((bits + np.uint32(0x7FFF) + lsb) >> 16).astype(np.uint16)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = ((bits >> 16) | np.uint32(0x40)).astype(np.uint16)
    return np.where(nan, quiet, rounded)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def gather_rows(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return np.asarray(src, np.float32)[np.asarray(rows, np.int64)]


def hamming_dedup(hashes: np.ndarray, max_dist: int) -> np.ndarray:
    hashes = np.asarray(hashes, dtype=np.uint64)
    keep = np.zeros(hashes.size, dtype=bool)
    kept: list = []
    for i, h in enumerate(int(v) for v in hashes):
        if all(bin(h ^ k).count("1") > max_dist for k in kept):
            keep[i] = True
            kept.append(h)
    return keep


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    x = a[:, None] ^ b[None, :]
    return np.unpackbits(x.view(np.uint8).reshape(a.size, b.size, 8), axis=-1).sum(
        -1, dtype=np.int32)


def merge_topk(scores: np.ndarray, ids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(shards, q, k') -> (q, k): descending score, ties to the smaller id,
    NaN ordered as -inf, -1e30 / -1 fillers past the candidates."""

    scores = np.asarray(scores, np.float32)
    ids = np.asarray(ids, np.int64)
    shards, q, kin = scores.shape
    flat_s = scores.transpose(1, 0, 2).reshape(q, shards * kin)
    flat_i = ids.transpose(1, 0, 2).reshape(q, shards * kin)
    key = np.where(np.isnan(flat_s), -np.inf, flat_s)
    order = np.lexsort((flat_i, -key), axis=-1)[:, :k]
    out_s = np.take_along_axis(flat_s, order, axis=-1)
    out_i = np.take_along_axis(flat_i, order, axis=-1)
    pad = k - order.shape[1]
    if pad > 0:
        out_s = np.pad(out_s, ((0, 0), (0, pad)), constant_values=-1e30)
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
    return out_s, out_i


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.where(norms > 1e-12, x / np.maximum(norms, 1e-12), x)
