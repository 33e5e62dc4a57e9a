"""Masked cosine similarity top-k over device-resident embedding slabs.

Port of ``mmrag_tpu/ops/topk.py`` (dense layouts). Corpus slabs live on the
device; tenant and ``video_id`` predicates are pushed *into* the scoring mask
(additive -1e30) rather than applied post-fusion — the reference's
post-filter bug (``api/routes.py:272-279``, SURVEY §3.3) cannot occur.

Every exact search goes through the bucket-max kernel path (B4,
:mod:`mmrag_tpu_torch.ops.pallas_topk`): the slab is never copied and on the
card the kernel always launches. ``backend="approx"`` (X1,
``TPU_TOPK_BACKEND=approx``) takes K-bmax's top-t form instead
(:func:`~mmrag_tpu_torch.ops.pallas_topk.approx_cosine_topk`), with a
recall of the exact top-k in place of exactness.
:func:`cosine_topk_dense` (dense ``q @ c.T`` + a top-k) is the plain
reference the tests hold the kernel path against; no search calls it.

Every top-k here and in the index ops orders exact ties as ``jax.lax.top_k``
does, the lower index first (:func:`topk_first`); ``torch.topk`` does not
define that order.

The int8 form (``TPU_INDEX_DTYPE=int8``) keeps its own quantizer,
:func:`quantize_rows_int8` (not the W8A8 one of ``ops/quant.py``: a true
division by ``max(absmax, 1e-12) / 127``, then a clip), and scores with an
exact integer dot, so that the IVF probe, spill and append-tail scores of an
int8 layout merge on one scale.

Scores are cosine similarities assuming L2-normalized rows/queries, matching
the reference's ``score = 1 - distance`` resort (``lancedb_store.py:125-139``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG_INF = -1e30
INT8_CHUNK = 65536  # slab rows widened to f32 at a time by the int8 product


class TopK(NamedTuple):
    values: torch.Tensor
    indices: torch.Tensor


def topk_first(scores: torch.Tensor, k: int) -> TopK:
    """``(values, indices)`` of the ``k`` largest entries along the last dim,
    in descending order, equal values in index order: ``jax.lax.top_k``'s
    rule (on a tie the lower index comes first), which every top-k of the
    JAX package follows. ``torch.topk`` leaves the order of ties undefined,
    so this is a stable descending sort, cut to ``k``."""

    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return TopK(values[..., :k], indices[..., :k])


TILE_N = 2048  # the row tile of the JAX two-phase top-ks (B4's and the ADC's)


def hottest_buckets(bucket_max: torch.Tensor, n: int, kb: int, bucket: int = 128):
    """Phase B of the two-phase top-ks (B4 and the ADC path): the ``kb``
    buckets of largest maximum per row of ``bucket_max`` ``(q, ceil(n /
    bucket))``, laid out as the JAX package lays out its candidates. Returns
    the bucket ids ``(q, kb')`` and the bucket count of JAX's layout, which
    caps ``kb'``; buckets past ``ceil(n / bucket)`` hold only rows past n.

    At ``n >= TILE_N`` JAX pads the rows to whole tiles (its buckets past
    ``n`` exist, at -1e30, and may be picked for fillers) and takes
    ``lax.top_k`` of the maxima: by maximum, the lower bucket first on a tie.
    Below one tile it takes a dense top-k instead, whose ties go to the
    lowest row id: then the chosen buckets (which hold every row of the dense
    answer) are laid out in row order."""

    nb = bucket_max.shape[1]
    if n >= TILE_N and n % TILE_N:
        nb = -(-n // TILE_N) * TILE_N // bucket
        bucket_max = torch.nn.functional.pad(bucket_max, (0, nb - bucket_max.shape[1]),
                                             value=NEG_INF)
    idx = topk_first(bucket_max, min(kb, nb)).indices
    if n < TILE_N:
        idx = torch.sort(idx, dim=-1).values
    return idx, nb


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Zero-safe L2 normalization (reference ``app/ml/embeddings.py:46-49``)."""

    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def predicate_mask(users, docs, live, user_id, doc_id):
    """Liveness + tenant + optional-document mask. The ONE place the
    isolation predicate lives: the operands broadcast, so scalar ids serve one
    query and id columns against gathered planes serve many (the slab, the
    probed blocks, the spill). ``live`` is bool or an int32 plane."""

    return live.bool() & (users == user_id) & ((doc_id < 0) | (docs == doc_id))


def predicate_mask_multi(users, docs, live, user_ids, doc_ids):
    """Per-query ``(q, n)`` form of :func:`predicate_mask`."""

    return predicate_mask(users[None, :], docs[None, :], live[None, :],
                          user_ids[:, None], doc_ids[:, None])


def cosine_topk_dense(
    queries: torch.Tensor,  # (q, d) f32/bf16, L2-normalized
    corpus: torch.Tensor,  # (n, d) slab (padded rows are masked out)
    valid_mask: torch.Tensor,  # (n,) or (q, n) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dense top-k: the reference for :func:`cosine_topk`."""

    # stream-dtype operands, f32 accumulation (bf16 products are exact in f32)
    scores = queries.to(corpus.dtype).float() @ corpus.float().T
    mask = valid_mask if valid_mask.ndim == 2 else valid_mask[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    values, indices = topk_first(scores, k)
    return values, indices.to(torch.int32)


def cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    backend: str = "auto",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine scores + row indices per query.

    ``valid_mask`` is ``(n,)`` (one predicate for every query) or ``(q, n)``
    (per-query predicates — multi-tenant batched search).

    ``backend`` is ``auto`` (exact, B4) or ``approx`` (X1: a recall of at
    least ``recall_target`` against the exact top-k is the contract, as for
    ``jax.lax.approx_max_k``). The approximate search keeps a fixed
    ``kernels.APPROX_TOP`` (48) rows a 128-row bucket, which guarantees every
    query a recall of at least ``min(1, 48 / k)`` on any rows, so it raises
    ``ValueError`` where ``recall_target * k`` exceeds 48 (at the default
    0.95, k above 50) rather than promise what it cannot hold. It is slower
    than ``auto`` on the card and stands for parity with the JAX package.

    Returns ``(scores (q, k) f32, indices (q, k) i32)``. Indices of masked-out
    / padded rows never appear unless fewer than ``k`` rows are valid, in
    which case the filler entries carry scores <= -1e29 (callers drop them).
    When ``k`` exceeds the corpus, the missing columns are filled with score
    -1e30 and index 0.
    """

    if queries.ndim != 2 or corpus.ndim != 2:
        raise ValueError("queries and corpus must be rank-2")
    if valid_mask.ndim == 2 and valid_mask.shape[0] != queries.shape[0]:
        raise ValueError(
            f"per-query mask rows {valid_mask.shape[0]} != queries {queries.shape[0]}"
        )
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"dim mismatch: queries {tuple(queries.shape)} vs corpus {tuple(corpus.shape)}"
        )
    if backend not in ("auto", "approx"):
        raise ValueError(f"unknown topk backend {backend!r}: auto or approx")
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target {recall_target} is not in (0, 1]")
    n = corpus.shape[0]
    k_eff = min(k, n)
    from .kernels import APPROX_TOP
    from .pallas_topk import approx_cosine_topk, fused_cosine_topk

    if backend == "approx" and recall_target * k_eff > APPROX_TOP:
        raise ValueError(f"approx top-k keeps {APPROX_TOP} rows a bucket, which guarantees a "
                         f"recall of {APPROX_TOP} / k: recall_target {recall_target} at k "
                         f"{k_eff} needs k <= {int(APPROX_TOP / recall_target)}")

    search = approx_cosine_topk if backend == "approx" else fused_cosine_topk
    scores, idx = search(queries, corpus, valid_mask, k_eff)
    if k_eff < k:
        pad = k - k_eff
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=0)
    return scores, idx


def quantize_rows_int8(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of ``mmrag_tpu/ops/topk.py``: ``(int8 rows, f32
    row scales)`` with ``row ~= int8 * scale``. The scale is
    ``max(absmax, 1e-12) / 127`` (a true division) and the codes are clipped
    to [-127, 127]; ``torch.round`` rounds halves to even like ``jnp.round``."""

    mat = mat.float()
    absmax = mat.abs().amax(-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(mat / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def int8_dot(qq: torch.Tensor, corpus_q: torch.Tensor) -> torch.Tensor:
    """Exact ``(q, n)`` integer dot of int8 queries with an int8 slab, as f32.

    Each sum holds at most 512 products of at most 127**2, below 2**24, so an
    f32 accumulation is exact in any order (TF32 is off). The slab is widened
    ``INT8_CHUNK`` rows at a time, never whole."""

    qf = qq.float()
    n = corpus_q.shape[0]
    raw = torch.empty((qq.shape[0], n), dtype=torch.float32, device=corpus_q.device)
    for lo in range(0, n, INT8_CHUNK):
        hi = min(lo + INT8_CHUNK, n)
        raw[:, lo:hi] = qf @ corpus_q[lo:hi].float().T
    return raw


def cosine_topk_int8(
    queries: torch.Tensor,  # (q, d) f32, L2-normalized
    corpus_q: torch.Tensor,  # (n, d) int8
    corpus_scale: torch.Tensor,  # (n,) f32
    valid_mask: torch.Tensor,  # (n,) or (q, n) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over an int8 slab (``_cosine_topk_int8`` of the JAX
    package): the queries quantize per row, the integer dot is exact, and
    scores are ``(raw * qscale) * row_scale`` in f32."""

    qq, qscale = quantize_rows_int8(queries)
    scores = int8_dot(qq, corpus_q) * qscale[:, None] * corpus_scale[None, :]
    mask = valid_mask if valid_mask.ndim == 2 else valid_mask[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    values, indices = topk_first(scores, min(k, corpus_q.shape[0]))
    return values, indices.to(torch.int32)


def pad_topk(
    scores: torch.Tensor, idx: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad clamped top-k lists back to ``k`` with the standard -1e30/-1
    fillers (shared by the IVF and sharded paths)."""

    if scores.shape[-1] >= k:
        return scores, idx
    pad = k - scores.shape[-1]
    scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return scores, idx


def merge_topk(
    scores_a: torch.Tensor,
    idx_a: torch.Tensor,
    scores_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k lists into one (used for shard merges)."""

    scores = torch.cat([scores_a, scores_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    values, sel = topk_first(scores, min(k, scores.shape[-1]))
    return values, torch.gather(idx, -1, sel)
