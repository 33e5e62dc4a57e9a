"""Exact masked cosine top-k by bucket maxima (B4).

Port of ``mmrag_tpu/ops/pallas_topk.py::fused_cosine_topk`` (the module keeps
its JAX name so the two packages line up file for file). Its Pallas kernel
``_bucket_max_kernel`` becomes the hand-written CUDA kernel K-bmax
(``csrc/bucket_max.cu``); phases B and C stay plain torch ops, as they stay
plain jnp in the JAX package:

  Phase A (K-bmax)  ``queries @ corpus.T`` over the rows the mask keeps
                    (-1e30 elsewhere) reduced to the max of each 128-row
                    bucket, ``(q, n/128)``; the score matrix is never written
                    to device memory, and the kernel reads the bool mask
                    itself (JAX turns it into an f32 bias first).
  Phase B (torch)   a top-k over bucket maxima picks the ``k + MARGIN``
                    hottest buckets per query.
  Phase C (torch)   gather those buckets' rows, rescore exactly (f32
                    accumulation), a top-k over ``(k + MARGIN) * 128``.

Exact ties come out as JAX's: both top-ks put the lower index first
(``jax.lax.top_k``'s rule, :func:`mmrag_tpu_torch.ops.topk.topk_first`), so
equal rows come in the rank order of their buckets, not by row id; below
one 2048-row tile, where JAX takes its dense top-k instead, in row order.

Exactness: every global top-k element makes its bucket's max >= s_k (the k-th
best score), so all buckets holding top-k elements rank within the top-k
buckets by max; ``MARGIN`` >= 0 covers ties at the boundary.

The corpus is never padded: the kernel scores rows past ``n`` at -1e30 and
phase C masks them, so any ``n`` runs the kernel (no small-corpus fallback).

:func:`approx_cosine_topk` is the approximate search (X1,
``TPU_TOPK_BACKEND=approx``; JAX's ``jax.lax.approx_max_k``): the top-k, by
(score descending, row ascending), of the union of each bucket's
``APPROX_TOP`` (48) best rows. Phases B and C do not run. On the TPU
``approx_max_k`` keeps each bin's best and takes the top-k of those; one row
a bucket missed most of a query's neighbours where a document's chunks sit
in contiguous rows (recall@50 0.085). A query loses only the true top-k rows
past the 48th of one bucket, so its recall is at least ``min(1, 48 / k)`` on
any rows (``ops/kernels.py::APPROX_TOP``). On the card the union is never
written out: K-bmax's top-k form keeps each persistent block's best k while
the corpus streams and a merge kernel takes the blocks' lists to the answer
(``kernels.approx_topk``); one corpus read, as the exact path's phase A, and
no phases B and C (``PERF.md`` has the times against the exact path).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .topk import hottest_buckets, topk_first

NEG = kernels.NEG
BUCKET = kernels.BUCKET  # rows per bucket
MARGIN = 4  # extra buckets rescored in phase C


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _topk_rows(queries, corpus, mask, k: int, bucket_max_fn):
    qp = queries.shape[0]
    n = corpus.shape[0]
    bucket_max = bucket_max_fn(queries, corpus, mask)  # (qp, ceil(n/128))
    # the hottest buckets in JAX's phase-B order (ties: the lower bucket)
    bucket_idx, nb = hottest_buckets(bucket_max, n, k + MARGIN)  # (qp, kb)
    kb = bucket_idx.shape[1]
    rows = bucket_idx[:, :, None] * BUCKET + torch.arange(BUCKET, device=corpus.device)
    rows = rows.reshape(qp, kb * BUCKET)
    ragged = nb * BUCKET != n  # buckets hold rows past n
    rows_c = torch.clamp(rows, max=n - 1) if ragged else rows
    cand = corpus[rows_c.reshape(-1)].reshape(qp, kb * BUCKET, -1)
    if cand.is_cuda and cand.dtype == torch.bfloat16:
        # bf16 products, f32 sums and output (JAX's preferred_element_type),
        # without an f32 copy of the gathered rows; the CPU lacks this form
        cand_scores = torch.bmm(cand, queries[:, :, None], out_dtype=torch.float32)[:, :, 0]
    else:
        cand_scores = torch.bmm(cand.float(), queries.float()[:, :, None])[:, :, 0]
    if mask.shape[0] == 1:
        keep = mask[0][rows_c]
    else:
        keep = torch.gather(mask, 1, rows_c)
    if ragged:
        keep = keep & (rows < n)
    # -1e30 where JAX adds its -1e30 bias: s + (-1e30) rounds to -1e30
    cand_scores = torch.where(keep, cand_scores, NEG)
    # JAX's phase C: on a tie the earlier candidate first; a filler past n
    # keeps its padded row id, as JAX's does
    values, local = topk_first(cand_scores, k)
    return values, torch.gather(rows, 1, local).to(torch.int32)


def fused_cosine_topk(
    queries: torch.Tensor,  # (q, d)
    corpus: torch.Tensor,  # (n, d) bf16/f32 slab
    valid_mask: torch.Tensor,  # (n,) or (q, n) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked cosine top-k: ``(scores (q, k) f32, indices (q, k) i32)``.

    Same contract as :func:`mmrag_tpu_torch.ops.topk.cosine_topk`; rows
    failing ``valid_mask`` surface only as fillers with scores <= -1e29 when
    fewer than ``k`` rows are valid. On a CUDA corpus phase A launches
    K-bmax; on a CPU corpus it runs the plain version."""

    return _fused_cosine_topk(queries, corpus, valid_mask, k, _bucket_max_counted)


def _bucket_max_counted(queries, corpus, mask):
    # one count per K-bmax launch: a batch of more than 32 queries takes several
    out = kernels.bucket_max(queries, corpus, mask)
    if corpus.device.type == "cuda":
        kernels.count_launch("B4")
    return out


def approx_cosine_topk(queries, corpus, valid_mask, k: int):
    """Approximate masked cosine top-k, ``fused_cosine_topk``'s contract with
    a recall of the exact top-k in place of exactness, at least ``min(1,
    APPROX_TOP / k)`` for every query: ``(scores (q, k) f32, indices (q, k)
    i32)``, the candidates' exact scores, best first, on equal scores the
    lower row first. Needs ``ceil(n / 128) * APPROX_TOP >= k``. On a CUDA
    corpus it launches K-bmax-top and K-bmax-topk-merge; on a CPU corpus it
    runs the plain version."""

    return _approx_cosine_topk(queries, corpus, valid_mask, k, kernels.approx_topk)


def approx_cosine_topk_plain(queries, corpus, valid_mask, k: int):
    """:func:`approx_cosine_topk` in plain torch on any device: one stable
    sort of the union's ``nb * APPROX_TOP`` candidates a query (the
    yardstick the kernels are held against on the card)."""

    return _approx_cosine_topk(queries, corpus, valid_mask, k, kernels.approx_topk_plain)


def _approx_cosine_topk(queries, corpus, valid_mask, k: int, top_fn):
    n = corpus.shape[0]
    k = min(k, n)
    if -(-n // BUCKET) * kernels.APPROX_TOP < k:
        raise ValueError(f"approx top-k needs ceil(n / {BUCKET}) * {kernels.APPROX_TOP} >= k: "
                         f"n {n}, k {k}")
    return _per_launch(queries, corpus, valid_mask, k, top_fn)


def fused_cosine_topk_plain(queries, corpus, valid_mask, k: int):
    """:func:`fused_cosine_topk` with phase A in plain torch on any device
    (the yardstick the kernel is held against on the card)."""

    return _fused_cosine_topk(queries, corpus, valid_mask, k, kernels.bucket_max_plain)


def _fused_cosine_topk(queries, corpus, valid_mask, k: int, bucket_max_fn):
    k = min(k, corpus.shape[0])
    return _per_launch(queries, corpus, valid_mask, k,
                       lambda qs, corpus, ms, k: _topk_rows(qs, corpus, ms, k, bucket_max_fn))


def _per_launch(queries, corpus, valid_mask, k: int, rows_fn):
    """Pad the queries to a multiple of 8 (pad rows match nothing), then
    ``rows_fn(queries, corpus, mask, k)`` on each group of up to 32 (one
    kernel launch each)."""

    q, d = queries.shape
    n = corpus.shape[0]
    qp = max(8, _round_up(q, 8))
    queries = queries.to(corpus.dtype)
    if qp != q:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, qp - q))
    mask = valid_mask.to(torch.bool)
    if mask.ndim == 2:  # per-query tenant masks; pad rows match nothing
        if qp != q:
            mask = torch.cat([mask, mask.new_zeros((qp - q, n))])
    else:
        mask = mask[None, :]
    mask = mask.contiguous()
    queries = queries.contiguous()
    scores_parts, idx_parts = [], []
    for s0 in range(0, qp, 32):  # the kernel takes up to 32 queries a launch
        qs = queries[s0 : s0 + 32]
        ms = mask if mask.shape[0] == 1 else mask[s0 : s0 + 32]
        sc, ix = rows_fn(qs, corpus, ms, k)
        scores_parts.append(sc)
        idx_parts.append(ix)
    if len(scores_parts) == 1:
        return scores_parts[0][:q], idx_parts[0][:q]
    return torch.cat(scores_parts)[:q], torch.cat(idx_parts)[:q]
