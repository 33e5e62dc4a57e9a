"""Product quantization (PQ): m-byte codes + ADC search.

Port of ``mmrag_tpu/ops/pq.py``, the "PQ" half of the reference's LanceDB
IVF_PQ index (``lancedb_store.py:51-58``, ``num_sub_vectors=16``): each row
splits into ``m`` subvectors, each quantized to one of 256 per-subvector
centroids, so a 384-d row costs ``m`` bytes on the device (16 by default,
against 768 B for a bf16 row). Cosine of L2-normalized vectors decomposes
over subvectors, so scoring a code is ``m`` table lookups (asymmetric
distance computation, ADC).

  * **Codebooks**: ``m`` independent Euclidean k-means (``index_add_``
    updates), on an evenly spaced sample.
  * **Codes** live on the device as int8 (bias -128); the f32 originals stay
    in host RAM (see ``VectorIndex``) for the exact refine.
  * **Search** (:func:`pq_topk`) is the two-phase bucket-max recipe of
    ``ops/pallas_topk.py`` applied to codes. Phase A is B10 (K-adc bucket
    max, ``csrc/adc.cu``): scores from shared-memory bf16 tables reduced to
    128-row bucket maxima, the (q, n) score matrix never written. Phase B
    (``topk`` of bucket maxima) and the bucket-granular gather stay torch
    ops; phase C rescoring is B11 (K-adc rescore, :func:`adc_rescore_scores`),
    which also scores the IVF_PQ probe and spill. Every ``n`` takes this path
    on the card: the kernels mask rows past ``n``, so nothing is padded.
    :func:`_pq_topk_scan` is the plain reference; the fused path returns its
    scores bit for bit (both sum the same bf16 entries in j order).
  * **Exact refine on host** (:func:`refine_exact`): ADC returns
    ``k * refine`` candidates, rescored against the host originals
    (LanceDB's ``refine_factor`` role).

``torch.topk`` on the card does not break ties by the lowest index, and ADC
scores tie often (sums of 16 bf16 entries): compare sorted score lists
exactly, and ids only where scores are apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import kernels
from .topk import NEG_INF

PQ_K = 256  # centroids per subvector (8-bit codes)
ADC_BUCKET = kernels.BUCKET  # rows per bucket
ADC_MARGIN = 4  # extra buckets rescored (tie safety)
ENCODE_CHUNK = 65536


# ---------------------------------------------------------------------------
# Codebook training (m independent Euclidean k-means)
# ---------------------------------------------------------------------------


def _assign_one(rows: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of one subvector: argmin ||x - c||^2 =
    argmax (x.c - ||c||^2 / 2). (n, ds), (K, ds) -> (n,) int32."""

    bias = 0.5 * torch.sum(cents * cents, dim=1)
    return torch.argmax(rows @ cents.T - bias[None, :], dim=1).to(torch.int32)


def _pq_kmeans_step(sub_rows: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration for every subvector: sub_rows (m, n, ds) f32,
    codebooks (m, K, ds) f32 -> updated codebooks. Empty clusters keep their
    centroid."""

    out = []
    for rows, cents in zip(sub_rows, codebooks):
        assign = _assign_one(rows, cents).long()
        sums = torch.zeros_like(cents).index_add_(0, assign, rows)
        counts = torch.bincount(assign, minlength=PQ_K).float()[:, None]
        out.append(torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents))
    return torch.stack(out)


def _pq_assign(sub_rows: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(m, n, ds), (m, K, ds) -> codes (n, m) int32."""

    return torch.stack([_assign_one(r, c) for r, c in zip(sub_rows, codebooks)], dim=1)


def _split_subvectors(rows: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, d/m); d must divide by m (384 / 16 = 24)."""

    n, d = rows.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subvectors")
    return rows.reshape(n, m, d // m).permute(1, 0, 2)


def train_pq(
    rows: torch.Tensor,  # (n, d) f32, L2-normalized
    m: int = 16,
    iters: int = 10,
    train_sample: int = 65536,
) -> torch.Tensor:
    """Train (m, K, ds) codebooks. Init = strided row sample per subvector
    (wraps when n < K); Lloyd runs on an evenly spaced subsample."""

    from .ivf import _as_index, _even_indices

    n = rows.shape[0]
    train = rows
    if train_sample and n > train_sample:
        train = rows[_as_index(_even_indices(n, train_sample), rows.device)]
    sub = _split_subvectors(train.float(), m).contiguous()
    tn = sub.shape[1]
    stride = max(tn // PQ_K, 1)
    init = sub[:, ::stride, :][:, :PQ_K, :]
    if init.shape[1] < PQ_K:
        reps = -(-PQ_K // init.shape[1])
        init = init.repeat(1, reps, 1)[:, :PQ_K, :]
    codebooks = init.contiguous()
    for _ in range(max(iters, 1)):
        codebooks = _pq_kmeans_step(sub, codebooks)
    return codebooks


def pq_encode(rows: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, m) int8 codes (bias -128), ``ENCODE_CHUNK`` rows at a
    time: the assignment's (m, chunk, K) f32 transient stays bounded."""

    m = codebooks.shape[0]
    parts = []
    for lo in range(0, rows.shape[0], ENCODE_CHUNK):
        chunk = rows[lo:lo + ENCODE_CHUNK].float()
        codes = _pq_assign(_split_subvectors(chunk, m), codebooks)
        parts.append((codes - 128).to(torch.int8))
    if not parts:
        return torch.zeros((0, m), dtype=torch.int8, device=rows.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# ---------------------------------------------------------------------------
# ADC search
# ---------------------------------------------------------------------------


def _adc_tables(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(q, d) x (m, K, ds) -> per-subvector lookup tables (m, K, q) f32."""

    q, d = queries.shape
    m, _, ds = codebooks.shape
    qsub = queries.float().reshape(q, m, ds).permute(1, 2, 0)  # (m, ds, q)
    return torch.bmm(codebooks, qsub)


def _pq_topk_scan(
    queries: torch.Tensor,  # (q, d) f32, L2-normalized
    codebooks: torch.Tensor,  # (m, K, ds) f32
    codes: torch.Tensor,  # (n, m) int8 (bias -128)
    valid_mask: torch.Tensor,  # (n,) or (q, n) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain ADC reference: an (n, q) f32 accumulator, one bf16 table
    selection per subvector added in order — the sums the kernels form."""

    tables = _adc_tables(queries, codebooks).to(torch.bfloat16).float()  # (m, K, q)
    acc = 0.0
    for j in range(codebooks.shape[0]):
        acc = acc + tables[j][codes[:, j].long() + 128]
    scores = acc.T  # (q, n)
    mask = valid_mask if valid_mask.ndim == 2 else valid_mask[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    top = torch.topk(scores, k, dim=-1)
    return top.values, top.indices.to(torch.int32)


def _adc_bucket_max_counted(tables, codes, bias):
    out = kernels.adc_bucket_max(tables, codes, bias)
    if codes.device.type == "cuda":
        kernels.count_launch("B10")
    return out


def adc_rescore_scores(
    tables: torch.Tensor,  # (m, q, K) bf16 per-query ADC tables
    cand_codes: torch.Tensor,  # (q|1, m, S) int8 lane-major candidates
    bias: torch.Tensor,  # (q, S) f32: 0 live / NEG_INF dead
) -> torch.Tensor:
    """Biased ADC scores of per-query candidate sets, (q, S) f32: B11, the
    engine behind the flat path's phase C and the IVF_PQ probe and spill. A
    leading dim of 1 on ``cand_codes`` means every query scores the same
    candidates (the spill): the kernel reads the one copy for each query."""

    out = kernels.adc_rescore(tables.contiguous(), cand_codes.contiguous(), bias.contiguous())
    if cand_codes.device.type == "cuda":
        kernels.count_launch("B11")
    return out


def _pq_topk_fused(
    tables: torch.Tensor,  # (m, q, K) bf16 per-query ADC tables
    codes: torch.Tensor,  # (n, m) int8
    bias: torch.Tensor,  # (1|q, n) f32: 0 live / NEG_INF masked
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase ADC top-k over query chunks of at most
    :func:`kernels.adc_max_queries` (the bucket-max kernel's shared-memory
    tables)."""

    m, q, _ = tables.shape
    step = kernels.adc_max_queries(m)
    parts_s, parts_i = [], []
    for s0 in range(0, q, step):
        t = tables[:, s0:s0 + step].contiguous()
        b = bias if bias.shape[0] == 1 else bias[s0:s0 + step]
        s, i = _fused_chunk(t, codes, b.contiguous(), k)
        parts_s.append(s)
        parts_i.append(i)
    return torch.cat(parts_s), torch.cat(parts_i)


def _fused_chunk(tables, codes, bias, k: int):
    qc = tables.shape[1]
    n, m = codes.shape
    # Phase A (B10): bucket maxima, the score matrix never written
    bucket_max = _adc_bucket_max_counted(tables, codes, bias)
    nb = bucket_max.shape[1]
    # Phase B: hottest buckets per query (every top-k row makes its bucket's
    # max >= the k-th score, so k + margin buckets cover the top-k set)
    kb = min(k + ADC_MARGIN, nb)
    bucket_idx = torch.topk(bucket_max, kb, dim=-1).indices  # (qc, kb)
    # Phase C: bucket-granular candidate fetch, exact ADC rescore (B11)
    rows = bucket_idx[:, :, None] * ADC_BUCKET + torch.arange(ADC_BUCKET, device=codes.device)
    rows = rows.reshape(qc, kb * ADC_BUCKET)
    in_range = rows < n
    rows_c = torch.clamp(rows, max=n - 1)
    cand_codes = codes[rows_c.reshape(-1)].reshape(qc, -1, m).transpose(1, 2).contiguous()
    cand_bias = bias[0][rows_c] if bias.shape[0] == 1 else torch.gather(bias, 1, rows_c)
    cand_bias = torch.where(in_range, cand_bias, NEG_INF)
    scores = adc_rescore_scores(tables, cand_codes, cand_bias)
    top = torch.topk(scores, k, dim=-1)
    return top.values, torch.gather(rows_c, 1, top.indices).to(torch.int32)


def pq_topk(
    queries: torch.Tensor,  # (q, d) f32, L2-normalized
    codebooks: torch.Tensor,  # (m, K, ds) f32
    codes: torch.Tensor,  # (n, m) int8 (bias -128)
    valid_mask: torch.Tensor,  # (n,) or (q, n) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked ADC top-k: approximate cosine via code tables, exact predicate
    semantics (mask applied before top-k, the contract of
    ``ops.topk.cosine_topk``). Returns (scores (q, k) f32, idx (q, k) i32).
    Takes the two-phase kernel path at every ``n``."""

    n = codes.shape[0]
    k = min(k, n)
    tables = _adc_tables(queries, codebooks).permute(0, 2, 1).to(torch.bfloat16)  # (m, q, K)
    zero = torch.zeros((), dtype=torch.float32, device=codes.device)
    bias = torch.where(valid_mask, zero, NEG_INF)
    if bias.ndim == 1:
        bias = bias[None, :]
    return _pq_topk_fused(tables.contiguous(), codes, bias.contiguous(), k)


def refine_exact(
    queries: np.ndarray,  # (q, d) f32, L2-normalized
    host_rows: np.ndarray,  # (N, d) f32 originals (host RAM)
    cand_idx: np.ndarray,  # (q, c) i32 ADC candidates (may contain -1/fillers)
    cand_scores: np.ndarray,  # (q, c) f32 ADC scores (NEG_INF fillers)
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host rescore of the ADC shortlist (LanceDB refine_factor role):
    gathers the candidates' originals and recomputes true cosines. Filler
    candidates (score <= -1e30) keep their sentinel."""

    q, c = cand_idx.shape
    safe = np.clip(cand_idx, 0, max(len(host_rows) - 1, 0))
    gathered = host_rows[safe]  # (q, c, d)
    exact = np.einsum("qcd,qd->qc", gathered, queries, dtype=np.float32)
    exact = np.where(cand_scores <= float(np.float32(NEG_INF)) / 2, cand_scores, exact)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    rows = np.arange(q)[:, None]
    return exact[rows, order], cand_idx[rows, order]


# ---------------------------------------------------------------------------
# Convenience container
# ---------------------------------------------------------------------------


@dataclass
class PQData:
    """Trained codebooks + encode/search bound to one index instance."""

    codebooks: torch.Tensor  # (m, K, ds) f32

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    def encode(self, rows: torch.Tensor) -> torch.Tensor:
        return pq_encode(rows, self.codebooks)

    def reconstruction_cosine(self, rows: torch.Tensor) -> float:
        """Mean cosine between rows and their PQ reconstruction — the
        quality statistic of a (re)train."""

        codes = (self.encode(rows).long() + 128).T  # (m, n)
        sub = _split_subvectors(rows.float(), self.m)  # (m, n, ds)
        recon = torch.stack([cb[c] for cb, c in zip(self.codebooks, codes)])  # (m, n, ds)
        dots = torch.sum(recon * sub, dim=(0, 2))
        norms = torch.sqrt(torch.sum(recon * recon, dim=(0, 2)))
        return float(torch.mean(dots / torch.clamp(norms, min=1e-12)))
