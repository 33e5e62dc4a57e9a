"""IVF (inverted-file) ANN: k-means partitions + static-shape probing.

Port of ``mmrag_tpu/ops/ivf.py`` (the reference's LanceDB IVF role,
``lancedb_store.py:51-58``, 32 partitions):

  * k-means is spherical (rows and centroids stay L2-normalized): the
    assignment step is one ``(n, d) x (d, C)`` product + argmax (in
    ``ASSIGN_CHUNK``-row pieces, so the (n, C) score matrix is never whole),
    the update step an ``index_add_``.
  * the cluster layout is a dense ``(C, B, d)`` bucket tensor (B = padded
    per-cluster capacity). Overflow rows go to a ``spill`` slab scored
    densely on every query, so imbalanced clusters degrade cost, never
    membership.
  * searches return global row indices of the flat slab, so tombstone and
    tenant masks apply unchanged.

The probe of a bf16/f32 layout is B8 and of an int8 layout B9
(:func:`pallas_probe_scores`, :func:`pallas_probe_scores_q`, hand-written
CUDA in ``csrc/ivf_probe.cu``): on a CUDA tensor the kernel launches at every
bucket size and width; on a CPU tensor its plain version runs. A
product-quantized layout (the literal IVF_PQ) scores its probed and spilled
codes with the ADC rescore kernel B11 (``ops/pq.py``).

On the card, k-means sums with atomics in no fixed order, so centroids may
differ from run to run by an ulp and a near-tie row may change cluster:
judge layouts there by recall, not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels
from .topk import (
    NEG_INF,
    l2_normalize,
    merge_topk,
    pad_topk as _pad_k,
    predicate_mask,
    predicate_mask_multi,
    quantize_rows_int8,
)

ASSIGN_CHUNK = 65536  # rows scored against the centroids at a time


# ---------------------------------------------------------------------------
# k-means (cosine/spherical: rows and centroids stay L2-normalized)
# ---------------------------------------------------------------------------


def _dot_f32(rows: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``rows @ other.T`` with ``other`` cast to the rows' dtype and f32
    products (exact for bf16): JAX's ``preferred_element_type=f32`` dot."""

    return rows.float() @ other.to(rows.dtype).float().T


def _as_index(sel: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(sel, np.int64)).to(device)


def _kmeans_step(rows: torch.Tensor, centroids: torch.Tensor, n_clusters: int):
    scores = _dot_f32(rows, centroids)
    assign = torch.argmax(scores, dim=1)
    sums = torch.zeros((n_clusters, rows.shape[1]), dtype=torch.float32, device=rows.device)
    sums.index_add_(0, assign, rows.float())
    counts = torch.bincount(assign, minlength=n_clusters).float()
    fresh = sums / torch.clamp(counts[:, None], min=1.0)
    # empty clusters keep their previous centroid instead of collapsing to 0
    new_c = torch.where(counts[:, None] > 0, l2_normalize(fresh), centroids)
    return new_c, assign.to(torch.int32)


def _assign_int8(rows_q: torch.Tensor, centroids: torch.Tensor, scales: torch.Tensor):
    """Assignment + structure for an int8 slab without dequantizing it: the
    raw integer dot picks the same centroid the dequantized rows would (the
    per-row scales are positive); only the structure statistic applies the
    scale."""

    assigns, total = [], 0.0
    cents = centroids.to(torch.bfloat16)  # int8 values are exact in bf16
    for lo in range(0, rows_q.shape[0], ASSIGN_CHUNK):
        hi = min(lo + ASSIGN_CHUNK, rows_q.shape[0])
        scores = rows_q[lo:hi].float() @ cents.float().T
        assigns.append(torch.argmax(scores, dim=1).to(torch.int32))
        total += float((scores.amax(dim=1) * scales[lo:hi]).double().sum())
    return torch.cat(assigns), total / max(rows_q.shape[0], 1)


def _even_indices(n: int, count: int) -> np.ndarray:
    """``count`` evenly spaced row indices over ``[0, n)`` — deterministic,
    spans the whole insertion order, distinct for count <= n."""

    return np.linspace(0, n - 1, num=count).astype(np.int32)


def kmeans(
    rows: torch.Tensor,  # (n, d), L2-normalized, f32/bf16
    n_clusters: int,
    iters: int = 8,
    train_sample: int = 0,  # 0 = train on all rows; else evenly spaced sample cap
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means; returns (centroids (C, d) f32, assign (n,) int32).

    Init is strided row sampling of the training set; with ``train_sample``
    Lloyd runs on an evenly spaced subsample and only the final assignment
    touches every row."""

    n = rows.shape[0]
    train = rows
    if train_sample and n > train_sample:
        train = rows[_as_index(_even_indices(n, train_sample), rows.device)]
    tn = train.shape[0]
    stride = max(tn // n_clusters, 1)
    centroids = l2_normalize(train[::stride][:n_clusters].float())
    if centroids.shape[0] < n_clusters:  # n < C: pad by wrapping
        reps = -(-n_clusters // centroids.shape[0])
        centroids = centroids.repeat(reps, 1)[:n_clusters]
    for _ in range(max(iters, 1)):
        centroids, _ = _kmeans_step(train, centroids, n_clusters)
    # final assignment of EVERY row against the final centroids
    assign, _ = _assign_with_structure(rows, centroids)
    return centroids, assign


def _assign_with_structure(rows: torch.Tensor, centroids: torch.Tensor):
    """Final assignment + mean best-cosine ("structure"), the clusterability
    signal: for uniform rows on the d-sphere the expected best-of-C cosine is
    ~sqrt(2 ln C / d); clustered corpora score several times that."""

    assigns, total = [], 0.0
    for lo in range(0, rows.shape[0], ASSIGN_CHUNK):
        hi = min(lo + ASSIGN_CHUNK, rows.shape[0])
        scores = _dot_f32(rows[lo:hi], centroids)
        assigns.append(torch.argmax(scores, dim=1).to(torch.int32))
        total += float(scores.amax(dim=1).double().sum())
    return torch.cat(assigns), total / max(rows.shape[0], 1)


def structureless_baseline(n_clusters: int, d: int) -> float:
    """Expected best-of-C assignment cosine for uniform rows on the d-sphere."""

    return float(np.sqrt(2.0 * np.log(max(n_clusters, 2)) / d))


def default_n_clusters(n: int) -> int:
    """sqrt scaling keeps probe cost ~ O(sqrt n): 1M -> 2048 clusters."""

    return max(8, min(1 << int(np.ceil(np.log2(max(np.sqrt(n) * 2, 8)))), n))


def bucket_size(n: int, n_clusters: int, bucket_factor: float) -> int:
    """Bucket capacity: factor x mean cluster size, aligned to 128 (8 for
    tiny indexes). The probe kernel takes any B."""

    bucket = int(-(-n * bucket_factor // n_clusters))
    align = 128 if bucket >= 64 else 8
    return max(8, (bucket + align - 1) // align * align)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


@dataclass
class IVFData:
    """Device-resident IVF layout over a flat row slab.

    Tenant/document/liveness predicates are carried in bucket layout
    (``*_b`` and ``spill_*``) so the probe kernel evaluates them in place.
    users/docs are immutable per row; liveness changes flow in through
    :meth:`mark_dead`, keyed by the host-side ``slot_of_row`` map."""

    centroids: torch.Tensor  # (C, d) f32
    buckets: torch.Tensor  # (C, B, d) slab dtype (int8 codes (C, B, m) for pq)
    bucket_ids: torch.Tensor  # (C, 1, B) int32 global row index, -1 = empty
    users_b: torch.Tensor  # (C, 1, B) int32
    docs_b: torch.Tensor  # (C, 1, B) int32
    live_b: torch.Tensor  # (C, 1, B) int32 0/1
    spill: torch.Tensor  # (S, d) overflow rows, scored densely (S may be 0)
    spill_ids: torch.Tensor  # (S,) int32
    spill_users: torch.Tensor  # (S,) int32
    spill_docs: torch.Tensor  # (S,) int32
    spill_live: torch.Tensor  # (S,) int32
    slot_of_row: np.ndarray  # host (built_rows, 2): (cluster, slot); (-1, s) = spill
    built_rows: int  # rows [0, built_rows) are covered by this layout
    # int8 storage: buckets/spill hold quantized rows, these their scales
    scales_b: Optional[torch.Tensor] = None  # (C, 1, B) f32
    spill_scales: Optional[torch.Tensor] = None  # (S,) f32
    # product-quantized layout (IVF_PQ): the codebooks that encoded the
    # bucket codes (a snapshot; the owning index may retrain its own later)
    pq_codebooks: Optional[torch.Tensor] = None  # (m, K, ds) f32
    structure: float = 0.0  # mean best-assignment cosine at build time
    # residual coding: codes encode x - centroid[assign]; scoring adds the
    # query-centroid dot back (spill_assign carries each spill row's cluster)
    pq_residual: bool = False
    spill_assign: Optional[torch.Tensor] = None  # (S,) int32

    @property
    def is_pq(self) -> bool:
        return self.pq_codebooks is not None

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def bucket_size(self) -> int:
        return int(self.buckets.shape[1])

    def mark_dead(self, rows: np.ndarray) -> None:
        """Tombstone clustered/spilled rows (called by the owning index)."""

        rows = np.asarray(rows)
        rows = rows[rows < self.built_rows]
        if rows.size == 0:
            return
        slots = self.slot_of_row[rows]
        bucketed = slots[slots[:, 0] >= 0]
        spilled = slots[slots[:, 0] < 0]
        dev = self.live_b.device
        if bucketed.size:
            self.live_b[_as_index(bucketed[:, 0], dev), 0, _as_index(bucketed[:, 1], dev)] = 0
        if spilled.size:
            self.spill_live[_as_index(spilled[:, 1], dev)] = 0


def _as_int32(x, n: int, fill: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((n,), fill, dtype=torch.int32, device=device)
    return torch.as_tensor(x, device=device).to(torch.int32)


def build_ivf(
    slab_rows: torch.Tensor,  # (n, d) L2-normalized rows (a slab prefix)
    n_clusters: Optional[int] = None,
    bucket_factor: float = 1.5,
    iters: int = 8,
    users: Optional[torch.Tensor] = None,  # (n,) int32 tenant ids
    docs: Optional[torch.Tensor] = None,  # (n,) int32 document ids
    live: Optional[torch.Tensor] = None,  # (n,) bool/int
    scales: Optional[torch.Tensor] = None,  # (n,) f32: slab_rows is int8
    train_sample: int = 131072,
    centroids: Optional[torch.Tensor] = None,  # (C, d): warm rebuild, no Lloyd
    assign: Optional[np.ndarray] = None,  # (n,) precomputed assignment
    structure_override: Optional[float] = None,  # with `assign`
    pq_codebooks: Optional[torch.Tensor] = None,  # slab_rows are ADC codes
    pq_residual: bool = False,  # codes encode x - centroid[assign]
) -> IVFData:
    """Cluster rows and lay them out in fixed-size buckets (the four forms of
    the JAX function: cold, warm ``centroids=``, int8 ``scales=`` and
    precomputed ``assign=`` with ``pq_codebooks``).

    The host handles only int32 slot bookkeeping (which row lands in which
    slot: a stable sort by cluster keeps insertion order within a bucket),
    then one device gather materializes the bucket tensor. Rows beyond a
    bucket's capacity spill. Predicates default to one tenant/document, all
    live."""

    n, d = slab_rows.shape
    dev = slab_rows.device
    if pq_codebooks is not None and (assign is None or centroids is None):
        raise ValueError(
            "pq layout needs a precomputed assignment + centroids "
            "(codes carry no clustering geometry)"
        )
    if pq_residual and pq_codebooks is None:
        raise ValueError("pq_residual requires pq_codebooks")
    users = _as_int32(users, n, 0, dev)
    docs = _as_int32(docs, n, 0, dev)
    live = _as_int32(live, n, 1, dev)
    if n_clusters is None:
        n_clusters = default_n_clusters(n)

    if assign is not None:
        # precomputed assignment (pq layout): layout only
        centroids = torch.as_tensor(centroids, device=dev).float()
        structure = 0.0 if structure_override is None else float(structure_override)
        assign_h = np.asarray(assign, np.int32)
    else:
        if centroids is not None:  # warm rebuild: only the assignment pass
            centroids = torch.as_tensor(centroids, device=dev).float()
        elif scales is not None:
            # train on a dequantized evenly spaced sample only
            sel = _as_index(_even_indices(n, min(train_sample or n, n)), dev)
            sample = slab_rows[sel].float() * torch.as_tensor(scales, device=dev).float()[sel, None]
            centroids, _ = kmeans(sample, n_clusters, iters, train_sample=0)
        else:
            centroids, _ = kmeans(slab_rows, n_clusters, iters, train_sample=train_sample)
        if scales is not None:
            scales = torch.as_tensor(scales, device=dev).float()
            a, structure = _assign_int8(slab_rows, centroids, scales)
        else:
            a, structure = _assign_with_structure(slab_rows, centroids)
        assign_h = a.cpu().numpy()
    n_clusters = int(centroids.shape[0])
    bucket = bucket_size(n, n_clusters, bucket_factor)
    structure = float(structure)

    # host-side slot assignment (vectorized int bookkeeping only): stable
    # sort by cluster preserves insertion order within each bucket
    ids = np.full((n_clusters, bucket), -1, np.int32)
    order = np.argsort(assign_h, kind="stable").astype(np.int32)
    sorted_assign = assign_h[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    pos = np.arange(n) - starts[sorted_assign]
    fits = pos < bucket
    ids[sorted_assign[fits], pos[fits]] = order[fits]
    spill_ids = order[~fits]
    pad_spill = max(8, (len(spill_ids) + 7) // 8 * 8) if len(spill_ids) else 0
    if pad_spill:
        spill_ids = np.pad(spill_ids, (0, pad_spill - len(spill_ids)), constant_values=-1)

    slot_of_row = np.full((n, 2), -1, np.int32)
    slot_of_row[order[fits], 0] = sorted_assign[fits]
    slot_of_row[order[fits], 1] = pos[fits]
    if len(spill_ids):
        real_spill = spill_ids[spill_ids >= 0] if pad_spill else spill_ids
        slot_of_row[order[~fits], 1] = np.arange(len(real_spill), dtype=np.int32)

    ids_dev = torch.from_numpy(ids).to(dev)
    clipped = ids_dev.clamp(0, n - 1).long()
    in_slot = ids_dev >= 0
    buckets = slab_rows[clipped.reshape(-1)].reshape(n_clusters, bucket, d)
    buckets.masked_fill_(~in_slot[..., None], 0)

    def plane(col, fill):
        return torch.where(in_slot, col[clipped], fill).to(col.dtype).reshape(
            n_clusters, 1, bucket)

    users_b, docs_b, live_b = plane(users, -1), plane(docs, -1), plane(live, 0)
    scales_b = plane(scales, 1.0) if scales is not None else None
    spill_scales = None
    if pad_spill:
        sid_dev = torch.from_numpy(spill_ids).to(dev)
        sclip = sid_dev.clamp(0, n - 1).long()
        s_in = sid_dev >= 0
        spill = slab_rows[sclip].masked_fill(~s_in[:, None], 0)
        spill_users = torch.where(s_in, users[sclip], -1).to(torch.int32)
        spill_docs = torch.where(s_in, docs[sclip], -1).to(torch.int32)
        spill_live = torch.where(s_in, live[sclip], 0).to(torch.int32)
        assign_dev = torch.from_numpy(assign_h).to(dev)
        spill_assign = torch.where(s_in, assign_dev[sclip], 0).to(torch.int32)
        if scales is not None:
            spill_scales = torch.where(s_in, scales[sclip], 1.0).float()
    else:
        sid_dev = torch.zeros((0,), dtype=torch.int32, device=dev)
        spill = torch.zeros((0, d), dtype=slab_rows.dtype, device=dev)
        spill_users = torch.zeros((0,), dtype=torch.int32, device=dev)
        spill_docs = spill_users.clone()
        spill_live = spill_users.clone()
        spill_assign = spill_users.clone()
        if scales is not None:
            spill_scales = torch.zeros((0,), dtype=torch.float32, device=dev)

    return IVFData(
        centroids=centroids,
        buckets=buckets,
        bucket_ids=ids_dev.reshape(n_clusters, 1, bucket),
        users_b=users_b,
        docs_b=docs_b,
        live_b=live_b,
        spill=spill,
        spill_ids=sid_dev,
        spill_users=spill_users,
        spill_docs=spill_docs,
        spill_live=spill_live,
        slot_of_row=slot_of_row,
        built_rows=n,
        scales_b=scales_b,
        spill_scales=spill_scales,
        pq_codebooks=(
            torch.as_tensor(pq_codebooks, device=dev).float()
            if pq_codebooks is not None else None
        ),
        structure=structure,
        pq_residual=bool(pq_residual),
        spill_assign=spill_assign,
    )


# ---------------------------------------------------------------------------
# The probe kernels (B8, B9)
# ---------------------------------------------------------------------------


def pallas_probe_scores(
    queries: torch.Tensor,  # (q, d) f32
    buckets: torch.Tensor,  # (C, B, d)
    bucket_ids: torch.Tensor,  # (C, 1, B) int32
    users_b: torch.Tensor,  # (C, 1, B) int32
    docs_b: torch.Tensor,  # (C, 1, B) int32
    live_b: torch.Tensor,  # (C, 1, B) int32
    probes: torch.Tensor,  # (q, nprobe) int32
    uids: torch.Tensor,  # (q,) int32 tenant predicate per query
    dids: torch.Tensor,  # (q,) int32 document predicate (-1 = none)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked probe scores + row ids, each (q, nprobe, B): B8. The predicate
    evaluates inside the kernel on the bucket-layout planes; the probed
    blocks are read in place. On a CUDA tensor the K-probe kernel launches;
    on a CPU tensor its plain version runs."""

    out = kernels.probe_scores(
        queries.to(buckets.dtype).contiguous(), buckets, bucket_ids, users_b, docs_b, live_b,
        probes.to(torch.int32).contiguous(), uids, dids,
    )
    if buckets.device.type == "cuda":
        kernels.count_launch("B8")
    return out


def pallas_probe_scores_q(
    queries_q: torch.Tensor,  # (q, d) quantized query VALUES (integers in [-127, 127])
    buckets: torch.Tensor,  # (C, B, d) int8
    scales_b: torch.Tensor,  # (C, 1, B) f32 per-slot dequant scales
    bucket_ids: torch.Tensor,
    users_b: torch.Tensor,
    docs_b: torch.Tensor,
    live_b: torch.Tensor,
    probes: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked probe over quantized buckets (B9): the exact integer dot times
    the slot's scale (the caller applies the per-query scale), -inf where
    masked, + row ids."""

    out = kernels.probe_scores_q(
        queries_q.to(torch.int8).contiguous(), buckets, scales_b, bucket_ids, users_b, docs_b,
        live_b, probes.to(torch.int32).contiguous(), uids, dids,
    )
    if buckets.device.type == "cuda":
        kernels.count_launch("B9")
    return out


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _probe_clusters(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int):
    cscores = queries.float() @ centroids.T
    top = torch.topk(cscores, nprobe, dim=-1)
    return top.values, top.indices.to(torch.int32)


def _ivf_probe(
    queries: torch.Tensor,  # (q, d) f32 normalized
    centroids: torch.Tensor,
    buckets: torch.Tensor,
    bucket_ids: torch.Tensor,  # (C, 1, B)
    row_mask: torch.Tensor,  # (n,) or (q, n) bool over GLOBAL row ids
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic-mask probe (plain torch; arbitrary row masks)."""

    qn, d = queries.shape
    _, probes = _probe_clusters(queries, centroids, nprobe)
    pl = probes.long()
    sub = buckets[pl].reshape(qn, -1, d)  # (q, nprobe*B, d) gather
    ids = bucket_ids[pl].reshape(qn, -1)
    scores = torch.bmm(sub.float(), queries.to(buckets.dtype).float()[:, :, None])[:, :, 0]
    mask2d = row_mask if row_mask.ndim == 2 else row_mask[None].expand(qn, -1)
    valid = (ids >= 0) & torch.gather(mask2d, 1, ids.clamp(min=0).long())
    scores = torch.where(valid, scores, NEG_INF)
    top = torch.topk(scores, k, dim=-1)
    return top.values, torch.gather(ids, 1, top.indices)


def _ivf_probe_pred(
    queries: torch.Tensor,  # (q, d) f32 normalized
    centroids: torch.Tensor,
    buckets: torch.Tensor,
    bucket_ids: torch.Tensor,  # (C, 1, B)
    users_b: torch.Tensor,
    docs_b: torch.Tensor,
    live_b: torch.Tensor,
    uids: torch.Tensor,  # (q,) int32
    dids: torch.Tensor,  # (q,) int32, -1 = no document filter
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tenant/doc/live-predicated probe through B8; masking happens in bucket
    layout, so no (n,)-indexed gather exists anywhere."""

    qn = queries.shape[0]
    _, probes = _probe_clusters(queries, centroids, nprobe)
    s3, i3 = pallas_probe_scores(queries, buckets, bucket_ids, users_b, docs_b, live_b,
                                 probes, uids, dids)
    top = torch.topk(s3.reshape(qn, -1), k, dim=-1)
    return top.values, torch.gather(i3.reshape(qn, -1), 1, top.indices)


def _ivf_probe_pred_q(
    queries: torch.Tensor,  # (q, d) f32 normalized
    centroids: torch.Tensor,
    buckets: torch.Tensor,  # (C, B, d) int8
    scales_b: torch.Tensor,  # (C, 1, B) f32
    bucket_ids: torch.Tensor,
    users_b: torch.Tensor,
    docs_b: torch.Tensor,
    live_b: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicated probe over QUANTIZED buckets (B9). Queries quantize as the
    dense int8 path does (:func:`mmrag_tpu_torch.ops.topk.cosine_topk_int8`),
    so probe, spill and append-tail scores merge on one scale."""

    qn = queries.shape[0]
    _, probes = _probe_clusters(queries, centroids, nprobe)
    qq, qscale = quantize_rows_int8(queries)
    s3, i3 = pallas_probe_scores_q(qq, buckets, scales_b, bucket_ids, users_b, docs_b,
                                   live_b, probes, uids, dids)
    scores = s3.reshape(qn, -1) * qscale[:, None]
    top = torch.topk(scores, k, dim=-1)
    return top.values, torch.gather(i3.reshape(qn, -1), 1, top.indices)


def _ivf_probe_pred_adc(
    queries: torch.Tensor,  # (q, d) f32 normalized (probe selection only)
    tables: torch.Tensor,  # (m, q, K) bf16 per-query ADC tables
    centroids: torch.Tensor,
    buckets: torch.Tensor,  # (C, B, m) int8 ADC codes
    bucket_ids: torch.Tensor,
    users_b: torch.Tensor,
    docs_b: torch.Tensor,
    live_b: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
    k: int,
    nprobe: int,
    residual: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicated probe over PQ-CODED buckets (the literal IVF_PQ): the
    probed blocks' codes are fetched block by block (lane-major for the
    kernel) and scored by the ADC rescore kernel B11 against the layout's
    own codebook tables. With ``residual`` the codes encode
    ``x - centroid`` and the probed centroids' query dots (already computed
    for probe selection) are added back."""

    from .pq import adc_rescore_scores

    q, B, m = queries.shape[0], buckets.shape[1], buckets.shape[2]
    cvals, probes = _probe_clusters(queries, centroids, nprobe)
    flat = probes.reshape(-1).long()
    S = nprobe * B
    cand = buckets[flat].reshape(q, S, m).transpose(1, 2).contiguous()  # (q, m, S)
    ids = bucket_ids[flat].reshape(q, S)
    valid = predicate_mask(users_b[flat].reshape(q, S), docs_b[flat].reshape(q, S),
                           live_b[flat].reshape(q, S), uids[:, None], dids[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=queries.device)
    bias = torch.where(valid, zero, NEG_INF)
    scores = adc_rescore_scores(tables, cand, bias)
    if residual:
        scores = scores + cvals[:, :, None].expand(q, nprobe, B).reshape(q, S)
    top = torch.topk(scores, min(k, S), dim=-1)
    return _pad_k(top.values, torch.gather(ids, 1, top.indices), k)


def _spill_top(scores, spill_ids, k: int):
    top = torch.topk(scores, min(k, scores.shape[1]), dim=-1)
    return top.values, spill_ids[top.indices.reshape(-1)].reshape(top.indices.shape)


def _spill_scores_pred_adc(
    tables: torch.Tensor,  # (m, q, K) bf16
    spill: torch.Tensor,  # (S, m) int8 codes
    spill_ids: torch.Tensor,
    spill_users: torch.Tensor,
    spill_docs: torch.Tensor,
    spill_live: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
    k: int,
    queries: Optional[torch.Tensor] = None,  # residual layout: (q, d) f32
    centroids: Optional[torch.Tensor] = None,  # residual layout: (C, d) f32
    spill_assign: Optional[torch.Tensor] = None,  # residual layout: (S,) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scores of the spill (B11 in its shared form: ONE lane-major copy
    of the spill codes, leading dim 1, read by every query's blocks)."""

    from .pq import adc_rescore_scores

    valid = predicate_mask_multi(spill_users, spill_docs, spill_live, uids, dids)
    zero = torch.zeros((), dtype=torch.float32, device=spill.device)
    bias = torch.where(valid, zero, NEG_INF)  # (q, S)
    scores = adc_rescore_scores(tables, spill.T.contiguous()[None], bias)
    if spill_assign is not None:  # residual layout: add back q . centroid[assign]
        cs = queries.float() @ centroids.T
        scores = scores + cs[:, spill_assign.long()]
    return _spill_top(scores, spill_ids, k)


def _spill_scores_pred_q(
    queries: torch.Tensor,  # (q, d) f32
    spill: torch.Tensor,  # (S, d) int8
    spill_scales: torch.Tensor,  # (S,) f32
    spill_ids: torch.Tensor,
    spill_users: torch.Tensor,
    spill_docs: torch.Tensor,
    spill_live: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    qq, qscale = quantize_rows_int8(queries)
    raw = qq.float() @ spill.float().T  # integer sums < 2**24: exact
    scores = raw * qscale[:, None] * spill_scales[None, :]
    valid = predicate_mask_multi(spill_users, spill_docs, spill_live, uids, dids)
    return _spill_top(torch.where(valid, scores, NEG_INF), spill_ids, k)


def _spill_scores(
    queries: torch.Tensor,
    spill: torch.Tensor,
    spill_ids: torch.Tensor,
    row_mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    qn = queries.shape[0]
    scores = queries.to(spill.dtype).float() @ spill.float().T
    mask2d = row_mask if row_mask.ndim == 2 else row_mask[None].expand(qn, -1)
    ids = spill_ids.clamp(min=0).long()[None].expand(qn, -1)
    valid = (spill_ids >= 0)[None, :] & torch.gather(mask2d, 1, ids)
    return _spill_top(torch.where(valid, scores, NEG_INF), spill_ids, k)


def _spill_scores_pred(
    queries: torch.Tensor,
    spill: torch.Tensor,
    spill_ids: torch.Tensor,
    spill_users: torch.Tensor,
    spill_docs: torch.Tensor,
    spill_live: torch.Tensor,
    uids: torch.Tensor,
    dids: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = queries.to(spill.dtype).float() @ spill.float().T
    valid = predicate_mask_multi(spill_users, spill_docs, spill_live, uids, dids)
    return _spill_top(torch.where(valid, scores, NEG_INF), spill_ids, k)


def ivf_search(
    ivf: IVFData,
    queries: torch.Tensor,  # (q, d) f32, L2-normalized
    row_mask: torch.Tensor,  # (n,) or (q, n) bool over global row ids
    k: int,
    nprobe: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k with an arbitrary row mask (plain torch; the store
    serves :func:`ivf_search_pred`)."""

    if ivf.is_pq:
        raise ValueError(
            "pq-coded layouts score via ivf_search_pred (ADC), not the dense row path"
        )
    nprobe = min(nprobe, ivf.n_clusters)
    k_eff = min(k, nprobe * ivf.bucket_size)
    s, i = _ivf_probe(queries, ivf.centroids, ivf.buckets, ivf.bucket_ids, row_mask, k_eff,
                      nprobe)
    s, i = _pad_k(s, i, k)
    if ivf.spill.shape[0]:
        s2, i2 = _spill_scores(queries, ivf.spill, ivf.spill_ids, row_mask, k)
        s, i = merge_topk(s, i, s2, i2, k)
    return s, i


def ivf_search_pred(
    ivf: IVFData,
    queries: torch.Tensor,  # (q, d) f32, L2-normalized
    uids: torch.Tensor,  # (q,) int32 tenant per query
    dids: torch.Tensor,  # (q,) int32 doc filter per query (-1 = none)
    k: int,
    nprobe: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicated top-k: tenant/doc/live masks evaluate in bucket layout
    (inside the probe kernel) — the production search path."""

    queries = queries.float()
    uids = uids.to(torch.int32).contiguous()
    dids = dids.to(torch.int32).contiguous()
    nprobe = min(nprobe, ivf.n_clusters)
    k_eff = min(k, nprobe * ivf.bucket_size)
    if ivf.is_pq:  # PQ-coded layout: ADC scoring against the layout's books
        from .pq import _adc_tables

        tables = _adc_tables(queries, ivf.pq_codebooks).permute(0, 2, 1).to(
            torch.bfloat16).contiguous()  # (m, q, K)
        s, i = _ivf_probe_pred_adc(
            queries, tables, ivf.centroids, ivf.buckets, ivf.bucket_ids,
            ivf.users_b, ivf.docs_b, ivf.live_b, uids, dids, k_eff, nprobe,
            residual=ivf.pq_residual,
        )
        s, i = _pad_k(s, i, k)
        if ivf.spill.shape[0]:
            residual_args = (
                dict(queries=queries, centroids=ivf.centroids, spill_assign=ivf.spill_assign)
                if ivf.pq_residual else {}
            )
            s2, i2 = _spill_scores_pred_adc(
                tables, ivf.spill, ivf.spill_ids, ivf.spill_users, ivf.spill_docs,
                ivf.spill_live, uids, dids, k, **residual_args,
            )
            s, i = merge_topk(s, i, s2, i2, k)
        return s, i
    if ivf.scales_b is not None:  # quantized layout (ivf + int8)
        s, i = _ivf_probe_pred_q(
            queries, ivf.centroids, ivf.buckets, ivf.scales_b, ivf.bucket_ids,
            ivf.users_b, ivf.docs_b, ivf.live_b, uids, dids, k_eff, nprobe,
        )
    else:
        s, i = _ivf_probe_pred(
            queries, ivf.centroids, ivf.buckets, ivf.bucket_ids,
            ivf.users_b, ivf.docs_b, ivf.live_b, uids, dids, k_eff, nprobe,
        )
    s, i = _pad_k(s, i, k)
    if ivf.spill.shape[0]:
        if ivf.scales_b is not None:
            s2, i2 = _spill_scores_pred_q(
                queries, ivf.spill, ivf.spill_scales, ivf.spill_ids,
                ivf.spill_users, ivf.spill_docs, ivf.spill_live, uids, dids, k,
            )
        else:
            s2, i2 = _spill_scores_pred(
                queries, ivf.spill, ivf.spill_ids, ivf.spill_users,
                ivf.spill_docs, ivf.spill_live, uids, dids, k,
            )
        s, i = merge_topk(s, i, s2, i2, k)
    return s, i
