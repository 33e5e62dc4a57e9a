"""Partitioned (IVF / IVF_PQ) ANN composed with corpus row sharding.

Port of ``mmrag_tpu/parallel/sharded_ivf.py``: the shape "shared global
centroids, probe locally, merge candidates".

  * ONE set of global centroids is trained on the evenly spaced sample of
    the whole corpus that the single-device build uses, so centroids and
    assignments match the single-device layout bit for bit on the same rows.
  * Each shard lays out ITS OWN rows (the contiguous global row range its
    slab block holds) into a local ``(C, B_s, d)`` bucket tensor on its
    device, with ``B_s`` sized from the largest shard, so a shard's probe
    costs about ``1 / n_shards`` of the single-device one. Overflow rows
    spill per shard and are scored exactly; every shard's spill is padded to
    one length, as the JAX package stacks them.
  * Bucket and spill row ids are GLOBAL, so the merged output needs no
    offset arithmetic and fillers stay ``-1``.
  * A search runs the single-device predicated search
    (:func:`mmrag_tpu_torch.ops.ivf.ivf_search_pred`: the probe B8 for
    bf16/f32 rows, B9 for int8 rows, B11 for PQ codes, then the exact
    spill) per shard on its device, and the per-shard top-k lists merge on
    the mesh's first device in shard-major order (:func:`topk_first`).

Each shard's layout is an :class:`~mmrag_tpu_torch.ops.ivf.IVFData` of its
own; :class:`ShardedIVFData` holds them with the global slot map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import ivf as ivf_ops
from ..ops.topk import pad_topk, topk_first
from .mesh import Mesh, on_device


@dataclass
class ShardedIVFData:
    """Per-shard IVF layouts (``shards[s]`` on ``mesh.devices[s]``, global
    row ids) with :class:`~mmrag_tpu_torch.ops.ivf.IVFData`'s attribute
    contract for the owning index: ``centroids``, ``built_rows``,
    ``structure``, ``is_pq``, ``pq_residual``, ``n_clusters``,
    ``bucket_size`` and :meth:`mark_dead`."""

    mesh: Mesh
    centroids: torch.Tensor  # (C, d) f32 on the first device
    shards: List[ivf_ops.IVFData]
    slot_of_row: np.ndarray  # host (built_rows, 3): (shard, cluster, slot); cluster -1 = spill
    built_rows: int
    structure: float = 0.0
    pq_residual: bool = False
    pq_codebooks: Optional[torch.Tensor] = None  # (m, K, ds) f32

    @property
    def is_pq(self) -> bool:
        return self.pq_codebooks is not None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def bucket_size(self) -> int:
        return self.shards[0].bucket_size

    @property
    def spill_size(self) -> int:
        return int(self.shards[0].spill.shape[0])

    @property
    def scales_b(self) -> Optional[torch.Tensor]:
        return self.shards[0].scales_b

    def mark_dead(self, rows: np.ndarray) -> None:
        """Tombstone clustered/spilled rows in their shards' liveness planes."""

        rows = np.asarray(rows)
        rows = rows[rows < self.built_rows]
        if rows.size == 0:
            return
        slots = self.slot_of_row[rows]
        for s in np.unique(slots[:, 0]):
            mine = slots[slots[:, 0] == s]
            shard = self.shards[int(s)]
            dev = shard.live_b.device
            bucketed = mine[mine[:, 1] >= 0]
            spilled = mine[mine[:, 1] < 0]
            if bucketed.size:
                shard.live_b[ivf_ops._as_index(bucketed[:, 1], dev), 0,
                             ivf_ops._as_index(bucketed[:, 2], dev)] = 0
            if spilled.size:
                shard.spill_live[ivf_ops._as_index(spilled[:, 2], dev)] = 0


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _assign_scores(rows: torch.Tensor, centroids: torch.Tensor,
                   scales: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, float]:
    """One shard's assignment against the replicated centroids, on the
    shard's device: the f32-result product and argmax in chunks, and the
    SUM of the best scores (times the row scales for int8 rows) for the
    structure statistic."""

    if scales is not None:  # int8: the argmax is scale-invariant
        assign, mean = ivf_ops._assign_int8(rows, centroids, scales)
    else:
        assign, mean = ivf_ops._assign_with_structure(rows, centroids)
    return assign, mean * rows.shape[0]


def _shard_slot_bookkeeping(
    assign_h: np.ndarray,  # (snap_size,) global assignment
    n_shards: int,
    shard_rows: int,
    n_clusters: int,
    bucket: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host bookkeeping, one single-device pass per shard range (a stable
    sort by cluster keeps insertion order within a bucket).

    Returns ``(ids_local (n_shards, C, B), ids_global, spill_local
    (n_shards, S), spill_global, slot_of_row (n, 3))`` where *local* ids
    index into the shard's slab block and *global* into the flat corpus."""

    snap = assign_h.shape[0]
    per_shard = []
    spills = []
    slot_of_row = np.full((snap, 3), -1, np.int32)
    for s in range(n_shards):
        lo = s * shard_rows
        hi = min(lo + shard_rows, snap)
        ids = np.full((n_clusters, bucket), -1, np.int32)
        if hi > lo:
            a = assign_h[lo:hi]
            n = hi - lo
            order = np.argsort(a, kind="stable").astype(np.int32)
            sorted_a = a[order]
            starts = np.searchsorted(sorted_a, np.arange(n_clusters))
            pos = np.arange(n) - starts[sorted_a]
            fits = pos < bucket
            ids[sorted_a[fits], pos[fits]] = order[fits]
            spill_local = order[~fits]
            slot_of_row[lo + order[fits], 0] = s
            slot_of_row[lo + order[fits], 1] = sorted_a[fits]
            slot_of_row[lo + order[fits], 2] = pos[fits]
            slot_of_row[lo + spill_local, 0] = s
            slot_of_row[lo + spill_local, 2] = np.arange(len(spill_local), dtype=np.int32)
        else:
            spill_local = np.zeros((0,), np.int32)
        per_shard.append(ids)
        spills.append(spill_local)

    s_max = max((len(sp) for sp in spills), default=0)
    pad_spill = max(8, (s_max + 7) // 8 * 8) if s_max else 0
    spill_l = np.full((n_shards, pad_spill), -1, np.int32)
    for s, sp in enumerate(spills):
        spill_l[s, : len(sp)] = sp
    ids_local = np.stack(per_shard)
    offs = (np.arange(n_shards, dtype=np.int32) * shard_rows)[:, None, None]
    ids_global = np.where(ids_local >= 0, ids_local + offs, -1)
    spill_global = np.where(spill_l >= 0, spill_l + offs[:, :, 0], -1)
    return ids_local, ids_global, spill_l, spill_global, slot_of_row


def _gather_shard(slab, users, docs, live, scales, assign, ids_local, ids_global,
                  spill_local, spill_global, centroids, books, structure, residual,
                  built_rows) -> ivf_ops.IVFData:
    """One shard's bucket layout on its device: the slot map's rows of the
    shard's slab block and predicate columns (empty slots zero / -1 / dead)."""

    dev = slab.device
    C, B = ids_local.shape
    d = slab.shape[1]
    shard_rows = slab.shape[0]
    ids = torch.from_numpy(ids_local).to(dev)
    clipped = ids.clamp(0, shard_rows - 1).long()
    in_slot = ids >= 0

    def plane(col, fill):
        return torch.where(in_slot, col[clipped], fill).to(col.dtype).reshape(C, 1, B)

    buckets = slab[clipped.reshape(-1)].reshape(C, B, d)
    buckets.masked_fill_(~in_slot[..., None], 0)
    live_i = live.to(torch.int32)
    sp = torch.from_numpy(spill_local).to(dev)
    sclip = sp.clamp(0, shard_rows - 1).long()
    s_in = sp >= 0
    spill = slab[sclip].masked_fill(~s_in[:, None], 0)
    return ivf_ops.IVFData(
        centroids=centroids.to(dev),
        buckets=buckets,
        bucket_ids=torch.from_numpy(ids_global).to(dev).reshape(C, 1, B),
        users_b=plane(users, -1),
        docs_b=plane(docs, -1),
        live_b=plane(live_i, 0),
        spill=spill,
        spill_ids=torch.from_numpy(spill_global).to(dev),
        spill_users=torch.where(s_in, users[sclip], -1).to(torch.int32),
        spill_docs=torch.where(s_in, docs[sclip], -1).to(torch.int32),
        spill_live=torch.where(s_in, live_i[sclip], 0).to(torch.int32),
        slot_of_row=np.zeros((0, 2), np.int32),  # the global map is the owner's
        built_rows=built_rows,
        scales_b=plane(scales, 1.0) if scales is not None else None,
        spill_scales=(torch.where(s_in, scales[sclip], 1.0).float()
                      if scales is not None else None),
        pq_codebooks=books.to(dev) if books is not None else None,
        structure=structure,
        pq_residual=residual,
        spill_assign=(torch.where(s_in, assign[sclip], 0).to(torch.int32)
                      if assign is not None else torch.zeros_like(sp)),
    )


def build_sharded_ivf(
    mesh: Mesh,
    slab: Sequence[torch.Tensor],  # per-shard (shard_rows, d) rows or (shard_rows, m) codes
    users: Sequence[torch.Tensor],  # per-shard (shard_rows,) int32
    docs: Sequence[torch.Tensor],
    live: Sequence[torch.Tensor],
    snap_size: int,
    n_clusters: Optional[int] = None,
    bucket_factor: float = 1.5,
    iters: int = 8,
    scales: Optional[Sequence[torch.Tensor]] = None,  # per-shard f32: the slab is int8 rows
    centroids: Optional[torch.Tensor] = None,  # warm start (no Lloyd)
    assign: Optional[np.ndarray] = None,  # (snap_size,) precomputed (pq layout)
    structure_override: Optional[float] = None,
    pq_codebooks: Optional[torch.Tensor] = None,
    pq_residual: bool = False,
) -> ShardedIVFData:
    """Build per-shard bucket layouts over a row-sharded slab: the contract
    of :func:`mmrag_tpu_torch.ops.ivf.build_ivf`, with k-means trained on the
    single-device build's evenly spaced sample, so centroids and
    assignments equal the single-device ones on the same rows; only the
    bucket capacity (per shard against global) differs, and overflow is
    scored exactly either way."""

    n_shards = mesh.n_data
    if len(slab) != n_shards:
        raise ValueError(f"{len(slab)} slab shards for a data axis of {n_shards}")
    shard_rows = int(slab[0].shape[0])
    head = mesh.devices[0]
    if pq_codebooks is not None and (assign is None or centroids is None):
        raise ValueError("pq layout needs precomputed assignment + centroids")

    def global_rows(sel: np.ndarray, cols) -> torch.Tensor:
        """Rows ``sel`` (global ids, ascending) of a sharded column, on the
        first device."""

        parts = []
        for s in range(n_shards):
            mine = sel[(sel >= s * shard_rows) & (sel < (s + 1) * shard_rows)] - s * shard_rows
            if mine.size:
                parts.append(cols[s][ivf_ops._as_index(mine, cols[s].device)].to(head))
        return torch.cat(parts)

    if assign is not None:
        centroids = torch.as_tensor(centroids, device=head).float()
        assign_h = np.asarray(assign, np.int32)
        structure = 0.0 if structure_override is None else float(structure_override)
    else:
        if centroids is None:
            if n_clusters is None:
                n_clusters = ivf_ops.default_n_clusters(snap_size)
            sel = ivf_ops._even_indices(snap_size, min(snap_size, 131072))
            sample = global_rows(sel, slab)
            if scales is not None:  # int8 rows: dequantize the sample only
                sample = sample.float() * global_rows(sel, scales)[:, None]
            centroids, _ = ivf_ops.kmeans(sample, n_clusters, iters, train_sample=0)
        else:
            centroids = torch.as_tensor(centroids, device=head).float()
        assigns, total = [], 0.0
        for s, dev in enumerate(mesh.devices):
            n_s = min(max(snap_size - s * shard_rows, 0), shard_rows)
            if not n_s:
                continue
            with on_device(dev):
                a, best_sum = _assign_scores(
                    slab[s][:n_s], centroids.to(dev),
                    scales[s][:n_s] if scales is not None else None)
            assigns.append(a.cpu().numpy())
            total += best_sum
        assign_h = np.concatenate(assigns)
        structure = total / snap_size if snap_size else 0.0
    n_clusters = int(centroids.shape[0])

    shard_n_max = max(min((s + 1) * shard_rows, snap_size) - min(s * shard_rows, snap_size)
                      for s in range(n_shards))
    bucket = ivf_ops.bucket_size(max(shard_n_max, 1), n_clusters, bucket_factor)
    ids_local, ids_global, spill_l, spill_global, slot_of_row = _shard_slot_bookkeeping(
        assign_h, n_shards, shard_rows, n_clusters, bucket)
    assign_pad = None
    if pq_residual:
        assign_pad = np.zeros((n_shards * shard_rows,), np.int32)
        assign_pad[:snap_size] = assign_h
    books = torch.as_tensor(pq_codebooks, device=head).float() if pq_codebooks is not None \
        else None
    layouts = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            layouts.append(_gather_shard(
                slab[s], users[s], docs[s], live[s],
                scales[s] if scales is not None else None,
                (torch.from_numpy(assign_pad[s * shard_rows:(s + 1) * shard_rows]).to(dev)
                 if assign_pad is not None else None),
                ids_local[s], ids_global[s], spill_l[s], spill_global[s],
                centroids, books, float(structure), bool(pq_residual), snap_size))
    return ShardedIVFData(
        mesh=mesh, centroids=centroids, shards=layouts, slot_of_row=slot_of_row,
        built_rows=snap_size, structure=float(structure), pq_residual=bool(pq_residual),
        pq_codebooks=books,
    )


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def sharded_ivf_search_fn(mesh: Mesh, k: int, nprobe: int):
    """``fn(queries, uids, dids, *shard_layouts) -> (scores, global_idx)``:
    probe selection (the ``(q, C)`` centroid product) is recomputed on every
    shard, identical everywhere; each shard probes ITS OWN buckets and spill
    (:func:`~mmrag_tpu_torch.ops.ivf.ivf_search_pred`, the kernel of its
    layout) on its device, and the per-shard top-k lists merge on the first
    device, shard-major."""

    def run(queries, uids, dids, *layouts):
        if len(layouts) != mesh.n_data:
            raise ValueError(f"{len(layouts)} layouts for a data axis of {mesh.n_data}")
        head = mesh.devices[0]
        copies = {}
        all_s, all_i = [], []
        for layout, dev in zip(layouts, mesh.devices):
            if dev not in copies:
                copies[dev] = (queries.to(dev), uids.to(dev), dids.to(dev))
            with on_device(dev):
                s, ix = ivf_ops.ivf_search_pred(layout, *copies[dev], k, nprobe)
            all_s.append(s.to(head))
            all_i.append(ix.to(head))
        ms = torch.cat(all_s, dim=1)  # (q, n_shards * k), shard-major
        mi = torch.cat(all_i, dim=1)
        top = topk_first(ms, min(k, ms.shape[1]))
        return pad_topk(top.values, torch.gather(mi, 1, top.indices), k)

    return run


def sharded_ivf_search_args(ivf: ShardedIVFData) -> List[ivf_ops.IVFData]:
    """The per-shard layouts, in the order the search fn takes them."""

    return list(ivf.shards)


def sharded_ivf_kind(ivf: ShardedIVFData) -> str:
    if ivf.is_pq:
        return "adc"
    if ivf.scales_b is not None:
        return "int8"
    return "dense"
