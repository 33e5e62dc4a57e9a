"""Corpus-sharded top-k retrieval over a device mesh (X7).

Port of ``mmrag_tpu/parallel/sharded_index.py``. Corpus rows are sharded
over the mesh's ``data`` axis; each shard runs the single-device search of
its layout on its own device (:func:`~mmrag_tpu_torch.ops.topk.cosine_topk`,
B4; :func:`~mmrag_tpu_torch.ops.topk.cosine_topk_int8`;
:func:`~mmrag_tpu_torch.ops.pq.pq_topk`, B10 + B11), so the kernels launch
once per shard, and the per-shard candidate lists merge on the mesh's first
device: the JAX package's ``all_gather`` + ``lax.top_k`` becomes a
shard-major concatenation ``(q, n_shards * k_local)`` and
:func:`~mmrag_tpu_torch.ops.topk.topk_first`, so exact ties across shards
keep ``lax.top_k``'s order (the lower shard, then the lower local rank,
first). Only ``O(shards * q * k)`` values move, never the corpus.

Row indices returned are GLOBAL (each shard's offset added on its device).

Across processes (:func:`sharded_topk_fn` given a ``torch.distributed``
process ``group``, each process holding its own rows on its own mesh, as
``tests/dcn_worker.py`` runs JAX's global mesh; without a group the search
is this process's alone, whatever group is initialised): each process
merges its shards, offsets its ids by ``rank * rows_per_process``, and the
processes all-gather their ``(q, k)`` scores and ids in rank order, which
is global shard-major order; one more
:func:`~mmrag_tpu_torch.ops.topk.topk_first` gives the flat merge's result
and its tie order. Over ``nccl`` the gather runs on the device; over
``gloo`` on host copies of the ``(q, k)`` slices. Two processes on one card
take ``gloo`` (NCCL refuses two ranks on one device), so only the merge's
``q * k * 8`` bytes a process cross the host; the search stays on the card.
``merge_slices_host`` is not this merge: its native merge puts the smaller
id first on a tie, where the shard-major merge keeps ``lax.top_k``'s order.
Arguments called *sharded* below are sequences of per-shard tensors, shard
``s`` on ``mesh.devices[s]`` (:func:`~mmrag_tpu_torch.parallel.mesh.row_sharded`,
:class:`~mmrag_tpu_torch.parallel.mesh.ShardedRows.shards`); replicated
arguments are single tensors, copied once to each distinct device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.topk import (
    cosine_topk,
    cosine_topk_int8,
    pad_topk,
    predicate_mask_multi,
    topk_first,
)
from .mesh import Mesh, on_device, row_sharded


def _merged_topk_fn(mesh: Mesh, k: int, local_score: Callable, n_shard_args: int,
                    n_repl_args: int = 1):
    """The search every layout shares: ``local_score(*repl_args,
    *shard_args) -> (scores, idx)`` runs per shard (the first replicated
    argument is the query batch), then the global offset, the gather onto
    the first device and the k-merge. The local k is clamped to the shard
    row count and the merged output padded back to ``k``."""

    def run(*args):
        if len(args) != n_repl_args + n_shard_args:
            raise TypeError(f"expected {n_repl_args} replicated + {n_shard_args} sharded "
                            f"arguments, got {len(args)}")
        repl, sharded = args[:n_repl_args], args[n_repl_args:]
        for a in sharded:
            if len(a) != mesh.n_data:
                raise ValueError(f"{len(a)} shards for a data axis of {mesh.n_data}")
        head = mesh.devices[0]
        copies = {}
        scores, idx = [], []
        for s, dev in enumerate(mesh.devices):
            if dev not in copies:
                copies[dev] = [a.to(dev) for a in repl]
            shard = [a[s] for a in sharded]
            shard_rows = shard[0].shape[0]
            with on_device(dev):
                sc, ix = local_score(*copies[dev], *shard)
            scores.append(sc.to(head))
            idx.append((ix + s * shard_rows).to(head))
        merged_s = torch.cat(scores, dim=1)  # (q, n_shards * k_local), shard-major
        merged_i = torch.cat(idx, dim=1)
        top = topk_first(merged_s, min(k, merged_s.shape[1]))
        return pad_topk(top.values, torch.gather(merged_i, 1, top.indices), k)

    return run


def sharded_search_fn(mesh: Mesh, k: int, backend: str = "auto"):
    """The engine's sharded search (``VectorIndex`` sharded mode):
    ``fn(queries, uids, dids, slab, users, docs, live)`` with the slab and
    its predicate columns sharded and the queries and per-query tenant /
    document ids replicated. The tenant/document predicate is evaluated per
    shard (:func:`predicate_mask_multi`, the single-device rule), then the
    shard's ``cosine_topk`` of ``backend`` scores it (B4, or X1's top-k form
    and its merge under ``approx``); the exact merge follows either way."""

    def local_score(queries, uids, dids, slab, users, docs, live):
        mask = predicate_mask_multi(users, docs, live, uids, dids)
        return cosine_topk(queries, slab, mask, min(k, slab.shape[0]), backend)

    return _merged_topk_fn(mesh, k, local_score, n_shard_args=4, n_repl_args=3)


def sharded_search_int8_fn(mesh: Mesh, k: int):
    """int8 storage: ``fn(queries, uids, dids, slab_q, scales, users, docs,
    live)``; each shard runs the exact integer scoring of its rows."""

    def local_score(queries, uids, dids, slab_q, scales, users, docs, live):
        mask = predicate_mask_multi(users, docs, live, uids, dids)
        return cosine_topk_int8(queries, slab_q, scales, mask, min(k, slab_q.shape[0]))

    return _merged_topk_fn(mesh, k, local_score, n_shard_args=5, n_repl_args=3)


def sharded_search_pq_fn(mesh: Mesh, k: int):
    """Product-quantized storage: ``fn(queries, uids, dids, codebooks,
    codes, users, docs, live)`` with the m-byte code slab sharded and the
    (small) codebooks replicated. Each shard builds its ADC tables and runs
    B10 + B11 over its codes; the caller's exact host refine rescores the
    merged shortlist, as in the single-device pq mode."""

    from ..ops.pq import pq_topk

    def local_score(queries, uids, dids, codebooks, codes, users, docs, live):
        mask = predicate_mask_multi(users, docs, live, uids, dids)
        return pq_topk(queries, codebooks, codes, mask, min(k, codes.shape[0]))

    return _merged_topk_fn(mesh, k, local_score, n_shard_args=4, n_repl_args=4)


def sharded_topk_fn(mesh: Mesh, k: int, backend: str = "auto", group=None):
    """``fn(queries, corpus, mask) -> (scores, global_idx)`` with ``corpus``
    and its ``(n,)`` mask sharded over ``mesh``.

    ``group`` (a ``torch.distributed`` process group, e.g.
    ``torch.distributed.group.WORLD``) makes the search span its processes:
    ``mesh`` is this process's and its shards are this process's rows, every
    process holds the same number, ``rows_per_process``, process ``rank`` of
    the group holds global rows ``[rank * rows_per_process, (rank + 1) *
    rows_per_process)``, and every process of the group must make the same
    call; each returns the global top-k with global ids (the module
    docstring has the merge). With ``group=None`` the search is this
    process's rows alone, with ids local to them."""

    def local_score(queries, corpus_shard, mask_shard):
        return cosine_topk(queries, corpus_shard, mask_shard, k, backend)

    local = _merged_topk_fn(mesh, k, local_score, n_shard_args=2)
    if group is None:
        return local

    def run(queries, corpus, mask):
        scores, idx = local(queries, corpus, mask)
        rows = sum(int(c.shape[0]) for c in corpus)
        # the -1 fillers of a process with fewer than k rows stay -1
        idx = torch.where(idx >= 0, idx + torch.distributed.get_rank(group) * rows, idx)
        return _merge_processes(scores, idx, k, group)

    return run


def _merge_processes(scores: torch.Tensor, idx: torch.Tensor, k: int, group):
    """All-gather every process's ``(q, k')`` scores and global ids over
    ``group`` in rank order and take their top ``k`` (exact ties: the lower
    rank first, then the earlier place in its list, as one shard-major
    merge)."""

    dist = torch.distributed
    world = dist.get_world_size(group)
    head = scores.device
    on_host = dist.get_backend(group) == "gloo"  # gloo gathers host tensors
    parts = (scores, idx.to(torch.int64))
    if on_host:
        parts = tuple(t.cpu() for t in parts)
    gathered = []
    for t in parts:
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t.contiguous(), group=group)
        gathered.append(torch.cat(out, dim=1).to(head))
    merged_s, merged_i = gathered
    top = topk_first(merged_s, min(k, merged_s.shape[1]))
    return pad_topk(top.values, torch.gather(merged_i, 1, top.indices).to(idx.dtype), k)


def _check_rows(n: int, mesh: Mesh) -> int:
    if n % mesh.n_data:
        raise ValueError(f"corpus rows {n} not divisible by data axis {mesh.n_data}")
    return n // mesh.n_data


def sharded_topk(queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor, k: int,
                 mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-shard ``corpus`` and its ``(n,)`` ``mask`` over the mesh and
    search. The rows must divide evenly over the data axis (pad with
    ``mask=False`` rows; ragged rows raise)."""

    shard_rows = _check_rows(corpus.shape[0], mesh)
    fn = sharded_topk_fn(mesh, min(k, shard_rows))
    scores, idx = fn(queries, row_sharded(mesh, corpus), row_sharded(mesh, mask))
    return pad_topk(scores, idx, k)


def sharded_topk_int8(queries: torch.Tensor, corpus_q: torch.Tensor,
                      corpus_scale: torch.Tensor, mask: torch.Tensor, k: int,
                      mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-sharded top-k over int8 rows ``(n, d)`` and their ``(n,)``
    f32 scales: each shard runs the exact integer scoring, the merge is the
    shared one."""

    k_eff = min(k, _check_rows(corpus_q.shape[0], mesh))

    def local_score(queries, shard_q, shard_scale, shard_mask):
        return cosine_topk_int8(queries, shard_q, shard_scale, shard_mask, k_eff)

    fn = _merged_topk_fn(mesh, k_eff, local_score, n_shard_args=3)
    scores, idx = fn(queries, row_sharded(mesh, corpus_q), row_sharded(mesh, corpus_scale),
                     row_sharded(mesh, mask))
    return pad_topk(scores, idx, k)


def merge_slices_host(slice_scores, slice_ids, k: int):
    """Merge per-slice top-k results on the host: ``(slices, q, k)`` f32
    scores and int64 global ids -> ``(scores (q, k), ids (q, k))``, through
    the native C++ merge (:func:`mmrag_tpu_torch.native.merge_topk`):
    descending score, ties to the smaller id."""

    from .. import native

    return native.merge_topk(np.asarray(slice_scores, dtype=np.float32),
                             np.asarray(slice_ids, dtype=np.int64), k)

