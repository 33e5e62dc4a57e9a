"""Device-resident vector index: slabs + masked top-k search.

Port of ``mmrag_tpu/index/store.py`` on one device. One :class:`VectorIndex`
per modality (``text``/``image``), like the reference's two collections
(``lancedb_store.py:30-31``):

  * Embeddings live in a device slab of shape ``(capacity, dim)``; capacity
    is a power of two from 4096 and grows by copying, so the search sees a
    few fixed shapes.
  * Tenant/document predicates are exact int32 ids from host-side interning
    tables (no hash collisions -> no cross-tenant leakage) and are pushed
    into the scoring mask on the device.
  * Upsert keeps the reference's delete-then-add semantics
    (``lancedb_store.py:87-101``): existing chunk_ids are tombstoned, new
    rows appended. Rows are L2-normalized on write, so search is a dot
    product = cosine.

Four layouts (``TPU_INDEX_DTYPE`` x ``TPU_TOPK_BACKEND``), each a search path
through the port's kernels:

  * dense bf16/f32: the bucket-max top-k B4, or with ``backend="approx"``
    K-bmax's top-k form (X1, a recall contract in place of exactness);
  * dense int8: per-row int8 rows and f32 scales
    (:func:`mmrag_tpu_torch.ops.topk.cosine_topk_int8`, an exact integer dot);
  * pq: m-byte product-quantized codes on the device, the f32 originals in
    host RAM; ADC search B10 + B11, then an exact host refine;
  * ``ivf`` over any of them: a k-means partitioned layout built once the
    index holds ``ivf_min_rows`` rows, probed by B8 (bf16/f32), B9 (int8) or
    B11 (pq: the literal IVF_PQ), plus the exact spill and append tail.

Two data gates judge the data, not the kernels, as the JAX package's do: a
layout whose mean assignment cosine is below ``ivf_min_structure`` x the
structureless baseline is discarded (the dense path serves), and a pq index
whose codebooks reconstruct the rows below ``pq_min_quality`` demotes to
int8. A failing search raises; there is no retry on another path.

Persistence (the JAX package's on-disk format, so either package loads the
other's snapshots): :meth:`save` writes one npz with the row ids inside,
atomically (``os.replace``), and a ``manifest.json`` (``dim``, ``rows`` and,
with a journal, ``snapshot_seq``). The payload is the layout's own: int8
codes and scales losslessly (``embeddings_int8``, ``scales``), bf16 bits as
``uint16`` (``embeddings_bf16``; round to nearest even by the port's own
``native.f32_to_bf16``), or f32 (``embeddings``); beside it the IVF
centroids (``ivf_centroids``: the first build after a load only assigns)
and a pq index's codebooks and codes (``pq_codebooks``, ``pq_codes``: a
restart installs them instead of retraining). :meth:`load` /
:meth:`load_or_create` read it back; :meth:`compact` drops tombstoned rows.

Cross-process replication (:mod:`mmrag_tpu_torch.index.journal`): with a
journal attached (:meth:`attach_journal`), every logical mutation is
appended to the shared SQLite log and applied by seq-ordered replay, reads
catch up with peers' entries, ``save`` stamps the covered seq and compacts
the log, and a process whose cursor fell behind a compaction reloads the
snapshot. Without a journal every mutation applies in this process
directly.

Row-sharded mode (``mesh=`` a :class:`~mmrag_tpu_torch.parallel.mesh.Mesh`
with a data axis above 1, the engine's multi-device mode): the slab and its
predicate columns are :class:`~mmrag_tpu_torch.parallel.mesh.ShardedRows`,
capacity rounds up to a multiple of the data axis, and every search runs its
layout's kernels once per shard and merges on the first device
(:mod:`mmrag_tpu_torch.parallel.sharded_index`; the ivf layouts per shard,
:mod:`mmrag_tpu_torch.parallel.sharded_ivf`). The append tail of an ivf
layout is scanned on the first device. A failing search raises here too:
the JAX package's runtime retries on another search path are not ported.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device, storage_dtype, synchronize, topk_backend
from ..ops.topk import (
    cosine_topk,
    cosine_topk_int8,
    merge_topk,
    predicate_mask,
    predicate_mask_multi,
    quantize_rows_int8,
)
from ..storage.records import VectorRow
from ..utils.profiling import metrics, stage

_MIN_CAPACITY = 4096
_QUERY_BUCKETS = (1, 2, 4, 8, 16, 32)
_UNSEEN_DOC = np.iinfo(np.int32).max  # a doc the index never saw: matches nothing
_NO_TENANT = -2  # pad rows and unknown tenants: matches nothing
_logger = logging.getLogger(__name__)

# In-flight background ivf-build threads, joined at exit (and by
# ``RagEngine.close``) so no build is cut inside a device call.
_ivf_builds: "set[threading.Thread]" = set()
_ivf_builds_lock = threading.Lock()


def _join_ivf_builds(timeout: float = 120.0) -> None:
    with _ivf_builds_lock:
        pending = list(_ivf_builds)
    for t in pending:
        t.join(timeout)
        if t.is_alive():
            _logger.warning("ivf build %s still running at exit", t.name)


atexit.register(_join_ivf_builds)


def _query_bucket(q: int) -> int:
    """Round a coalesced query count up to a bucket so any micro-batch size
    hits one of a few search shapes."""

    for b in _QUERY_BUCKETS:
        if q <= b:
            return b
    return -(-q // _QUERY_BUCKETS[-1]) * _QUERY_BUCKETS[-1]


def _pad_queries(queries: torch.Tensor) -> torch.Tensor:
    """Zero-pad the query batch to its bucket; pad rows are sliced off after
    the search (and in the multi-tenant path carry the never-matching tenant
    sentinel, so they cannot surface hits)."""

    q = queries.shape[0]
    b = _query_bucket(q)
    if b == q:
        return queries
    return torch.nn.functional.pad(queries, (0, 0, 0, b - q))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VectorIndex:
    """A growable device-resident embedding index for one modality."""

    _PQ_TRAIN_SAMPLE = 65536

    def __init__(self, dim: int, dtype: str = "bfloat16", device: DeviceLike = None,
                 backend: str = "auto",
                 ivf_nprobe: Optional[int] = None,
                 ivf_min_rows: Optional[int] = None,
                 ivf_min_structure: Optional[float] = None,
                 pq_m: Optional[int] = None,
                 pq_refine: Optional[int] = None,
                 pq_residual: Optional[bool] = None,
                 pq_min_quality: Optional[float] = None,
                 mesh=None) -> None:
        self.dim = dim
        self.name = "index"  # its spans' ``index``: the collection, once loaded as one
        # row-sharded mode: a mesh whose data axis is above 1; the first
        # device of the mesh holds the merged results
        self.mesh = mesh
        # mesh.devices raises for a mesh with a model axis (training's)
        self._n_data = len(mesh.devices) if mesh is not None else 1
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.devices[0])
        if self._n_data > 1 and self.device != resolve_device(mesh.devices[0]):
            raise ValueError(f"device {self.device} is not the mesh's first device "
                             f"{mesh.devices[0]}")
        # "ivf": the k-means partitioned layout (ops/ivf.py), built once the
        # index is large enough; "auto": the dense (or pq) scan; "approx": the
        # dense scan's approximate form (bf16 / f32 slabs)
        self.backend = topk_backend(backend)
        self.use_ivf = self.backend == "ivf"
        # dtype "pq": the device slab holds m-byte codes, the f32 originals
        # stay in host RAM for the exact refine; ``dtype`` stays bf16, as in
        # the JAX package (its snapshot payload dtype)
        self.dtype = storage_dtype(dtype)
        self.is_pq = dtype == "pq"
        if self.backend == "approx" and (self.is_pq or self.dtype == torch.int8):
            raise ValueError(f"{dtype} index supports backend auto/ivf, not 'approx' "
                             "(the approximate path scores bf16/f32 slabs)")
        # the dense scan's cosine_topk backend (ivf's tail scan is exact)
        self._topk = "approx" if self.backend == "approx" else "auto"
        self.pq_m = 16 if pq_m is None else int(pq_m)
        self.pq_refine = 16 if pq_refine is None else int(pq_refine)
        # ivf+pq: encode bucket codes as residuals to their cluster centroid
        # (the FAISS/LanceDB IVF_PQ convention); TPU_PQ_RESIDUAL=0 opts out
        self.pq_residual = True if pq_residual is None else bool(pq_residual)
        # reconstruction-quality gate: a (re)train whose mean reconstruction
        # cosine falls below this demotes the index to int8 (0 disables)
        self.pq_min_quality = 0.8 if pq_min_quality is None else float(pq_min_quality)
        if self.is_pq and dim % self.pq_m:
            raise ValueError(f"pq index dim {dim} not divisible by pq_m={self.pq_m}")
        self._pq = None  # ops.pq.PQData once trained
        self._pq_trained_at = 0  # rows at last codebook (re)train
        self._host_slab: Optional[np.ndarray] = (
            np.zeros((0, dim), np.float32) if self.is_pq else None
        )
        self.ivf_nprobe = 64 if ivf_nprobe is None else int(ivf_nprobe)
        self.ivf_min_rows = 65536 if ivf_min_rows is None else int(ivf_min_rows)
        # clusterability gate: a layout below min_structure x the
        # structureless baseline is discarded (0 disables)
        self.ivf_min_structure = 1.5 if ivf_min_structure is None else float(ivf_min_structure)
        self._ivf = None  # ops.ivf.IVFData once built
        self._ivf_building = False  # a background (re)build is in flight
        self._ivf_error: Optional[BaseException] = None  # a failed background build
        self._ivf_poor_at = 0  # rows when structure was judged poor (backoff)
        # persisted centroids (snapshot restore): the first build after a
        # load skips Lloyd and only runs the assignment matmul
        self._ivf_warm_centroids: Optional[np.ndarray] = None
        self.ivf_build_async = True  # tests and chip_smoke.py set False
        self._generation = 0  # bumped by compact() and a reload; aborts stale installs
        self._scales: Optional[torch.Tensor] = None  # (capacity,) f32, int8 mode
        self._lock = threading.RLock()
        self._capacity = 0
        self._size = 0  # rows appended (including tombstones)
        self._slab: Optional[torch.Tensor] = None
        self._users: Optional[torch.Tensor] = None
        self._docs: Optional[torch.Tensor] = None
        self._live: Optional[torch.Tensor] = None
        # host-side row metadata, parallel to slab rows
        self._chunk_ids: List[str] = []
        self._row_user: List[str] = []
        self._row_doc: List[str] = []
        self._row_live: np.ndarray = np.zeros(0, dtype=bool)
        self._chunk_to_row: Dict[str, int] = {}
        # exact interning tables (no hash collisions)
        self._user_intern: Dict[str, int] = {}
        self._doc_intern: Dict[str, int] = {}
        # the layout's name, for a snapshot reload ("int8" after a demotion)
        self._dtype_str = "pq" if self.is_pq else str(self.dtype).split(".")[-1]
        # cross-process replication (index/journal.py): when attached, every
        # logical mutation is journaled before it is applied by seq-ordered
        # replay, so api and worker processes converge on one row state
        self._journal = None
        self._journal_collection: Optional[str] = None
        self._applied_seq = 0
        self._journal_poll_sec = 0.25
        self._last_journal_check = 0.0
        self._snapshot_dir: Optional[str] = None
        self._snapshot_name: Optional[str] = None
        self._loaded_snapshot_seq = 0

    # -- internals ----------------------------------------------------------

    @property
    def is_int8(self) -> bool:
        return self.dtype == torch.int8

    @property
    def _sharded(self) -> bool:
        return self._n_data > 1

    def _column(self, shape, fill, dtype):
        """A fresh ``(capacity, ...)`` column: row-sharded over the mesh in
        sharded mode, one tensor on the device otherwise."""

        if self._sharded:
            from ..parallel.mesh import ShardedRows

            return ShardedRows.full(self.mesh, shape, fill, dtype)
        return torch.full(shape, fill, dtype=dtype, device=self.device)

    def _intern(self, table: Dict[str, int], key: str) -> int:
        if key not in table:
            table[key] = len(table)
        return table[key]

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self._capacity:
            return
        new_cap = max(_MIN_CAPACITY, self._capacity or _MIN_CAPACITY)
        while new_cap < needed:
            new_cap *= 2
        if new_cap % self._n_data:  # a data axis that is not a power of two
            new_cap += self._n_data - new_cap % self._n_data
        if self.is_pq:  # device slab = m-byte codes; originals grow host-side
            new_slab = self._column((new_cap, self.pq_m), 0, torch.int8)
            host = np.zeros((new_cap, self.dim), np.float32)
            host[: self._size] = self._host_slab[: self._size]
            self._host_slab = host
        else:
            new_slab = self._column((new_cap, self.dim), 0, self.dtype)
        new_users = self._column((new_cap,), -1, torch.int32)
        new_docs = self._column((new_cap,), -1, torch.int32)
        new_live = self._column((new_cap,), False, torch.bool)
        new_scales = self._column((new_cap,), 1.0, torch.float32) if self.is_int8 else None
        if self._size > 0:
            n = self._size
            new_slab[:n] = self._slab[:n]
            new_users[:n] = self._users[:n]
            new_docs[:n] = self._docs[:n]
            new_live[:n] = self._live[:n]
            if new_scales is not None:
                new_scales[:n] = self._scales[:n]
        self._slab, self._users, self._docs, self._live = new_slab, new_users, new_docs, new_live
        self._scales = new_scales
        self._capacity = new_cap

    def _host_rows_f32(self) -> np.ndarray:
        """Written-prefix slab as f32 on the host (dequantized in int8 mode;
        the host-RAM originals in pq mode)."""

        if self._size == 0:
            return np.zeros((0, self.dim), np.float32)
        if self.is_pq:
            return self._host_slab[: self._size]
        rows = self._slab[: self._size].float()
        if self.is_int8:
            rows = rows * self._scales[: self._size][:, None]
        return rows.cpu().numpy()

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device)

    # -- pq mode (ops/pq.py: codes on device, originals in host RAM) ---------

    def _pq_write_codes(self, start: int, count: int) -> None:
        """Encode host rows [start, start+count) into the device code slab.

        Codebooks (re)train when the corpus has quadrupled since the last
        train (each retrain re-encodes everything). The train sample is
        taken on the host, so the f32 corpus never goes to the device whole;
        encoding streams ``ENCODE_CHUNK``-row chunks."""

        from ..ops import ivf as ivf_ops
        from ..ops import pq as pqops

        total = start + count
        if self._pq is None or total >= 4 * max(self._pq_trained_at, 1):
            sample = self._host_slab[
                ivf_ops._even_indices(total, min(total, self._PQ_TRAIN_SAMPLE))
            ]
            self._pq = pqops.PQData(pqops.train_pq(self._to_device(sample), m=self.pq_m))
            self._pq_trained_at = total
            rc = self._pq.reconstruction_cosine(self._to_device(
                self._host_slab[ivf_ops._even_indices(total, min(total, 16_384))]
            ))
            metrics.gauge("index.pq.reconstruction_cosine", rc)
            _logger.info("pq codebooks trained on %d rows (m=%d): reconstruction "
                         "cosine %.4f", total, self.pq_m, rc)
            if self.pq_min_quality and rc < self.pq_min_quality:
                # quality gate: the data resists m-byte codes; serve the
                # int8 layout instead of a collapsed ADC shortlist
                self._demote_pq_to_int8(total, rc)
                return
            start, count = 0, total  # codes are stale: re-encode everything
        for lo in range(start, start + count, pqops.ENCODE_CHUNK):
            hi = min(lo + pqops.ENCODE_CHUNK, start + count)
            self._slab[lo:hi] = self._pq.encode(self._to_device(self._host_slab[lo:hi]))

    def _demote_pq_to_int8(self, total: int, rc: float) -> None:
        """Switch a pq index to the int8 layout in place (quality-gate trip),
        re-materializing every row from the host originals in bounded chunks;
        the mode flips only after every chunk is written."""

        from ..ops import pq as pqops

        metrics.incr("index.pq.demoted")
        _logger.warning(
            "pq index demoted to int8: reconstruction cosine %.4f < gate %.2f on %d "
            "rows — this geometry resists %d-byte codes; the int8 scan serves instead "
            "(override: TPU_PQ_MIN_QUALITY)", rc, self.pq_min_quality, total, self.pq_m,
        )
        slab = self._column((self._capacity, self.dim), 0, torch.int8)
        scales = self._column((self._capacity,), 1.0, torch.float32)
        for lo in range(0, total, pqops.ENCODE_CHUNK):
            hi = min(lo + pqops.ENCODE_CHUNK, total)
            slab[lo:hi], scales[lo:hi] = quantize_rows_int8(self._to_device(self._host_slab[lo:hi]))
        self.is_pq = False
        self.dtype = torch.int8
        self._dtype_str = "int8"
        self._pq = None
        self._pq_trained_at = 0
        self._host_slab = None
        self._ivf = None  # any layout held pq codes; rebuilt lazily
        self._slab = slab
        self._scales = scales

    def _pq_multi_async(self, queries: torch.Tensor, uids: torch.Tensor, dids: torch.Tensor,
                        k: int):
        """ADC candidate search on the device (IVF_PQ probe + tail when the
        layout is built, else the flat B10 + B11 path), then an exact host
        refine at collect time: the collector gathers the shortlist's f32
        originals from host RAM and returns the true top-k. The captured host
        slab stays consistent with the captured codes: growth rebinds a fresh
        array and never mutates captured rows."""

        from ..ops import pq as pqops

        cand = min(max(k * self.pq_refine, k), self._capacity)
        ivf = self._ivf  # (re)built by _maybe_ivf at the search entrances
        if ivf is not None and ivf.is_pq:
            s, i = self._ivf_pq_dispatch(ivf, queries, uids, dids, cand)
        elif self._sharded:
            from ..parallel.sharded_index import sharded_search_pq_fn

            s, i = sharded_search_pq_fn(self.mesh, cand)(
                queries, uids, dids, self._pq.codebooks, self._slab.shards,
                self._users.shards, self._docs.shards, self._live.shards)
        else:
            mask = predicate_mask_multi(self._users, self._docs, self._live, uids, dids)
            s, i = pqops.pq_topk(queries, self._pq.codebooks, self._slab, mask, cand)
        host_rows = self._host_slab

        def collect():
            return pqops.refine_exact(_host(queries), host_rows, _host(i), _host(s),
                                      min(k, cand))

        return collect

    def _ivf_pq_dispatch(self, ivf, queries, uids, dids, cand: int):
        """Probed ADC over the coded layout (B11) + flat-ADC append tail
        (B10 + B11), merged. Bucket codes decode against the layout's own
        codebooks, the tail against the current ones; the exact host refine
        rescores the merged shortlist either way."""

        from ..ops.pq import pq_topk

        s, i = self._ivf_probe(ivf, queries, uids, dids, cand)
        built = ivf.built_rows
        appended = self._size - built
        if appended > 0:
            tail_len = min(self._pow2(max(appended, 4096)), self._capacity - built)
            end = built + tail_len
            tmask = predicate_mask_multi(self._users[built:end], self._docs[built:end],
                                         self._live[built:end], uids, dids)
            s2, i2 = pq_topk(queries, self._pq.codebooks, self._slab[built:end], tmask,
                             min(cand, tail_len))
            s, i = merge_topk(s, i, s2, i2 + built, cand)
        return s, i

    def _tombstone(self, chunk_ids: Sequence[str]) -> None:
        rows = [self._chunk_to_row[c] for c in chunk_ids if c in self._chunk_to_row]
        if not rows:
            return
        self._row_live[rows] = False
        self._live[torch.as_tensor(rows, dtype=torch.long, device=self.device)] = False
        if self._ivf is not None:  # keep the bucket-layout liveness in sync
            self._ivf.mark_dead(np.asarray(rows, dtype=np.int64))
        for c in chunk_ids:
            self._chunk_to_row.pop(c, None)

    # -- dense (full-scan) dispatch -----------------------------------------

    def _dense(self, queries: torch.Tensor, mask: torch.Tensor, k: int):
        """Masked scan of the whole slab: B4 for bf16/f32, the exact int8
        product for int8; ``mask`` is (n,) for one predicate or (q, n)."""

        kk = min(k, self._capacity)
        if self.is_int8:
            return cosine_topk_int8(queries, self._slab, self._scales, mask, kk)
        return cosine_topk(queries, self._slab, mask, kk, self._topk)

    def _dense_sharded(self, queries: torch.Tensor, uids: torch.Tensor, dids: torch.Tensor,
                       k: int):
        """The same scan per shard, the predicate evaluated per shard, the
        candidates merged on the first device (X7)."""

        from ..parallel import sharded_index as si

        kk = min(k, self._capacity)
        cols = (self._users.shards, self._docs.shards, self._live.shards)
        if self.is_int8:
            return si.sharded_search_int8_fn(self.mesh, kk)(
                queries, uids, dids, self._slab.shards, self._scales.shards, *cols)
        return si.sharded_search_fn(self.mesh, kk, self._topk)(
            queries, uids, dids, self._slab.shards, *cols)

    # -- IVF ANN ------------------------------------------------------------

    def build_ivf(self, n_clusters: Optional[int] = None,
                  bucket_factor: float = 1.5, iters: int = 8) -> None:
        """(Re)cluster the current rows into the IVF bucket layout.

        k-means and the bucket gather run outside the lock against a
        snapshot, so searches keep serving meanwhile. The written prefix of
        the slab never changes in place, except pq codes on a codebook
        retrain, so those and the liveness column (which tombstones write in
        place) are cloned under the lock; tombstones that land mid-build are
        re-applied from the host liveness array on install."""

        from ..ops import ivf as ivf_ops

        if self._sharded:
            return self._build_ivf_sharded(n_clusters, bucket_factor, iters)
        with self._lock:
            if self._size == 0 or (self.is_pq and self._pq is None):
                self._ivf = None
                return
            snap = self._size
            snap_gen = self._generation
            # residual-pq rebuilds re-encode every bucket code from the host
            # originals, so the flat code slab is not read at all
            if self.is_pq:
                slab = None if self.pq_residual else self._slab[:snap].clone()
            else:
                slab = self._slab[:snap]
            users = self._users[:snap]
            docs = self._docs[:snap]
            live = self._live[:snap].clone()
            scales = self._scales[:snap] if self.is_int8 else None
            pq_books = self._pq.codebooks if self.is_pq else None
            host_rows = self._host_slab if self.is_pq else None

        warm = self._ivf_warm_centroids
        self._ivf_warm_centroids = None  # one-shot; later rebuilds re-train
        if warm is not None:
            warm = torch.from_numpy(np.asarray(warm, np.float32)).to(self.device)
        if pq_books is not None:
            data = self._build_ivf_pq(slab, host_rows, snap, pq_books, users, docs, live,
                                      n_clusters, bucket_factor, iters, warm)
        else:
            data = ivf_ops.build_ivf(slab, n_clusters, bucket_factor, iters, users=users,
                                     docs=docs, live=live, scales=scales, centroids=warm)
        self._gate_and_install_ivf(data, snap, snap_gen)

    def _build_ivf_sharded(self, n_clusters, bucket_factor: float, iters: int) -> None:
        """The row-sharded (re)build: per-shard bucket layouts with shared
        global centroids (:func:`~mmrag_tpu_torch.parallel.sharded_ivf.
        build_sharded_ivf`), under the single-device build's snapshot rules:
        the shards' written prefixes never change in place (pq codes on a
        retrain excepted, so those are copied), liveness is copied."""

        from ..parallel.mesh import row_sharded
        from ..parallel.sharded_ivf import build_sharded_ivf

        with self._lock:
            if self._size == 0 or (self.is_pq and self._pq is None):
                self._ivf = None
                return
            snap = self._size
            snap_gen = self._generation
            cap = self._capacity
            slab = None if self.is_pq else list(self._slab.shards)
            users, docs = list(self._users.shards), list(self._docs.shards)
            live = [t.clone() for t in self._live.shards]
            scales = list(self._scales.shards) if self.is_int8 else None
            pq_books = self._pq.codebooks if self.is_pq else None
            pq_codes = (self._slab[:snap].clone()
                        if self.is_pq and not self.pq_residual else None)
            host_rows = self._host_slab if self.is_pq else None

        warm = self._ivf_warm_centroids
        self._ivf_warm_centroids = None  # one-shot; later rebuilds re-train
        if warm is not None:
            warm = torch.from_numpy(np.asarray(warm, np.float32)).to(self.device)
        if pq_books is not None:
            # cluster and residual-encode on the host originals, the
            # single-device recipe, then shard the codes for the layout
            centroids, rbooks, assign_h, res_codes, structure = self._pq_cluster_encode(
                host_rows, snap, n_clusters, iters, warm)
            codes = torch.zeros((cap, self.pq_m), dtype=torch.int8, device=self.device)
            codes[:snap] = torch.cat(res_codes) if rbooks is not None else pq_codes
            data = build_sharded_ivf(
                self.mesh, row_sharded(self.mesh, codes), users, docs, live, snap,
                bucket_factor=bucket_factor, centroids=centroids, assign=assign_h,
                structure_override=structure,
                pq_codebooks=rbooks if rbooks is not None else pq_books,
                pq_residual=rbooks is not None)
        else:
            data = build_sharded_ivf(self.mesh, slab, users, docs, live, snap,
                                     n_clusters=n_clusters, bucket_factor=bucket_factor,
                                     iters=iters, scales=scales, centroids=warm)
        self._gate_and_install_ivf(data, snap, snap_gen)

    def _gate_and_install_ivf(self, data, snap_size: int, snap_gen: int) -> None:
        """Discard structureless layouts, re-apply mid-build tombstones,
        install; a build of a corpus that compact() or a snapshot reload has
        since replaced is dropped."""

        from ..ops import ivf as ivf_ops

        baseline = ivf_ops.structureless_baseline(data.n_clusters, self.dim)
        if self.ivf_min_structure and data.structure < self.ivf_min_structure * baseline:
            with self._lock:
                if self._generation != snap_gen:
                    return  # the verdict belongs to a row set that is gone
                self._ivf = None
                self._ivf_poor_at = snap_size
            _logger.warning(
                "ivf layout discarded: mean assignment cosine %.3f < %.1fx structureless "
                "baseline %.3f — data has no cluster structure; serving the dense path",
                data.structure, self.ivf_min_structure, baseline,
            )
            return
        with self._lock:
            if self._generation != snap_gen:
                _logger.info("ivf build discarded: the index was rebuilt mid-build")
                return
            if data.is_pq != self.is_pq:  # demoted to int8 mid-build
                _logger.info("ivf build discarded: the index changed layout mid-build")
                return
            dead = np.flatnonzero(~self._row_live[:snap_size])
            if dead.size:  # tombstones that landed while building
                data.mark_dead(dead)
            self._ivf = data
            self._ivf_poor_at = 0
            _logger.info("ivf built: %d rows, %d clusters x %d bucket, structure %.3f "
                         "(baseline %.3f)", data.built_rows, data.n_clusters,
                         data.bucket_size, data.structure, baseline)

    def _build_ivf_pq(self, codes, host_rows, snap_size, books, users, docs, live,
                      n_clusters, bucket_factor, iters, warm=None):
        """Build the literal IVF_PQ layout: cluster on the f32 HOST originals
        (codes carry no clustering geometry), lay the m-byte codes out in
        buckets. With ``pq_residual`` the bucket codes re-encode
        ``x - centroid[assign]`` against codebooks trained on residuals."""

        from ..ops import ivf as ivf_ops

        centroids, rbooks, assign_h, res_codes, structure = self._pq_cluster_encode(
            host_rows, snap_size, n_clusters, iters, warm)
        if rbooks is not None:
            codes = res_codes[0] if len(res_codes) == 1 else torch.cat(res_codes)
            books = rbooks
        return ivf_ops.build_ivf(
            codes, bucket_factor=bucket_factor, users=users, docs=docs, live=live,
            centroids=centroids, assign=assign_h, structure_override=structure,
            pq_codebooks=books, pq_residual=rbooks is not None,
        )

    def _pq_cluster_encode(self, host_rows, snap_size: int, n_clusters, iters: int,
                           warm=None):
        """Centroids (the snapshot's ``warm`` ones, or k-means on an evenly
        spaced <=131k sample), residual codebooks when enabled, and the
        chunked assignment (+ residual encode) pass over the host originals:
        the f32 corpus never goes to the device whole. Returns
        ``(centroids, rbooks_or_None, assign_h, res_codes_or_None,
        structure)``."""

        from ..ops import ivf as ivf_ops
        from ..ops import pq as pqops

        sample = None
        if warm is not None:
            centroids = warm
        else:
            if n_clusters is None:
                n_clusters = ivf_ops.default_n_clusters(snap_size)
            sample = self._to_device(host_rows[
                ivf_ops._even_indices(snap_size, min(snap_size, 131072))
            ])
            centroids, _ = ivf_ops.kmeans(sample, n_clusters, iters, train_sample=0)
        rbooks = None
        if self.pq_residual:
            if sample is None:
                sample = self._to_device(host_rows[
                    ivf_ops._even_indices(snap_size, min(snap_size, self._PQ_TRAIN_SAMPLE))
                ])
            rsample = sample
            if sample.shape[0] > self._PQ_TRAIN_SAMPLE:
                rsample = sample[ivf_ops._as_index(
                    ivf_ops._even_indices(sample.shape[0], self._PQ_TRAIN_SAMPLE),
                    sample.device)]
            a_s, _ = ivf_ops._assign_with_structure(rsample, centroids)
            rbooks = pqops.train_pq(rsample - centroids[a_s.long()], m=self.pq_m)
        assigns: List[np.ndarray] = []
        res_codes: List[torch.Tensor] = []
        weighted = 0.0
        for lo in range(0, snap_size, pqops.ENCODE_CHUNK):
            hi = min(lo + pqops.ENCODE_CHUNK, snap_size)
            chunk = self._to_device(host_rows[lo:hi])
            a, st = ivf_ops._assign_with_structure(chunk, centroids)
            assigns.append(a.cpu().numpy())
            weighted += st * chunk.shape[0]
            if rbooks is not None:
                res_codes.append(pqops.pq_encode(chunk - centroids[a.long()], rbooks))
        return (centroids, rbooks, np.concatenate(assigns),
                res_codes if rbooks is not None else None, weighted / snap_size)

    def drop_ivf(self) -> None:
        with self._lock:
            self._ivf = None

    def _build_ivf_background(self) -> None:
        if self._ivf_building:
            return
        self._ivf_building = True

        def run():
            # a failure is kept for the next search, which raises it: the
            # index never goes on serving another path without a word
            try:
                self.build_ivf()
            except BaseException as exc:
                self._ivf_error = exc
            finally:
                self._ivf_building = False
                with _ivf_builds_lock:
                    _ivf_builds.discard(threading.current_thread())

        t = threading.Thread(target=run, name="ivf-build", daemon=True)
        with _ivf_builds_lock:
            _ivf_builds.add(t)
        t.start()

    def _maybe_ivf(self):
        """Return the current layout (possibly stale; the tail scan covers
        staleness) and start a (re)build when warranted: in the background
        by default, so searches never wait on k-means. A background build
        that failed raises here, once; the next search builds again."""

        if self._ivf_error is not None:
            exc, self._ivf_error = self._ivf_error, None
            raise RuntimeError("the background ivf build failed") from exc
        if not self.use_ivf:
            return self._ivf  # an explicit build_ivf() is still honored
        build = self._build_ivf_background if self.ivf_build_async else self.build_ivf
        if self._ivf is None:
            if self._ivf_poor_at and self._size < 2 * self._ivf_poor_at:
                return None  # judged structureless; retry once the corpus doubles
            if self._size >= self.ivf_min_rows:
                build()
            return self._ivf
        tail = self._size - self._ivf.built_rows
        if tail > max(self._ivf.built_rows // 2, 4096):
            build()  # tail grew past half the clustered set
        return self._ivf

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << max(n - 1, 0).bit_length()

    def _ivf_probe(self, ivf, queries, uids, dids, k: int):
        """Probe a layout, one device's (``ivf_search_pred``) or the
        per-shard ones (the sharded search), with GLOBAL row ids either way."""

        from ..ops.ivf import ivf_search_pred
        from ..parallel import sharded_ivf as sivf

        if isinstance(ivf, sivf.ShardedIVFData):
            return sivf.sharded_ivf_search_fn(self.mesh, k, self.ivf_nprobe)(
                queries, uids, dids, *sivf.sharded_ivf_search_args(ivf))
        return ivf_search_pred(ivf, queries, uids, dids, k, self.ivf_nprobe)

    def _ivf_search_inner(self, ivf, queries, uids, dids, k: int):
        """Predicated probe (B8 or B9) + exact spill, then the exactly scored
        append tail (rows written after the build: B4 for a bf16/f32 slab,
        the int8 scan for int8), merged. Returns device tensors."""

        scores, idx = self._ivf_probe(ivf, queries, uids, dids, k)
        built = ivf.built_rows
        appended = self._size - built
        if appended > 0:
            # pad the tail to a power of two (few shapes), not to capacity
            tail_len = min(self._pow2(max(appended, 4096)), self._capacity - built)
            end = built + tail_len
            tmask = predicate_mask_multi(self._users[built:end], self._docs[built:end],
                                         self._live[built:end], uids, dids)
            kk = min(k, tail_len)
            if self.is_int8:  # the probe's query quantization: one scale
                s2, i2 = cosine_topk_int8(queries, self._slab[built:end],
                                          self._scales[built:end], tmask, kk)
            else:
                s2, i2 = cosine_topk(queries, self._slab[built:end], tmask, kk)
            scores, idx = merge_topk(scores, idx, s2, i2 + built, k)
        return scores, idx

    # -- public API ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return int(self._row_live.sum())

    # -- cross-process replication ------------------------------------------

    def attach_journal(self, journal, collection: str, directory: str, name: str,
                       poll_sec: float = 0.25) -> None:
        """Join a shared mutation journal (:mod:`mmrag_tpu_torch.index.journal`).

        ``directory``/``name`` locate this index's snapshot for gap recovery.
        Replays any tail the loaded snapshot did not cover, so a process
        booting after a peer's ingest sees the peer's rows at once."""

        with self._lock:
            self._journal = journal
            self._journal_collection = collection
            self._snapshot_dir = directory
            self._snapshot_name = name
            self._journal_poll_sec = poll_sec
            self._applied_seq = self._loaded_snapshot_seq
            self._replay_through()

    def _maybe_replay(self) -> None:
        """Throttled read-path catch-up: one SQLite point read at most every
        ``poll_sec``; replay only when a peer appended past our cursor."""

        if self._journal is None:
            return
        now = time.monotonic()
        if now - self._last_journal_check < self._journal_poll_sec:
            return
        self._last_journal_check = now
        coll = self._journal_collection
        if (self._journal.max_seq(coll) > self._applied_seq
                or self._journal.compacted_upto(coll) > self._applied_seq):
            self._replay_through()

    def _replay_through(self, target_seq: Optional[int] = None) -> int:
        """Apply journal entries in seq order up to the tip. Returns the row
        count produced by the entry with ``target_seq`` (the caller's own
        append), 0 otherwise."""

        from . import journal as _journal

        result = 0
        with self._lock:
            if self._journal.compacted_upto(self._journal_collection) > self._applied_seq:
                # entries between our cursor and the newest snapshot were
                # compacted away: recover from the snapshot that covered them
                self._reload_snapshot()
            for seq, op, payload in self._journal.entries_after(self._journal_collection,
                                                                self._applied_seq):
                if op == _journal.OP_UPSERT:
                    n = self._apply_upsert(_journal.decode_rows(payload))
                elif op == _journal.OP_DELETE_DOC:
                    n = self._apply_delete_document(payload.decode("utf-8"))
                else:  # an entry of a newer schema: converge at boot instead
                    _logger.warning("unknown journal op %r (seq %d)", op, seq)
                    n = 0
                self._applied_seq = seq
                if seq == target_seq:
                    result = n
        return result

    def _reload_snapshot(self) -> None:
        """Replace the in-memory state with the newest on-disk snapshot (gap
        recovery after a journal compaction outpaced this process)."""

        manifest = os.path.join(self._snapshot_dir, f"{self._snapshot_name}.manifest.json")
        if not os.path.exists(manifest):
            # compaction only runs after a successful save, so this is
            # unreachable unless the snapshot was deleted out of band
            _logger.error("journal gap but no snapshot at %s", manifest)
            return
        fresh = VectorIndex.load(
            self._snapshot_dir, self._snapshot_name, self._dtype_str, device=self.device,
            backend=self.backend, ivf_nprobe=self.ivf_nprobe,
            ivf_min_rows=self.ivf_min_rows, ivf_min_structure=self.ivf_min_structure,
            pq_m=self.pq_m, pq_refine=self.pq_refine, pq_residual=self.pq_residual,
            pq_min_quality=self.pq_min_quality, mesh=self.mesh,
        )
        with self._lock:
            for attr in (
                "_capacity", "_size", "_slab", "_users", "_docs", "_live", "_scales",
                "_chunk_ids", "_row_user", "_row_doc", "_row_live", "_chunk_to_row",
                "_user_intern", "_doc_intern", "_ivf_warm_centroids", "_ivf_poor_at",
                "_pq", "_pq_trained_at", "_host_slab",
                # a pq index that demoted to int8 carries the demotion through
                "is_pq", "dtype", "_dtype_str",
            ):
                setattr(self, attr, getattr(fresh, attr))
            self._ivf = None
            self._generation += 1  # drops in-flight background IVF builds
            self._applied_seq = fresh._loaded_snapshot_seq
            _logger.info("index %s reloaded from snapshot (seq %d)", self._snapshot_name,
                         self._applied_seq)

    def upsert(self, rows: Sequence[VectorRow]) -> int:
        """Delete-then-add upsert; returns number of rows written.

        With a journal attached the mutation is appended to the shared log
        first, then applied by seq-ordered replay (one total order across
        processes); without one it applies directly."""

        if not rows:
            return 0
        if self._journal is None:
            return self._apply_upsert(rows)
        from . import journal as _journal

        rows = list(rows)
        for r in rows:  # validate BEFORE journaling: peers must never see an
            if len(r.embedding) != self.dim:  # entry that cannot apply
                raise ValueError(f"dim mismatch: index {self.dim}, rows {len(r.embedding)}")
        # the journal's two parts, the encode and (once the lock is held) the
        # append: the wait for the lock is in neither
        with stage("index.journal", items=len(rows), index=self.name, part="encode"):
            blob = _journal.encode_rows(rows)
        with self._lock:
            with stage("index.journal", items=len(rows), index=self.name, part="append"):
                seq = self._journal.append(self._journal_collection, _journal.OP_UPSERT, blob)
            with stage("index.replay", index=self.name):
                return self._replay_through(seq)

    def _apply_upsert(self, rows: Sequence[VectorRow]) -> int:
        with self._lock, stage("index.apply", items=len(rows), index=self.name):
            # validate BEFORE tombstoning: a rejected upsert must not delete
            # the rows it failed to replace
            mat = np.stack([r.embedding for r in rows]).astype(np.float32)
            if mat.shape[1] != self.dim:
                raise ValueError(f"dim mismatch: index {self.dim}, rows {mat.shape[1]}")
            self._tombstone([r.chunk_id for r in rows])
            n = len(rows)
            start = self._size
            self._ensure_capacity(start + n)
            # normalize on write (reference lancedb_store.py:63-69)
            norms = np.linalg.norm(mat, axis=1, keepdims=True)
            mat = mat / np.maximum(norms, 1e-12)
            users = np.asarray(
                [self._intern(self._user_intern, r.user_id) for r in rows], np.int32
            )
            docs = np.asarray(
                [self._intern(self._doc_intern, r.document_id) for r in rows], np.int32
            )
            end = start + n
            dev = self.device
            if self.is_pq:
                self._host_slab[start:end] = mat
                self._pq_write_codes(start, n)  # may demote the index to int8
            elif self.is_int8:
                self._slab[start:end], self._scales[start:end] = quantize_rows_int8(
                    self._to_device(mat))
            else:
                self._slab[start:end] = self._to_device(mat).to(self.dtype)
            self._users[start:end] = torch.from_numpy(users).to(dev)
            self._docs[start:end] = torch.from_numpy(docs).to(dev)
            self._live[start:end] = True
            self._chunk_ids.extend(r.chunk_id for r in rows)
            self._row_user.extend(r.user_id for r in rows)
            self._row_doc.extend(r.document_id for r in rows)
            self._row_live = np.concatenate([self._row_live, np.ones(n, dtype=bool)])
            for i, r in enumerate(rows):
                self._chunk_to_row[r.chunk_id] = start + i
            self._size = end
            return n

    def delete_document(self, document_id: str) -> int:
        """Tombstone every row of a document (journaled when attached)."""

        if self._journal is None:
            return self._apply_delete_document(document_id)
        from . import journal as _journal

        with self._lock:
            seq = self._journal.append(self._journal_collection, _journal.OP_DELETE_DOC,
                                       document_id.encode("utf-8"))
            return self._replay_through(seq)

    def _apply_delete_document(self, document_id: str) -> int:
        with self._lock:
            doomed = [
                c for c, row in self._chunk_to_row.items() if self._row_doc[row] == document_id
            ]
            self._tombstone(doomed)
            return len(doomed)

    def _as_queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return queries.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)

    def _collect(self, scores, idx, n_queries: int, k: int, chunk_ids: List[str]):
        scores, idx = _host(scores), _host(idx)
        out: List[List[Tuple[str, float]]] = []
        for qi in range(n_queries):
            hits = []
            for score, row in zip(scores[qi], idx[qi]):
                if score <= -1e29 or len(hits) >= k:
                    break
                hits.append((chunk_ids[row], float(score)))
            out.append(hits)
        return out

    def search(
        self, query: np.ndarray, user_id: str, k: int, document_id: Optional[str] = None,
    ) -> List[Tuple[str, float]]:
        """Single-query convenience wrapper over :meth:`search_batch`."""

        return self.search_batch(query[None, :], user_id, k, document_id)[0]

    def search_batch(
        self, queries, user_id: str, k: int, document_id: Optional[str] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Masked cosine top-k. Returns per-query ``(chunk_id, score)`` lists
        sorted descending, only live rows of this tenant (and document, when
        filtered) — predicate applied *pre*-top-k on the device."""

        self._maybe_replay()
        with self._lock:
            n_queries = queries.shape[0]
            if self._size == 0 or user_id not in self._user_intern:
                return [[] for _ in range(n_queries)]
            uid = self._user_intern[user_id]
            if document_id is not None:
                if document_id not in self._doc_intern:
                    return [[] for _ in range(n_queries)]
                did = self._doc_intern[document_id]
            else:
                did = -1
            q = _pad_queries(self._as_queries(queries))
            ivf = self._maybe_ivf()
            if self.is_pq or ivf is not None or self._sharded:
                uids = torch.full((q.shape[0],), uid, dtype=torch.int32, device=self.device)
                dids = torch.full((q.shape[0],), did, dtype=torch.int32, device=self.device)
            if self.is_pq:
                scores, idx = self._pq_multi_async(q, uids, dids, k)()
            elif ivf is not None:  # the layout serves bf16/f32 AND int8 slabs
                scores, idx = self._ivf_search_inner(ivf, q, uids, dids, min(k, self._capacity))
            elif self._sharded:
                scores, idx = self._dense_sharded(q, uids, dids, k)
            else:
                mask = predicate_mask(self._users, self._docs, self._live, uid, did)
                scores, idx = self._dense(q, mask, k)
            return self._collect(scores, idx, n_queries, k, self._chunk_ids)

    def search_batch_multi(
        self,
        queries,  # (q, dim)
        user_ids: Sequence[str],  # one tenant per query row
        k: int,
        document_ids: Optional[Sequence[Optional[str]]] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Batched search where EVERY query carries its own tenant (and
        optional document) predicate — one device search for a coalesced
        cross-tenant micro-batch; isolation holds exactly as in
        :meth:`search_batch`."""

        return self.search_batch_multi_async(queries, user_ids, k, document_ids)()

    def search_batch_multi_async(
        self,
        queries,  # (q, dim) np array OR device tensor (no sync forced on the latter)
        user_ids: Sequence[str],
        k: int,
        document_ids: Optional[Sequence[Optional[str]]] = None,
    ):
        """:meth:`search_batch_multi` split into dispatch + collect: returns a
        zero-arg callable producing the hit lists. The search is enqueued on
        the device before this returns; the collector reads it back (and, in
        pq mode, runs the exact host refine). A failure raises (there is no
        retry on another search path)."""

        q = queries.shape[0]
        if len(user_ids) != q:
            raise ValueError(f"{len(user_ids)} user_ids for {q} queries")
        if document_ids is not None and len(document_ids) != q:
            raise ValueError(f"{len(document_ids)} document_ids for {q} queries")
        with stage("index.replay", index=self.name):
            self._maybe_replay()
        with self._lock, stage("index.dispatch", items=q, index=self.name):
            if self._size == 0:
                return lambda: [[] for _ in range(q)]
            uids = np.asarray(
                [self._user_intern.get(u, _NO_TENANT) for u in user_ids], np.int32
            )
            dids = np.full(q, -1, np.int32)
            if document_ids is not None:
                for i, d in enumerate(document_ids):
                    if d is None:
                        continue
                    # a doc this index never saw -> positive sentinel that can
                    # never equal an interned id (negative means "no filter")
                    dids[i] = self._doc_intern.get(d, _UNSEEN_DOC)
            qt = _pad_queries(self._as_queries(queries))
            pad = qt.shape[0] - q
            if pad:  # pad rows match no tenant
                uids = np.concatenate([uids, np.full(pad, _NO_TENANT, np.int32)])
                dids = np.concatenate([dids, np.full(pad, -1, np.int32)])
            uids_t = torch.from_numpy(uids).to(self.device)
            dids_t = torch.from_numpy(dids).to(self.device)
            ivf = self._maybe_ivf()
            if self.is_pq:
                pending = self._pq_multi_async(qt, uids_t, dids_t, k)
            else:
                if ivf is not None:
                    s, i = self._ivf_search_inner(ivf, qt, uids_t, dids_t,
                                                  min(k, self._capacity))
                elif self._sharded:
                    s, i = self._dense_sharded(qt, uids_t, dids_t, k)
                else:
                    s, i = self._dense(qt, predicate_mask_multi(
                        self._users, self._docs, self._live, uids_t, dids_t), k)
                pending = lambda: (s, i)  # noqa: E731
            # rows only append under the captured list, so it stays consistent
            chunk_ids = self._chunk_ids

        def collect():
            with stage("index.wait", items=q, index=self.name):
                synchronize(self.device)
            with stage("index.collect", items=q, index=self.name):
                return self._collect(*pending(), q, k, chunk_ids)

        return collect

    # -- maintenance --------------------------------------------------------

    def compact(self) -> int:
        """Drop tombstoned rows, rebuilding the slab. Returns the live count."""

        with self._lock:
            live_rows = np.flatnonzero(self._row_live)
            mat = native.gather_rows(self._host_rows_f32(), live_rows)
            chunk_ids = [self._chunk_ids[i] for i in live_rows]
            users = [self._row_user[i] for i in live_rows]
            docs = [self._row_doc[i] for i in live_rows]
            self._capacity = 0
            self._size = 0
            self._slab = self._users = self._docs = self._live = None
            self._scales = None
            if self.is_pq:  # fresh codebooks for the compacted corpus
                self._pq = None
                self._pq_trained_at = 0
                self._host_slab = np.zeros((0, self.dim), np.float32)
            self._ivf = None  # row ids change; rebuilt lazily at the next search
            self._generation += 1  # drops any in-flight background build
            self._chunk_ids, self._row_user, self._row_doc = [], [], []
            self._row_live = np.zeros(0, dtype=bool)
            self._chunk_to_row = {}
            self._user_intern, self._doc_intern = {}, {}
            rows = [
                VectorRow(chunk_id=c, user_id=u, document_id=d,
                          modality="text" if self.dim != 512 else "image", embedding=e)
                for c, u, d, e in zip(chunk_ids, users, docs, mat)
            ]
            if rows:
                # applied directly: compaction is a physical rebuild, not a
                # logical mutation, and peers' journals must not see it
                self._apply_upsert(rows)
            return len(rows)

    # -- persistence --------------------------------------------------------

    def save(self, directory: str, name: str) -> None:
        """Atomic snapshot in the JAX package's format: the row ids ride
        inside the npz (string arrays), so one ``os.replace`` commits data
        and ids together; the manifest is a small summary.

        With a journal attached, the snapshot first replays to the log tip
        (so one process's save never drops a peer's rows), stamps the
        covered seq into the manifest, and compacts the entries it covers
        (keeping the journal's safety window for live peers)."""

        with self._lock:
            if self._journal is not None:
                self._replay_through()
            os.makedirs(directory, exist_ok=True)
            live_rows = np.flatnonzero(self._row_live)
            live_t = torch.from_numpy(live_rows).to(self.device)
            ids_arrays = {  # fixed-width unicode: no pickle needed to load
                "chunk_ids": np.asarray([self._chunk_ids[i] for i in live_rows], dtype=np.str_),
                "user_ids": np.asarray([self._row_user[i] for i in live_rows], dtype=np.str_),
                "document_ids": np.asarray([self._row_doc[i] for i in live_rows],
                                           dtype=np.str_),
            }
            manifest = {"dim": self.dim, "rows": int(live_rows.size)}
            if self._journal is not None:
                manifest["snapshot_seq"] = self._applied_seq
            if self._ivf is not None:
                # the restored index warm-rebuilds its layout with one
                # assignment pass instead of k-means
                ids_arrays["ivf_centroids"] = _host(self._ivf.centroids).astype(np.float32)
            if self.is_pq and self._pq is not None and self._size:
                # codebooks + m-byte codes: a restart installs them instead
                # of retraining and re-encoding the corpus
                ids_arrays["pq_codebooks"] = _host(self._pq.codebooks).astype(np.float32)
                ids_arrays["pq_codes"] = _host(self._slab[: self._size][live_t])
            if self.is_int8:
                # lossless: the codes and scales themselves, no re-quantization
                if self._size:
                    payload = {"embeddings_int8": _host(self._slab[: self._size][live_t]),
                               "scales": _host(self._scales[: self._size][live_t])}
                else:
                    payload = {"embeddings_int8": np.zeros((0, self.dim), np.int8),
                               "scales": np.zeros((0,), np.float32)}
            else:
                # bf16 (the pq host originals too): the native round to
                # nearest even, exact for a bf16 slab
                mat = native.gather_rows(self._host_rows_f32(), live_rows)
                payload = ({"embeddings_bf16": native.f32_to_bf16(mat)}
                           if self.dtype == torch.bfloat16 else {"embeddings": mat})
            npz_tmp = os.path.join(directory, f"{name}.npz.tmp")
            with open(npz_tmp, "wb") as fh:
                np.savez(fh, **payload, **ids_arrays)
            os.replace(npz_tmp, os.path.join(directory, f"{name}.npz"))
            tmp = os.path.join(directory, f"{name}.manifest.json.tmp")
            with open(tmp, "w") as fh:
                json.dump(manifest, fh)
            os.replace(tmp, os.path.join(directory, f"{name}.manifest.json"))
            if self._journal is not None:
                self._journal.compact(self._journal_collection, self._applied_seq)

    def _install_rows(self, chunk_ids, user_ids, doc_ids) -> None:
        """The row metadata of a snapshot installed into an EMPTY index whose
        first ``len(chunk_ids)`` slab rows were just written."""

        n = len(chunk_ids)
        dev = self.device
        users = [self._intern(self._user_intern, u) for u in user_ids]
        docs = [self._intern(self._doc_intern, d) for d in doc_ids]
        self._users[:n] = torch.tensor(users, dtype=torch.int32).to(dev)
        self._docs[:n] = torch.tensor(docs, dtype=torch.int32).to(dev)
        self._live[:n] = True
        self._chunk_ids = list(chunk_ids)
        self._row_user = list(user_ids)
        self._row_doc = list(doc_ids)
        self._row_live = np.ones(n, dtype=bool)
        self._chunk_to_row = {c: i for i, c in enumerate(chunk_ids)}
        self._size = n

    def _install_prequantized(self, chunk_ids, user_ids, doc_ids, q_mat, scales) -> None:
        """Populate an EMPTY int8 index from persisted codes and scales,
        bypassing normalize + quantize, so a save/load round trip is exact."""

        with self._lock:
            assert self._size == 0 and self.is_int8
            n = len(chunk_ids)
            if n == 0:
                return
            self._ensure_capacity(n)
            self._slab[:n] = torch.from_numpy(np.asarray(q_mat, np.int8)).to(self.device)
            self._scales[:n] = torch.from_numpy(np.asarray(scales, np.float32)).to(self.device)
            self._install_rows(chunk_ids, user_ids, doc_ids)

    def _install_precoded(self, chunk_ids, user_ids, doc_ids, mat, codebooks, codes) -> None:
        """Populate an EMPTY pq index from a snapshot's codebooks and codes:
        a warm restart skips the retrain and the re-encode. ``mat`` (the
        bf16-rounded originals) refills the host slab for the refine and
        later retrains."""

        from ..ops import pq as pqops

        with self._lock:
            assert self._size == 0 and self.is_pq
            n = len(chunk_ids)
            if n == 0:
                return
            self._ensure_capacity(n)
            self._host_slab[:n] = np.asarray(mat, np.float32)
            self._pq = pqops.PQData(torch.from_numpy(np.asarray(codebooks, np.float32))
                                    .to(self.device))
            self._pq_trained_at = n
            self._slab[:n] = torch.from_numpy(np.asarray(codes, np.int8)).to(self.device)
            self._install_rows(chunk_ids, user_ids, doc_ids)

    @classmethod
    def load(cls, directory: str, name: str, dtype: str = "bfloat16",
             device: DeviceLike = None, **knobs) -> "VectorIndex":
        """An index from a snapshot that :meth:`save` (of either package)
        wrote; ``dtype`` and ``knobs`` (the constructor's backend / ivf / pq
        settings) are this run's, and a payload of another dtype converts."""

        with open(os.path.join(directory, f"{name}.manifest.json")) as fh:
            manifest = json.load(fh)
        seq = int(manifest.get("snapshot_seq", 0))
        index = cls(dim=manifest["dim"], dtype=dtype, device=device, **knobs)
        with np.load(os.path.join(directory, f"{name}.npz")) as data:
            if "chunk_ids" in data:  # ids inside the npz, atomic with the rows
                chunk_ids = data["chunk_ids"].tolist()
                user_ids = data["user_ids"].tolist()
                document_ids = data["document_ids"].tolist()
            else:  # snapshots from before that: the ids in the manifest
                chunk_ids = manifest["chunk_ids"]
                user_ids = manifest["user_ids"]
                document_ids = manifest["document_ids"]
            warm = np.asarray(data["ivf_centroids"]) if "ivf_centroids" in data else None
            pq_books = np.asarray(data["pq_codebooks"]) if "pq_codebooks" in data else None
            pq_codes = np.asarray(data["pq_codes"]) if "pq_codes" in data else None
            if "embeddings_int8" in data and index.is_int8:
                index._install_prequantized(chunk_ids, user_ids, document_ids,
                                            data["embeddings_int8"], data["scales"])
                index._ivf_warm_centroids = warm
                index._loaded_snapshot_seq = seq
                return index
            if "embeddings_int8" in data:  # the dtype changed between runs
                mat = data["embeddings_int8"].astype(np.float32) * data["scales"][:, None]
            elif "embeddings_bf16" in data:
                mat = native.bf16_to_f32(data["embeddings_bf16"])
            else:
                mat = data["embeddings"]
        if len(chunk_ids) != len(mat):
            raise ValueError(f"{name}: snapshot ids ({len(chunk_ids)}) and embeddings "
                             f"({len(mat)}) disagree; refusing to zip mismatched rows")
        if (index.is_pq and pq_books is not None and pq_codes is not None
                and len(pq_codes) == len(chunk_ids) and pq_codes.shape[1] == index.pq_m):
            index._install_precoded(chunk_ids, user_ids, document_ids, mat, pq_books, pq_codes)
        else:  # a pq_m changed between runs retrains here
            rows = [
                VectorRow(chunk_id=c, user_id=u, document_id=d,
                          modality="text" if manifest["dim"] != 512 else "image", embedding=e)
                for c, u, d, e in zip(chunk_ids, user_ids, document_ids, mat)
            ]
            if rows:
                index.upsert(rows)
        index._ivf_warm_centroids = warm
        index._loaded_snapshot_seq = seq
        return index

    @classmethod
    def load_or_create(
        cls, directory: str, name: str, dim: int, dtype: str = "bfloat16",
        device: DeviceLike = None, **knobs,
    ) -> "VectorIndex":
        """The snapshot ``directory/name`` when one exists (:meth:`load`),
        else a fresh index. ``knobs`` are the constructor's backend / ivf /
        pq settings."""

        if os.path.exists(os.path.join(directory, f"{name}.manifest.json")):
            index = cls.load(directory, name, dtype, device=device, **knobs)
        else:
            index = cls(dim=dim, dtype=dtype, device=device, **knobs)
        index.name = name
        return index
