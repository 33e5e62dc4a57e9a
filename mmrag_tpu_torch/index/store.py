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

  * dense bf16/f32: the bucket-max top-k B4;
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

Not ported yet: snapshots (``save``/``load``), the cross-process journal,
``compact`` and row sharding. Without a journal every mutation applies in
this process directly.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, storage_dtype, topk_backend
from ..ops.topk import (
    cosine_topk,
    cosine_topk_int8,
    merge_topk,
    predicate_mask,
    predicate_mask_multi,
    quantize_rows_int8,
)
from ..storage.records import VectorRow
from ..utils.profiling import metrics

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
                 pq_min_quality: Optional[float] = None) -> None:
        self.dim = dim
        self.device = resolve_device(device)
        # "ivf": the k-means partitioned layout (ops/ivf.py), built once the
        # index is large enough; "auto": the dense (or pq) scan
        self.use_ivf = topk_backend(backend) == "ivf"
        # dtype "pq": the device slab holds m-byte codes, the f32 originals
        # stay in host RAM for the exact refine; ``dtype`` stays bf16, as in
        # the JAX package (its snapshot payload dtype)
        self.dtype = storage_dtype(dtype)
        self.is_pq = dtype == "pq"
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
        self.ivf_build_async = True  # tests and chip_smoke.py set False
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
        self._row_doc: List[str] = []
        self._row_live: np.ndarray = np.zeros(0, dtype=bool)
        self._chunk_to_row: Dict[str, int] = {}
        # exact interning tables (no hash collisions)
        self._user_intern: Dict[str, int] = {}
        self._doc_intern: Dict[str, int] = {}

    # -- internals ----------------------------------------------------------

    @property
    def is_int8(self) -> bool:
        return self.dtype == torch.int8

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
        dev = self.device
        if self.is_pq:  # device slab = m-byte codes; originals grow host-side
            new_slab = torch.zeros((new_cap, self.pq_m), dtype=torch.int8, device=dev)
            host = np.zeros((new_cap, self.dim), np.float32)
            host[: self._size] = self._host_slab[: self._size]
            self._host_slab = host
        else:
            new_slab = torch.zeros((new_cap, self.dim), dtype=self.dtype, device=dev)
        new_users = torch.full((new_cap,), -1, dtype=torch.int32, device=dev)
        new_docs = torch.full((new_cap,), -1, dtype=torch.int32, device=dev)
        new_live = torch.zeros((new_cap,), dtype=torch.bool, device=dev)
        new_scales = (
            torch.ones((new_cap,), dtype=torch.float32, device=dev) if self.is_int8 else None
        )
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
            rows = rows * self._scales[: self._size, None]
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
        slab = torch.zeros((self._capacity, self.dim), dtype=torch.int8, device=self.device)
        scales = torch.ones((self._capacity,), dtype=torch.float32, device=self.device)
        for lo in range(0, total, pqops.ENCODE_CHUNK):
            hi = min(lo + pqops.ENCODE_CHUNK, total)
            slab[lo:hi], scales[lo:hi] = quantize_rows_int8(self._to_device(self._host_slab[lo:hi]))
        self.is_pq = False
        self.dtype = torch.int8
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

        from ..ops.ivf import ivf_search_pred
        from ..ops.pq import pq_topk

        s, i = ivf_search_pred(ivf, queries, uids, dids, cand, self.ivf_nprobe)
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
        return cosine_topk(queries, self._slab, mask, kk)

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

        with self._lock:
            if self._size == 0 or (self.is_pq and self._pq is None):
                self._ivf = None
                return
            snap = self._size
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

        if pq_books is not None:
            data = self._build_ivf_pq(slab, host_rows, snap, pq_books, users, docs, live,
                                      n_clusters, bucket_factor, iters)
        else:
            data = ivf_ops.build_ivf(slab, n_clusters, bucket_factor, iters, users=users,
                                     docs=docs, live=live, scales=scales)
        self._gate_and_install_ivf(data, snap)

    def _gate_and_install_ivf(self, data, snap_size: int) -> None:
        """Discard structureless layouts, re-apply mid-build tombstones,
        install."""

        from ..ops import ivf as ivf_ops

        baseline = ivf_ops.structureless_baseline(data.n_clusters, self.dim)
        if self.ivf_min_structure and data.structure < self.ivf_min_structure * baseline:
            with self._lock:
                self._ivf = None
                self._ivf_poor_at = snap_size
            _logger.warning(
                "ivf layout discarded: mean assignment cosine %.3f < %.1fx structureless "
                "baseline %.3f — data has no cluster structure; serving the dense path",
                data.structure, self.ivf_min_structure, baseline,
            )
            return
        with self._lock:
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
                      n_clusters, bucket_factor, iters):
        """Build the literal IVF_PQ layout: cluster on the f32 HOST originals
        (codes carry no clustering geometry), lay the m-byte codes out in
        buckets. With ``pq_residual`` the bucket codes re-encode
        ``x - centroid[assign]`` against codebooks trained on residuals."""

        from ..ops import ivf as ivf_ops

        centroids, rbooks, assign_h, res_codes, structure = self._pq_cluster_encode(
            host_rows, snap_size, n_clusters, iters)
        if rbooks is not None:
            codes = res_codes[0] if len(res_codes) == 1 else torch.cat(res_codes)
            books = rbooks
        return ivf_ops.build_ivf(
            codes, bucket_factor=bucket_factor, users=users, docs=docs, live=live,
            centroids=centroids, assign=assign_h, structure_override=structure,
            pq_codebooks=books, pq_residual=rbooks is not None,
        )

    def _pq_cluster_encode(self, host_rows, snap_size: int, n_clusters, iters: int):
        """Centroids from k-means on an evenly spaced <=131k sample, residual
        codebooks when enabled, and the chunked assignment (+ residual
        encode) pass over the host originals: the f32 corpus never goes to
        the device whole. Returns ``(centroids, rbooks_or_None, assign_h,
        res_codes_or_None, structure)``."""

        from ..ops import ivf as ivf_ops
        from ..ops import pq as pqops

        if n_clusters is None:
            n_clusters = ivf_ops.default_n_clusters(snap_size)
        sample = self._to_device(host_rows[
            ivf_ops._even_indices(snap_size, min(snap_size, 131072))
        ])
        centroids, _ = ivf_ops.kmeans(sample, n_clusters, iters, train_sample=0)
        rbooks = None
        if self.pq_residual:
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

    def _ivf_search_inner(self, ivf, queries, uids, dids, k: int):
        """Predicated probe (B8 or B9) + exact spill, then the exactly scored
        append tail (rows written after the build: B4 for a bf16/f32 slab,
        the int8 scan for int8), merged. Returns device tensors."""

        from ..ops.ivf import ivf_search_pred

        scores, idx = ivf_search_pred(ivf, queries, uids, dids, k, self.ivf_nprobe)
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

    def upsert(self, rows: Sequence[VectorRow]) -> int:
        """Delete-then-add upsert; returns number of rows written."""

        if not rows:
            return 0
        return self._apply_upsert(rows)

    def _apply_upsert(self, rows: Sequence[VectorRow]) -> int:
        with self._lock:
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
            self._row_doc.extend(r.document_id for r in rows)
            self._row_live = np.concatenate([self._row_live, np.ones(n, dtype=bool)])
            for i, r in enumerate(rows):
                self._chunk_to_row[r.chunk_id] = start + i
            self._size = end
            return n

    def delete_document(self, document_id: str) -> int:
        """Tombstone every row of a document."""

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
            if self.is_pq or ivf is not None:
                uids = torch.full((q.shape[0],), uid, dtype=torch.int32, device=self.device)
                dids = torch.full((q.shape[0],), did, dtype=torch.int32, device=self.device)
            if self.is_pq:
                scores, idx = self._pq_multi_async(q, uids, dids, k)()
            elif ivf is not None:  # the layout serves bf16/f32 AND int8 slabs
                scores, idx = self._ivf_search_inner(ivf, q, uids, dids, min(k, self._capacity))
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
        with self._lock:
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
                else:
                    s, i = self._dense(qt, predicate_mask_multi(
                        self._users, self._docs, self._live, uids_t, dids_t), k)
                pending = lambda: (s, i)  # noqa: E731
            # rows only append under the captured list, so it stays consistent
            chunk_ids = self._chunk_ids

        return lambda: self._collect(*pending(), q, k, chunk_ids)

    @classmethod
    def load_or_create(
        cls, directory: str, name: str, dim: int, dtype: str = "bfloat16",
        device: DeviceLike = None, **knobs,
    ) -> "VectorIndex":
        """A fresh index, or an error where a snapshot exists: loading
        snapshots is not ported, and starting empty over one would hide its
        rows. ``knobs`` are the constructor's backend / ivf / pq settings."""

        manifest = os.path.join(directory, f"{name}.manifest.json")
        if os.path.exists(manifest):
            raise NotImplementedError(
                f"index snapshot {manifest} exists; loading snapshots is not ported yet"
            )
        return cls(dim=dim, dtype=dtype, device=device, **knobs)
