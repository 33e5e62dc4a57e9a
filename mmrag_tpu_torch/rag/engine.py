"""RagEngine: the process-wide wiring of encoders, indexes, and catalogs.

Port of ``mmrag_tpu/rag/engine.py``. Owns:
  * :class:`EncoderRuntime`            — MiniLM / CLIP / cross-encoder
  * two :class:`VectorIndex` instances — text (384-d) + image (512-d) slabs,
    the reference's two LanceDB collections (``lancedb_store.py:30-31``),
    in the layout ``TPU_INDEX_DTYPE`` and ``TPU_TOPK_BACKEND`` choose
  * :class:`MetadataStore`             — documents/chunks catalog (SQLite)
  * :class:`NoteStore`                 — notes/quizzes
  * :class:`IndexVersionStore`         — per-user version counters (cache keys)

Both indexes load the snapshots in ``paths.index_dir`` (the JAX package's
format) and :meth:`persist_indexes` writes them. With ``TPU_INDEX_JOURNAL``
(the default) both join the shared mutation journal
``index_dir/index_journal.db``: every upsert and document delete is logged
and applied by seq-ordered replay, so another process over the same
directory (the JAX package's too) sees the same rows, and a restart replays
what the newest snapshot did not cover.

With ``TPU_MICROBATCH_WINDOW_MS > 0`` (the default, 4 ms) concurrent
requests coalesce in two lazy batchers: :attr:`RagEngine.query_batcher` for
the dual query embedding and :attr:`RagEngine.retrieval_batcher` for whole
``retrieve`` calls (``TPU_MICROBATCH_WORKERS`` runners).

Multi-device mode: the engine takes the runtime's mesh (``TPU_DATA_PARALLEL``,
:func:`~mmrag_tpu_torch.parallel.mesh.engine_data_mesh`) and hands it to both
indexes, so their slabs are row-sharded over its data axis while the
runtime's encoder batches split over it; with one device there is no mesh.
"""

from __future__ import annotations

import gc
import os
import threading
from typing import Optional

from ..device import DeviceLike
from ..index.store import VectorIndex, _join_ivf_builds
from ..index.version import IndexVersionStore
from ..models.runtime import EncoderRuntime, get_runtime
from ..settings import Settings, settings as _default_settings
from ..storage.metadata import MetadataStore
from ..storage.notes import NoteStore


def _freeze_heap() -> None:
    """Take every object alive now out of the cyclic collector's view.

    A full (generation 2) collection traverses every tracked object of the
    process, and the imports alone hold about 170,000 (torch's). Where the
    allocation counters trigger one, it stops every thread: on the H100's
    host one took 189 ms inside a coalesced ``retrieve_batch`` (``PERF.md``
    §5, R15). The engine is long-lived, so what exists when it is built
    (modules, the runtime, the indexes) is frozen (``gc.freeze``) after one
    collection of today's garbage; later collections traverse only what was
    created since. Refcounting still frees a frozen object, and
    :meth:`RagEngine.close` breaks the engine's one reference cycle, so a
    closed and dropped engine is freed as before. The JAX package's engine
    leaves the collector as it is."""

    gc.collect()
    gc.freeze()


class RagEngine:
    def __init__(
        self,
        cfg: Optional[Settings] = None,
        runtime: Optional[EncoderRuntime] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg or _default_settings
        self.runtime = runtime or get_runtime(self.cfg, device=device)
        self.device = self.runtime.device
        # multi-device mode: both index slabs row-sharded over the runtime's
        # data axis (None on one device; stubs have no mesh)
        self.mesh = getattr(self.runtime, "mesh", None)
        paths = self.cfg.paths
        os.makedirs(paths.index_dir, exist_ok=True)
        # the index storage dtype is its own knob: TPU_INDEX_DTYPE=int8 or pq
        # does not change the encoders' compute dtype
        index_dtype = self.cfg.tpu.index_dtype or self.cfg.tpu.compute_dtype
        tpu = self.cfg.tpu
        knobs = dict(
            dtype=index_dtype, device=self.device, backend=tpu.topk_backend,
            ivf_nprobe=tpu.ivf_nprobe, ivf_min_rows=tpu.ivf_min_rows,
            ivf_min_structure=tpu.ivf_min_structure, pq_m=tpu.pq_m,
            pq_refine=tpu.pq_refine, pq_residual=tpu.pq_residual,
            pq_min_quality=tpu.pq_min_quality, mesh=self.mesh,
        )
        self.text_index = VectorIndex.load_or_create(
            paths.index_dir, "text_collection", dim=self.runtime.text_dim, **knobs)
        self.image_index = VectorIndex.load_or_create(
            paths.index_dir, "image_collection", dim=self.runtime.clip_dim, **knobs)
        # cross-process replication (the reference's api / Celery-worker
        # split): both processes journal index mutations into one SQLite log
        # and replay each other's entries, so a worker-side ingest is visible
        # to api retrieval within journal_poll_sec and neither process's
        # persist drops the other's rows
        self.journal = None
        if tpu.index_journal:
            from ..index.journal import IndexJournal

            self.journal = IndexJournal(os.path.join(paths.index_dir, "index_journal.db"))
            for index, name in ((self.text_index, "text_collection"),
                                (self.image_index, "image_collection")):
                index.attach_journal(self.journal, name, paths.index_dir, name,
                                     poll_sec=tpu.journal_poll_sec)
        self.metadata = MetadataStore(os.path.join(paths.index_dir, "metadata.db"))
        self.notes = NoteStore(paths.notes_db_path)
        self.versions = IndexVersionStore(os.path.join(paths.index_dir, "index_versions.db"))
        self._persist_lock = threading.Lock()
        self._query_batcher = None
        self._retrieval_batcher = None
        self._batcher_lock = threading.Lock()
        _freeze_heap()

    @property
    def query_batcher(self):
        """Lazy cross-request query-embed coalescer (None when disabled via
        ``TPU_MICROBATCH_WINDOW_MS=0``)."""

        if self.cfg.tpu.microbatch_window_ms <= 0:
            return None
        with self._batcher_lock:
            if self._query_batcher is None:
                from ..serving.batcher import QueryEmbedBatcher

                self._query_batcher = QueryEmbedBatcher(
                    self.runtime,
                    max_batch=self.cfg.tpu.microbatch_max,
                    window_ms=self.cfg.tpu.microbatch_window_ms,
                )
            return self._query_batcher

    @property
    def retrieval_batcher(self):
        """Lazy whole-request retrieval coalescer: N concurrent ``retrieve``
        calls share one embed + one masked top-k per modality + one rerank
        call (None when disabled via ``TPU_MICROBATCH_WINDOW_MS=0``)."""

        if self.cfg.tpu.microbatch_window_ms <= 0:
            return None
        with self._batcher_lock:
            if self._retrieval_batcher is None:
                from ..serving.batcher import MicroBatcher

                def run(items):
                    from .retrieve import retrieve_batch

                    return retrieve_batch(list(items), self)

                self._retrieval_batcher = MicroBatcher(
                    run,
                    max_batch=self.cfg.tpu.microbatch_max,
                    window_ms=self.cfg.tpu.microbatch_window_ms,
                    name="retrieval",
                    workers=self.cfg.tpu.microbatch_workers,
                )
            return self._retrieval_batcher

    def warmup_serving(self, max_coalesce: Optional[int] = None,
                       stop: Optional[threading.Event] = None) -> int:
        """Run the serving query path once for every coalesce length the
        retrieval batcher can produce (both query towers, the masked top-k of
        each non-empty index, the cross-encoder at each new padded batch), so
        the weights are loaded and the kernels built (``nvcc``) and loaded
        before the first request. The JAX package's warmup compiles the same
        executables; here nothing is compiled per shape, but the first
        launches build the kernels. The warmup tenant is a never-interned
        sentinel, so no real rows are scanned into results. Returns the
        number of warm dispatches issued, counted as the JAX package counts
        them.

        ``stop``: checked between lengths — a shutting-down server sets it
        and joins the warmup thread, so interpreter teardown never lands
        while a warmup launch is in flight."""

        max_coalesce = max_coalesce or self.cfg.tpu.microbatch_max
        cfgr = self.cfg.retrieval
        # a mid-length passage so the rerank runs a realistic seq bucket
        passage = "warmup passage text for the cross encoder. " * 8
        count = 0
        warmed_rerank: set = set()
        for n in range(1, max_coalesce + 1):
            if stop is not None and stop.is_set():
                return count
            qs = [f"warmup query {i} of {n}" for i in range(n)]
            tdev, idev = self.runtime.embed_queries_device(qs)
            count += 1
            users = ["\x00warmup"] * n
            for index, k, qdev in (
                (self.text_index, cfgr.index_topk_text, tdev),
                (self.image_index, cfgr.index_topk_image, idev),
            ):
                if index._size > 0:  # an empty index never dispatches
                    index.search_batch_multi_async(qdev, users, k)()
                    count += 1
            if cfgr.use_rerank:
                # run the cross-encoder only when this length's bucket
                # decomposition introduces a new padded batch size
                n_pairs = n * cfgr.rerank_topk
                buckets = set(self.runtime.rerank_bucket_sizes(n_pairs))
                if not buckets <= warmed_rerank:
                    self.runtime.rerank_pairs(
                        ["warmup query"] * n_pairs, [passage] * n_pairs
                    )
                    warmed_rerank |= buckets
                    count += 1
        return count

    def persist_indexes(self) -> None:
        """Flush both vector indexes to disk (restart survival, like the
        reference's on-disk LanceDB tables)."""

        with self._persist_lock:
            self.text_index.save(self.cfg.paths.index_dir, "text_collection")
            self.image_index.save(self.cfg.paths.index_dir, "image_collection")

    def close(self) -> None:
        # dropping the batchers breaks the one reference cycle (the
        # retrieval batcher's function holds the engine), so a closed engine
        # is freed by refcounting, frozen or not (see _freeze_heap)
        with self._batcher_lock:
            batchers = (self._retrieval_batcher, self._query_batcher)
            self._retrieval_batcher = self._query_batcher = None
        for batcher in batchers:
            if batcher is not None:
                batcher.close()
        _join_ivf_builds()  # no background IVF build outlives the engine
        self.metadata.close()
        self.notes.close()
        self.versions.close()
        if self.journal is not None:
            self.journal.close()


_engine: Optional[RagEngine] = None
_engine_lock = threading.Lock()


def get_engine(cfg: Optional[Settings] = None, device: DeviceLike = None) -> RagEngine:
    """The process engine, built at the first call (on ``device``: the card
    unless ``"cpu"`` is asked for)."""

    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = RagEngine(cfg, device=device)
    return _engine


def set_engine(engine: Optional[RagEngine]) -> None:
    """Test/serving hook to install (or clear) the process engine."""

    global _engine
    with _engine_lock:
        _engine = engine
