"""RagEngine: the process-wide wiring of encoders, indexes, and catalogs.

Port of ``mmrag_tpu/rag/engine.py`` on one device. Owns:
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

Not carried over yet: the device mesh and the serving batchers, so
``TPU_MICROBATCH_WINDOW_MS`` must be 0 until ``serving/`` is ported.
"""

from __future__ import annotations

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


class RagEngine:
    def __init__(
        self,
        cfg: Optional[Settings] = None,
        runtime: Optional[EncoderRuntime] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg or _default_settings
        if self.cfg.tpu.microbatch_window_ms > 0:
            raise NotImplementedError(
                "TPU_MICROBATCH_WINDOW_MS > 0 needs the serving batchers, which are "
                "not ported yet; set it to 0"
            )
        self.runtime = runtime or get_runtime(self.cfg, device=device)
        self.device = self.runtime.device
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
            pq_min_quality=tpu.pq_min_quality,
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

    def persist_indexes(self) -> None:
        """Flush both vector indexes to disk (restart survival, like the
        reference's on-disk LanceDB tables)."""

        with self._persist_lock:
            self.text_index.save(self.cfg.paths.index_dir, "text_collection")
            self.image_index.save(self.cfg.paths.index_dir, "image_collection")

    def close(self) -> None:
        _join_ivf_builds()  # no background IVF build outlives the engine
        self.metadata.close()
        self.notes.close()
        self.versions.close()
        if self.journal is not None:
            self.journal.close()


_engine: Optional[RagEngine] = None
_engine_lock = threading.Lock()


def get_engine(cfg: Optional[Settings] = None) -> RagEngine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = RagEngine(cfg)
    return _engine
