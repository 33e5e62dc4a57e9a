"""Cross-process index mutation journal (SQLite WAL).

Port of ``mmrag_tpu/index/journal.py`` (the port's own copy: same SQLite
schema, same payload format, so a journal written by either package replays
in the other).

The reference's api and Celery worker both write to the SAME on-disk LanceDB
tables (the reference's ``app/storage/lancedb_store.py:29-41`` and
``app/tasks.py:120-150``), so a worker-side ingest is immediately visible to
api-side retrieval. :class:`~mmrag_tpu_torch.index.store.VectorIndex` keeps
the corpus in device memory slabs instead — which means each process has its
own copy. This journal is the replication layer that restores the
reference's shared-table semantics:

  * Every logical mutation (``upsert`` batch, ``delete_document``) is
    appended as one totally-ordered entry (SQLite ``AUTOINCREMENT`` seq)
    BEFORE it is applied, then applied by replaying the log in seq order —
    so every process converges to the same row state regardless of which
    process originated which write.
  * Readers poll ``max_seq`` (one indexed SQLite point read, throttled to
    ``journal_poll_sec``) and replay any foreign entries before serving.
  * ``save`` replays to the tip first and stamps the applied seq into the
    snapshot manifest (``snapshot_seq``), so a persisted snapshot is always
    a superset of every entry it claims to cover and a fresh process can
    boot from snapshot + tail replay.
  * Compaction deletes entries already covered by the newest snapshot, but
    only after a safety window, so a long-idle live process can still tail;
    one that slept past the window detects the gap and reloads the snapshot.

Payloads are pickle-free ``np.savez`` blobs (embeddings as float32 — the
normalize/quantize path in the index is deterministic, so replicas converge
bit-exactly, including int8 slabs).
"""

from __future__ import annotations

import io
import logging
import os
import sqlite3
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..storage.records import VectorRow

logger = logging.getLogger(__name__)

OP_UPSERT = "upsert"
OP_DELETE_DOC = "delete_doc"


def encode_rows(rows: Sequence[VectorRow]) -> bytes:
    """One upsert batch -> npz blob (atomic unit of replication)."""

    buf = io.BytesIO()
    np.savez(
        buf,
        chunk_ids=np.asarray([r.chunk_id for r in rows], dtype=np.str_),
        user_ids=np.asarray([r.user_id for r in rows], dtype=np.str_),
        document_ids=np.asarray([r.document_id for r in rows], dtype=np.str_),
        modalities=np.asarray([r.modality for r in rows], dtype=np.str_),
        embeddings=np.stack([r.embedding for r in rows]).astype(np.float32),
    )
    return buf.getvalue()


def decode_rows(blob: bytes) -> List[VectorRow]:
    with np.load(io.BytesIO(blob)) as data:
        return [
            VectorRow(
                chunk_id=c, user_id=u, document_id=d, modality=m, embedding=e
            )
            for c, u, d, m, e in zip(
                data["chunk_ids"].tolist(),
                data["user_ids"].tolist(),
                data["document_ids"].tolist(),
                data["modalities"].tolist(),
                data["embeddings"],
            )
        ]


class IndexJournal:
    """Shared append-only mutation log; one DB serves every collection."""

    def __init__(self, db_path: str, compact_window_sec: float = 3600.0) -> None:
        directory = os.path.dirname(os.path.abspath(db_path))
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self.compact_window_sec = compact_window_sec
        with self._lock, self._conn:
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS log (
                    seq INTEGER PRIMARY KEY AUTOINCREMENT,
                    collection TEXT NOT NULL,
                    op TEXT NOT NULL,
                    payload BLOB,
                    ts REAL NOT NULL
                )
                """
            )
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS log_coll_seq ON log(collection, seq)"
            )
            # highest seq ever physically deleted per collection: a reader
            # whose cursor is below this cannot tail-replay and must reload
            # the snapshot that covered the deleted entries
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS compacted (
                    collection TEXT PRIMARY KEY,
                    upto INTEGER NOT NULL
                )
                """
            )

    def append(self, collection: str, op: str, payload: bytes) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO log (collection, op, payload, ts) VALUES (?,?,?,?)",
                (collection, op, payload, time.time()),
            )
            return int(cur.lastrowid)

    def max_seq(self, collection: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(seq) FROM log WHERE collection=?", (collection,)
            ).fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    def min_seq(self, collection: str) -> int:
        """Smallest retained seq (0 when the log is empty)."""

        with self._lock:
            row = self._conn.execute(
                "SELECT MIN(seq) FROM log WHERE collection=?", (collection,)
            ).fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    def entries_after(
        self, collection: str, seq: int
    ) -> List[Tuple[int, str, Optional[bytes]]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, op, payload FROM log WHERE collection=? AND seq>? "
                "ORDER BY seq",
                (collection, seq),
            ).fetchall()
        return [(int(s), op, payload) for s, op, payload in rows]

    def compact(self, collection: str, upto_seq: int) -> int:
        """Drop entries covered by a snapshot at ``upto_seq`` — but keep a
        ``compact_window_sec`` tail so long-lived peers can still replay
        instead of snapshot-reloading. Returns rows deleted."""

        horizon = time.time() - self.compact_window_sec
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT MAX(seq) FROM log WHERE collection=? AND seq<=? AND ts<?",
                (collection, upto_seq, horizon),
            ).fetchone()
            if row is None or row[0] is None:
                return 0
            deleted_upto = int(row[0])
            cur = self._conn.execute(
                "DELETE FROM log WHERE collection=? AND seq<=?",
                (collection, deleted_upto),
            )
            self._conn.execute(
                "INSERT INTO compacted (collection, upto) VALUES (?,?) "
                "ON CONFLICT(collection) DO UPDATE SET upto=MAX(upto, excluded.upto)",
                (collection, deleted_upto),
            )
            return cur.rowcount

    def compacted_upto(self, collection: str) -> int:
        """Highest seq ever deleted for this collection (0 = none)."""

        with self._lock:
            row = self._conn.execute(
                "SELECT upto FROM compacted WHERE collection=?", (collection,)
            ).fetchone()
        return int(row[0]) if row else 0

    def close(self) -> None:
        with self._lock:
            self._conn.close()
