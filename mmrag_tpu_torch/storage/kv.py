"""SQLite-backed TTL key-value store — the control-plane role Redis plays in
the reference (idempotency keys ``api/routes.py:171-184``, 24h already-indexed
dedup ``app/tasks.py:45-62,196-197``).

When a Redis client + server are available the serving layer prefers them
(:func:`mmrag_tpu_torch.serving.jobs.make_kv`); this store is the always-available
fallback with the same get/setex semantics, visible across processes.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import Optional


class KVStore:
    def __init__(self, path: str) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._lock, self._conn:
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS kv (
                    key TEXT PRIMARY KEY,
                    value TEXT NOT NULL,
                    expires_at REAL
                )
                """
            )

    def get(self, key: str) -> Optional[str]:
        now = time.time()
        with self._lock:
            row = self._conn.execute(
                "SELECT value, expires_at FROM kv WHERE key=?", (key,)
            ).fetchone()
            if row is None:
                return None
            value, expires = row
            if expires is not None and expires < now:
                with self._conn:
                    self._conn.execute("DELETE FROM kv WHERE key=?", (key,))
                return None
            return value

    def setex(self, key: str, ttl_sec: Optional[float], value: str) -> None:
        expires = time.time() + ttl_sec if ttl_sec else None
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value, "
                "expires_at=excluded.expires_at",
                (key, value, expires),
            )

    def set_if_absent(self, key: str, ttl_sec: Optional[float], value: str) -> bool:
        """Atomic SETNX-with-TTL; returns True iff the key was set."""

        now = time.time()
        expires = now + ttl_sec if ttl_sec else None
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT expires_at FROM kv WHERE key=?", (key,)
            ).fetchone()
            if row is not None and (row[0] is None or row[0] >= now):
                return False
            self._conn.execute(
                "INSERT INTO kv (key, value, expires_at) VALUES (?, ?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value, "
                "expires_at=excluded.expires_at",
                (key, value, expires),
            )
            return True

    def delete(self, key: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM kv WHERE key=?", (key,))

    def sweep(self) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM kv WHERE expires_at IS NOT NULL AND expires_at < ?",
                (time.time(),),
            )
            return cur.rowcount

    def close(self) -> None:
        with self._lock:
            self._conn.close()
