"""Async job layer: Celery-compatible states over a local worker pool.

The reference runs YouTube ingestion on Celery workers with Redis as broker
and result backend (``app/celery_app.py:5-10``,
``app/tasks.py:49-208``), polled via ``AsyncResult`` (``api/routes.py:218``).
This layer keeps that contract — states ``PENDING / STARTED / PROGRESS /
SUCCESS / FAILURE`` with ``{stage, pct}`` meta and a 1h result TTL — over two
interchangeable backends:

  * :class:`LocalJobQueue` — a thread pool + SQLite job table (always
    available; state survives restarts and is visible across processes, which
    in-memory Celery eager mode is not). Task name + payload persist with the
    job and STARTED claims are atomic, so SEPARATE WORKER PROCESSES
    (``python -m mmrag_tpu_torch.serving.jobs worker`` — the docker-compose worker
    service, reference ``docker-compose.yml`` worker role) can poll the same
    jobs.db and claim work the api enqueued; set ``TPU_JOB_WORKERS=0`` on the
    api to run the reference's exact api/worker split.
  * Celery, when ``celery`` + a reachable Redis are importable/configured —
    gated in :func:`make_job_queue`.

Port of ``mmrag_tpu/serving/jobs.py``. Each worker thread drives the full
ingest pipeline; the device work inside is already batched, so worker
concurrency stays small (one card, reference ``--pool=solo`` analogue).
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

from ..settings import Settings, settings as _default_settings

logger = logging.getLogger(__name__)

TERMINAL_STATES = ("SUCCESS", "FAILURE")

# Celery-style stage -> percent map. Our pipeline reports finer-grained
# stages than the reference; the reference's own stage names
# (api/routes.py:201-211) are kept as aliases so its clients/dashboards see
# identical progress values for identical stages.
STAGE_PCT = {
    "begin": 5,
    "metadata": 15,
    "transcript": 35,
    "extract": 35,  # reference alias
    "index_text": 55,
    "frames": 70,
    "index_images": 85,
    "notes": 95,
    "done": 100,
    "ready": 100,  # reference alias
}


class LocalJobQueue:
    """Threaded job runner with SQLite-persisted Celery-style state."""

    def __init__(
        self,
        db_path: str,
        workers: int = 1,
        result_ttl_sec: float = 3600.0,
    ) -> None:
        directory = os.path.dirname(os.path.abspath(db_path))
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._closed = False
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._lock, self._conn:
            self._conn.execute(
                """
                CREATE TABLE IF NOT EXISTS jobs (
                    job_id TEXT PRIMARY KEY,
                    state TEXT NOT NULL,
                    meta TEXT NOT NULL DEFAULT '{}',
                    result TEXT,
                    created_at REAL NOT NULL,
                    updated_at REAL NOT NULL,
                    task TEXT,
                    payload TEXT
                )
                """
            )
            # legacy dbs predate the task/payload columns
            cols = {r[1] for r in self._conn.execute("PRAGMA table_info(jobs)")}
            for col in ("task", "payload"):
                if col not in cols:
                    self._conn.execute(f"ALTER TABLE jobs ADD COLUMN {col} TEXT")
        self._workers = workers
        self._pool = ThreadPoolExecutor(
            max_workers=max(workers, 1), thread_name_prefix="ingest"
        )
        self._result_ttl = result_ttl_sec
        self._handlers: Dict[str, Callable] = {}
        # job_ids submitted to this process's pool and not yet finished:
        # stops the worker poll loop from re-submitting still-PENDING jobs
        # that are merely queued behind busy workers
        self._inflight: set = set()

    # -- registration -------------------------------------------------------

    def register(self, name: str, fn: Callable) -> None:
        """Register a task handler: fn(progress_cb, **payload) -> dict."""

        self._handlers[name] = fn

    # -- state --------------------------------------------------------------

    def _set_state(
        self, job_id: str, state: str, meta: Optional[Dict] = None,
        result: Optional[Dict] = None,
    ) -> None:
        with self._lock:
            if self._closed:
                # shutdown(wait=False) left this job running on purpose; its
                # remaining state writes are droppable, not crashes. Checked
                # under the SAME lock acquisition as the write: a separate
                # check-then-write pair let shutdown close the connection in
                # between, turning the drop into a ProgrammingError.
                logger.warning("job %s state %s dropped: queue closed", job_id, state)
                return
            with self._conn:
                self._conn.execute(
                    "UPDATE jobs SET state=?, meta=COALESCE(?, meta), "
                    "result=COALESCE(?, result), updated_at=? WHERE job_id=?",
                    (
                        state,
                        json.dumps(meta) if meta is not None else None,
                        json.dumps(result) if result is not None else None,
                        time.time(),
                        job_id,
                    ),
                )

    def status(self, job_id: str) -> Dict:
        """Celery AsyncResult-shaped status (reference ``routes.py:214-228``)."""

        with self._lock:
            if self._closed:  # benign read racing shutdown, not a 500
                return {"job_id": job_id, "state": "PENDING", "meta": {},
                        "result": None}
            row = self._conn.execute(
                "SELECT state, meta, result, updated_at FROM jobs WHERE job_id=?",
                (job_id,),
            ).fetchone()
        if row is None:
            return {"job_id": job_id, "state": "PENDING", "meta": {}, "result": None}
        state, meta, result, updated = row
        if state in TERMINAL_STATES and time.time() - updated > self._result_ttl:
            return {"job_id": job_id, "state": "PENDING", "meta": {}, "result": None}
        meta = json.loads(meta or "{}")
        pct = 100 if state == "SUCCESS" else STAGE_PCT.get(meta.get("stage"), 0)
        return {
            "job_id": job_id,
            "state": state,
            "meta": meta,
            "pct": pct,
            "result": json.loads(result) if result else None,
        }

    # -- enqueue/run --------------------------------------------------------

    def enqueue(self, task_name: str, payload: Dict) -> str:
        if task_name not in self._handlers:
            raise KeyError(f"no handler registered for {task_name!r}")
        job_id = uuid.uuid4().hex
        now = time.time()
        with self._lock:
            if self._closed:
                raise RuntimeError("job queue is closed")
            with self._conn:
                self._conn.execute(
                    "INSERT INTO jobs (job_id, state, meta, created_at, "
                    "updated_at, task, payload) "
                    "VALUES (?, 'PENDING', '{}', ?, ?, ?, ?)",
                    (job_id, now, now, task_name, json.dumps(payload)),
                )
        if self._workers > 0:
            self._submit(job_id, task_name, payload)
        return job_id

    def _submit(self, job_id: str, task_name: str, payload: Dict):
        """Submit a job to the pool once; duplicates return None."""

        with self._lock:
            if self._closed or job_id in self._inflight:
                return None
            self._inflight.add(job_id)

        def run():
            try:
                self._run(job_id, task_name, payload)
            finally:
                with self._lock:
                    self._inflight.discard(job_id)

        return self._pool.submit(run)

    def _claim(self, job_id: str) -> bool:
        """Atomic PENDING -> STARTED transition; exactly one process wins."""

        with self._lock:
            if self._closed:
                return False  # racing shutdown(wait=False): drop, don't crash
            with self._conn:
                cur = self._conn.execute(
                    "UPDATE jobs SET state='STARTED', meta=?, updated_at=? "
                    "WHERE job_id=? AND state='PENDING'",
                    (json.dumps({"stage": "begin"}), time.time(), job_id),
                )
                return cur.rowcount == 1

    def _run(self, job_id: str, task_name: str, payload: Dict) -> None:
        if not self._claim(job_id):
            return  # a peer worker process won the claim

        def progress(stage: str, **extra) -> None:
            self._set_state(job_id, "PROGRESS", {"stage": stage, **extra})

        try:
            handler = self._handlers.get(task_name)
            if handler is None:
                raise KeyError(f"no handler registered for {task_name!r}")
            result = handler(progress, **payload)
            self._set_state(job_id, "SUCCESS", {"stage": "done"}, result or {})
        except Exception as exc:
            logger.exception("job %s failed", job_id)
            self._set_state(
                job_id, "FAILURE",
                {"stage": "error", "error": str(exc),
                 "traceback": traceback.format_exc()[-2000:]},
                {},
            )

    def wait(self, job_id: str, timeout_sec: float = 60.0) -> Dict:
        """Test/CLI helper: poll until terminal state."""

        deadline = time.time() + timeout_sec
        while time.time() < deadline:
            st = self.status(job_id)
            if st["state"] in TERMINAL_STATES:
                return st
            time.sleep(0.05)
        return self.status(job_id)

    def claim_pending_once(self, wait: bool = True) -> int:
        """Worker-process drain: submit every PENDING job in the table to
        the worker pool (the api enqueued them; with TPU_JOB_WORKERS=0 it
        never runs them itself). Jobs run with concurrency = the pool's
        ``--workers`` size, so a 30-minute video ingest does not serialize
        the queue behind it. Returns the
        number of jobs submitted; ``wait=True`` blocks until they finish."""

        with self._lock:
            if self._closed:
                return 0
            rows = self._conn.execute(
                "SELECT job_id, task, payload FROM jobs WHERE state='PENDING' "
                "AND task IS NOT NULL ORDER BY created_at"
            ).fetchall()
        futures = []
        for job_id, task, payload in rows:
            if self.status(job_id)["state"] != "PENDING":
                continue
            fut = self._submit(job_id, task, json.loads(payload or "{}"))
            if fut is not None:
                futures.append(fut)
        if wait:
            for fut in futures:
                fut.result()
        return len(futures)

    def worker_loop(self, poll_sec: float = 1.0, stop_event=None) -> None:
        """Poll-and-claim loop for a dedicated worker process."""

        logger.info("worker loop polling every %.1fs", poll_sec)
        while stop_event is None or not stop_event.is_set():
            if self._closed:
                return
            try:
                # non-blocking: keep claiming while workers chew on long
                # ingests, so all --workers slots stay busy
                if self.claim_pending_once(wait=False) == 0:
                    time.sleep(poll_sec)
            except sqlite3.Error:
                logger.exception("worker poll failed; retrying")
                time.sleep(poll_sec)

    def shutdown(self, wait: bool = False) -> None:
        """wait=True drains in-flight jobs (graceful server shutdown);
        wait=False cancels queued work and returns immediately."""

        self._pool.shutdown(wait=wait, cancel_futures=not wait)
        with self._lock:
            self._closed = True
            self._conn.close()


def make_job_queue(cfg: Optional[Settings] = None, workers: Optional[int] = None) -> LocalJobQueue:
    """Celery-over-Redis when importable+configured, else the local queue.

    Celery support degrades silently to local (the reference's own
    Redis->in-memory fallback pattern, ``api/routes.py:68-77``).
    """

    cfg = cfg or _default_settings
    if workers is None:
        # TPU_JOB_WORKERS=0 -> enqueue-only api; a dedicated worker process
        # (python -m mmrag_tpu_torch.serving.jobs worker) claims and runs jobs —
        # the reference's api/Celery-worker topology. Flows through the
        # typed Settings loader like every other TPU_* knob, so explicit
        # env mappings (tests, bench harnesses) control it too.
        workers = cfg.tpu.job_workers
    try:  # pragma: no cover - exercised only when celery+redis exist
        import celery  # type: ignore  # noqa: F401
        import redis  # type: ignore

        redis.Redis.from_url(cfg.api.redis_url, socket_connect_timeout=1).ping()
        logger.info("redis reachable — but celery transport wiring is deferred; "
                    "using local queue with redis-backed kv")
    except Exception:
        pass
    return LocalJobQueue(
        os.path.join(cfg.paths.ingest_cache_dir, "jobs.db"),
        workers=workers,
        result_ttl_sec=cfg.cache.job_result_ttl_sec,
    )


def _worker_main(argv=None) -> None:
    """``python -m mmrag_tpu_torch.serving.jobs worker`` — the docker-compose
    worker service: claims jobs the api enqueued into the shared jobs.db and
    drives the full ingest pipeline (reference Celery worker role;
    ``--pool=solo`` accepted for compose-file parity, concurrency comes from
    ``--workers``)."""

    import argparse

    parser = argparse.ArgumentParser(prog="mmrag_tpu_torch.serving.jobs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker")
    w.add_argument("--workers", type=int, default=1)
    w.add_argument("--pool", default="solo")  # reference CLI compatibility
    w.add_argument("--poll-sec", type=float, default=1.0)
    w.add_argument("-l", "--loglevel", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(level=getattr(logging, args.loglevel.upper(), logging.INFO))
    import signal
    import threading

    from ..rag.engine import get_engine
    from ..storage.kv import KVStore
    from .tasks import ingest_youtube_task

    engine = get_engine()
    kv = KVStore(os.path.join(engine.cfg.paths.ingest_cache_dir, "control.db"))
    queue = make_job_queue(engine.cfg, workers=args.workers)

    def handler(progress, user_id: str, url: str):
        return ingest_youtube_task(
            progress, user_id=user_id, url=url, engine=engine, kv=kv
        )

    queue.register("ingest_youtube", handler)

    # Celery-style warm shutdown (the compose `docker compose down` path):
    # stop claiming, DRAIN in-flight ingests (they mutate the index — and a
    # pool thread killed inside a device call at teardown can abort the
    # process), persist, close.
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # pragma: no cover - non-main-thread embed
            pass
    try:
        queue.worker_loop(poll_sec=args.poll_sec, stop_event=stop)
    finally:
        logger.info("worker draining in-flight jobs and shutting down")
        queue.shutdown(wait=True)
        engine.persist_indexes()
        engine.close()
        kv.close()
        logger.info("worker shutdown complete")


if __name__ == "__main__":  # pragma: no cover - process entrypoint
    _worker_main()
