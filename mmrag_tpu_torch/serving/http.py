"""HTTP serving layer: the reference's 9-endpoint FastAPI contract, stdlib-native.

Same paths, methods, headers, status codes, and JSON shapes as
``api/routes.py:94-282``:

  GET  /healthz                       liveness (``:94-96``)
  POST /process-pdf[/]                sync PDF ingest, multipart upload (``:99-164``)
  POST /process-youtube/              form-encoded enqueue (``:188-191``)
  POST /ingest-youtube, /ingest/youtube   JSON enqueue (``:194-198``)
  GET  /yt_status/{id}, /ingest/status/{id}  job polling + stage->pct (``:214-228``)
  GET  /videos/                       per-user video list (``:231-234``)
  GET  /videos/{id}/notes             notes payload (``:237-243``)
  GET  /videos/{id}/quiz              quiz payload (``:246-252``)
  POST /chat_pro, /chat/              retrieval-grounded chat (``:265-282``)

Auth: ``X-API-Key`` -> tenant id (``:34,47-51``; 401 on miss). Rate limit:
per-key sliding window, 60/min default (``:39-44``; 429 on breach).
Idempotency-Key replays the first 202 (``:54-77,171-184``). Request-id
logging middleware mirrors ``app/main.py:30-41``.

Built on ``http.server.ThreadingHTTPServer`` because FastAPI/uvicorn are not
in this image; the request/response contract is byte-compatible, and an
ASGI adapter can be layered later without touching handlers. The ``video_id``
chat filter is pushed down into the retrieval mask (unlike the reference's
post-fusion filter, ``:272-279``).

Port of ``mmrag_tpu/serving/http.py``. Every handler thread, the job
workers and the batchers' runners issue their card work on the one default
stream, so a slab that a concurrent upsert frees is reused only after the
kernels queued before it have read it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .. import cache
from ..rag import generate, index_build, retrieve
from ..rag.engine import RagEngine, get_engine
from ..settings import Settings, settings as _default_settings
from ..storage.kv import KVStore
from ..storage.records import Document, new_id
from ..utils import profiling
from ..utils.profiling import stage
from .jobs import LocalJobQueue, make_job_queue
from .tasks import ingest_youtube_task

logger = logging.getLogger("mmrag_tpu_torch.http")


class RateLimiter:
    """Per-key sliding-window limiter (slowapi role, ``api/routes.py:39-44``)."""

    def __init__(self, per_minute: int) -> None:
        self.per_minute = per_minute
        self._hits: Dict[str, deque] = {}
        self._lock = threading.Lock()

    def allow(self, key: str) -> bool:
        now = time.monotonic()
        with self._lock:
            window = self._hits.setdefault(key, deque())
            while window and window[0] < now - 60.0:
                window.popleft()
            if len(window) >= self.per_minute:
                return False
            window.append(now)
            return True


class ApiContext:
    """Shared state for all request threads."""

    def __init__(
        self,
        cfg: Optional[Settings] = None,
        engine: Optional[RagEngine] = None,
        queue: Optional[LocalJobQueue] = None,
    ) -> None:
        self.cfg = cfg or _default_settings
        self.engine = engine or get_engine(self.cfg)
        self.queue = queue or make_job_queue(self.cfg)
        self.kv = KVStore(os.path.join(self.cfg.paths.ingest_cache_dir, "control.db"))
        self.limiter = RateLimiter(self.cfg.rate_limit.per_minute)
        self.queue.register("ingest_youtube", self._youtube_handler)

    def _youtube_handler(self, progress, user_id: str, url: str) -> Dict:
        return ingest_youtube_task(
            progress, user_id=user_id, url=url, engine=self.engine, kv=self.kv
        )

    def user_for_key(self, api_key: Optional[str]) -> Optional[str]:
        if not api_key:
            return None
        return self.cfg.api.api_keys.get(api_key)


class _BodyTooLarge(Exception):
    def __init__(self, length: int) -> None:
        super().__init__(f"request body of {length} bytes exceeds the limit")


_VIDEO_NOTES_RE = re.compile(r"^/videos/([^/]+)/notes/?$")
_VIDEO_QUIZ_RE = re.compile(r"^/videos/([^/]+)/quiz/?$")
_STATUS_RE = re.compile(r"^/(?:yt_status|ingest/status)/([^/]+)/?$")


class ApiHandler(BaseHTTPRequestHandler):
    server_version = "mmrag-tpu/0.1"
    # HTTP/1.1 persistent connections (uvicorn parity): every response path
    # is Content-Length-framed, so keep-alive is safe and saves a TCP
    # handshake + handler-thread spawn per request for pooling clients
    protocol_version = "HTTP/1.1"
    ctx: ApiContext  # injected by make_server

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-ID", getattr(self, "_request_id", "-"))
        self.end_headers()
        self.wfile.write(body)

    _MAX_BODY_BYTES = 64 * 1024 * 1024  # one request can't exhaust memory


    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length > self._MAX_BODY_BYTES:
            raise _BodyTooLarge(length)
        self._body_consumed = True
        return self.rfile.read(length) if length else b""

    def _drain_body(self) -> None:
        """Keep-alive hygiene: a handler that responded BEFORE consuming the
        request body (401 auth, 413 too-large, 404 route) leaves the body
        bytes in ``rfile``, where HTTP/1.1 framing would parse them as the
        next request line on the persistent connection. Discard a bounded
        body; anything unbounded (too large, or chunked encoding we don't
        parse) closes the connection instead — correctness over reuse."""

        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            return
        if getattr(self, "_body_consumed", False):
            return
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return
        if length > self._MAX_BODY_BYTES:
            self.close_connection = True
            return
        remaining = length
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                self.close_connection = True
                return
            remaining -= len(chunk)

    def _auth(self) -> Optional[str]:
        user = self.ctx.user_for_key(self.headers.get("X-API-Key"))
        if user is None:
            self._json(401, {"detail": "invalid or missing API key"})
            return None
        if not self.ctx.limiter.allow(self.headers.get("X-API-Key")):
            self._json(429, {"detail": "rate limit exceeded"})
            return None
        return user

    def _parse_multipart(self) -> Dict[str, Tuple[str, bytes]]:
        """Minimal multipart/form-data parser: {field: (filename, data)}."""

        ctype = self.headers.get("Content-Type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return {}
        boundary = m.group(1).encode()
        body = self._read_body()
        parts: Dict[str, Tuple[str, bytes]] = {}
        for chunk in body.split(b"--" + boundary):
            # strip exactly the framing CRLFs, never payload bytes: each part
            # is "\r\n<headers>\r\n\r\n<data>\r\n" (a trailing-newline PDF
            # must round-trip byte-identical)
            if chunk.startswith(b"\r\n"):
                chunk = chunk[2:]
            if not chunk or chunk.rstrip(b"\r\n-") == b"":
                continue
            if b"\r\n\r\n" not in chunk:
                continue
            header_blob, data = chunk.split(b"\r\n\r\n", 1)
            if data.endswith(b"\r\n"):
                data = data[:-2]
            headers = header_blob.decode(errors="ignore")
            name_m = re.search(r'name="([^"]+)"', headers)
            file_m = re.search(r'filename="([^"]*)"', headers)
            if name_m:
                # basename strips path-traversal components from the
                # client-controlled filename (../../ or absolute paths)
                fname = os.path.basename((file_m.group(1) if file_m else "").replace("\\", "/"))
                parts[name_m.group(1)] = (fname, data)
        return parts

    # -- request entry ------------------------------------------------------

    def do_GET(self):  # noqa: N802
        self._request_id = uuid.uuid4().hex[:8]
        path = self.path.split("?")[0]
        with stage("http.request", self._request_id, method="GET", path=path):
            self._get(path)

    def do_POST(self):  # noqa: N802
        self._request_id = uuid.uuid4().hex[:8]
        self._body_consumed = False
        path = self.path.split("?")[0]
        with stage("http.request", self._request_id, method="POST", path=path):
            self._post(path)

    def _get(self, path: str) -> None:
        started = time.monotonic()
        try:
            if path == "/healthz":
                from ..utils import watchdog

                return self._json(200, {"status": "ok", **watchdog.status()})
            if path in ("/", "/index.html"):
                return self._console()
            user = self._auth()
            if user is None:
                return
            if path in ("/metrics", "/metrics/"):
                query = self.path.partition("?")[2]
                accept = self.headers.get("Accept", "")
                # real scrapers send `text/plain;version=0.0.4` with NO
                # space after the semicolon — normalize before matching
                accept_c = accept.replace(" ", "")
                if (
                    "format=prometheus" in query
                    or "application/openmetrics-text" in accept_c
                    or "text/plain;version=0.0.4" in accept_c
                ):
                    body = profiling.metrics.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header(
                        "X-Request-ID", getattr(self, "_request_id", "-")
                    )
                    self.end_headers()
                    self.wfile.write(body)
                    return
                return self._json(200, profiling.metrics.summary())
            if path in ("/videos", "/videos/"):
                return self._json(
                    200, {"videos": self.ctx.engine.notes.list_videos(user)}
                )
            m = _VIDEO_NOTES_RE.match(path)
            if m:
                notes = self.ctx.engine.notes.get_video(user, m.group(1))
                if notes is None:
                    return self._json(404, {"detail": "no notes for video"})
                return self._json(200, notes)
            m = _VIDEO_QUIZ_RE.match(path)
            if m:
                quiz = self.ctx.engine.notes.get_quiz(user, m.group(1))
                if quiz is None:
                    return self._json(404, {"detail": "no quiz for video"})
                return self._json(200, {"video_id": m.group(1), "quiz": quiz})
            m = _STATUS_RE.match(path)
            if m:
                status = dict(self.ctx.queue.status(m.group(1)))
                # reference payload compat (api/routes.py:214-228): meta keys
                # flattened, then SUCCESS result keys OVERWRITE them (the
                # reference's body.update(meta); body.update(payload) order —
                # final results must win over stale mid-progress extras),
                # progress under "progress_pct"; our canonical keys protected
                core = {"job_id", "state", "meta", "result", "pct"}
                for k, v in (status.get("meta") or {}).items():
                    if k not in core:
                        status[k] = v
                if status.get("state") == "SUCCESS" and isinstance(status.get("result"), dict):
                    for k, v in status["result"].items():
                        if k not in core:
                            status[k] = v
                status["progress_pct"] = status.get("pct", 0)
                return self._json(200, status)
            return self._json(404, {"detail": f"no route for {path}"})
        except Exception as exc:
            logger.exception("GET %s failed", path)
            return self._json(500, {"detail": str(exc)})
        finally:
            logger.info(
                "rid=%s GET %s %.0fms", self._request_id, path,
                (time.monotonic() - started) * 1e3,
            )

    def _post(self, path: str) -> None:
        started = time.monotonic()
        try:
            if self.headers.get("Transfer-Encoding"):
                # we frame strictly by Content-Length; a chunked body would
                # desync the persistent connection if silently ignored
                self.close_connection = True
                return self._json(
                    411, {"detail": "chunked bodies unsupported; send "
                                    "Content-Length"})
            user = self._auth()
            if user is None:
                return
            if path in ("/process-pdf", "/process-pdf/"):
                return self._process_pdf(user)
            if path in ("/process-youtube", "/process-youtube/",
                        "/ingest-youtube", "/ingest/youtube"):
                return self._enqueue_youtube(user)
            if path in ("/chat_pro", "/chat", "/chat/"):
                return self._chat(user)
            return self._json(404, {"detail": f"no route for {path}"})
        except _BodyTooLarge as exc:
            return self._json(413, {"detail": str(exc)})
        except Exception as exc:
            logger.exception("POST %s failed", path)
            return self._json(500, {"detail": str(exc)})
        finally:
            try:
                self._drain_body()
            except Exception:
                self.close_connection = True
            logger.info(
                "rid=%s POST %s %.0fms", self._request_id, path,
                (time.monotonic() - started) * 1e3,
            )

    # -- endpoints ----------------------------------------------------------

    def _process_pdf(self, user: str) -> None:
        from ..ingest.pdf import PdfExtractionError, extract_pdf_nodes

        parts = self._parse_multipart()
        if "file" not in parts:
            return self._json(400, {"detail": "multipart field 'file' required"})
        filename, data = parts["file"]
        ext = os.path.splitext(filename or "upload.pdf")[1].lower()
        if ext not in self.ctx.cfg.uploads.allowed_exts:
            return self._json(
                400, {"detail": f"extension {ext!r} not allowed"}
            )
        document_id = new_id()
        upload_dir = os.path.join(
            self.ctx.cfg.paths.ingest_cache_dir, "uploads", user, document_id
        )
        os.makedirs(upload_dir, exist_ok=True)
        pdf_path = os.path.join(upload_dir, filename or "upload.pdf")
        with open(pdf_path, "wb") as fh:
            fh.write(data)

        engine = self.ctx.engine
        engine.metadata.upsert_document(
            Document(
                document_id=document_id, user_id=user, doc_type="pdf",
                title=filename or document_id, source=pdf_path, status="processing",
            )
        )
        try:
            with stage("pdf.extract"):
                text_nodes, image_nodes = extract_pdf_nodes(
                    user, document_id, pdf_path, self.ctx.cfg
                )
        except PdfExtractionError as exc:
            engine.metadata.set_document_status(document_id, "failed")
            return self._json(400, {"detail": str(exc)})
        try:
            with stage("pdf.index_text"):
                n_text = index_build.index_text_nodes(user, text_nodes, engine)
            with stage("pdf.index_images"):
                n_images = index_build.index_image_nodes(user, image_nodes, engine)
        except Exception:
            # never leave the catalog stuck in "processing" (the 500 from
            # do_POST carries the error to the client)
            engine.metadata.set_document_status(document_id, "failed")
            raise
        engine.metadata.set_document_status(document_id, "ready")
        engine.persist_indexes()
        return self._json(
            200,
            {
                "document_id": document_id,
                "status": "ok",  # reference payload value (api/routes.py:161)
                "document_status": "ready",
                "text_nodes": n_text,
                "image_nodes": n_images,
                # reference payload keys (api/routes.py:160-164)
                "text_chunks_indexed": n_text,
                "images_indexed": n_images,
            },
        )

    def _enqueue_youtube(self, user: str) -> None:
        ctype = self.headers.get("Content-Type", "")
        body = self._read_body()
        url = ""
        if "application/json" in ctype:
            try:
                url = (json.loads(body or b"{}").get("url") or "").strip()
            except json.JSONDecodeError:
                return self._json(400, {"detail": "invalid JSON body"})
        else:  # form-encoded (reference /process-youtube/)
            from urllib.parse import parse_qs

            url = (parse_qs(body.decode(errors="ignore")).get("url", [""])[0]).strip()
        if not url:
            return self._json(400, {"detail": "url is required"})

        idem = self.headers.get("Idempotency-Key")
        if idem:
            # atomic reservation (SETNX) closes the get-then-set race the
            # reference has (api/routes.py:171-184): exactly one concurrent
            # retry wins and enqueues; losers replay the winner's payload
            idem_key = f"idem:{user}:{idem}"
            reserved = json.dumps({"state": "PENDING", "reserved": True})
            if not self.ctx.kv.set_if_absent(idem_key, 3600.0, reserved):
                existing = reserved
                for _ in range(100):  # winner is mid-enqueue; wait <=1 s
                    existing = self.ctx.kv.get(idem_key) or reserved
                    if not json.loads(existing).get("reserved"):
                        break
                    time.sleep(0.01)
                return self._json(202, json.loads(existing))
        job_id = self.ctx.queue.enqueue(
            "ingest_youtube", {"user_id": user, "url": url}
        )
        payload = {"job_id": job_id, "state": "PENDING"}
        if idem:
            self.ctx.kv.setex(idem_key, 3600.0, json.dumps(payload))
        return self._json(202, payload)

    def _chat(self, user: str) -> None:
        try:
            body = json.loads(self._read_body() or b"{}")
        except json.JSONDecodeError:
            return self._json(400, {"detail": "invalid JSON body"})
        query = (body.get("query") or body.get("message") or "").strip()
        if not query:
            return self._json(400, {"detail": "query is required"})
        video_id = body.get("video_id") or None
        engine = self.ctx.engine
        app_cfg = self.ctx.cfg

        # 60 s whole-response cache keyed (user, normalized query,
        # index_version, video_id) — the reference's @chat_cache
        # (api/routes.py:274, app/cache/__init__.py:86-111); saves the
        # Gemini round-trip, not just retrieval
        @cache.chat_cache(lambda u: engine.versions.get(u))
        def _cached_chat(user_id: str, q: str, video_id=None):
            with stage("chat.retrieve"):
                retrieved = retrieve.retrieve(
                    user_id, q, engine, document_id=video_id
                )
            with stage("chat.generate"):
                resp = generate.generate_response(
                    q, retrieved["results"], app_cfg
                )
            resp["results"] = retrieved["results"]
            resp["index_version"] = retrieved["index_version"]
            return resp

        with stage("chat"):
            response = _cached_chat(user, query, video_id=video_id)
        return self._json(200, response)

    def _console(self) -> None:
        from .console import CONSOLE_HTML

        body = CONSOLE_HTML.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def make_server(
    host: str = "127.0.0.1",
    port: int = 8000,
    cfg: Optional[Settings] = None,
    engine: Optional[RagEngine] = None,
    queue: Optional[LocalJobQueue] = None,
) -> ThreadingHTTPServer:
    ctx = ApiContext(cfg, engine, queue)
    handler = type("BoundApiHandler", (ApiHandler,), {"ctx": ctx})

    class _Server(ThreadingHTTPServer):
        # stdlib default listen backlog is 5: a burst of concurrent clients
        # (the serving-load shape, 16 simultaneous connects) overflows the
        # SYN queue and the kernel RSTs the excess. The reference runs
        # uvicorn, whose default backlog is 2048 — match it.
        request_queue_size = 2048

    server = _Server((host, port), handler)
    server.ctx = ctx  # type: ignore[attr-defined]
    return server


def serve_forever(host: str = "0.0.0.0", port: int = 8000, device=None) -> None:
    """Serve until SIGTERM / SIGINT. ``device``: the engine's torch device
    (the card unless ``"cpu"`` is asked for)."""

    import signal
    import threading

    server = make_server(host, port, engine=get_engine(device=device))
    ctx0 = server.ctx  # type: ignore[attr-defined]
    warm_stop = threading.Event()
    warm_thread = None
    if ctx0.cfg.tpu.serving_warmup:
        # warm in the background so /healthz (compose healthchecks) responds
        # immediately; the first launches build and load the kernels
        def _warm():
            try:
                n = ctx0.engine.warmup_serving(stop=warm_stop)
                logger.info(
                    "serving warmup: %d query-path dispatches run", n
                )
            except Exception:
                logger.exception("serving warmup failed (continuing)")

        warm_thread = threading.Thread(
            target=_warm, name="serving-warmup", daemon=True
        )
        warm_thread.start()

    from ..utils.watchdog import start_watchdog

    start_watchdog(ctx0.cfg.tpu.device_watchdog_sec)

    def _graceful(signum, _frame):
        logger.info("signal %s: draining jobs and shutting down", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _graceful)
        except ValueError:  # non-main thread (embedded use)
            pass
    logger.info("serving on %s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        ctx = server.ctx  # type: ignore[attr-defined]
        # a daemon thread inside a device call at interpreter teardown can
        # abort the process: stop warmup at its next bucket boundary and
        # join (bounded), and stop the watchdog
        warm_stop.set()
        if warm_thread is not None:
            warm_thread.join(timeout=120.0)
        from ..utils.watchdog import stop_watchdog

        stop_watchdog()
        try:
            # order matters: stop accepting work, drain in-flight ingest jobs
            # (they mutate the index), THEN snapshot, THEN close the stores
            ctx.queue.shutdown(wait=True)
            ctx.engine.persist_indexes()
        finally:
            ctx.engine.close()
            server.server_close()
            if ctx.cfg.tpu.profile_dir:  # TPU_PROFILE_DIR: the span ring, for chrome://tracing
                path = os.path.join(ctx.cfg.tpu.profile_dir, f"spans-{os.getpid()}.json")
                logger.info("wrote %d spans to %s", profiling.write_chrome_trace(path), path)
        logger.info("shutdown complete")
