"""The port's HTTP API: auth, rate limit, PDF ingest, YouTube job flow, chat,
notes — the cases of ``tests/test_serving.py`` against
``mmrag_tpu_torch.serving``, on the CPU, plus a parity case against the JAX
package's server.

The port's server runs a tiny engine under the default serving settings
(``TPU_MICROBATCH_WINDOW_MS=4``, 3 workers), so every ``/chat_pro`` here goes
through the coalescing retrieval batcher. The parity case sends the same PDF
bytes and the same queries to the JAX server and the port's server over the
same weights (f32 on both) and holds the ``/chat_pro`` payloads equal:
``response``, citations and result ids in order, scores within 1e-4."""

import json
import os
import threading
import zlib

import httpx
import numpy as np
import pytest

from mmrag_tpu_torch.ingest.youtube import TranscriptSegment
from mmrag_tpu_torch.serving.http import make_server
from mmrag_tpu_torch.serving.jobs import LocalJobQueue

from tiny_torch import jax_tiny_engine, tiny_engine, write_tiny_weights

SCORE_TOL = 1e-4  # f32 encoders on both sides; kernels' plain versions agree to ~1e-6


def _make_pdf_bytes(texts):
    objects, kids, next_id = [], [], 3
    for text in texts:
        comp = zlib.compress(f"BT ({text}) Tj ET".encode())
        kids.append(next_id)
        objects.append((next_id, f"<< /Type /Page /Contents {next_id+1} 0 R >>".encode()))
        objects.append((next_id + 1, b"<< /Filter /FlateDecode >>\nstream\n" + comp + b"\nendstream"))
        next_id += 2
    refs = " ".join(f"{k} 0 R" for k in kids)
    body = b"%PDF-1.4\n"
    for num, payload in [(1, b"<< /Type /Catalog >>"),
                         (2, f"<< /Type /Pages /Kids [{refs}] >>".encode())] + objects:
        body += f"{num} 0 obj\n".encode() + payload + b"\nendobj\n"
    return body + b"%%EOF"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_tiny_weights(tmp_path_factory.mktemp("tiny_weights"))


@pytest.fixture(autouse=True)
def _clear_port_caches():
    from mmrag_tpu_torch.cache import clear_all_caches

    clear_all_caches()
    yield
    clear_all_caches()


def _serve(engine, queue):
    server = make_server("127.0.0.1", 0, cfg=engine.cfg, engine=engine, queue=queue)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture()
def api(tmp_path, monkeypatch, weights):
    engine = tiny_engine(tmp_path, weights)
    queue = LocalJobQueue(str(tmp_path / "jobs.db"), workers=1)
    server = _serve(engine, queue)
    port = server.server_address[1]

    # fake the network-bound ladder stages (reference monkeypatch seam)
    from mmrag_tpu_torch.serving import tasks as task_mod

    def fake_ladder(url, work_dir, cfg, **kwargs):
        return {
            "video_id": "dQw4w9WgXcQ",
            "segments": [
                TranscriptSegment("cells make energy", 0.0, 5.0),
                TranscriptSegment("the krebs cycle explained", 5.0, 5.0),
            ],
            "source": "transcript",
        }

    def fake_info(url, cfg):
        return {"video_id": "dQw4w9WgXcQ", "title": "Bio video", "duration": 120}

    monkeypatch.setattr(task_mod.yt, "transcript_or_fallback", fake_ladder)
    monkeypatch.setattr(task_mod.yt, "fetch_video_info", fake_info)

    client = httpx.Client(
        base_url=f"http://127.0.0.1:{port}", headers={"X-API-Key": "test-key"}, timeout=120.0,
    )
    yield client, queue
    client.close()
    server.shutdown()
    queue.shutdown()
    engine.close()


def test_healthz_unauthenticated(api):
    client, _ = api
    res = httpx.get(str(client.base_url) + "/healthz", timeout=10)
    body = res.json()
    assert res.status_code == 200 and body["status"] == "ok"
    # device-health watchdog view (off in tests -> unknown)
    assert body["device"] in ("ok", "wedged", "unknown")


def test_auth_required(api):
    client, _ = api
    res = httpx.post(str(client.base_url) + "/chat_pro", json={"query": "x"}, timeout=10)
    assert res.status_code == 401
    res = httpx.get(str(client.base_url) + "/videos/", headers={"X-API-Key": "wrong"}, timeout=10)
    assert res.status_code == 401


def test_unknown_route(api):
    client, _ = api
    assert client.get("/nope").status_code == 404
    assert client.post("/nope").status_code == 404


def test_metrics_json_and_prometheus(api):
    client, _ = api
    from mmrag_tpu_torch.utils.profiling import metrics

    metrics.reset()
    metrics.incr("test.scrape")
    metrics.observe("test.scrape", 0.012)

    res = client.get("/metrics")
    assert res.status_code == 200
    assert res.headers["content-type"].startswith("application/json")
    body = res.json()
    assert body["counters"]["test.scrape"] == 1
    assert body["latency_ms"]["test.scrape"]["count"] == 1

    res = client.get("/metrics?format=prometheus")
    assert res.status_code == 200
    assert res.headers["content-type"].startswith("text/plain; version=0.0.4")
    # a real Prometheus scraper's Accept has no space after the semicolons
    res_h = client.get("/metrics", headers={"Accept": "text/plain;version=0.0.4;q=0.5,*/*;q=0.1"})
    assert res_h.status_code == 200
    assert res_h.headers["content-type"].startswith("text/plain; version=0.0.4")
    assert "# TYPE mmrag_test_scrape_total counter" in res_h.text
    text = res.text
    assert "mmrag_test_scrape_total 1" in text
    assert 'mmrag_test_scrape_latency_ms{quantile="0.5"} 12.0' in text
    assert "mmrag_test_scrape_latency_ms_count 1" in text
    res = client.get("/metrics", headers={"Accept": "application/openmetrics-text;version=1.0.0"})
    assert res.headers["content-type"].startswith("text/plain")
    assert "mmrag_test_scrape_total" in res.text


def test_process_pdf_and_chat(api):
    client, _ = api
    pdf = _make_pdf_bytes(["The mitochondria is the powerhouse of the cell"])
    res = client.post("/process-pdf/", files={"file": ("bio.pdf", pdf, "application/pdf")})
    assert res.status_code == 200, res.text
    out = res.json()
    assert out["status"] == "ok" and out["text_nodes"] >= 1
    assert out["text_chunks_indexed"] == out["text_nodes"]
    assert out["document_status"] == "ready"
    res = client.post("/chat_pro", json={"query": "what is the powerhouse of the cell?"})
    assert res.status_code == 200
    chat = res.json()
    assert "answer" in chat and "citations" in chat and "abstained" in chat
    assert chat["results"] is not None
    # reference /chat_pro payload contract (api/routes.py:265-282)
    assert chat["response"] == chat["answer"]
    assert set(chat["citations"].keys()) == {"text", "images"}


def test_process_pdf_and_chat_pq_index(tmp_path, weights):
    """The full HTTP contract over the product-quantized index layout."""

    engine = tiny_engine(tmp_path, weights, extra_env={"TPU_INDEX_DTYPE": "pq"})
    assert engine.text_index.is_pq
    queue = LocalJobQueue(str(tmp_path / "jobs.db"), workers=1)
    server = _serve(engine, queue)
    client = httpx.Client(base_url=f"http://127.0.0.1:{server.server_address[1]}",
                          headers={"X-API-Key": "test-key"}, timeout=120.0)
    try:
        pdf = _make_pdf_bytes(["The mitochondria is the powerhouse of the cell"])
        res = client.post("/process-pdf/", files={"file": ("bio.pdf", pdf, "application/pdf")})
        assert res.status_code == 200, res.text
        assert res.json()["document_status"] == "ready"
        res = client.post("/chat_pro", json={"query": "what is the powerhouse of the cell?"})
        assert res.status_code == 200
        chat = res.json()
        assert chat["results"] is not None and "citations" in chat
    finally:
        client.close()
        server.shutdown()
        queue.shutdown()
        engine.close()


def test_chat_response_cached_for_identical_query(api, monkeypatch):
    from mmrag_tpu_torch.rag import generate as gen_mod

    client, _ = api
    pdf = _make_pdf_bytes(["Golgi apparatus packages proteins"])
    assert client.post("/process-pdf/",
                       files={"file": ("g.pdf", pdf, "application/pdf")}).status_code == 200
    calls = {"n": 0}
    real = gen_mod.generate_response

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(gen_mod, "generate_response", counting)
    q = {"query": "what packages proteins?"}
    first = client.post("/chat_pro", json=q).json()
    second = client.post("/chat_pro", json=q).json()
    assert calls["n"] == 1
    assert first == second


def test_process_pdf_sanitizes_traversal_filename(api):
    client, _ = api
    pdf = _make_pdf_bytes(["escape attempt"])
    res = client.post("/process-pdf/",
                      files={"file": ("../../../../tmp/evil-escape-torch.pdf", pdf,
                                      "application/pdf")})
    assert res.status_code == 200
    assert not os.path.exists("/tmp/evil-escape-torch.pdf")


def test_process_pdf_preserves_trailing_newlines(api, monkeypatch):
    from mmrag_tpu_torch.ingest import pdf as pdf_mod

    client, _ = api
    payload = _make_pdf_bytes(["newline tail"]) + b"\r\n\r\n\n"
    seen = {}
    real = pdf_mod.extract_pdf_nodes

    def capture(user, doc, path, cfg):
        seen["bytes"] = open(path, "rb").read()
        return real(user, doc, path, cfg)

    monkeypatch.setattr(pdf_mod, "extract_pdf_nodes", capture)
    res = client.post("/process-pdf/", files={"file": ("t.pdf", payload, "application/pdf")})
    assert res.status_code == 200
    assert seen["bytes"] == payload


def test_request_body_size_limit(api):
    import socket

    client, _ = api
    host, port = client.base_url.host, client.base_url.port
    with socket.create_connection((host, port), timeout=10) as sock:
        sock.sendall(
            b"POST /chat_pro HTTP/1.1\r\n"
            b"Host: x\r\nX-API-Key: test-key\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: 209715200\r\n\r\n"
        )
        status = sock.recv(4096).split(b"\r\n", 1)[0]
    assert b"413" in status


def test_process_pdf_rejects_bad_ext(api):
    client, _ = api
    res = client.post("/process-pdf/", files={"file": ("evil.exe", b"x", "application/foo")})
    assert res.status_code == 400


def test_process_pdf_requires_file_field(api):
    client, _ = api
    res = client.post("/process-pdf/", files={"other": ("a.pdf", b"%PDF", "application/pdf")})
    assert res.status_code == 400


def test_chat_requires_query(api):
    client, _ = api
    assert client.post("/chat_pro", json={}).status_code == 400
    assert client.post("/chat_pro", content=b"not json",
                       headers={"Content-Type": "application/json"}).status_code == 400


def test_youtube_job_flow_and_notes(api):
    client, queue = api
    res = client.post("/ingest/youtube", json={"url": "https://youtu.be/dQw4w9WgXcQ"})
    assert res.status_code == 202
    job_id = res.json()["job_id"]
    final = queue.wait(job_id, timeout_sec=120)
    assert final["state"] == "SUCCESS", final
    assert final["result"]["text_nodes"] == 2

    st = client.get(f"/yt_status/{job_id}").json()
    assert st["state"] == "SUCCESS" and st["pct"] == 100
    assert st["progress_pct"] == 100
    assert st["text_nodes"] == 2
    st2 = client.get(f"/ingest/status/{job_id}").json()
    assert st2["state"] == "SUCCESS"

    videos = client.get("/videos/").json()["videos"]
    assert videos and videos[0]["video_id"] == "dQw4w9WgXcQ"
    notes = client.get("/videos/dQw4w9WgXcQ/notes").json()
    assert notes["summary"]
    quiz = client.get("/videos/dQw4w9WgXcQ/quiz").json()
    assert "quiz" in quiz
    chat = client.post("/chat_pro", json={"query": "krebs cycle",
                                          "video_id": "dQw4w9WgXcQ"}).json()
    assert "answer" in chat
    assert all(h["document_id"] == "dQw4w9WgXcQ" for h in chat["results"])


def test_youtube_form_endpoint(api):
    client, _ = api
    res = client.post("/process-youtube/", data={"url": "https://youtu.be/dQw4w9WgXcQ"})
    assert res.status_code == 202


def test_youtube_requires_url(api):
    client, _ = api
    assert client.post("/ingest/youtube", json={}).status_code == 400


def test_idempotency_key_replays(api):
    client, _ = api
    headers = {"Idempotency-Key": "abc123"}
    first = client.post("/ingest/youtube", json={"url": "https://youtu.be/dQw4w9WgXcQ"},
                        headers=headers).json()
    second = client.post("/ingest/youtube", json={"url": "https://youtu.be/dQw4w9WgXcQ"},
                         headers=headers).json()
    assert first["job_id"] == second["job_id"]


def test_notes_404(api):
    client, _ = api
    assert client.get("/videos/unknown/notes").status_code == 404
    assert client.get("/videos/unknown/quiz").status_code == 404


def test_status_unknown_job_pending(api):
    client, _ = api
    st = client.get("/yt_status/doesnotexist").json()
    assert st["state"] == "PENDING"


def test_rate_limit(tmp_path, weights):
    engine = tiny_engine(tmp_path / "rl", weights, extra_env={"RATE_LIMIT_PER_MIN": "3"})
    queue = LocalJobQueue(str(tmp_path / "rl-jobs.db"))
    server = _serve(engine, queue)
    try:
        with httpx.Client(base_url=f"http://127.0.0.1:{server.server_address[1]}",
                          headers={"X-API-Key": "test-key"}, timeout=10) as client:
            codes = [client.get("/videos/").status_code for _ in range(5)]
        assert codes[:3] == [200, 200, 200] and 429 in codes[3:]
    finally:
        server.shutdown()
        queue.shutdown()
        engine.close()


def test_console_served(api):
    client, _ = api
    res = httpx.get(str(client.base_url) + "/", timeout=10)
    assert res.status_code == 200 and "Multimodal RAG" in res.text


def test_worker_process_claims_api_enqueued_jobs(tmp_path):
    db = str(tmp_path / "jobs.db")
    api_q = LocalJobQueue(db, workers=0)
    api_q.register("t", lambda progress, **kw: {"who": "api"})
    job = api_q.enqueue("t", {"x": 1})
    assert api_q.status(job)["state"] == "PENDING"

    runs = []
    worker_q = LocalJobQueue(db, workers=1)
    worker_q.register("t", lambda progress, **kw: (runs.append(kw), {"who": "worker", **kw})[1])
    assert worker_q.claim_pending_once() == 1
    st = api_q.status(job)
    assert st["state"] == "SUCCESS" and st["result"] == {"who": "worker", "x": 1}
    assert runs == [{"x": 1}]
    assert worker_q.claim_pending_once() == 0
    worker_q.shutdown()
    api_q.shutdown()


def test_batcher_records_coalescing_histogram():
    from mmrag_tpu_torch.serving.batcher import MicroBatcher

    b = MicroBatcher(lambda items: [i * 2 for i in items], max_batch=4, window_ms=50)
    results = []
    threads = [threading.Thread(target=lambda v=v: results.append(b.submit(v))) for v in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == [0, 2, 4, 6]
    assert sum(k * v for k, v in b.batch_sizes.items()) == 4
    b.close()


def test_worker_process_warm_shutdown(tmp_path):
    """SIGTERM to the dedicated worker process must drain and exit 0. The
    subprocess installs an engine on the CPU with ``set_engine`` before
    ``_worker_main`` asks for it (the counterpart of the JAX test forcing the
    CPU platform): the port's default engine is the card's."""

    import signal
    import subprocess
    import sys
    import time as _time

    env = dict(os.environ)
    env.update({
        "TPU_INDEX_DIR": str(tmp_path / "index"),
        "NOTES_DB_PATH": str(tmp_path / "notes.db"),
        "MEDIA_DIR": str(tmp_path / "media"),
        "INGEST_CACHE_DIR": str(tmp_path / "cache"),
        "TPU_SERVING_WARMUP": "0",
    })
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from mmrag_tpu_torch.rag.engine import RagEngine, set_engine\n"
         "set_engine(RagEngine(device='cpu'))\n"
         "from mmrag_tpu_torch.serving.jobs import _worker_main\n"
         "_worker_main(['worker', '--poll-sec', '0.1'])"],
        env=env, stderr=subprocess.PIPE, text=True,
    )
    deadline = _time.monotonic() + 120
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if "worker loop polling" in line:
            break
        assert _time.monotonic() < deadline, "".join(lines)
    proc.send_signal(signal.SIGTERM)
    try:
        rest = proc.communicate(timeout=60)[1]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, (proc.returncode, rest[-2000:])
    assert "worker shutdown complete" in rest
    assert "jax" not in rest.lower()


def test_keepalive_after_early_response_drains_body(api):
    client, _ = api
    payload = json.dumps({"query": "x" * 5000})
    r1 = client.post("/chat_pro", content=payload,
                     headers={"X-API-Key": "wrong-key", "Content-Type": "application/json"})
    assert r1.status_code == 401
    assert client.get("/videos/").status_code == 200

    def chunks():
        yield b'{"query": "hi"}'

    r3 = client.post("/chat_pro", content=chunks(), headers={"Content-Type": "application/json"})
    assert r3.status_code == 411
    assert client.get("/videos/").status_code == 200


PARITY_PAGES = [
    "The mitochondria is the powerhouse of the cell and makes ATP",
    "Chloroplasts capture light energy in plant cells",
    "The Golgi apparatus packages proteins for transport",
    "Ribosomes translate messenger RNA into proteins",
]
PARITY_QUERIES = ["what is the powerhouse of the cell?", "how do plants capture light?",
                  "which organelle packages proteins", "protein translation"]


def test_chat_payloads_match_the_jax_server(tmp_path, weights, monkeypatch):
    """The same PDF bytes and queries through the JAX package's server and
    the port's, over the same weights: equal ``/chat_pro`` payloads."""

    from mmrag_tpu.cache import clear_all_caches as jclear
    from mmrag_tpu.serving import http as jhttp
    from mmrag_tpu.serving.jobs import LocalJobQueue as JQueue
    from mmrag_tpu_torch.serving import http as thttp

    # document ids are random per upload: pin them so both servers cite the same ids
    for mod in (jhttp, thttp):
        monkeypatch.setattr(mod, "new_id", lambda: "doc-parity")
    jclear()
    pdf = _make_pdf_bytes(PARITY_PAGES)
    payloads = {}
    for name, make, Queue, mk in (
        ("jax", jax_tiny_engine, JQueue, jhttp.make_server),
        ("torch", tiny_engine, LocalJobQueue, thttp.make_server),
    ):
        engine = make(tmp_path / name, weights)
        queue = Queue(str(tmp_path / f"{name}-jobs.db"), workers=1)
        server = mk("127.0.0.1", 0, cfg=engine.cfg, engine=engine, queue=queue)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            with httpx.Client(base_url=f"http://127.0.0.1:{server.server_address[1]}",
                              headers={"X-API-Key": "test-key"}, timeout=300.0) as client:
                res = client.post("/process-pdf/",
                                  files={"file": ("cells.pdf", pdf, "application/pdf")})
                assert res.status_code == 200, res.text
                payloads[name] = [client.post("/chat_pro", json={"query": q}).json()
                                  for q in PARITY_QUERIES]
        finally:
            server.shutdown()
            queue.shutdown()
            engine.close()
    for got, want in zip(payloads["torch"], payloads["jax"]):
        assert got["results"], got
        for key in ("response", "citations", "abstained", "snippets"):
            assert got[key] == want[key], key
        assert [h["chunk_id"] for h in got["results"]] == [h["chunk_id"] for h in want["results"]]
        np.testing.assert_allclose([h["score"] for h in got["results"]],
                                   [h["score"] for h in want["results"]], atol=SCORE_TOL)
        assert ([t["token"] for t in got["citation_tokens"]]
                == [t["token"] for t in want["citation_tokens"]])
