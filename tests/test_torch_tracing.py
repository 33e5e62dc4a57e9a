"""The port's span recorder (``mmrag_tpu_torch.utils.profiling``): spans nest
by parent id, a request's id crosses the micro-batcher's threads, the
``stage.*`` observations the benchmark reads still reach a patched
``metrics.observe``, the ring stays bounded and is stamped on the monotonic
clock, collections are recorded and counted, one ``/chat_pro`` carries one
request id from the HTTP handler to the batch runner's ``retrieve.*``
spans, ``/metrics`` counts every observation, and ``TPU_PROFILE_DIR`` gets
the ring as a Chrome trace when the server shuts down. No timing
thresholds."""

import gc
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import httpx

from mmrag_tpu_torch.serving.batcher import MicroBatcher
from mmrag_tpu_torch.utils import profiling
from mmrag_tpu_torch.utils.profiling import stage

from test_torch_serving import _clear_port_caches, _make_pdf_bytes, api, weights  # noqa: F401

SID, PARENT, RID, NAME, TID, START, END, ITEMS, ATTRS = range(len(profiling.FIELDS))


def _mine(since: float):
    return [r for r in profiling.records() if r[START] >= since]


def _attr(record, key):
    return dict(record[ATTRS] or ()).get(key)


def test_spans_nest_with_parent_ids():
    since = time.monotonic()
    with stage("outer", "req-1") as outer:
        with stage("middle", items=3, model="minilm") as middle:
            with stage("inner") as inner:
                pass
        with stage("sibling") as sibling:
            sibling.items = 7
    assert profiling.current() == (0, None)
    by = {r[NAME]: r for r in _mine(since)}
    assert by["outer"][PARENT] == 0 and by["outer"][SID] == outer.sid
    assert by["middle"][PARENT] == outer.sid and by["inner"][PARENT] == middle.sid
    assert by["sibling"][PARENT] == outer.sid and by["sibling"][ITEMS] == 7
    assert {by[n][RID] for n in by} == {"req-1"}
    assert by["middle"][ITEMS] == 3 and _attr(by["middle"], "model") == "minilm"
    assert by["inner"][SID] == inner.sid
    assert by["outer"][START] <= by["middle"][START] <= by["inner"][START]
    assert by["inner"][END] <= by["middle"][END] <= by["sibling"][START] <= by["outer"][END]


def test_batcher_carries_each_request_id():
    def work(items):
        with stage("work"):
            return [i * 2 for i in items]

    since = time.monotonic()
    batcher = MicroBatcher(work, max_batch=4, window_ms=20, name="traced", workers=3)
    results, opened = {}, {}
    barrier = threading.Barrier(10)

    def client(i):
        with stage("client", f"r{i}") as span:
            opened[f"r{i}"] = span.sid
            barrier.wait(timeout=30)
            results[i] = batcher.submit(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert results == {i: i * 2 for i in range(10)}
    mine = _mine(since)
    waits = [r for r in mine if r[NAME] == "queue_wait.traced"]
    assert sorted(r[RID] for r in waits) == sorted(opened)
    assert all(r[PARENT] == opened[r[RID]] for r in waits)
    batches = [r for r in mine if r[NAME] == "serving.batch" and _attr(r, "batcher") == "traced"]
    listed = [rid for b in batches for rid in b[RID]]
    assert sorted(listed) == sorted(opened)
    assert sum(b[ITEMS] for b in batches) == 10
    assert all(1 <= _attr(b, "running") <= 3 for b in batches)
    work_spans = [r for r in mine if r[NAME] == "work"]
    by_sid = {b[SID]: b for b in batches}
    assert len(work_spans) == len(batches)
    assert all(w[RID] == by_sid[w[PARENT]][RID] for w in work_spans)


def _ingest_and_chat(client, query="what is the powerhouse of the cell?"):
    pdf = _make_pdf_bytes(["The mitochondria is the powerhouse of the cell"])
    res = client.post("/process-pdf/", files={"file": ("bio.pdf", pdf, "application/pdf")})
    assert res.status_code == 200, res.text
    res = client.post("/chat_pro", json={"query": query})
    assert res.status_code == 200, res.text
    return res.headers["X-Request-ID"]


def test_stage_observations_reach_a_patched_observe(api, monkeypatch):
    client, _ = api
    seen = []
    observe = profiling.metrics.observe

    def hooked(name, seconds):
        seen.append(name)
        return observe(name, seconds)

    monkeypatch.setattr(profiling.metrics, "observe", hooked)
    _ingest_and_chat(client)
    assert {"stage.queue_wait.retrieval", "stage.retrieve.hydrate", "stage.retrieve.rerank",
            "stage.batch_run.retrieval", "stage.http.request"} <= set(seen)


def test_ring_stays_bounded():
    for i in range(profiling.RING_SIZE + 100):
        with stage("fill", items=i):
            pass
    ring = profiling.records()
    assert len(ring) == profiling.RING_SIZE
    assert ring[-1][NAME] == "fill" and ring[-1][ITEMS] == profiling.RING_SIZE + 99
    assert ring[0][START] <= ring[-1][START]


def test_records_are_stamped_with_the_monotonic_clock():
    before = time.monotonic()
    with stage("clocked"):
        time.sleep(0.002)
    after = time.monotonic()
    (rec,) = [r for r in _mine(before) if r[NAME] == "clocked"]
    assert before <= rec[START] < rec[END] <= after
    assert rec[TID] == threading.get_ident()


def test_forced_collection_is_recorded_and_counted():
    counters = profiling.metrics.summary()["counters"]
    runs, pause = counters["gc.collections.gen2"], counters["gc.pause_ms"]
    since = time.monotonic()
    gc.collect()
    with stage("after.collection"):  # its exit observes the queued full collection
        pass
    full = [r for r in _mine(since) if r[NAME] == "gc" and _attr(r, "generation") == 2]
    assert full and full[-1][START] <= full[-1][END]
    summary = profiling.metrics.summary()
    assert summary["counters"]["gc.collections.gen2"] >= runs + 1
    assert summary["counters"]["gc.pause_ms"] > pause
    assert summary["latency_ms"]["stage.gc.full"]["count"] >= 1
    assert "mmrag_gc_collections_gen2_total" in profiling.metrics.prometheus_text()


def test_collection_inside_a_locked_observe_returns(monkeypatch):
    # a traced run's observe holds a plain lock and allocates under it: a full
    # collection that starts there must not call back into it
    lock = threading.Lock()
    seen = []
    observe = profiling.metrics.observe

    def locked(name, seconds):
        with lock:
            seen.append(name)
            if name == "stage.collecting":
                gc.collect()
        return observe(name, seconds)

    monkeypatch.setattr(profiling.metrics, "observe", locked)

    def spans():
        with stage("collecting"):
            pass
        with stage("after.collecting"):
            pass

    thread = threading.Thread(target=spans, daemon=True)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive(), "the collector's hook blocked on the observer's lock"
    assert seen.index("stage.collecting") < seen.index("stage.gc.full")


def test_chat_pro_spans_carry_one_request_id(api):
    client, _ = api
    since = time.monotonic()
    rid = _ingest_and_chat(client, "which organelle makes energy?")
    mine = _mine(since)
    (root,) = [r for r in mine if r[NAME] == "http.request" and r[RID] == rid]
    assert root[PARENT] == 0 and _attr(root, "path") == "/chat_pro"
    assert _attr(root, "method") == "POST"
    (chat,) = [r for r in mine if r[NAME] == "chat" and r[RID] == rid]
    assert chat[PARENT] == root[SID]
    (wait,) = [r for r in mine if r[NAME] == "queue_wait.retrieval" and r[RID] == rid]
    (retrieve,) = [r for r in mine if r[NAME] == "chat.retrieve" and r[RID] == rid]
    assert wait[PARENT] == retrieve[SID] and retrieve[PARENT] == chat[SID]
    (batch,) = [r for r in mine if r[NAME] == "serving.batch" and rid in r[RID]]
    children = {r[NAME] for r in mine if r[PARENT] == batch[SID]}
    assert {"retrieve.embed", "retrieve.search", "retrieve.hydrate", "retrieve.rerank",
            "retrieve.fuse"} <= children
    under = [r for r in mine if r[NAME].startswith(("retrieve.", "runtime.", "index."))
             and r[START] >= batch[START] and r[END] <= batch[END] and r[TID] == batch[TID]]
    assert under and all(r[RID] == batch[RID] for r in under)
    assert {"runtime.tokenize", "runtime.launch", "runtime.wait", "index.dispatch",
            "index.wait"} <= {r[NAME] for r in under}


def test_ingest_spans_nest_under_ingest_text(api):
    client, _ = api
    since = time.monotonic()
    _ingest_and_chat(client)
    mine = _mine(since)
    (text,) = [r for r in mine if r[NAME] == "ingest.text"]
    children = {r[NAME]: r for r in mine if r[PARENT] == text[SID]}
    assert {"ingest.split", "runtime.tokenize", "runtime.launch", "runtime.wait",
            "ingest.upsert", "ingest.catalogue"} <= set(children)
    assert text[ITEMS] == children["ingest.upsert"][ITEMS] >= 1
    journal = [r for r in mine if r[NAME] == "index.journal"
               and r[PARENT] == children["ingest.upsert"][SID]]
    encode, append = journal
    assert (_attr(encode, "part"), _attr(append, "part")) == ("encode", "append")
    assert encode[END] <= append[START] and encode[ITEMS] == append[ITEMS] == text[ITEMS]
    assert any(r[NAME] == "index.apply" for r in mine)


def test_prometheus_count_is_every_observation():
    profiling.metrics.reset()
    for _ in range(600):
        with stage("counted"):
            pass
    summary = profiling.metrics.summary()
    assert summary["counters"]["stage.counted"] == 600
    assert summary["latency_ms"]["stage.counted"]["count"] == 600
    assert "mmrag_stage_counted_latency_ms_count 600" in profiling.metrics.prometheus_text()


def test_chrome_trace_of_the_ring(tmp_path):
    since = time.monotonic()
    with stage("exported", "req-x", items=2, model="cross"):
        pass
    path = str(tmp_path / "spans.json")
    assert profiling.write_chrome_trace(path) >= 1
    events = json.load(open(path))["traceEvents"]
    (event,) = [e for e in events if e["name"] == "exported" and e["ts"] >= since * 1e6]
    assert event["ph"] == "X" and event["pid"] == os.getpid() and event["dur"] >= 0
    assert event["args"]["rid"] == "req-x" and event["args"]["model"] == "cross"
    assert event["args"]["items"] == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_writes_spans_to_profile_dir_on_shutdown(tmp_path):
    profile_dir = tmp_path / "profile"
    port = _free_port()
    env = dict(os.environ)
    env.update({
        "TPU_INDEX_DIR": str(tmp_path / "index"),
        "NOTES_DB_PATH": str(tmp_path / "notes.db"),
        "MEDIA_DIR": str(tmp_path / "media"),
        "INGEST_CACHE_DIR": str(tmp_path / "cache"),
        "TPU_SERVING_WARMUP": "0",
        "TPU_PROFILE_DIR": str(profile_dir),
    })
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import logging\n"
         "logging.basicConfig(level=logging.INFO)\n"
         "from mmrag_tpu_torch.rag.engine import RagEngine, set_engine\n"
         "set_engine(RagEngine(device='cpu'))\n"
         "from mmrag_tpu_torch.serving.http import serve_forever\n"
         f"serve_forever('127.0.0.1', {port}, device='cpu')"],
        env=env, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if "serving on" in line:
                break
            assert time.monotonic() < deadline, "".join(lines)
        assert httpx.get(f"http://127.0.0.1:{port}/healthz", timeout=30).status_code == 200
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest[-2000:]
    trace = profile_dir / f"spans-{proc.pid}.json"
    assert trace.exists(), rest[-2000:]
    events = json.load(open(trace))["traceEvents"]
    (request,) = [e for e in events if e["name"] == "http.request"]
    assert request["args"]["path"] == "/healthz" and request["dur"] > 0
    assert "jax" not in rest.lower()

