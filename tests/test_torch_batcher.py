"""The port's MicroBatcher: coalescing, ordering, error propagation, engine
wiring — the cases of ``tests/test_batcher.py`` against
``mmrag_tpu_torch.serving.batcher`` — and the engine under the default
serving settings: a coalesced ``retrieve`` gives the direct path's payload,
and ``warmup_serving`` counts what the JAX package's counts."""

import threading
import time

import numpy as np
import pytest
import torch

from mmrag_tpu_torch.serving.batcher import MicroBatcher, QueryEmbedBatcher

from tiny_torch import jax_tiny_engine, tiny_engine, write_tiny_weights


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_tiny_weights(tmp_path_factory.mktemp("tiny_weights"))


@pytest.fixture(autouse=True)
def _clear_port_caches():
    from mmrag_tpu_torch.cache import clear_all_caches

    clear_all_caches()
    yield
    clear_all_caches()


def test_coalesces_concurrent_submits():
    calls = []

    def fn(items):
        calls.append(list(items))
        time.sleep(0.01)
        return [x * 2 for x in items]

    b = MicroBatcher(fn, max_batch=8, window_ms=30)
    results = {}

    def worker(i):
        results[i] = b.submit(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()
    assert results == {i: i * 2 for i in range(6)}
    assert b.batches_run < 6
    assert sum(len(c) for c in calls) == 6


def test_max_batch_splits():
    def fn(items):
        assert len(items) <= 2
        return items

    b = MicroBatcher(fn, max_batch=2, window_ms=20)
    threads, out = [], []
    for i in range(5):
        t = threading.Thread(target=lambda i=i: out.append(b.submit(i)))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    b.close()
    assert sorted(out) == [0, 1, 2, 3, 4]


def test_error_propagates_to_all_waiters():
    def fn(items):
        raise RuntimeError("boom")

    b = MicroBatcher(fn, max_batch=4, window_ms=10)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit("x")
    b.close()


def test_result_count_mismatch_raises():
    b = MicroBatcher(lambda items: items[:-1] if len(items) > 1 else [], window_ms=1)
    with pytest.raises(RuntimeError, match="results"):
        b.submit(1)
    b.close()


def test_closed_batcher_rejects():
    b = MicroBatcher(lambda items: items)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)


class _FakeRuntime:
    device = torch.device("cpu")

    def __init__(self):
        self.text_calls = 0
        self.clip_calls = 0

    def embed_text_batch(self, texts):
        self.text_calls += 1
        return np.arange(len(texts) * 4, dtype=np.float32).reshape(len(texts), 4)

    def embed_queries_for_images(self, queries):
        self.clip_calls += 1
        return np.ones((len(queries), 8), dtype=np.float32)


def test_query_embed_batcher_one_dispatch_per_tower():
    rt = _FakeRuntime()
    qb = QueryEmbedBatcher(rt, max_batch=8, window_ms=30)
    results = {}
    threads = [threading.Thread(target=lambda q=f"q{i}": results.update({q: qb.embed(q)}))
               for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    qb.close()
    assert len(results) == 5
    for v in results.values():
        assert v["text"].shape == (4,) and v["image"].shape == (8,)
    assert rt.text_calls < 5 and rt.clip_calls == rt.text_calls
    assert qb.stats["items_seen"] == 5


class _EngineRuntimeStub(_FakeRuntime):
    text_dim = 4
    clip_dim = 8


def test_engine_batcher_gated_by_setting(tmp_path):
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    env = {"DATA_DIR": str(tmp_path), "TPU_INDEX_DIR": str(tmp_path / "index"),
           "NOTES_DB_PATH": str(tmp_path / "notes.db"), "TPU_MICROBATCH_WINDOW_MS": "0"}
    eng = RagEngine(load_settings(env), runtime=_EngineRuntimeStub())
    assert eng.query_batcher is None and eng.retrieval_batcher is None
    eng.close()

    eng2 = RagEngine(load_settings({**env, "TPU_MICROBATCH_WINDOW_MS": "2"}),
                     runtime=_EngineRuntimeStub())
    b = eng2.query_batcher
    assert b is not None and eng2.query_batcher is b  # cached
    eng2.close()


def test_pipelined_workers_overlap_batches():
    active, peak = [], []
    lock = threading.Lock()

    def fn(items):
        with lock:
            active.append(1)
            peak.append(sum(active))
        time.sleep(0.05)
        with lock:
            active.pop()
        return [x * 2 for x in items]

    b = MicroBatcher(fn, max_batch=2, window_ms=1, workers=2)
    results = {}

    def worker(i):
        results[i] = b.submit(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()
    assert results == {i: i * 2 for i in range(8)}
    assert max(peak) == 2


def test_pipelined_workers_fold_arrivals_when_saturated():
    def fn(items):
        time.sleep(0.05)
        return list(items)

    b = MicroBatcher(fn, max_batch=16, window_ms=1, workers=2)
    results = {}

    def worker(i):
        if i >= 2:
            time.sleep(0.01 + i * 0.002)
        results[i] = b.submit(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()
    assert results == {i: i for i in range(10)}
    assert b.batches_run <= 5, dict(b.batch_sizes)


_WORDS = ("alpha particle physics beta decay chains gamma rays solar panels convert "
          "sunlight into power cells batteries store energy wind turbines").split()


def _fill(engine, ib):
    from mmrag_tpu_torch.storage.records import Chunk, VectorRow

    rng = np.random.default_rng(0)
    for user in ("u1", "u2"):
        nodes = [{"id": f"doc-{user}-c{i}", "text": " ".join(rng.choice(_WORDS, 12)),
                  "metadata": {"document_id": f"doc-{user}-{i % 2}", "page": i + 1}}
                 for i in range(10)]
        ib.index_text_nodes(user, nodes, engine)
    emb = engine.runtime.embed_images_batch(
        [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(4)])
    for user, sel in (("u1", (0, 1)), ("u2", (2, 3))):
        rows = [VectorRow(chunk_id=f"img-{i}", user_id=user, document_id=f"doc-{user}-0",
                          modality="image", embedding=emb[i]) for i in sel]
        chunks = [Chunk(chunk_id=f"img-{i}", document_id=f"doc-{user}-0", user_id=user,
                        modality="image", media_path=f"/m/{i}.png") for i in sel]
        ib.index_image_rows(user, rows, chunks, engine)


ITEMS = [("u1", "alpha physics", None), ("u2", "gamma rays", None),
         ("u1", "beta decay", "doc-u1-1"), ("u2", "solar power cells", None),
         ("u1", "wind turbines store energy", None), ("u2", "sunlight", "doc-u2-0")]


def test_coalesced_retrieve_equals_the_direct_path(tmp_path, weights):
    """Under the default window the engine builds both batchers; concurrent
    ``retrieve`` calls coalesce (a batch above 1) and each payload equals
    the direct path's (window 0) on the same rows: ids, order, scores within
    1e-5 and rerank scores within 1e-4, as ``tests/test_rag_pipeline.py``
    holds the JAX package's."""

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.rag import index_build as ib
    from mmrag_tpu_torch.rag.retrieve import retrieve

    eng = tiny_engine(tmp_path, weights, {"TPU_MICROBATCH_WINDOW_MS": "50"})
    direct = tiny_engine(tmp_path / "direct", weights, {"TPU_MICROBATCH_WINDOW_MS": "0"})
    try:
        assert eng.cfg.tpu.microbatch_workers == 3
        _fill(eng, ib)
        _fill(direct, ib)
        got = {}
        start = threading.Barrier(len(ITEMS))

        def ask(i, item):
            start.wait()
            got[i] = retrieve(item[0], item[1], eng, item[2])

        threads = [threading.Thread(target=ask, args=(i, it)) for i, it in enumerate(ITEMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert max(eng.retrieval_batcher.batch_sizes) > 1, eng.retrieval_batcher.batch_sizes
        clear_all_caches()
        for i, (user, query, doc) in enumerate(ITEMS):
            want = retrieve(user, query, direct, doc)
            assert want["results"]
            for key in ("results", "text", "images"):
                assert [h["chunk_id"] for h in got[i][key]] == [h["chunk_id"] for h in want[key]]
                np.testing.assert_allclose([h["score"] for h in got[i][key]],
                                           [h["score"] for h in want[key]], atol=1e-5)
            gr = [h["rerank_score"] for h in got[i]["text"] if h["rerank_score"] is not None]
            wr = [h["rerank_score"] for h in want["text"] if h["rerank_score"] is not None]
            np.testing.assert_allclose(gr, wr, atol=1e-4)
            assert all(h["user_id"] == user for h in got[i]["results"])
            if doc is not None:
                assert all(h["document_id"] == doc for h in got[i]["results"])
    finally:
        eng.close()
        direct.close()


@pytest.mark.parametrize("max_coalesce", [4, None])
def test_warmup_serving_counts_what_jax_counts(tmp_path, weights, max_coalesce):
    """The same settings and non-empty indexes: the port's warmup issues as
    many dispatches as the JAX package's (query towers, both searches at
    every coalesce length, the cross-encoder at each new padded batch)."""

    from mmrag_tpu.rag import index_build as jib
    from mmrag_tpu_torch.rag import index_build as tib

    counts = {}
    for name, make, ib in (("jax", jax_tiny_engine, jib), ("torch", tiny_engine, tib)):
        eng = make(tmp_path / name, weights)
        try:
            if name == "torch":
                _fill(eng, ib)
            else:
                ib.index_text_nodes("u1", [{"id": "c0", "text": "alpha physics",
                                            "metadata": {"document_id": "d"}}], eng)
                _fill_jax_images(eng)
            counts[name] = eng.warmup_serving(max_coalesce)
        finally:
            eng.close()
    n = max_coalesce or 16
    assert counts["torch"] == counts["jax"] > 3 * n
    stop = threading.Event()
    stop.set()
    eng = tiny_engine(tmp_path / "stopped", weights)
    try:
        assert eng.warmup_serving(stop=stop) == 0  # a set stop event runs nothing
    finally:
        eng.close()


def _fill_jax_images(eng):
    from mmrag_tpu.rag import index_build as jib
    from mmrag_tpu.storage.records import Chunk, VectorRow

    emb = np.eye(1, 512, dtype=np.float32)
    jib.index_image_rows("u1", [VectorRow(chunk_id="img-0", user_id="u1", document_id="d",
                                          modality="image", embedding=emb[0])],
                         [Chunk(chunk_id="img-0", document_id="d", user_id="u1",
                                modality="image", media_path="/m/0.png")], eng)
