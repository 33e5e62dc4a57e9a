"""The port's multi-device mode against the JAX package's on its 8 virtual
CPU devices: the cases of ``tests/test_engine_multichip.py``.

The port's side runs on an 8-shard mesh over ``cpu`` (one device listed
eight times), the JAX side on ``build_mesh()`` over its 8 devices. The
row-sharded ``VectorIndex`` (dense f32 and bf16, int8, ivf, ivf + int8,
ivf + pq), and a ``RagEngine`` whose runtime splits its encoder batches over
the mesh, must give the JAX package's hits: the same ids in the same order,
scores within 1e-6 (index) and 1e-4 (engine), and the port's own
single-device results. A snapshot of either package's sharded index boots
the other.
"""

import threading

import numpy as np
import pytest

from mmrag_tpu.index.store import VectorIndex as JIndex
from mmrag_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mmrag_tpu.storage.records import VectorRow as JRow
from mmrag_tpu_torch.index.store import VectorIndex as TIndex
from mmrag_tpu_torch.parallel.mesh import DATA_AXIS, build_mesh
from mmrag_tpu_torch.parallel.sharded_ivf import ShardedIVFData
from mmrag_tpu_torch.storage.records import VectorRow as TRow

D = 64


@pytest.fixture(scope="module")
def jmesh():
    return jbuild_mesh(model_parallel=1)


@pytest.fixture(scope="module")
def tmesh():
    return build_mesh(devices=["cpu"] * 8)


def _mat(rng, n, clustered=False, centers=8):
    if not clustered:
        return rng.standard_normal((n, D)).astype(np.float32)
    cents = rng.standard_normal((centers, D)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return cents[rng.integers(0, centers, n)] + 0.2 * rng.standard_normal((n, D)).astype(
        np.float32)


def _queries(rng, n):
    """Unit queries: scores are cosines, at most 1 (the 1e-6 holds there)."""

    q = rng.standard_normal((n, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rows(Row, mat, user="u1", doc="d1", start=0):
    return [Row(chunk_id=f"{doc}-c{start + i}", user_id=user, document_id=doc,
                modality="text", embedding=mat[i]) for i in range(len(mat))]


def _pair(jmesh, tmesh, dtype="float32", backend="auto", **kw):
    """A JAX sharded index and the port's, same settings, sync ivf builds."""

    j = JIndex(dim=D, dtype=dtype, backend=backend, mesh=jmesh, **kw)
    t = TIndex(dim=D, dtype=dtype, backend=backend, mesh=tmesh, device="cpu", **kw)
    j.ivf_build_async = t.ivf_build_async = False
    return j, t


def _upsert(pair, mat, **kw):
    j, t = pair
    j.upsert(_rows(JRow, mat, **kw))
    t.upsert(_rows(TRow, mat, **kw))


def _same(a, b, atol=1e-6):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [c for c, _ in ha] == [c for c, _ in hb]
        np.testing.assert_allclose([s for _, s in hb], [s for _, s in ha], rtol=0, atol=atol)


class TestShardedVectorIndex:
    def test_matches_jax_and_single_device(self, rng, jmesh, tmesh):
        pair = _pair(jmesh, tmesh)
        single = TIndex(dim=D, dtype="float32", device="cpu")
        mat1, mat2 = _mat(rng, 500), _mat(rng, 300)
        _upsert(pair, mat1)
        _upsert(pair, mat2, user="u2", doc="d2")
        single.upsert(_rows(TRow, mat1) + _rows(TRow, mat2, user="u2", doc="d2"))
        j, t = pair
        assert t._sharded and t._slab.shard_rows * 8 == t._capacity
        queries = _queries(rng, 4)
        for user, doc in [("u1", None), ("u2", "d2"), ("u1", "d2")]:
            got = t.search_batch(queries, user, k=10, document_id=doc)
            _same(j.search_batch(queries, user, k=10, document_id=doc), got)
            _same(single.search_batch(queries, user, k=10, document_id=doc), got)

    def test_multi_tenant_batched(self, rng, jmesh, tmesh):
        pair = _pair(jmesh, tmesh, dtype="bfloat16")
        _upsert(pair, _mat(rng, 200))
        _upsert(pair, _mat(rng, 200), user="u2", doc="d2")
        queries = _queries(rng, 6)
        users = ["u1", "u2", "u1", "u2", "nobody", "u1"]
        docs = [None, "d2", "d1", None, None, "d2"]
        j, t = pair
        a = j.search_batch_multi(queries, users, 8, docs)
        b = t.search_batch_multi(queries, users, 8, docs)
        _same(a, b)
        assert b[4] == [] and b[5] == []  # unknown tenant isolated; u1 has no d2

    def test_int8_sharded(self, rng, jmesh, tmesh):
        pair = _pair(jmesh, tmesh, dtype="int8")
        _upsert(pair, _mat(rng, 400))
        queries = _queries(rng, 3)
        j, t = pair
        _same(j.search_batch(queries, "u1", k=5), t.search_batch(queries, "u1", k=5))

    def test_tombstone_growth_compact_persist(self, rng, jmesh, tmesh, tmp_path):
        pair = _pair(jmesh, tmesh)
        _upsert(pair, _mat(rng, 100))
        _upsert(pair, _mat(rng, 5000), start=100)  # capacity growth
        j, t = pair
        assert t._capacity == j._capacity and t._capacity % 8 == 0
        for ix in pair:
            ix.delete_document("d1")  # every row tombstoned on the sharded live column
            assert len(ix) == 0
        rows = _mat(rng, 64)
        _upsert(pair, rows, doc="d3")
        for ix in pair:
            ix.compact()
            assert len(ix) == 64
        j.save(str(tmp_path / "jax"), "t")
        t.save(str(tmp_path / "port"), "t")
        with np.load(tmp_path / "jax" / "t.npz") as a, np.load(tmp_path / "port" / "t.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        q = (rows[7] / np.linalg.norm(rows[7]))[None, :].astype(np.float32)
        # each package's sharded snapshot boots the other's sharded index
        boots = [TIndex.load(str(tmp_path / "jax"), "t", dtype="float32", device="cpu",
                             mesh=tmesh),
                 JIndex.load(str(tmp_path / "port"), "t", dtype="float32", mesh=jmesh)]
        for back in boots:
            assert back.search_batch(q, "u1", k=1)[0][0][0] == "d3-c7"
        _same(boots[1].search_batch(q, "u1", k=5), boots[0].search_batch(q, "u1", k=5))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_ivf_composes_with_mesh(self, rng, jmesh, tmesh, dtype):
        """backend=ivf + mesh builds per-shard bucket layouts; at nprobe 4
        of 8 clusters they give the JAX package's sharded layout's hits
        (the same centroids, buckets and spills), and at nprobe >= C they
        give the dense sharded scan's."""

        mat = _mat(rng, 2000, clustered=True)
        pair = _pair(jmesh, tmesh, dtype, "ivf", ivf_min_rows=10, ivf_nprobe=4)
        _upsert(pair, mat)
        j, t = pair
        q = _queries(rng, 4)
        got = t.search_batch(q, "u1", k=10)
        _same(j.search_batch(q, "u1", k=10), got)
        assert isinstance(t._ivf, ShardedIVFData) and t._ivf.n_shards == tmesh.shape[DATA_AXIS]
        assert (t._ivf.scales_b is not None) == (dtype == "int8")
        assert t._ivf.bucket_size == j._ivf.bucket_size
        assert t._ivf.spill_size == j._ivf.spill_size
        np.testing.assert_array_equal(t._ivf.slot_of_row, j._ivf.slot_of_row)
        full = TIndex(dim=D, dtype=dtype, backend="ivf", mesh=tmesh, device="cpu",
                      ivf_min_rows=10, ivf_nprobe=10_000)
        full.ivf_build_async = False
        dense = TIndex(dim=D, dtype=dtype, mesh=tmesh, device="cpu")
        for ix in (full, dense):
            ix.upsert(_rows(TRow, mat))
        _same(dense.search_batch(q, "u1", k=10), full.search_batch(q, "u1", k=10),
              atol=1e-4 if dtype == "int8" else 1e-6)

    def test_ivf_pq_composes_with_mesh(self, rng, jmesh, tmesh):
        """The partitioned-and-coded layout (residual ivf_pq) per shard + the
        exact host refine: the JAX package's hits, and >= 0.8 overlap with
        the exact scan."""

        mat = _mat(rng, 3000, clustered=True)
        pair = _pair(jmesh, tmesh, "pq", "ivf", ivf_min_rows=10)
        _upsert(pair, mat)
        j, t = pair
        q = (mat[:5] + 0.05 * rng.standard_normal((5, D))).astype(np.float32)
        got = t.search_batch(q, "u1", k=8)
        _same(j.search_batch(q, "u1", k=8), got)
        assert isinstance(t._ivf, ShardedIVFData) and t._ivf.is_pq and t._ivf.pq_residual
        exact = TIndex(dim=D, dtype="float32", mesh=tmesh, device="cpu")
        exact.upsert(_rows(TRow, mat))
        want = exact.search_batch(q, "u1", k=8)
        overlap = np.mean([len({c for c, _ in a} & {c for c, _ in b}) / 8.0
                           for a, b in zip(got, want)])
        assert overlap >= 0.8, overlap

    def test_flat_pq_sharded(self, rng, jmesh, tmesh):
        pair = _pair(jmesh, tmesh, "pq")
        _upsert(pair, _mat(rng, 3000, clustered=True))
        j, t = pair
        assert t.is_pq and not t.is_int8  # the quality gate kept pq
        q = _queries(rng, 3)
        _same(j.search_batch_multi(q, ["u1"] * 3, 6), t.search_batch_multi(q, ["u1"] * 3, 6))

    def test_sharded_ivf_tail_and_tombstones(self, rng, jmesh, tmesh):
        """Rows appended after the build are scored exactly (the tail scan)
        and tombstones reach the per-shard liveness planes."""

        mat = _mat(rng, 2000, clustered=True)
        pair = _pair(jmesh, tmesh, "float32", "ivf", ivf_min_rows=10, ivf_nprobe=10_000)
        _upsert(pair, mat)
        j, t = pair
        for ix in pair:
            ix.search_batch(_queries(rng, 1), "u1", k=1)
        built = t._ivf
        late = _mat(rng, 50)
        _upsert(pair, late, doc="d9", start=50_000)
        assert t._ivf is built  # a small tail: no rebuild
        q = (late[7] / np.linalg.norm(late[7]))[None, :].astype(np.float32)
        hits = t.search_batch(q, "u1", k=1)
        assert hits[0][0][0] == "d9-c50007"
        _same(j.search_batch(q, "u1", k=5), t.search_batch(q, "u1", k=5))
        for ix, Row in zip(pair, (JRow, TRow)):
            ix.delete_document("d9")
            ix.delete_document("d1")
            ix.upsert(_rows(Row, mat[3:4], start=3))
        assert t.search_batch(q, "u1", k=3, document_id="d9")[0] == []
        q0 = (mat[3] / np.linalg.norm(mat[3]))[None, :].astype(np.float32)
        assert t.search_batch(q0, "u1", k=1)[0][0][0] == "d1-c3"
        _same(j.search_batch(q0, "u1", k=4), t.search_batch(q0, "u1", k=4))

    def test_sharded_ivf_snapshot_warm_rebuild(self, rng, jmesh, tmesh, tmp_path):
        """A sharded snapshot persists its global centroids; the restored
        index warm-rebuilds per-shard layouts with one assignment pass and
        serves the same results — from either package's snapshot."""

        mat = _mat(rng, 1200, clustered=True)
        pair = _pair(jmesh, tmesh, "float32", "ivf", ivf_min_rows=10, ivf_nprobe=10_000)
        _upsert(pair, mat)
        j, t = pair
        q = _queries(rng, 3)
        want = t.search_batch(q, "u1", k=6)
        _same(j.search_batch(q, "u1", k=6), want)
        j.save(str(tmp_path / "jax"), "t")
        t.save(str(tmp_path / "port"), "t")
        for src in ("jax", "port"):
            back = TIndex.load(str(tmp_path / src), "t", dtype="float32", device="cpu",
                               backend="ivf", mesh=tmesh, ivf_min_rows=10, ivf_nprobe=10_000)
            back.ivf_build_async = False
            assert back._ivf_warm_centroids is not None
            got = back.search_batch(q, "u1", k=6)
            assert isinstance(back._ivf, ShardedIVFData)
            np.testing.assert_allclose(back._ivf.centroids.numpy(), t._ivf.centroids.numpy(),
                                       atol=1e-6)
            _same(want, got)

    def test_sharded_ivf_structure_gate(self, rng, jmesh, tmesh):
        """Structureless rows discard the sharded layout as the single-device
        gate does; the dense sharded scan serves instead."""

        pair = _pair(jmesh, tmesh, "float32", "ivf", ivf_min_rows=10)
        _upsert(pair, _mat(rng, 500))
        j, t = pair
        q = _queries(rng, 2)
        hits = t.search_batch(q, "u1", k=5)
        assert t._ivf is None and t._ivf_poor_at > 0
        assert all(len(h) == 5 for h in hits)
        _same(j.search_batch(q, "u1", k=5), hits)


def test_non_power_of_two_mesh(rng):
    """A 3-shard mesh: capacity rounds up to a multiple of 3, and the dense
    and ivf searches match the JAX package's 3-device mesh and the port's
    single-device index."""

    jm = jbuild_mesh(n_devices=3, model_parallel=1)
    tm = build_mesh(devices=["cpu"] * 3)
    mat = _mat(rng, 1300, clustered=True)
    q = _queries(rng, 3)
    single = TIndex(dim=D, dtype="float32", device="cpu")
    single.upsert(_rows(TRow, mat))
    for backend in ("auto", "ivf"):
        pair = _pair(jm, tm, "float32", backend, ivf_min_rows=10, ivf_nprobe=3)
        _upsert(pair, mat)
        j, t = pair
        assert t._capacity % 3 == 0 and t._capacity == j._capacity
        got = t.search_batch(q, "u1", k=7)
        _same(j.search_batch(q, "u1", k=7), got)
        if backend == "auto":
            _same(single.search_batch(q, "u1", k=7), got)


def test_sharded_ivf_concurrent_mutation_stress(rng, tmesh):
    """Background sharded-ivf builds race writers, readers, a deleter and a
    compactor: tenant isolation holds at every observation and the final
    state holds every write."""

    import sys

    index = TIndex(dim=D, dtype="float32", backend="ivf", mesh=tmesh, device="cpu",
                   ivf_min_rows=32, ivf_nprobe=10_000)
    assert index.ivf_build_async
    cents = rng.standard_normal((8, D)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    thread_rngs = rng.spawn(5)  # a Generator is not thread-safe: one each

    def mk(tid, i, r):
        noise = r.standard_normal(D).astype(np.float32)
        emb = cents[(tid + i) % 8] + 0.2 * noise / np.linalg.norm(noise)
        return TRow(chunk_id=f"t{tid}-c{i}", user_id=f"u{tid}", document_id=f"d{tid}",
                    modality="text", embedding=emb)

    errors = []
    q = _queries(rng, 2)

    def writer(tid):
        try:
            for i in range(40):
                index.upsert([mk(tid, i, thread_rngs[tid])])
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def reader(tid):
        try:
            for _ in range(12):
                for hits in index.search_batch(q, f"u{tid % 3}", k=5):
                    for cid, _ in hits:
                        assert cid.startswith(f"t{tid % 3}-"), cid
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def deleter():
        try:
            index.upsert([mk(3, i, thread_rngs[3]) for i in range(16)])
            index.delete_document("d3")
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def compactor():
        try:
            index.compact()
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = ([threading.Thread(target=writer, args=(t,)) for t in range(3)]
               + [threading.Thread(target=reader, args=(t,)) for t in range(3)]
               + [threading.Thread(target=deleter), threading.Thread(target=compactor)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(index) == 120  # 3 writers x 40; d3's 16 rows tombstoned
    index.ivf_build_async = False
    index.build_ivf()
    assert isinstance(index._ivf, ShardedIVFData)
    for tid in range(3):
        hits = index.search_batch(q, f"u{tid}", k=8)[0]
        assert hits and all(c.startswith(f"t{tid}-") for c, _ in hits)
    assert index.search_batch(q, "u3", k=5)[0] == []


# ---------------------------------------------------------------------------
# The engine: a data-parallel runtime and row-sharded indexes
# ---------------------------------------------------------------------------

TEXTS = [
    "The mitochondria is the powerhouse of the cell.",
    "Photosynthesis converts light energy into chemical energy.",
    "Newton's laws of motion describe classical mechanics.",
    "The Krebs cycle produces ATP in cellular respiration.",
    "Enzymes lower the activation energy of reactions.",
    "Plate tectonics moves the continents over millions of years.",
]


def _nodes():
    return [{"id": f"doc1-c{i}", "text": t, "metadata": {"document_id": "doc1", "page": i + 1}}
            for i, t in enumerate(TEXTS)]


def _engines(tmp_path, extra_env=None):
    """The port's engine on an 8-shard cpu mesh, the port's single-device
    engine and the JAX engine on its 8-device mesh, over the same tiny
    weights, each with the same text nodes and images ingested."""

    from mmrag_tpu.models.runtime import EncoderRuntime as JRuntime
    from mmrag_tpu.rag import index_build as jib
    from mmrag_tpu.rag.engine import RagEngine as JEngine
    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu.storage import Document as JDocument
    from mmrag_tpu.storage.records import Chunk as JChunk
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.rag import index_build as tib
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings
    from mmrag_tpu_torch.storage import Document
    from mmrag_tpu_torch.storage.records import Chunk

    from tiny import TINY_BERT as JBERT, TINY_CLIP as JCLIP
    from tiny_torch import TINY_BERT, TINY_CLIP, tiny_env, write_tiny_weights

    weights = write_tiny_weights(tmp_path / "weights")
    env = {"TPU_MICROBATCH_WINDOW_MS": "0", "TPU_INDEX_JOURNAL": "0", **(extra_env or {})}
    images = [np.random.default_rng(7 + i).integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for i in range(5)]
    built = {}
    for name in ("multi", "single", "jax"):
        e = tiny_env(tmp_path / name, weights, env)
        if name == "jax":
            cfg = jload({**e, "TPU_DATA_PARALLEL": "auto"})
            eng = JEngine(cfg, JRuntime(cfg, bert_cfg=JBERT, clip_cfg=JCLIP))
            ib, Doc, ChunkT = jib, JDocument, JChunk
        else:
            cfg = load_settings(e)
            mesh = build_mesh(devices=["cpu"] * 8) if name == "multi" else None
            eng = RagEngine(cfg, EncoderRuntime(cfg, bert_cfg=TINY_BERT, clip_cfg=TINY_CLIP,
                                                device="cpu", mesh=mesh))
            ib, Doc, ChunkT = tib, Document, Chunk
        eng.metadata.upsert_document(Doc(document_id="doc1", user_id="u1", doc_type="pdf",
                                         title="T"))
        ib.index_text_nodes("u1", _nodes(), eng)
        emb = eng.runtime.embed_images_batch(images)
        Row = JRow if name == "jax" else TRow
        chunks = [ChunkT(chunk_id=f"img-{i}", document_id="doc1", user_id="u1",
                         modality="image", media_path=f"/media/img-{i}.png") for i in range(5)]
        ib.index_image_rows("u1", [Row(chunk_id=f"img-{i}", user_id="u1", document_id="doc1",
                                       modality="image", embedding=emb[i]) for i in range(5)],
                            chunks, eng)
        built[name] = eng
    return built


def _clear():
    from mmrag_tpu.cache import clear_all_caches as jclear
    from mmrag_tpu_torch.cache import clear_all_caches as tclear

    jclear()
    tclear()


@pytest.fixture(autouse=True)
def _clear_port_caches():
    _clear()
    yield
    _clear()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    built = _engines(tmp_path_factory.mktemp("mc"))
    yield built
    for eng in built.values():
        eng.close()


def _assert_same_retrieve(got, want, atol=1e-4):
    assert [h["chunk_id"] for h in got["results"]] == [h["chunk_id"] for h in want["results"]]
    for key in ("text", "images"):
        assert [h["chunk_id"] for h in got[key]] == [h["chunk_id"] for h in want[key]]
        np.testing.assert_allclose([h["score"] for h in got[key]],
                                   [h["score"] for h in want[key]], rtol=0, atol=atol)


class TestEngineMultichip:
    def test_mesh_only_where_asked(self, engines):
        multi, single = engines["multi"], engines["single"]
        assert single.mesh is None and not single.text_index._sharded
        assert multi.mesh is multi.runtime.mesh and multi.mesh.n_data == 8
        assert multi.text_index._sharded and multi.image_index._sharded
        assert multi.text_index.mesh is multi.mesh

    @pytest.mark.parametrize("query", ["what powers the cell?", "laws of motion"])
    def test_retrieve_matches_single_device_and_jax(self, engines, query):
        from mmrag_tpu.rag import retrieve as jrv
        from mmrag_tpu_torch.rag import retrieve as trv

        got = trv.retrieve("u1", query, engines["multi"])
        assert got["results"]
        _assert_same_retrieve(got, trv.retrieve("u1", query, engines["single"]))
        _assert_same_retrieve(got, jrv.retrieve("u1", query, engines["jax"]))

    def test_retrieve_batch_final4(self, engines):
        from mmrag_tpu.rag import retrieve as jrv
        from mmrag_tpu_torch.rag import retrieve as trv

        items = [("u1", q, None) for q in ("cell energy", "motion", "continents", "enzymes",
                                             "ATP")]
        got = trv.retrieve_batch(items, engines["multi"])
        want = jrv.retrieve_batch(items, engines["jax"])
        for g, w in zip(got, want):
            _assert_same_retrieve(g, w)

    def test_dp_embeddings_match(self, engines):
        multi, single, jeng = engines["multi"], engines["single"], engines["jax"]
        texts = [f"sentence number {i} about biology" for i in range(11)]
        got = multi.runtime.embed_text_batch(texts)
        np.testing.assert_allclose(got, single.runtime.embed_text_batch(texts), atol=1e-5)
        np.testing.assert_allclose(got, jeng.runtime.embed_text_batch(texts), atol=1e-4)
        got = multi.runtime.embed_queries_for_images(texts[:3])
        np.testing.assert_allclose(got, jeng.runtime.embed_queries_for_images(texts[:3]),
                                   atol=1e-4)
        got = multi.runtime.rerank_scores("cell power", texts[:5])
        np.testing.assert_allclose(got, single.runtime.rerank_scores("cell power", texts[:5]),
                                   atol=1e-4)
        np.testing.assert_allclose(got, jeng.runtime.rerank_scores("cell power", texts[:5]),
                                   atol=1e-4)
        # every bucket padded to a multiple of the data axis
        assert multi.runtime._round_batch(4) == 8 and single.runtime._round_batch(4) == 4
        assert multi.runtime.rerank_bucket_sizes(3) == (8,)
        assert single.runtime.rerank_bucket_sizes(3) == (4,)

    def test_dp_image_embeddings_match(self, engines, rng):
        imgs = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(5)]
        got = engines["multi"].runtime.embed_images_batch(imgs)
        np.testing.assert_allclose(got, engines["single"].runtime.embed_images_batch(imgs),
                                   atol=1e-5)
        np.testing.assert_allclose(got, engines["jax"].runtime.embed_images_batch(imgs),
                                   atol=1e-4)


def test_dp_encoder_quant(tmp_path, monkeypatch):
    """``TPU_ENCODER_QUANT=int8`` with the data-parallel runtime: the int8
    blocks replicate with the params and the sharded engine matches the
    single-device int8 runtime and the JAX package's on its mesh."""

    monkeypatch.setenv("MMRAG_ATTN_IMPL", "fused")  # the JAX package's q8 kernels
    built = _engines(tmp_path, {"TPU_ENCODER_QUANT": "int8"})
    try:
        multi, single, jeng = built["multi"], built["single"], built["jax"]
        assert multi.runtime.quant and jeng.runtime.mesh is not None
        texts = [f"sentence number {i} about biology" for i in range(9)]
        got = multi.runtime.embed_text_batch(texts)
        np.testing.assert_allclose(got, single.runtime.embed_text_batch(texts), atol=1e-5)
        np.testing.assert_allclose(got, jeng.runtime.embed_text_batch(texts), atol=1e-4)
        got = multi.runtime.rerank_scores("cell power", texts[:5])
        np.testing.assert_allclose(got, single.runtime.rerank_scores("cell power", texts[:5]),
                                   atol=1e-4)
        np.testing.assert_allclose(got, jeng.runtime.rerank_scores("cell power", texts[:5]),
                                   atol=1e-4)
        from mmrag_tpu_torch.rag import retrieve as trv

        _assert_same_retrieve(trv.retrieve("u1", "what powers the cell?", multi),
                              trv.retrieve("u1", "what powers the cell?", single))
    finally:
        for eng in built.values():
            eng.close()
