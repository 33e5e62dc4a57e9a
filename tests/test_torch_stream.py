"""The port's streaming decode -> embed -> index pipeline
(``mmrag_tpu_torch/rag/stream.py``): the cases of ``tests/test_stream.py``,
and the rows it writes against the JAX package's on the same weights and
frames (ids and metadata equal, embeddings within 1e-5, f32 on both)."""

import numpy as np
import pytest
import torch

from mmrag_tpu_torch.rag.stream import stream_index_images, stream_index_video_frames

from tiny_torch import jax_tiny_engine, tiny_engine, write_tiny_weights

EMB_TOL = 1e-5


class _FakeRuntime:
    """Yields per-bucket 'device' tensors; records when each bucket is read
    back (``.cpu()``) relative to when the next bucket was produced."""

    clip_dim = 8

    def __init__(self, bucket: int = 4):
        self.bucket = bucket
        self.events = []

    def embed_images_async(self, images):
        runtime = self

        class _Lazy:
            def __init__(self, idx, n):
                self.idx, self.n = idx, n

            def __getitem__(self, sl):
                return self

            def float(self):
                return self

            def cpu(self):
                runtime.events.append(("force", self.idx))
                return torch.full((self.n, runtime.clip_dim), self.idx + 1.0)

        for b, start in enumerate(range(0, len(images), self.bucket)):
            n = min(self.bucket, len(images) - start)
            self.events.append(("produce", b))
            yield _Lazy(b, n), n


class _FakeIndex:
    def __init__(self):
        self.rows = []

    def upsert(self, rows):
        self.rows.extend(rows)
        return len(rows)


class _FakeMeta:
    def __init__(self):
        self.chunks, self.docs = [], []

    def upsert_chunks(self, chunks):
        self.chunks.extend(chunks)

    def ensure_document(self, doc_id, user_id):
        self.docs.append((doc_id, user_id))


class _FakeVersions:
    def __init__(self):
        self.bumps = []

    def bump(self, user):
        self.bumps.append(user)


class _FakeEngine:
    def __init__(self, bucket=4):
        self.runtime = _FakeRuntime(bucket)
        self.image_index = _FakeIndex()
        self.metadata = _FakeMeta()
        self.versions = _FakeVersions()


def _items(n):
    return [({"id": f"c{i}", "metadata": {"document_id": "doc1", "media_path": f"/m/{i}.jpg"}},
             np.zeros((8, 8, 3), np.uint8)) for i in range(n)]


def test_stream_indexes_all_rows_and_bumps_version():
    eng = _FakeEngine(bucket=4)
    assert stream_index_images("u1", _items(10), eng) == 10
    assert [r.chunk_id for r in eng.image_index.rows] == [f"c{i}" for i in range(10)]
    assert len(eng.metadata.chunks) == 10
    assert eng.versions.bumps == ["u1"]
    assert eng.image_index.rows[0].embedding[0] == 1.0
    assert eng.image_index.rows[9].embedding[0] == 3.0


def test_stream_overlaps_buckets():
    """Bucket N is read back only AFTER bucket N+1 is produced."""

    eng = _FakeEngine(bucket=4)
    stream_index_images("u1", _items(12), eng)
    ev = eng.runtime.events
    assert ev.index(("produce", 1)) < ev.index(("force", 0))
    assert ev.index(("produce", 2)) < ev.index(("force", 1))


def test_stream_empty_is_noop():
    eng = _FakeEngine()
    assert stream_index_images("u1", [], eng) == 0
    assert eng.versions.bumps == []


def test_video_frame_adapter_builds_nodes():
    from mmrag_tpu_torch.ingest.frames import ExtractedFrame

    eng = _FakeEngine(bucket=8)
    frames = [ExtractedFrame(path=f"/f/{i}.jpg", ts=float(i * 5)) for i in range(3)]
    arrays = [np.zeros((4, 4, 3), np.uint8)] * 3
    assert stream_index_video_frames("u1", "docv", frames, arrays, eng) == 3
    chunk = eng.metadata.chunks[1]
    assert chunk.modality == "image" and chunk.media_path == "/f/1.jpg"
    assert chunk.ts_start == 5.0
    assert eng.image_index.rows[0].chunk_id == "docv-frame-0000"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_tiny_weights(tmp_path_factory.mktemp("tiny_weights"))


def test_stream_registers_documents_before_chunks(tmp_path, weights):
    eng = tiny_engine(tmp_path, weights)
    try:
        items = [({"id": "img-0", "metadata": {"document_id": "never-registered",
                                                "media_path": "/m/0.jpg"}},
                  np.zeros((8, 8, 3), np.uint8))]
        assert stream_index_images("u1", items, eng) == 1
        chunk = eng.metadata.get_chunk("img-0")
        assert chunk is not None and chunk.document_id == "never-registered"
    finally:
        eng.close()


def test_stream_catalog_failure_leaves_no_orphan_vectors():
    eng = _FakeEngine(bucket=4)

    def boom(chunks):
        raise RuntimeError("catalog down")

    eng.metadata.upsert_chunks = boom
    eng.metadata.ensure_document = lambda *a, **k: None
    with pytest.raises(RuntimeError, match="catalog down"):
        stream_index_images("u1", _items(3), eng)
    assert eng.image_index.rows == []


def test_stream_rows_match_jax(tmp_path, weights, rng):
    """11 video frames (three buckets of up to 4) through both packages'
    ``stream_index_video_frames`` over the same weights: the same row ids,
    metadata and catalog chunks, embeddings within 1e-5."""

    from mmrag_tpu.ingest.frames import ExtractedFrame as JFrame
    from mmrag_tpu.rag.stream import stream_index_video_frames as jstream
    from mmrag_tpu_torch.ingest.frames import ExtractedFrame as TFrame

    arrays = [rng.integers(0, 256, (72, 128, 3), dtype=np.uint8) for _ in range(11)]
    rows = {}
    for name, make, stream, Frame in (("jax", jax_tiny_engine, jstream, JFrame),
                                      ("torch", tiny_engine, stream_index_video_frames, TFrame)):
        eng = make(tmp_path / name, weights)
        try:
            frames = [Frame(path=f"/f/{i}.jpg", ts=float(i * 5)) for i in range(11)]
            assert stream("u1", "docv", frames, arrays, eng) == 11
            index = eng.image_index
            ids = list(index._chunk_ids)
            chunks = [eng.metadata.get_chunk(f"docv-frame-{i:04d}") for i in range(11)]
            rows[name] = (ids, [(c.chunk_id, c.document_id, c.media_path, c.ts_start, c.meta)
                                for c in chunks], index._host_rows_f32(), eng.versions.get("u1"))
        finally:
            eng.close()
    (jids, jchunks, jemb, jver), (tids, tchunks, temb, tver) = rows["jax"], rows["torch"]
    assert tids == jids and tchunks == jchunks and tver == jver
    assert [c[0] for c in tchunks] == [f"docv-frame-{i:04d}" for i in range(11)]
    np.testing.assert_allclose(temb, jemb, atol=EMB_TOL)

