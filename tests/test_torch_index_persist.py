"""Index persistence and the mutation journal, port against the JAX package.

The port writes and reads the JAX package's snapshot format (one npz with
the row ids inside, written atomically, and a ``manifest.json`` with
``snapshot_seq``) and journal schema, so either package boots from the
other's files. Modelled on ``tests/test_index_store.py`` and
``tests/test_index_journal.py``: the same numpy rows, made from a seed, go
into both packages' ``VectorIndex`` on the CPU.

Tolerances: snapshot payloads bit for bit (bf16 bits, int8 codes and
scales, ids); search results the same chunk ids in the same order, scores
within 1e-5 (f32 sums of the same bf16 or int8 products in another order;
the pq refine is the same f32 numpy contraction on both sides).
"""

import json

import numpy as np
import pytest
import torch

from mmrag_tpu import native
from mmrag_tpu.index.journal import IndexJournal as JaxJournal
from mmrag_tpu.index.store import VectorIndex as JaxIndex
from mmrag_tpu.storage.records import VectorRow as JaxRow
from mmrag_tpu_torch import native as tnative
from mmrag_tpu_torch.index.journal import IndexJournal
from mmrag_tpu_torch.index.store import VectorIndex
from mmrag_tpu_torch.storage.records import VectorRow

DIM = 64
# each layout: the dtype name, and the knobs both packages' constructors take
LAYOUTS = {
    "bfloat16": ("bfloat16", {}),
    "int8": ("int8", {}),
    "pq": ("pq", {"pq_m": 8, "pq_min_quality": 0.0}),
    "ivf": ("bfloat16", {"backend": "ivf", "ivf_min_rows": 256, "ivf_nprobe": 4,
                         "ivf_min_structure": 0.0}),
}


def _clustered(rng, n, centers=12):
    c = rng.standard_normal((centers, DIM))
    mat = c[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, DIM))
    return mat.astype(np.float32)


def _rows(mat, cls=VectorRow, start=0, doc_every=50):
    return [cls(chunk_id=f"c{start + i}", user_id=f"u{(start + i) % 2}",
                document_id=f"d{(start + i) // doc_every}", modality="text", embedding=mat[i])
            for i in range(len(mat))]


def _jax_index(layout, **extra):
    dtype, knobs = LAYOUTS[layout]
    index = JaxIndex(dim=DIM, dtype=dtype, **knobs, **extra)
    index.ivf_build_async = False
    return index


def _port_index(layout, **extra):
    dtype, knobs = LAYOUTS[layout]
    index = VectorIndex(dim=DIM, dtype=dtype, device="cpu", **knobs, **extra)
    index.ivf_build_async = False
    return index


def _load_jax(layout, directory):
    dtype, knobs = LAYOUTS[layout]
    index = JaxIndex.load(str(directory), "text_collection", dtype, **knobs)
    index.ivf_build_async = False
    return index


def _load_port(layout, directory):
    dtype, knobs = LAYOUTS[layout]
    index = VectorIndex.load(str(directory), "text_collection", dtype, device="cpu", **knobs)
    index.ivf_build_async = False
    return index


def _fill(index, mat, cls):
    index.upsert(_rows(mat, cls))
    index.delete_document("d3")  # tombstones: the snapshot keeps live rows only
    if index.use_ivf:
        index.build_ivf(n_clusters=8)
        assert index._ivf is not None


def _same_search(a, b, queries):
    for user in ("u0", "u1"):
        ha = a.search_batch(queries, user, 10)
        hb = b.search_batch(queries, user, 10)
        for ra, rb in zip(ha, hb):
            assert [c for c, _ in ra] == [c for c, _ in rb]
            np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb], rtol=0,
                                       atol=1e-5)
            assert len(ra) == 10


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_snapshot_loads_in_the_port(layout, tmp_path):
    rng = np.random.default_rng(1)
    mat = _clustered(rng, 600)
    writer = _jax_index(layout)
    _fill(writer, mat, JaxRow)
    writer.save(str(tmp_path), "text_collection")
    port = _load_port(layout, tmp_path)
    ref = _load_jax(layout, tmp_path)
    assert len(port) == len(ref) == 550
    if layout == "ivf":  # the persisted centroids: both warm-build one layout
        np.testing.assert_array_equal(port._ivf_warm_centroids, ref._ivf_warm_centroids)
    if layout == "pq":  # codebooks and codes installed, not retrained
        np.testing.assert_array_equal(port._pq.codebooks.numpy(), np.asarray(ref._pq.codebooks))
    _same_search(port, ref, mat[:5] + 0.1 * rng.standard_normal((5, DIM)).astype(np.float32))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_snapshot_loads_in_jax(layout, tmp_path):
    rng = np.random.default_rng(2)
    mat = _clustered(rng, 600)
    writer = _port_index(layout)
    _fill(writer, mat, VectorRow)
    writer.save(str(tmp_path), "text_collection")
    manifest = json.loads((tmp_path / "text_collection.manifest.json").read_text())
    assert manifest == {"dim": DIM, "rows": 550}
    ref = _load_jax(layout, tmp_path)
    port = _load_port(layout, tmp_path)
    assert len(ref) == len(port) == 550
    _same_search(port, ref, mat[:5] + 0.1 * rng.standard_normal((5, DIM)).astype(np.float32))
    with np.load(tmp_path / "text_collection.npz") as data:
        keys = set(data.files)
    want = {"chunk_ids", "user_ids", "document_ids"} | {
        "bfloat16": {"embeddings_bf16"}, "int8": {"embeddings_int8", "scales"},
        "pq": {"embeddings_bf16", "pq_codebooks", "pq_codes"},
        "ivf": {"embeddings_bf16", "ivf_centroids"}}[layout]
    assert keys == want


@pytest.mark.parametrize("layout", ["bfloat16", "int8", "float32"])
def test_both_packages_write_the_same_snapshot(layout, tmp_path):
    """The same rows give bit-identical payloads and ids from either package."""

    rng = np.random.default_rng(3)
    mat = rng.standard_normal((300, DIM)).astype(np.float32)
    for pkg, (cls, row) in {"jax": (JaxIndex, JaxRow), "port": (VectorIndex, VectorRow)}.items():
        index = cls(dim=DIM, dtype=layout, **({"device": "cpu"} if pkg == "port" else {}))
        index.upsert(_rows(mat, row))
        index.delete_document("d1")
        index.save(str(tmp_path / pkg), "text_collection")
    with np.load(tmp_path / "jax" / "text_collection.npz") as j, \
            np.load(tmp_path / "port" / "text_collection.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            assert j[key].dtype == t[key].dtype, key
            np.testing.assert_array_equal(j[key], t[key], err_msg=key)


def test_bf16_bits_match_the_jax_native_conversion():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.array([0.0, -0.0, 1.0, 2 ** -130, 3.0000002, 1.00390625,
                                  1.01171875, 65504.0, -1e30], np.float32)])
    bits = tnative.f32_to_bf16(x)
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, native.f32_to_bf16(x))
    np.testing.assert_array_equal(tnative.bf16_to_f32(bits), native.bf16_to_f32(bits))


def test_pq_demoted_to_int8_survives_a_reload(tmp_path):
    """A pq index whose codebooks fail the quality gate serves int8; its
    snapshot carries int8 codes and reloads as int8 in a replica's reload."""

    rng = np.random.default_rng(5)
    journal = IndexJournal(str(tmp_path / "journal.db"), compact_window_sec=0.0)
    a = VectorIndex(dim=DIM, dtype="pq", device="cpu", pq_m=8, pq_min_quality=0.9999)
    b = VectorIndex(dim=DIM, dtype="pq", device="cpu", pq_m=8, pq_min_quality=0.9999)
    for idx in (a, b):
        idx.attach_journal(journal, "text_collection", str(tmp_path), "text_collection",
                           poll_sec=0.0)
    mat = rng.standard_normal((1000, DIM)).astype(np.float32)  # isotropic: the gate trips
    a.upsert(_rows(mat))
    assert not a.is_pq and a.is_int8 and a._dtype_str == "int8"
    a.save(str(tmp_path), "text_collection")  # compacts the log: b must reload
    with np.load(tmp_path / "text_collection.npz") as data:
        assert "embeddings_int8" in data.files
    hits = b.search_batch(mat[:2], "u0", 5)
    assert b.is_int8 and not b.is_pq and b._dtype_str == "int8" and len(b) == 1000
    # b reloads as pq, dequantizes, and demotes again: its codes are a
    # re-quantization of the snapshot's (as in the JAX package), so the
    # same rows, with scores within an int8 step
    want = a.search_batch(mat[:2], "u0", 5)
    assert [[c for c, _ in r] for r in hits] == [[c for c, _ in r] for r in want]
    np.testing.assert_allclose([s for r in hits for _, s in r], [s for r in want for _, s in r],
                               rtol=2e-3)


def _pair(tmp_path, dtype="float32", window_sec=3600.0):
    """Two port index replicas over one journal, like api + worker processes."""

    journal = IndexJournal(str(tmp_path / "journal.db"), compact_window_sec=window_sec)
    a = VectorIndex(dim=DIM, dtype=dtype, device="cpu")
    b = VectorIndex(dim=DIM, dtype=dtype, device="cpu")
    for idx in (a, b):
        idx.attach_journal(journal, "text_collection", str(tmp_path), "text_collection",
                           poll_sec=0.0)  # replay at every search: deterministic
    return journal, a, b


def _rand_rows(rng, n, doc="d1", start=0, user="u1"):
    mat = rng.standard_normal((n, DIM)).astype(np.float32)
    return [VectorRow(chunk_id=f"{doc}-c{start + i}", user_id=user, document_id=doc,
                      modality="text", embedding=mat[i]) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "pq"])
def test_replicas_converge_over_one_journal(dtype, tmp_path):
    rng = np.random.default_rng(6)
    _, a, b = _pair(tmp_path, dtype)
    a.upsert(_rand_rows(rng, 40))
    b.upsert(_rand_rows(rng, 10, doc="d2", start=100))
    a.delete_document("d2")
    b.upsert(_rand_rows(rng, 5, doc="d3", start=200))
    q = rng.standard_normal((2, DIM)).astype(np.float32)
    ha, hb = a.search_batch(q, "u1", 60), b.search_batch(q, "u1", 60)
    assert ha == hb  # the same replay order: the same rows, codes and scores
    assert len(ha[0]) == 45 and not any(c.startswith("d2") for c, _ in ha[0])


def test_journal_persist_tail_and_rejected_upsert(tmp_path):
    rng = np.random.default_rng(7)
    journal, a, b = _pair(tmp_path)
    a.upsert(_rand_rows(rng, 8))
    b.upsert(_rand_rows(rng, 8, doc="d2", start=50))
    # a saves without having searched: the snapshot still holds b's rows
    a.save(str(tmp_path), "text_collection")
    fresh = VectorIndex.load(str(tmp_path), "text_collection", "float32", device="cpu")
    assert len(fresh) == 16 and fresh._loaded_snapshot_seq == 2
    b.upsert(_rand_rows(rng, 4, doc="d3", start=90))  # after the snapshot
    c = VectorIndex.load(str(tmp_path), "text_collection", "float32", device="cpu")
    c.attach_journal(journal, "text_collection", str(tmp_path), "text_collection", poll_sec=0.0)
    assert len(c) == 20  # snapshot rows + the tail replayed
    bad = [VectorRow(chunk_id="x", user_id="u1", document_id="d1", modality="text",
                     embedding=np.zeros(32, np.float32))]
    with pytest.raises(ValueError):
        a.upsert(bad)
    assert journal.max_seq("text_collection") == 3  # peers never see it


def test_gap_recovery_after_compaction_reloads_the_snapshot(tmp_path):
    rng = np.random.default_rng(8)
    journal, a, b = _pair(tmp_path, window_sec=0.0)  # compaction keeps no tail
    a.upsert(_rand_rows(rng, 8))
    a.upsert(_rand_rows(rng, 4, doc="d2", start=50))
    a.save(str(tmp_path), "text_collection")  # b never replayed; the log is compacted
    assert journal.compacted_upto("text_collection") == 2
    assert journal.max_seq("text_collection") == 0
    q = rng.standard_normal((1, DIM)).astype(np.float32)
    hits = b.search_batch(q, "u1", 20)[0]
    assert len(hits) == 12 and b._applied_seq == 2
    want = a.search_batch(q, "u1", 20)[0]  # b renormalized the snapshot's rows
    assert [c for c, _ in hits] == [c for c, _ in want]
    np.testing.assert_allclose([s for _, s in hits], [s for _, s in want], rtol=1e-6)


def test_a_jax_journal_replays_in_the_port(tmp_path):
    """One journal file, a JAX index writing and a port index replaying:
    the schema and payloads are the same."""

    rng = np.random.default_rng(9)
    journal_j = JaxJournal(str(tmp_path / "journal.db"))
    journal_t = IndexJournal(str(tmp_path / "journal.db"))
    j = JaxIndex(dim=DIM, dtype="float32")
    t = VectorIndex(dim=DIM, dtype="float32", device="cpu")
    j.attach_journal(journal_j, "text_collection", str(tmp_path), "text_collection", poll_sec=0.0)
    t.attach_journal(journal_t, "text_collection", str(tmp_path), "text_collection", poll_sec=0.0)
    mat = rng.standard_normal((30, DIM)).astype(np.float32)
    j.upsert([JaxRow(chunk_id=f"c{i}", user_id="u1", document_id=f"d{i % 3}", modality="text",
                     embedding=mat[i]) for i in range(30)])
    j.delete_document("d1")
    q = rng.standard_normal((2, DIM)).astype(np.float32)
    ht, hj = t.search_batch(q, "u1", 30), j.search_batch(q, "u1", 30)
    assert [[c for c, _ in r] for r in ht] == [[c for c, _ in r] for r in hj]
    assert len(ht[0]) == 20


def _engine(tmp_path, journal=True):
    from mmrag_tpu_torch.models import bert, clip
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    cfg = load_settings({
        "TPU_INDEX_DIR": str(tmp_path / "index"), "NOTES_DB_PATH": str(tmp_path / "notes.db"),
        "WEIGHTS_DIR": str(tmp_path / "weights"), "TPU_COMPUTE_DTYPE": "float32",
        "TPU_MICROBATCH_WINDOW_MS": "0", "TPU_JOURNAL_POLL_SEC": "0",
        "TPU_INDEX_JOURNAL": "1" if journal else "0",
    })
    tiny_bert = bert.BertConfig(vocab_size=500, hidden_size=DIM, num_layers=1, num_heads=2,
                                intermediate_size=128, max_position=64)
    tiny_clip = clip.CLIPConfig(
        vision=clip.CLIPVisionConfig(hidden_size=64, num_layers=1, num_heads=2,
                                     intermediate_size=128),
        text=clip.CLIPTextConfig(vocab_size=500, hidden_size=64, num_layers=1, num_heads=2,
                                 intermediate_size=128), projection_dim=32)
    runtime = EncoderRuntime(cfg, bert_cfg=tiny_bert, clip_cfg=tiny_clip, device="cpu")
    return RagEngine(cfg, runtime)


@pytest.mark.parametrize("persist", [True, False])
def test_engine_restart_keeps_its_rows(persist, tmp_path):
    """Rows a RagEngine indexed are there after a restart over the same
    directory: from the snapshot persist_indexes wrote, or, without one,
    replayed from the journal that TPU_INDEX_JOURNAL keeps."""

    rng = np.random.default_rng(10)
    first = _engine(tmp_path)
    assert first.journal is not None
    rows = _rand_rows(rng, 12, user="u1")
    first.text_index.upsert(rows)
    img = [VectorRow(chunk_id=f"i{i}", user_id="u1", document_id="img", modality="image",
                     embedding=v) for i, v in enumerate(rng.standard_normal((5, 32)))]
    first.image_index.upsert(img)
    q = rows[3].embedding[None]
    before = first.text_index.search_batch(q, "u1", 5)
    if persist:
        first.persist_indexes()
    first.close()
    second = _engine(tmp_path)
    assert len(second.text_index) == 12 and len(second.image_index) == 5
    after = second.text_index.search_batch(q, "u1", 5)
    assert [c for c, _ in after[0]] == [c for c, _ in before[0]]
    assert after[0][0][0] == "d1-c3"
    second.close()
    if persist:  # without the journal the snapshot alone restores them
        third = _engine(tmp_path, journal=False)
        assert third.journal is None and len(third.text_index) == 12
        third.close()
