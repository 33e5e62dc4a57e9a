"""The port's ``VectorIndex`` layouts against ``mmrag_tpu.index.store``.

Both indexes (JAX and port, device cpu, ``ivf_build_async = False``) take
the same rows for two tenants and three documents, build their layout at the
first search, then take an append tail and a delete-then-add upsert. The
layouts: int8, ivf over bf16, ivf over int8, pq and ivf + pq (the literal
IVF_PQ). Hits must agree: the same ids wherever the scores are apart, and
scores within 1e-6 (bf16/int8: f32 sums in another order; pq: both refine to
exact cosines on the host).
"""

import numpy as np
import pytest
import torch

from mmrag_tpu.index.store import VectorIndex as JIndex
from mmrag_tpu.storage.records import VectorRow as JRow
from mmrag_tpu_torch.index.store import VectorIndex as TIndex
from mmrag_tpu_torch.storage.records import VectorRow as TRow

LAYOUTS = [("int8", "auto"), ("bfloat16", "ivf"), ("int8", "ivf"), ("pq", "auto"),
           ("pq", "ivf")]
D = 64


def _clustered(rng, n, d=D, centers=16, noise=0.25):
    c = rng.standard_normal((centers, d))
    mat = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    return (mat / np.linalg.norm(mat, axis=1, keepdims=True)).astype(np.float32)


def _rows(Row, mat, user, doc, start=0, prefix="c"):
    return [Row(chunk_id=f"{prefix}{start + i}", user_id=user,
                document_id=doc(i) if callable(doc) else doc, modality="text",
                embedding=mat[i]) for i in range(len(mat))]


def _both(dtype, backend, **kw):
    j = JIndex(dim=kw.pop("dim", D), dtype=dtype, backend=backend, **kw)
    t = TIndex(dim=j.dim, dtype=dtype, backend=backend, device="cpu", **kw)
    j.ivf_build_async = t.ivf_build_async = False
    return {"jax": (j, JRow), "torch": (t, TRow)}


@pytest.fixture(scope="module", params=LAYOUTS, ids=["-".join(p) for p in LAYOUTS])
def pair(request):
    dtype, backend = request.param
    rng = np.random.default_rng(0)
    mat = _clustered(rng, 2000)
    both = _both(dtype, backend, ivf_min_rows=1024)
    queries = mat[:8] + 0.05 * rng.standard_normal((8, D)).astype(np.float32)
    for ix, Row in both.values():
        ix.upsert(_rows(Row, mat[:1000], "u1", lambda i: f"d{i % 3}"))
        ix.upsert(_rows(Row, mat[1000:1800], "u2", "e", 1000))
        ix.search_batch(queries[:1], "u1", 3)  # builds the layout
        ix.upsert(_rows(Row, mat[1800:], "u1", "d9", 1800))  # the append tail
        # delete-then-add: c7 moves to a new vector, its old row is tombstoned
        ix.upsert(_rows(Row, mat[1999:], "u1", "d1", 7))
    return {k: v[0] for k, v in both.items()}, mat, queries, (dtype, backend)


USERS = ["u1", "u2"] * 4
DOCS = [None, None, "d1", None, None, "e", "d9", "nope"]


def _same(a, b, atol=1e-6):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb)
        sa = np.array([s for _, s in ha])
        np.testing.assert_allclose([s for _, s in hb], sa, rtol=0, atol=atol)
        for i, ((ca, s), (cb, _)) in enumerate(zip(ha, hb)):
            apart = all(abs(s - o) > 1e-5 for j, o in enumerate(sa) if j != i)
            if apart and i < len(ha) - 1:
                assert ca == cb, (ha, hb)


def test_layout_is_installed(pair):
    idx, _, _, (dtype, backend) = pair
    for ix in idx.values():
        assert (ix._ivf is not None) == (backend == "ivf")
        assert ix.is_pq == (dtype == "pq")
    t = idx["torch"]
    if backend == "ivf":
        assert t._ivf.is_pq == (dtype == "pq")
        assert (t._ivf.scales_b is not None) == (dtype == "int8")
        assert t._ivf.built_rows == 1800 and t._size == 2001
        assert t._ivf.bucket_size == idx["jax"]._ivf.bucket_size
    if dtype == "int8":
        assert t._slab.dtype == torch.int8 and t._scales is not None
    if dtype == "pq":
        assert t._slab.shape[1] == 16 and t._host_slab is not None


def test_multi_tenant_search_matches_jax(pair):
    idx, _, queries, _ = pair
    want = idx["jax"].search_batch_multi(queries, USERS, 10, DOCS)
    got = idx["torch"].search_batch_multi(queries, USERS, 10, DOCS)
    _same(got, want)
    assert got[7] == []  # a document the index never saw


def test_single_tenant_search_matches_jax(pair):
    idx, _, queries, _ = pair
    for user, doc in (("u1", None), ("u2", "e"), ("u1", "d2"), ("nobody", None)):
        _same(idx["torch"].search_batch(queries, user, 6, doc),
              idx["jax"].search_batch(queries, user, 6, doc))


def test_tenant_isolation_and_document_filter(pair):
    idx, _, queries, _ = pair
    t = idx["torch"]
    hits = t.search_batch_multi(queries, USERS, 10, DOCS)
    for user, doc, hs in zip(USERS, DOCS, hits):
        for cid, _ in hs:
            row = t._chunk_to_row[cid]
            assert t._user_intern[user] == int(t._users[row])
            if doc is not None:
                assert t._row_doc[row] == doc


def test_append_tail_and_delete_then_add(pair):
    idx, mat, _, (_, backend) = pair
    for ix in idx.values():
        tail = ix.search(mat[1900], "u1", 3)
        assert tail[0][0] == "c1900" and tail[0][1] > 0.99
        moved = ix.search(mat[1999], "u1", 3)  # c7 now holds mat[1999] (and so does c1999)
        assert {c for c, _ in moved[:2]} == {"c7", "c1999"}
        assert all(c != "c7" or s > 0.99 for c, s in ix.search(mat[7], "u1", 5))
        assert len(ix) == 2000
    if backend == "ivf":  # the old row of c7 is dead in the bucket layout
        layout = idx["torch"]._ivf
        cl, slot = layout.slot_of_row[7]
        dead = layout.live_b[cl, 0, slot] if cl >= 0 else layout.spill_live[slot]
        assert int(dead) == 0


def test_structure_gate_discards_isotropic_data():
    """Uniform rows on the sphere have no cluster structure: both packages
    discard the layout, back off until the corpus doubles, and serve the
    dense path."""

    rng = np.random.default_rng(1)
    mat = rng.standard_normal((2000, D)).astype(np.float32)
    both = _both("float32", "ivf", ivf_min_rows=64)
    out = {}
    for name, (ix, Row) in both.items():
        ix.upsert(_rows(Row, mat, "u1", "d"))
        out[name] = ix.search_batch(mat[:4], "u1", 3)
        assert ix._ivf is None and ix._ivf_poor_at == 2000
        ix.search(mat[5], "u1", 1)
        assert ix._ivf_poor_at == 2000  # no rebuild below twice the rows
    _same(out["torch"], out["jax"])
    assert [h[0][0] for h in out["torch"]] == ["c0", "c1", "c2", "c3"]


def test_pq_quality_gate_demotes_to_int8():
    """Isotropic rows at the text width resist 16-byte codes (reconstruction
    cosine ~0.6 < 0.8): both packages demote the index to int8 and serve it."""

    rng = np.random.default_rng(2)
    mat = rng.standard_normal((2048, 384)).astype(np.float32)
    both = _both("pq", "auto", dim=384)
    for ix, Row in both.values():
        ix.upsert(_rows(Row, mat, "u1", "d"))
        assert not ix.is_pq and ix._pq is None and ix._host_slab is None
    t = both["torch"][0]
    assert t.dtype == torch.int8 and t._slab.dtype == torch.int8 and t._scales is not None
    q = mat[:4] + 0.05 * rng.standard_normal((4, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _same(t.search_batch(q, "u1", 5), both["jax"][0].search_batch(q, "u1", 5))
    t.upsert(_rows(TRow, mat[:8], "u1", "d", 5000))  # appends keep flowing, as int8
    assert len(t) == 2056


def test_pq_gate_keeps_clustered_data_and_retrains_on_growth():
    rng = np.random.default_rng(3)
    mat = _clustered(rng, 700)
    t = TIndex(dim=D, dtype="pq", device="cpu")
    t.upsert(_rows(TRow, mat[:32], "u1", "d"))
    assert t.is_pq and t._pq_trained_at == 32
    t.upsert(_rows(TRow, mat[32:160], "u1", "d", 32))  # 160 >= 4 x 32: retrain
    assert t._pq_trained_at == 160
    t.upsert(_rows(TRow, mat[160:192], "u1", "d", 160))
    assert t._pq_trained_at == 160 and t._size == 192


def test_failed_background_build_raises_at_the_next_search(monkeypatch):
    """A background ivf build that fails (k-means out of memory, say) does
    not leave the index serving the dense path for good: the next search
    raises the failure, and the one after starts a new build."""

    from mmrag_tpu_torch.index import store
    from mmrag_tpu_torch.ops import ivf as tivf

    calls = []

    def fail(*args, **kwargs):
        calls.append(1)
        raise MemoryError("k-means ran out of device memory")

    monkeypatch.setattr(tivf, "build_ivf", fail)
    mat = _clustered(np.random.default_rng(4), 300)
    t = TIndex(dim=D, dtype="float32", backend="ivf", device="cpu", ivf_min_rows=256)
    t.upsert(_rows(TRow, mat, "u1", "d"))
    assert t.search(mat[0], "u1", 3)[0][0] == "c0"  # the dense path serves meanwhile
    store._join_ivf_builds()
    assert calls == [1] and not t._ivf_building
    with pytest.raises(RuntimeError, match="background ivf build failed") as info:
        t.search(mat[0], "u1", 3)
    assert isinstance(info.value.__cause__, MemoryError)
    assert t.search(mat[0], "u1", 3)[0][0] == "c0"  # reported once; builds again
    store._join_ivf_builds()
    assert len(calls) == 2 and t._ivf is None
