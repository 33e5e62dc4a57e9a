"""The approximate top-k (X1, ``TPU_TOPK_BACKEND=approx``) against the JAX
package's on the CPU.

JAX's ``cosine_topk(..., backend="approx")`` is ``jax.lax.approx_max_k``,
which the CPU computes exactly. The port's approximate search keeps the
``APPROX_TOP`` (48) best rows of each 128-row bucket and takes the top-k of
those; on a CPU tensor it runs that algorithm in plain torch (the kernel's
plain version), never an exact top-k. So:

* where no bucket holds more than 48 of a query's true top-k rows, the ids
  equal JAX's, in JAX's order, scores within 1e-6 (f32 sums in another
  order);
* on rows laid out as ingest appends them (each document's chunks in
  contiguous rows, ``chip_smoke.py``'s ``TopicGeometry``, documents of
  16 chunks aligned to the buckets and of 8-24, 16-48 and 32-96 chunks
  across bucket edges), recall@k against the exact top-k is at least 0.95
  at k 50 and 12, and every query's at least ``min(1, 48 / k)``; with one
  row a bucket (the argmax alone) it is far below;
* ``recall_target`` above ``48 / k`` raises, as 48 rows a bucket cannot
  guarantee it;
* ``VectorIndex(backend="approx")`` serves bf16 and f32 slabs and gives
  JAX's hits; int8 and pq refuse ``approx`` with ``ValueError``, as JAX's
  store does;
* on the 8-shard CPU mesh the approximate search gives the single-device
  index's hits and JAX's sharded ones (the exact merge follows each shard).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.index.store import VectorIndex as JIndex
from mmrag_tpu.ops import topk as jtopk
from mmrag_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mmrag_tpu.storage.records import VectorRow as JRow
from mmrag_tpu_torch.index.store import VectorIndex as TIndex
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import pallas_topk as tpallas
from mmrag_tpu_torch.ops import topk as ttopk
from mmrag_tpu_torch.ops.topk import topk_first
from mmrag_tpu_torch.parallel.mesh import build_mesh
from mmrag_tpu_torch.storage.records import VectorRow as TRow

T = kernels.APPROX_TOP


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _max_per_bucket(ids, scores):
    """The most true top-k rows any one bucket holds, over the queries
    (fillers at -1e30 do not count)."""

    worst = 0
    for row, s in zip(ids, scores):
        live = row[s > -1e29]
        if live.size:
            worst = max(worst, int(np.bincount(live // 128).max()))
    return worst


@pytest.mark.parametrize("n,q,k,per_query", [
    (4096, 1, 10, False), (4096, 5, 50, True), (6000, 16, 50, True), (2560, 40, 12, False),
    (300, 3, 20, False)])
def test_plain_approx_matches_jax_where_buckets_hold_few(n, q, k, per_query):
    rng = np.random.default_rng(n + q)
    d = 32
    corpus = _unit(rng.standard_normal((n, d)))
    queries = _unit(rng.standard_normal((q, d)))
    tenants = rng.integers(0, 3, n)
    if per_query:
        mask = tenants[None, :] == (np.arange(q) % 3)[:, None]
    else:
        mask = tenants == 0
    js, ji = jtopk.cosine_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k,
                               backend="approx")
    js, ji = np.asarray(js), np.asarray(ji)
    assert _max_per_bucket(ji, js) <= T  # the condition under which ids are JAX's
    ts, ti = ttopk.cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(mask), k, backend="approx")
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-6)


def test_plain_form_is_the_top_rows_of_each_bucket():
    """``bucket_max_argmax_plain``: per bucket the 48 best rows, descending,
    on equal scores the lower row first; masked rows and rows past n at
    -1e30; its first column is ``bucket_max_plain``'s maximum."""

    rng = np.random.default_rng(3)
    n, d = 300, 16
    corpus = torch.from_numpy(_unit(rng.standard_normal((n, d))))
    corpus[5] = corpus[40]  # an exact tie inside bucket 0
    queries = corpus[[40, 7]].clone()
    mask = torch.from_numpy(rng.random((2, n)) > 0.2)
    mask[:, 5] = mask[:, 40] = True
    vals, rows = kernels.bucket_max_argmax_plain(queries, corpus, mask)
    assert vals.shape == rows.shape == (2, 3, T) and rows.dtype == torch.int32
    np.testing.assert_array_equal(vals[:, :, 0].numpy(),
                                  kernels.bucket_max_plain(queries, corpus, mask).numpy())
    assert rows[0, 0, :2].tolist() == [5, 40]  # the tie: the lower row first
    scores = torch.where(mask, queries @ corpus.T, kernels.NEG)
    for j in range(2):
        for b in range(3):
            r = rows[j, b].long()
            assert ((r >= b * 128) & (r < (b + 1) * 128)).all()
            live = r < n
            np.testing.assert_array_equal(vals[j, b][live].numpy(), scores[j, r[live]].numpy())
            assert (vals[j, b][~live] == kernels.NEG).all()  # rows past n
            assert (vals[j, b][:-1] >= vals[j, b][1:]).all()


def _topic_rows(n, d, seed, doc_rows=None, m=16, topics=256, pool=16, cloud=16):
    """``chip_smoke.py``'s ``TopicGeometry`` fill: each document a cloud of
    chunks (noise 0.25 around its center) in contiguous rows, each center
    sharing half its m subvector patterns with its topic; documents of
    ``cloud`` rows, or of a length drawn from ``doc_rows=(lo, hi)``; a
    document belongs to one of three tenants. Returns the rows, their
    tenants, 16 sampled rows and queries near them (noise 0.02)."""

    rng = np.random.default_rng(seed)
    ds = d // m
    pats = rng.standard_normal((m, pool, ds)).astype(np.float32)
    if doc_rows is None:
        starts = np.arange(0, n, cloud)
    else:
        lens = rng.integers(doc_rows[0], doc_rows[1] + 1, n // doc_rows[0] + 1)
        starts = np.concatenate([[0], np.cumsum(lens)])
        starts = starts[starts < n]
    doc_of = np.searchsorted(starts, np.arange(n), side="right") - 1
    n_centers = len(starts)
    topic_codes = rng.integers(0, pool, (topics, m // 2))
    own = rng.integers(0, pool, (n_centers, m - m // 2))
    codes = np.concatenate([topic_codes[np.arange(n_centers) % topics], own], axis=1)
    centers = np.concatenate([pats[j][codes[:, j]] for j in range(m)], axis=1)
    c = centers[doc_of]
    rows = _unit(c + 0.25 * rng.standard_normal(c.shape, dtype=np.float32))
    tenants = doc_of % 3
    sel = rng.choice(n, 16, replace=False)
    queries = _unit(rows[sel] + 0.02 * rng.standard_normal((16, d)).astype(np.float32))
    return rows, tenants, sel, queries


def _recalls(got, exact):
    return [len(set(g) & set(e)) / len(e) for g, e in zip(got, exact)]


def _recall(got, exact):
    return float(np.mean(_recalls(got, exact)))


@pytest.mark.parametrize("doc_rows", [None, (8, 24), (16, 48), (32, 96)])
@pytest.mark.parametrize("k", [50, 12])
def test_recall_on_contiguous_documents(k, doc_rows):
    """Rows as ingest appends them: each document's chunks contiguous, so a
    query's neighbours cluster in few buckets; documents of 16 chunks
    aligned to the buckets, and of 8-24, 16-48 and 32-96 chunks straddling
    bucket edges (the port's chunking gives about 30 for a 10-page PDF).
    48 rows a bucket meet the 0.95 contract, and every query keeps at least
    ``min(1, 48 / k)`` of its top-k; the argmax alone does not (recall 0.085
    at k 50 on 16-chunk documents, ``tools/approx_recall.py``, where 16 rows
    a bucket gave 0.4625 on 32-96-chunk documents)."""

    rows, tenants, sel, queries = _topic_rows(32768, 64, seed=5, doc_rows=doc_rows)
    mask = torch.from_numpy(tenants[None, :] == tenants[sel][:, None])
    q, c = torch.from_numpy(queries), torch.from_numpy(rows)
    exact = topk_first(torch.where(mask, q @ c.T, -1e30), k).indices.numpy()
    _, got = ttopk.cosine_topk(q, c, mask, k, backend="approx")
    per = _recalls(got.numpy(), exact)
    assert np.mean(per) >= 0.95 and min(per) >= min(1.0, T / k)
    # one row a bucket: the same scores, only each bucket's best kept
    vals, ids = kernels.bucket_max_argmax_plain(q, c, mask)
    one = torch.gather(ids[:, :, 0], 1, topk_first(vals[:, :, 0], k).indices)
    assert _recall(one.numpy(), exact) < 0.5


def test_recall_target_beyond_the_kept_rows_raises():
    """48 rows a bucket guarantee a recall of 48 / k: a ``recall_target``
    that needs more raises; what it can hold runs (the store passes JAX's
    default 0.95, so k up to 50)."""

    c = torch.from_numpy(_unit(np.random.default_rng(2).standard_normal((8192, 8))))
    m = torch.ones(8192, dtype=torch.bool)
    for k, target in ((51, 0.95), (50, 0.97), (49, 1.0)):
        with pytest.raises(ValueError, match="recall_target"):
            ttopk.cosine_topk(c[:2], c, m, k, backend="approx", recall_target=target)
    for k, target in ((50, 0.95), (48, 1.0), (96, 0.5)):
        assert ttopk.cosine_topk(c[:2], c, m, k, backend="approx",
                                 recall_target=target)[1].shape == (2, k)
    ttopk.cosine_topk(c[:2], c, m, 96, backend="auto")  # the exact path takes any k


def test_approx_refuses_too_few_candidates_and_unknown_backends():
    c = torch.from_numpy(_unit(np.random.default_rng(0).standard_normal((128, 8))))
    with pytest.raises(ValueError, match="approx top-k needs"):
        ttopk.cosine_topk(c[:2], c, torch.ones(128, dtype=torch.bool), T + 1, backend="approx")
    for bad in ("xla", "pallas", "ivf"):
        with pytest.raises(ValueError, match="unknown topk backend"):
            ttopk.cosine_topk(c[:2], c, torch.ones(128, dtype=torch.bool), 5, backend=bad)
    with pytest.raises(ValueError, match="recall_target"):
        ttopk.cosine_topk(c[:2], c, torch.ones(128, dtype=torch.bool), 5, backend="approx",
                          recall_target=0.0)


def test_cpu_search_counts_no_launch():
    kernels.reset_launches()
    c = torch.from_numpy(_unit(np.random.default_rng(1).standard_normal((4096, 16))))
    tpallas.approx_cosine_topk(c[:3], c, torch.ones(4096, dtype=torch.bool), 10)
    assert not any(kernels.KERNEL_LAUNCHES.values()) and not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("dtype", ["int8", "pq"])
def test_index_refuses_approx_for_int8_and_pq(dtype):
    with pytest.raises(ValueError):
        JIndex(dim=16, dtype=dtype, backend="approx")
    with pytest.raises(ValueError, match="approx"):
        TIndex(16, dtype=dtype, backend="approx", device="cpu")


def _rows(Row, mat, user, doc, start=0):
    return [Row(chunk_id=f"{doc}-c{start + i}", user_id=user, document_id=doc,
                modality="text", embedding=mat[i]) for i in range(len(mat))]


def _fill(indexes, rng, d):
    mats = [rng.standard_normal((1500, d)).astype(np.float32),
            rng.standard_normal((900, d)).astype(np.float32)]
    for ix, Row in indexes:
        ix.upsert(_rows(Row, mats[0], "u1", "d1"))
        ix.upsert(_rows(Row, mats[1], "u2", "d2", start=1500))
    return mats


def _same(a, b, atol=1e-6):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [c for c, _ in ha] == [c for c, _ in hb]
        np.testing.assert_allclose([s for _, s in hb], [s for _, s in ha], rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_serves_approx_as_jax_does(dtype):
    rng = np.random.default_rng(11)
    d = 32
    j = JIndex(dim=d, dtype=dtype, backend="approx")
    t = TIndex(d, dtype=dtype, backend="approx", device="cpu")
    assert t.backend == "approx" and not t.use_ivf
    _fill([(j, JRow), (t, TRow)], rng, d)
    queries = _unit(rng.standard_normal((6, d)))
    users = ["u1", "u2", "u1", "u2", "nobody", "u1"]
    docs = [None, "d2", "d1", None, None, "d2"]
    got = t.search_batch_multi(queries, users, 12, docs)
    _same(j.search_batch_multi(queries, users, 12, docs), got,
          atol=1e-6 if dtype == "float32" else 1e-5)
    assert got[4] == [] and got[5] == []  # isolation: unknown tenant, u1 has no d2
    _same(j.search_batch(queries[:2], "u1", 50), t.search_batch(queries[:2], "u1", 50),
          atol=1e-6 if dtype == "float32" else 1e-5)


def test_mesh_approx_matches_one_device_and_jax():
    rng = np.random.default_rng(12)
    d = 32
    mesh = build_mesh(devices=["cpu"] * 8)
    sharded = TIndex(d, dtype="float32", backend="approx", device="cpu", mesh=mesh)
    single = TIndex(d, dtype="float32", backend="approx", device="cpu")
    jsharded = JIndex(dim=d, dtype="float32", backend="approx", mesh=jbuild_mesh(model_parallel=1))
    _fill([(sharded, TRow), (single, TRow), (jsharded, JRow)], rng, d)
    assert sharded._slab.shard_rows * 8 == sharded._capacity
    queries = _unit(rng.standard_normal((5, d)))
    users = ["u1", "u2", "u2", "u1", "u1"]
    docs = [None, None, "d2", "d1", None]
    got = sharded.search_batch_multi(queries, users, 50, docs)
    _same(single.search_batch_multi(queries, users, 50, docs), got)
    _same(jsharded.search_batch_multi(queries, users, 50, docs), got)
