"""The port's ``ops/ivf.py`` against ``mmrag_tpu.ops.ivf``.

The same numpy inputs, made from a seed, go through the JAX functions (the
Pallas probe kernels in interpret mode, as ``tests/test_ops_ivf.py`` runs
them) and through the port's on CPU tensors, which run the plain versions of
the B8/B9 kernels. Tolerances: B8 within 1e-5 in f32 (f32 sums in another
order); B9's raw dot and its scaled scores bit for bit (an exact integer dot,
then one rounding each, in JAX's order); layouts built from the same
centroids or the same assignment identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrag_tpu.ops import ivf as jivf
from mmrag_tpu.ops import pq as jpq
from mmrag_tpu.ops import topk as jtopk
from mmrag_tpu_torch.ops import ivf as tivf
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import pq as tpq
from mmrag_tpu_torch.ops import topk as ttopk


def _clustered(rng, n, d=64, centers=24, noise=0.25):
    c = rng.standard_normal((centers, d))
    mat = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    return mat.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _probe_inputs(rng, C=8, B=40, d=64, nprobe=3, qn=4):
    """B = 40 is not a multiple of 128; a fifth of the slots are dead and the
    last query's tenant owns no slot, so every one of its slots is masked."""

    return dict(
        queries=rng.standard_normal((qn, d)).astype(np.float32),
        bucket_ids=rng.permutation(C * B).reshape(C, 1, B).astype(np.int32),
        users_b=rng.integers(0, 3, (C, 1, B)).astype(np.int32),
        docs_b=rng.integers(0, 5, (C, 1, B)).astype(np.int32),
        live_b=(rng.random((C, 1, B)) > 0.2).astype(np.int32),
        probes=rng.integers(0, C, (qn, nprobe)).astype(np.int32),
        uids=np.array([0, 1, 2, 9][:qn], np.int32),
        dids=np.array([-1, 2, -1, -1][:qn], np.int32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [40, 128])
def test_b8_probe_plain_matches_interpret_kernel(dtype, B):
    rng = np.random.default_rng(B)
    inp = _probe_inputs(rng, B=B)
    buckets = rng.standard_normal((8, B, 64)).astype(np.float32)
    jb = jnp.asarray(buckets).astype(dtype)
    args = ("bucket_ids", "users_b", "docs_b", "live_b", "probes", "uids", "dids")
    js, ji = jivf.pallas_probe_scores(jnp.asarray(inp["queries"]), jb,
                                      *(jnp.asarray(inp[a]) for a in args), interpret=True)
    tb = _t(buckets).to(getattr(torch, dtype))
    ts, ti = tivf.pallas_probe_scores(_t(inp["queries"]), tb, *(_t(inp[a]) for a in args))
    assert ts.shape == (4, 3, B) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert np.all(ts.numpy()[3] == np.float32(-1e30))  # the all-masked query
    assert (ts.numpy() == np.float32(-1e30)).sum() == (np.asarray(js) == np.float32(-1e30)).sum()


@pytest.mark.parametrize("B", [40, 128])
def test_b9_probe_plain_matches_interpret_kernel_bit_for_bit(B):
    rng = np.random.default_rng(B + 1)
    inp = _probe_inputs(rng, B=B)
    buckets = rng.integers(-127, 128, (8, B, 64)).astype(np.int8)
    scales = (rng.random((8, 1, B)) * 0.01 + 1e-3).astype(np.float32)
    qq, _ = jtopk.quantize_rows_int8(jnp.asarray(inp["queries"]))
    args = ("bucket_ids", "users_b", "docs_b", "live_b", "probes", "uids", "dids")
    js, ji = jivf.pallas_probe_scores_q(qq.astype(jnp.bfloat16), jnp.asarray(buckets),
                                        jnp.asarray(scales),
                                        *(jnp.asarray(inp[a]) for a in args), interpret=True)
    ts, ti = tivf.pallas_probe_scores_q(_t(qq), _t(buckets), _t(scales),
                                        *(_t(inp[a]) for a in args))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # bitwise, -inf included
    assert np.all(np.isneginf(ts.numpy()[3]))
    # the raw integer dot itself: scale 1 everywhere
    ones = np.ones_like(scales)
    jr, _ = jivf.pallas_probe_scores_q(qq.astype(jnp.bfloat16), jnp.asarray(buckets),
                                       jnp.asarray(ones), *(jnp.asarray(inp[a]) for a in args),
                                       interpret=True)
    tr, _ = tivf.pallas_probe_scores_q(_t(qq), _t(buckets), _t(ones),
                                       *(_t(inp[a]) for a in args))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_cpu_probe_wrappers_count_no_launch():
    rng = np.random.default_rng(3)
    inp = _probe_inputs(rng)
    kernels.reset_launches()
    args = ("bucket_ids", "users_b", "docs_b", "live_b", "probes", "uids", "dids")
    tivf.pallas_probe_scores(_t(inp["queries"]), _t(rng.standard_normal((8, 40, 64))).float(),
                             *(_t(inp[a]) for a in args))
    assert kernels.LAUNCHES["B8"] == 0


def _same_layout(jl, tl):
    for field in ("bucket_ids", "users_b", "docs_b", "live_b", "spill_ids", "spill_users",
                  "spill_docs", "spill_live", "buckets", "spill"):
        np.testing.assert_array_equal(getattr(tl, field).numpy(),
                                      np.asarray(getattr(jl, field)), err_msg=field)
    np.testing.assert_array_equal(tl.slot_of_row, jl.slot_of_row)
    assert tl.built_rows == jl.built_rows and tl.bucket_size == jl.bucket_size


def _predicates(rng, n):
    return rng.integers(0, 3, n).astype(np.int32), rng.integers(0, 4, n).astype(np.int32)


def test_build_ivf_warm_centroids_layout_is_identical():
    rng = np.random.default_rng(0)
    mat = _clustered(rng, 2000)
    users, docs = _predicates(rng, 2000)
    cents = np.asarray(jivf.build_ivf(jnp.asarray(mat), n_clusters=16).centroids)
    jl = jivf.build_ivf(jnp.asarray(mat), centroids=jnp.asarray(cents), bucket_factor=1.0,
                        users=jnp.asarray(users), docs=jnp.asarray(docs))
    tl = tivf.build_ivf(_t(mat), centroids=_t(cents), bucket_factor=1.0, users=_t(users),
                        docs=_t(docs))
    assert tl.spill.shape[0] > 0  # bucket_factor 1.0 spills
    _same_layout(jl, tl)
    assert tl.structure == pytest.approx(jl.structure, abs=1e-6)


def test_build_ivf_int8_scales_layout_is_identical():
    rng = np.random.default_rng(1)
    mat = _clustered(rng, 1500)
    q8, scales = jtopk.quantize_rows_int8(jnp.asarray(mat))
    tq8, tscales = ttopk.quantize_rows_int8(_t(mat))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(scales))
    cents = np.asarray(jivf.build_ivf(q8, n_clusters=16, scales=scales).centroids)
    jl = jivf.build_ivf(q8, centroids=jnp.asarray(cents), scales=scales, bucket_factor=1.0)
    tl = tivf.build_ivf(tq8, centroids=_t(cents), scales=tscales, bucket_factor=1.0)
    _same_layout(jl, tl)
    np.testing.assert_array_equal(tl.scales_b.numpy(), np.asarray(jl.scales_b))
    np.testing.assert_array_equal(tl.spill_scales.numpy(), np.asarray(jl.spill_scales))
    assert tl.structure == pytest.approx(jl.structure, abs=1e-6)


@pytest.mark.parametrize("residual", [False, True])
def test_build_ivf_precomputed_pq_assignment_layout_is_identical(residual):
    rng = np.random.default_rng(2)
    mat = _clustered(rng, 1200)
    books = jpq.train_pq(jnp.asarray(mat), m=8, iters=3)
    codes = jpq.pq_encode(jnp.asarray(mat), books)
    cents, assign = jivf.kmeans(jnp.asarray(mat), 16, iters=3)
    users, docs = _predicates(rng, 1200)
    kw = dict(bucket_factor=0.5, structure_override=0.7, pq_residual=residual)
    jl = jivf.build_ivf(codes, centroids=cents, assign=np.asarray(assign), pq_codebooks=books,
                        users=jnp.asarray(users), docs=jnp.asarray(docs), **kw)
    tl = tivf.build_ivf(_t(codes), centroids=_t(cents), assign=np.asarray(assign),
                        pq_codebooks=_t(books), users=_t(users), docs=_t(docs), **kw)
    _same_layout(jl, tl)
    assert tl.is_pq and tl.structure == 0.7 and tl.pq_residual == residual
    np.testing.assert_array_equal(tl.spill_assign.numpy(), np.asarray(jl.spill_assign))


def _pred_queries(rng, mat, qn=4):
    q = mat[:qn] + 0.01 * rng.standard_normal((qn, mat.shape[1])).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _agree(ts, ti, js, ji, atol):
    """Scores within ``atol``; ids equal wherever the JAX scores are apart
    (the last place may tie with a row past the list, so it is not held)."""

    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)
    for s, a, b in zip(js, ti, ji):
        gap = np.abs(np.diff(s))
        apart = np.concatenate([[True], gap > 1e-6]) & np.concatenate([gap > 1e-6, [False]])
        apart &= s > -1e29
        np.testing.assert_array_equal(a[apart], b[apart])


@pytest.mark.parametrize("kind", ["float32", "int8", "pq"])
def test_ivf_search_pred_matches_jax(kind):
    rng = np.random.default_rng(4)
    mat = _clustered(rng, 2048)
    users, docs = _predicates(rng, 2048)
    live = np.ones(2048, np.int32)
    cents, assign = jivf.kmeans(jnp.asarray(mat), 16, iters=4)
    common = dict(bucket_factor=1.0, users=jnp.asarray(users), docs=jnp.asarray(docs))
    tcommon = dict(bucket_factor=1.0, users=_t(users), docs=_t(docs))
    if kind == "float32":
        jl = jivf.build_ivf(jnp.asarray(mat), centroids=cents, **common)
        tl = tivf.build_ivf(_t(mat), centroids=_t(cents), **tcommon)
    elif kind == "int8":
        q8, sc = jtopk.quantize_rows_int8(jnp.asarray(mat))
        jl = jivf.build_ivf(q8, centroids=cents, scales=sc, **common)
        tl = tivf.build_ivf(_t(q8), centroids=_t(cents), scales=_t(sc), **tcommon)
    else:
        books = jpq.train_pq(jnp.asarray(mat), m=8, iters=4)
        codes = jpq.pq_encode(jnp.asarray(mat), books)
        kw = dict(assign=np.asarray(assign), structure_override=1.0)
        jl = jivf.build_ivf(codes, centroids=cents, pq_codebooks=books, **kw, **common)
        tl = tivf.build_ivf(_t(codes), centroids=_t(cents), pq_codebooks=_t(books), **kw,
                            **tcommon)
    dead = rng.choice(2048, 100, replace=False)
    jl.mark_dead(dead)
    tl.mark_dead(dead)
    live[dead] = 0
    np.testing.assert_array_equal(tl.live_b.numpy(), np.asarray(jl.live_b))
    queries = _pred_queries(rng, mat)
    uids = np.array([0, 1, 2, 7], np.int32)  # tenant 7 owns nothing
    dids = np.array([-1, 1, -1, -1], np.int32)
    js, ji = jivf.ivf_search_pred(jl, jnp.asarray(queries), jnp.asarray(uids),
                                  jnp.asarray(dids), 8, nprobe=6)
    ts, ti = tivf.ivf_search_pred(tl, _t(queries), _t(uids), _t(dids), 8, nprobe=6)
    if kind == "float32":
        _agree(ts, ti, js, ji, 1e-5)
    else:  # an exact integer dot / the same bf16 table sums: bit for bit
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _agree(ts, ti, js, ji, 0.0)
    ti = ti.numpy()
    for q in range(4):
        for row in ti[q][ts.numpy()[q] > -1e29]:
            assert live[row] == 1 and users[row] == uids[q]
            assert dids[q] < 0 or docs[row] == dids[q]
    assert np.all(ts.numpy()[3] <= -1e29)


def test_generic_mask_ivf_search_and_exact_spill():
    rng = np.random.default_rng(5)
    mat = _clustered(rng, 512)
    cents = jivf.build_ivf(jnp.asarray(mat), n_clusters=4).centroids
    jl = jivf.build_ivf(jnp.asarray(mat), centroids=cents, bucket_factor=0.25)
    tl = tivf.build_ivf(_t(mat), centroids=_t(cents), bucket_factor=0.25)
    assert tl.spill.shape[0] > 0
    queries = mat[:3]
    mask = rng.random(512) > 0.3
    js, ji = jivf.ivf_search(jl, jnp.asarray(queries), jnp.asarray(mask), 5, nprobe=4)
    ts, ti = tivf.ivf_search(tl, _t(queries), _t(mask), 5, nprobe=4)
    _agree(ts, ti, js, ji, 1e-5)
    # probing every cluster plus the spill is exact
    es, ei = ttopk.cosine_topk_dense(_t(queries), _t(mat), _t(mask), 5)
    np.testing.assert_array_equal(ti.numpy(), ei.numpy())


def test_kmeans_on_separated_clusters_matches_jax():
    rng = np.random.default_rng(6)
    centers = np.eye(32, dtype=np.float32)[:8] * 3
    labels = rng.integers(0, 8, 800)
    mat = centers[labels] + 0.05 * rng.standard_normal((800, 32)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    tc, ta = tivf.kmeans(_t(mat), 16, iters=6, train_sample=500)
    jc, ja = jivf.kmeans(jnp.asarray(mat), 16, iters=6, train_sample=500)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    # every k-means cluster is pure: it holds rows of one true cluster only
    pairs = set(zip(ta.numpy().tolist(), labels.tolist()))
    assert len({a for a, _ in pairs}) == len(pairs)
    assert {lab for _, lab in pairs} == set(range(8))


def test_sizing_helpers_match_jax():
    for n in (40, 1000, 131072, 1 << 20):
        c = tivf.default_n_clusters(n)
        assert c == jivf.default_n_clusters(n)
        assert tivf.bucket_size(n, c, 1.5) == jivf.bucket_size(n, c, 1.5)
        assert tivf.structureless_baseline(c, 384) == jivf.structureless_baseline(c, 384)
    np.testing.assert_array_equal(tivf._even_indices(300, 200), jivf._even_indices(300, 200))
    assert tivf.default_n_clusters(1 << 20) == 2048 and tivf.bucket_size(1 << 20, 2048, 1.5) == 768
