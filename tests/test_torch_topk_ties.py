"""Exact score ties: the port returns the JAX package's rows, in its order.

Every top-k of the JAX package is ``jax.lax.top_k``, which puts the lower
index first on a tie. In the two-phase top-ks (B4's ``_fused_topk`` and the
ADC path's ``_pq_topk_fused``) that rule applies twice: phase B orders the
buckets by maximum (a tie: the lower bucket), phase C orders the candidates
laid out in that bucket order. So two equal rows in buckets of different
maxima come out in bucket-rank order, not by row id; below one 2048-row tile
JAX takes its dense top-k, where ties go to the lowest row id. Exact ties
arise when a tenant indexes the same chunk twice (a re-uploaded PDF).

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode on the CPU, as the JAX package's own tests run them) and
through the port on CPU tensors. Identical rows get bit-identical scores on
each side, so ids and their order must be identical, fillers included;
scores within 1e-6 (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.ops import ivf as jivf
from mmrag_tpu.ops import pallas_topk as jpallas
from mmrag_tpu.ops import pq as jpq
from mmrag_tpu.ops import topk as jtopk
from mmrag_tpu_torch.ops import ivf as tivf
from mmrag_tpu_torch.ops import pallas_topk as tpallas
from mmrag_tpu_torch.ops import pq as tpq
from mmrag_tpu_torch.ops import topk as ttopk


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _same(ts, ti, js, ji, atol=1e-6):
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), rtol=0, atol=atol)


def _planted(n, d, q, tie_buckets, top_buckets, seed):
    """Random unit rows; one row ``t`` copied into ``tie_buckets`` (bucket =
    128 rows, at a different offset in each); query i's own vector copied
    into each of ``top_buckets``, so those buckets' maxima beat t's."""

    rng = np.random.default_rng(seed)
    corpus = _unit(rng.standard_normal((n, d)))
    t = corpus[0].copy()
    queries = _unit(t + 0.05 * rng.standard_normal((q, d)))
    for j, b in enumerate(tie_buckets):
        corpus[b * 128 + (7 * j + 3) % 128] = t
    for j, b in enumerate(top_buckets):
        for i in range(q):
            corpus[b * 128 + (11 * j + 5 * i + 40) % 128] = queries[i]
    return corpus, queries


@pytest.mark.parametrize("per_query", [False, True])
def test_b4_ties_follow_bucket_rank_like_jax(per_query):
    n, d, q, k = 4096, 64, 3, 8
    corpus, queries = _planted(n, d, q, (3, 9, 17, 21, 28, 30), (21, 28), 1)
    rng = np.random.default_rng(2)
    mask = rng.random((q, n) if per_query else (n,)) > 0.1
    planted = [b * 128 + (7 * j + 3) % 128 for j, b in enumerate((3, 9, 17, 21, 28, 30))]
    mask[..., planted] = True
    for j, b in enumerate((21, 28)):
        for i in range(q):
            mask[..., b * 128 + (11 * j + 5 * i + 40) % 128] = True
    js, ji = jpallas.fused_cosine_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                       jnp.asarray(mask), k)
    ts, ti = tpallas.fused_cosine_topk(_t(queries), _t(corpus), _t(mask), k)
    _same(ts, ti, js, ji)
    # the tied copies come in bucket-rank order: bucket 21's (max 1.0)
    # before bucket 3's, though its row id is higher
    ids = ti.numpy()[0].tolist()
    assert ids.index(planted[3]) < ids.index(planted[0])


def test_b4_below_one_tile_ties_follow_row_ids_like_jax():
    """n < 2048: JAX's fused top-k is its dense top-k (ties by row id)."""

    n, d, q, k = 1000, 32, 4, 6
    corpus, queries = _planted(n, d, q, (1, 3, 5, 7), (5,), 3)
    mask = np.ones(n, bool)
    js, ji = jpallas.fused_cosine_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                       jnp.asarray(mask), k)
    ts, ti = tpallas.fused_cosine_topk(_t(queries), _t(corpus), _t(mask), k)
    _same(ts, ti, js, ji)
    dense_s, dense_i = ttopk.cosine_topk_dense(_t(queries), _t(corpus), _t(mask), k)
    _same(ts, ti, dense_s, dense_i)


@pytest.mark.parametrize("n", [2060, 4096 + 10])
def test_b4_fillers_take_jax_rows_past_a_ragged_end(n):
    """Fewer valid rows than k: the fillers (-1e30) are JAX's, including the
    ids of its padding rows past n (the last bucket ranks first here)."""

    rng = np.random.default_rng(n)
    corpus = _unit(rng.standard_normal((n, 32)))
    queries = np.stack([corpus[n - 5], _unit(rng.standard_normal(32))])
    mask = np.zeros(n, bool)
    mask[[130, n - 5]] = True
    js, ji = jpallas.fused_cosine_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                       jnp.asarray(mask), 20)
    ts, ti = tpallas.fused_cosine_topk(_t(queries), _t(corpus), _t(mask), 20)
    _same(ts, ti, js, ji)
    assert (ti.numpy() >= n).any()  # a padded row's id among the fillers


def test_dense_int8_and_merge_ties_like_jax():
    rng = np.random.default_rng(4)
    n, d = 300, 32
    corpus = _unit(rng.standard_normal((n, d)))
    corpus[[5, 77, 140, 299]] = corpus[200]
    queries = _unit(corpus[200] + 0.01 * rng.standard_normal((3, d)))
    mask = rng.random((3, n)) > 0.3
    mask[:, [5, 77, 140, 200, 299]] = True
    js, ji = jtopk._cosine_topk_xla(jnp.asarray(queries), jnp.asarray(corpus),
                                    jnp.asarray(mask), 7)
    ts, ti = ttopk.cosine_topk_dense(_t(queries), _t(corpus), _t(mask), 7)
    _same(ts, ti, js, ji)
    q8, sc = jtopk.quantize_rows_int8(jnp.asarray(corpus))
    js, ji = jtopk._cosine_topk_int8(jnp.asarray(queries), q8, sc, jnp.asarray(mask), 7)
    ts, ti = ttopk.cosine_topk_int8(_t(queries), _t(q8), _t(sc), _t(mask), 7)
    _same(ts, ti, js, ji, atol=0)
    a_s = np.array([[0.9, 0.5, 0.5, 0.1]], np.float32)
    b_s = np.array([[0.5, 0.5, 0.2]], np.float32)
    a_i, b_i = np.array([[1, 2, 3, 4]], np.int32), np.array([[9, 8, 7]], np.int32)
    jm = jtopk.merge_topk(*(jnp.asarray(x) for x in (a_s, a_i, b_s, b_i)), 5)
    tm = ttopk.merge_topk(*(_t(x) for x in (a_s, a_i, b_s, b_i)), 5)
    _same(*tm, *jm)


def test_ivf_probe_merge_and_spill_ties_like_jax():
    """One row copied into many slots of the IVF layout (and its spill):
    the probe merge and the spill scorer return JAX's copies in its order."""

    rng = np.random.default_rng(5)
    n, d = 2048, 32
    centers = _unit(rng.standard_normal((8, d)))
    mat = _unit(centers[rng.integers(0, 8, n)] + 0.2 * rng.standard_normal((n, d)))
    copies = rng.choice(n, 24, replace=False)
    mat[copies] = mat[copies[0]]
    users = (np.arange(n) % 2).astype(np.int32)
    users[copies] = 0
    docs = np.zeros(n, np.int32)
    cents, _ = jivf.kmeans(jnp.asarray(mat), 8, iters=4)
    common = dict(bucket_factor=1.0)
    jl = jivf.build_ivf(jnp.asarray(mat), centroids=cents, users=jnp.asarray(users),
                        docs=jnp.asarray(docs), **common)
    tl = tivf.build_ivf(_t(mat), centroids=_t(cents), users=_t(users), docs=_t(docs), **common)
    queries = _unit(mat[copies[0]][None] + 0.01 * rng.standard_normal((2, d)))
    uids, dids = np.zeros(2, np.int32), np.full(2, -1, np.int32)
    js, ji = jivf.ivf_search_pred(jl, jnp.asarray(queries), jnp.asarray(uids),
                                  jnp.asarray(dids), 12, nprobe=8)
    ts, ti = tivf.ivf_search_pred(tl, _t(queries), _t(uids), _t(dids), 12, nprobe=8)
    _same(ts, ti, js, ji, atol=1e-5)
    assert len(set(ti.numpy()[0].tolist()) & set(copies.tolist())) >= 8
    spill_ids = np.asarray(copies, np.int32)
    args = (mat[copies], spill_ids, users[copies], docs[copies], np.ones(24, np.int32))
    js, ji = jivf._spill_scores_pred(jnp.asarray(queries), *(jnp.asarray(a) for a in args),
                                     jnp.asarray(uids), jnp.asarray(dids), 10)
    ts, ti = tivf._spill_scores_pred(_t(queries), *(_t(a) for a in args), _t(uids), _t(dids),
                                     10)
    _same(ts, ti, js, ji, atol=1e-5)


@pytest.mark.parametrize("n", [700, 2048 + 300])
def test_pq_shortlist_and_refine_ties_like_jax(n):
    """Duplicate codes tie exactly in ADC (the same bf16 table sums): the
    shortlist below a tile (JAX's scan) and above it (its fused kernels) and
    the exact host refine give JAX's ids in its order."""

    rng = np.random.default_rng(n + 1)
    rows = _unit(rng.standard_normal((n, 32)))
    rows[rng.choice(n, 30, replace=False)] = rows[3]
    books = jpq.train_pq(jnp.asarray(rows), m=4, iters=3)
    codes = np.asarray(jpq.pq_encode(jnp.asarray(rows), books))
    queries = _unit(rows[3][None] + 0.02 * rng.standard_normal((3, 32)))
    mask = rng.random((3, n)) > 0.2
    js, ji = jpq.pq_topk(jnp.asarray(queries), books, jnp.asarray(codes), jnp.asarray(mask), 16)
    ts, ti = tpq.pq_topk(_t(queries), _t(np.asarray(books)), _t(codes), _t(mask), 16)
    _same(ts, ti, js, ji, atol=0)
    jr = jpq.refine_exact(queries, rows, np.asarray(ji), np.asarray(js), 6)
    tr = tpq.refine_exact(queries, rows, ti.numpy(), ts.numpy(), 6)
    _same(tr[0], tr[1], jr[0], jr[1], atol=0)
