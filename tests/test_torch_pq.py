"""The port's ``ops/pq.py`` against ``mmrag_tpu.ops.pq``.

The same numpy rows, codebooks and tables go through the JAX functions (the
fused ADC kernels in interpret mode, as ``tests/test_pq.py`` runs them) and
the port's on CPU tensors, which run the plain versions of B10 and B11. ADC
scores are sums of bf16 table entries in j order, so given the same tables
they agree bit for bit (the tables themselves are f32 sums taken in another
order, so a rare entry rounds to the neighbouring bf16). Scores tie often
(equal codes score equal), and the two packages' top-k break ties
differently: sorted score lists are compared exactly, ids only where the
scores are apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrag_tpu.ops import pq as jpq
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import pq as tpq


def _clustered(rng, n=4096, d=64, centers=32, noise=0.25):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    rows = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_tables(queries, books):
    """JAX's bf16 tables, (m, q, K), as a torch tensor."""

    t = jpq._adc_tables(jnp.asarray(queries), jnp.asarray(books)).astype(jnp.bfloat16)
    return _t(np.asarray(jnp.transpose(t, (0, 2, 1)).astype(jnp.float32))).to(torch.bfloat16)


def _same_topk(ts, ti, js, ji):
    """Sorted scores bit for bit; ids wherever the scores are apart."""

    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(np.sort(ts, axis=1), np.sort(js, axis=1))
    for s, a, b in zip(js, ti, ji):
        uniq = np.array([(s == v).sum() == 1 for v in s])
        uniq[-1] = False  # the last place may tie with a row past the list
        uniq &= s > -1e29
        np.testing.assert_array_equal(a[uniq], b[uniq])


def test_train_pq_and_encode_match_jax():
    rng = np.random.default_rng(0)
    rows = _clustered(rng, n=2000)
    jb = jpq.train_pq(jnp.asarray(rows), m=8, iters=4)
    tb = tpq.train_pq(_t(rows), m=8, iters=4)
    assert tb.shape == (8, tpq.PQ_K, 8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    jc = jpq.pq_encode(jnp.asarray(rows), jb)
    tc = tpq.pq_encode(_t(rows), _t(jb))
    assert tc.dtype == torch.int8 and tc.shape == (2000, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # fewer rows than centroids: the init wraps, as in JAX
    small = rows[:100]
    np.testing.assert_allclose(tpq.train_pq(_t(small), m=4, iters=2).numpy(),
                               np.asarray(jpq.train_pq(jnp.asarray(small), m=4, iters=2)),
                               atol=1e-6)
    rc_j = jpq.PQData(jb).reconstruction_cosine(jnp.asarray(rows))
    rc_t = tpq.PQData(_t(jb)).reconstruction_cosine(_t(rows))
    assert rc_t == pytest.approx(rc_j, abs=1e-5) and rc_t > 0.9


def test_adc_tables_match_jax():
    rng = np.random.default_rng(1)
    rows = _clustered(rng, n=1024)
    books = jpq.train_pq(jnp.asarray(rows), m=8, iters=3)
    queries = rows[:5]
    jt = jpq._adc_tables(jnp.asarray(queries), books)
    tt = tpq._adc_tables(_t(queries), _t(books))
    assert tt.shape == (8, 256, 5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    # the f32 sums over a subvector run in another order, so an entry within
    # an f32 ulp of a bf16 rounding midpoint may round to the next bf16
    tb = tt.to(torch.bfloat16).float().numpy()
    jb = np.asarray(jt.astype(jnp.bfloat16).astype(jnp.float32))
    differ = tb != jb
    assert differ.mean() < 1e-3
    np.testing.assert_allclose(tb[differ], jb[differ], rtol=2 ** -7, atol=0)


def _jax_fused(tables_np, codes, bias, k):
    """JAX's _pq_topk_fused on its padded inputs (queries to a multiple of 8,
    rows to a multiple of ADC_TILE, padding masked), interpret mode."""

    m, q, kk = tables_np.shape
    n = codes.shape[0]
    qp = max(8, -(-q // 8) * 8)
    np_ = -(-n // jpq.ADC_TILE) * jpq.ADC_TILE
    tables = np.zeros((m, qp, kk), np.float32)
    tables[:, :q] = tables_np
    codes_p = np.zeros((np_, codes.shape[1]), np.int8)
    codes_p[:n] = codes
    bias_p = np.full((bias.shape[0] if bias.shape[0] == 1 else qp, np_), -1e30, np.float32)
    bias_p[: bias.shape[0], :n] = bias
    s, i = jpq._pq_topk_fused(jnp.asarray(tables).astype(jnp.bfloat16), jnp.asarray(codes_p),
                              jnp.asarray(bias_p), k, True)
    return np.asarray(s)[:q], np.asarray(i)[:q]


@pytest.mark.parametrize("per_query", [False, True])
def test_b10_fused_path_matches_interpret_kernel_and_scan_bit_for_bit(per_query):
    rng = np.random.default_rng(2)
    n = 2 * 2048 + 700  # not a multiple of 2048 or of 128
    rows = _clustered(rng, n=n, centers=64)
    books = jpq.train_pq(jnp.asarray(rows), m=8, iters=3)
    codes = np.asarray(jpq.pq_encode(jnp.asarray(rows), books))
    queries = rows[:5]
    tables = _bf16_tables(queries, books)
    if per_query:
        mask = np.zeros((5, n), bool)
        mask[0, :50] = True
        mask[1, 50:100] = True  # mask[2] all False: an all-masked query
        mask[3, -30:] = True
        mask[4] = rng.random(n) > 0.5
    else:
        mask = np.ones((n,), bool)
        mask[::7] = False
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    bias = bias if per_query else bias[None]
    k = 20
    js, ji = _jax_fused(tables.float().numpy(), codes, bias, k)
    ts, ti = tpq._pq_topk_fused(tables, _t(codes), _t(bias), k)
    _same_topk(ts, ti, js, ji)
    ss, si = jpq._pq_topk_scan(jnp.asarray(queries), books, jnp.asarray(codes),
                               jnp.asarray(mask), k)
    _same_topk(ts, ti, ss, si)
    if per_query:
        assert np.all(ts.numpy()[2] <= -1e29)
        assert set(ti.numpy()[3][ts.numpy()[3] > -1e29]) <= set(range(n - 30, n))


def test_b10_bucket_max_plain_is_the_adc_formula():
    rng = np.random.default_rng(3)
    n, m, q = 1000, 8, 3
    tables = _t(rng.standard_normal((m, q, 256)).astype(np.float32)).to(torch.bfloat16)
    codes = rng.integers(-128, 128, (n, m)).astype(np.int8)
    bias = np.where(rng.random((q, n)) > 0.2, 0.0, -1e30).astype(np.float32)
    got = kernels.adc_bucket_max_plain(tables, _t(codes), _t(bias)).numpy()
    t = tables.float().numpy()
    acc = np.zeros((q, n), np.float32)
    for j in range(m):
        acc = (acc + t[j][:, codes[:, j].astype(np.int64) + 128]).astype(np.float32)
    scores = np.full((q, 8 * 128), np.float32(-1e30))
    scores[:, :n] = acc + bias
    np.testing.assert_array_equal(got, scores.reshape(q, 8, 128).max(-1))


@pytest.mark.parametrize("shared", [False, True])
def test_b11_rescore_matches_interpret_kernel_bit_for_bit(shared):
    rng = np.random.default_rng(4)
    m, q, S = 8, 5, 3000  # S not a multiple of the 2048-candidate tile
    tables = _t(rng.standard_normal((m, q, 256)).astype(np.float32)).to(torch.bfloat16)
    codes = rng.integers(-128, 128, (1 if shared else q, m, S)).astype(np.int8)
    bias = np.where(rng.random((q, S)) > 0.1, 0.0, -1e30).astype(np.float32)
    want = jpq.adc_rescore_scores(jnp.asarray(tables.float().numpy()).astype(jnp.bfloat16),
                                  jnp.asarray(codes), jnp.asarray(bias), interpret=True)
    got = tpq.adc_rescore_scores(tables, _t(codes), _t(bias))
    assert got.shape == (q, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [700, 2048 + 300])
def test_pq_topk_matches_jax_below_and_above_a_tile(n):
    """Below 2048 rows JAX takes its scan, above it its fused kernels; the
    port takes its kernel path at every n. Both give the same scores."""

    rng = np.random.default_rng(n)
    rows = _clustered(rng, n=n, d=32)
    books = jpq.train_pq(jnp.asarray(rows), m=4, iters=3)
    codes = jpq.pq_encode(jnp.asarray(rows), books)
    queries = rows[:3]
    mask = np.zeros((3, n), bool)
    mask[0, :10] = True
    mask[1, 10:] = True  # mask[2] all False
    js, ji = jpq.pq_topk(jnp.asarray(queries), books, codes, jnp.asarray(mask), 8)
    ts, ti = tpq.pq_topk(_t(queries), _t(books), _t(codes), _t(mask), 8)
    _same_topk(ts, ti, js, ji)
    assert set(ti.numpy()[0]) <= set(range(10)) and np.all(ts.numpy()[2] <= -1e29)
    # the port's plain scan gives the same scores
    ps, _ = tpq._pq_topk_scan(_t(queries), _t(books), _t(codes), _t(mask), 8)
    np.testing.assert_array_equal(np.sort(ps.numpy(), 1), np.sort(ts.numpy(), 1))


def test_query_chunks_follow_the_table_budget():
    assert kernels.adc_max_queries(16) == 16
    assert kernels.adc_max_queries(32) == 8 and kernels.adc_max_queries(64) == 4
    rng = np.random.default_rng(5)
    rows = _clustered(rng, n=600, d=64)
    books = tpq.train_pq(_t(rows), m=64, iters=2)  # 4 queries a chunk
    codes = tpq.pq_encode(_t(rows), books)
    queries = _t(rows[:9])
    s, i = tpq.pq_topk(queries, books, codes, torch.ones(600, dtype=torch.bool), 5)
    ss, si = tpq._pq_topk_scan(queries, books, codes, torch.ones(600, dtype=torch.bool), 5)
    np.testing.assert_array_equal(np.sort(s.numpy(), 1), np.sort(ss.numpy(), 1))


def test_refine_exact_matches_jax():
    rng = np.random.default_rng(6)
    rows = _clustered(rng, n=64, d=32)
    q = rows[:2]
    cand_i = np.array([[0, 5, 9, -1], [2, 7, -1, -1]], np.int32)
    neg = np.float32(-1e30)
    cand_s = np.array([[0.9, 0.8, 0.7, neg], [0.7, 0.6, neg, neg]], np.float32)
    ts, ti = tpq.refine_exact(q, rows, cand_i, cand_s, 3)
    js, ji = jpq.refine_exact(q, rows, cand_i, cand_s, 3)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    assert (ts[1][2:] <= -1e29).all()
