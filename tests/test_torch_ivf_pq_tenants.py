"""IVF_PQ on tenants whose rows are near-duplicates, against
``mmrag_tpu.index.store``: the geometry of the served tenants in
``chip_smoke.py``'s IVF_PQ pass, whose encoders carry random weights, at a
small size (d 64, 6,640 rows)."""

import numpy as np

from test_torch_index_layouts import D, _both, _clustered, _rows, _same


def _near(rng, center, n, noise):
    x = center + noise * rng.standard_normal((n, center.shape[-1]))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _recall(exact, hits):
    return float(np.mean([len(e & {c for c, _ in h}) / 10 for e, h in zip(exact, hits)]))


def test_ivf_pq_on_near_duplicate_tenants_matches_jax():
    """Served tenants whose rows are near-duplicates of one direction (what
    an encoder with random weights gives) inside a clustered corpus: IVF_PQ
    recall@10 against the exact search falls below the near-row recall, and
    a tenant whose rows sit opposite the query's direction lies in clusters
    the probe never picks, so its search is empty. Both packages give the
    same hits, so both are IVF_PQ's semantics, not the port's."""

    rng = np.random.default_rng(7)
    fill = _clustered(rng, 6000)
    u = rng.standard_normal(D)
    u /= np.linalg.norm(u)
    text = {"a": _near(rng, u, 300, 0.06), "b": _near(rng, u, 300, 0.06)}
    image = _near(rng, -u, 40, 0.06)  # reached only by probing every cluster
    queries = _near(rng, u, 8, 0.06)
    users = ["a", "b"] * 4
    fill_queries = _near(rng, fill[:8], 8, 0.0025)
    hits = {}
    for name, (ix, Row) in _both("pq", "ivf", ivf_min_rows=1024, ivf_nprobe=8).items():
        ix.upsert(_rows(Row, fill[:3000], "fill", "f", 0, "f"))
        for user, rows in text.items():
            ix.upsert(_rows(Row, rows, user, "t", 0, user))
        ix.upsert(_rows(Row, image, "img", "i", 0, "i"))
        ix.upsert(_rows(Row, fill[3000:], "fill", "f", 3000, "f"))
        hits[name] = ix.search_batch_multi(queries, users, 10)
        hits[name + " fill"] = ix.search_batch(fill_queries, "fill", 10)
        hits[name + " image"] = ix.search_batch(queries, "img", 10)
        assert ix._ivf is not None and ix._ivf.is_pq and ix.is_pq
        ix.ivf_nprobe = ix._ivf.n_clusters
        hits[name + " image, every cluster"] = ix.search_batch(queries, "img", 10)
    _same(hits["torch"], hits["jax"])
    assert all(len(h) == 10 for h in hits["torch"])
    assert hits["torch image"] == hits["jax image"] == [[]] * 8
    _same(hits["torch image, every cluster"], hits["jax image, every cluster"])
    assert all(len(h) == 10 for h in hits["torch image, every cluster"])

    exact = [{f"{user}{i}" for i in np.argsort(-(text[user] @ q))[:10]}
             for user, q in zip(users, queries)]
    assert _recall(exact, hits["torch"]) == _recall(exact, hits["jax"]) < 0.9
    # near-row queries of the clustered tenant meet the JAX floor in the same
    # index (the two packages' shortlists may differ at ADC ties)
    exact = [{f"f{i}" for i in np.argsort(-(fill @ q))[:10]} for q in fill_queries]
    assert _recall(exact, hits["torch fill"]) >= 0.9
    assert _recall(exact, hits["jax fill"]) >= 0.9
