"""The card's route for the approximate top-k (X1) in plain torch, held
exactly equal to its plain version on the CPU.

On the card ``approx_cosine_topk`` never writes out the union of each
bucket's 48 best rows: K-bmax-top's persistent blocks each keep a query's
best k (by score descending, row ascending) while they walk their buckets,
and K-bmax-topk-merge takes the blocks' lists to the answer.
``kernels.bucket_topk_plain`` runs that algorithm step by step (each block's
buckets in ascending order, the list's last score tau, no entry for a score
at or below it, the kernel's placement rule) and ``kernels.topk_merge_plain``
the merge. The key is a total order, so every grid must give exactly the
plain version's ids and scores (``approx_cosine_topk_plain``, one sort of
the union): at 1, 3 and 132 blocks, k 1, 12, 48, 50 and above the list
capacity, on shared and per-query masks, with a fully masked bucket, a
ragged last bucket, fewer live rows than k (the -1e30 fillers in row
order), exact ties across a bucket edge inside a block and across blocks,
and scores that rise with the row (every bucket enters every list). A
hypothesis property covers (n, q, k, grid, mask density) on rows of a
coarse grid of values, where exact ties are everywhere.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import pallas_topk as tpallas
from mmrag_tpu_torch.ops.topk import topk_first

T = kernels.APPROX_TOP
CAP = kernels.TOPK_CAP
GRIDS = [1, 3, 132]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(per_query, q=8, d=16, seed=0):
    """133 buckets (block 0 of a 132-block grid takes buckets 0 and 132),
    the last one ragged (77 rows); bucket 2 fully masked; row 128 a copy of
    row 127 (adjacent buckets: two blocks at grid 3 and 132), rows 394 and
    16906 copies of row 10 (buckets 3 and 132: block 0's at grid 3 and
    132 respectively); queries 0 and 1 sit on the copied rows."""

    rng = np.random.default_rng(seed)
    n = 132 * 128 + 77
    corpus = _unit(rng.standard_normal((n, d)))
    corpus[128] = corpus[127]
    corpus[394] = corpus[16906] = corpus[10]
    queries = _unit(rng.standard_normal((q, d)))
    queries[0], queries[1] = corpus[10], corpus[127]
    tenants = rng.integers(0, 3, n)
    if per_query:
        mask = tenants[None, :] == (np.arange(q) % 3)[:, None]
    else:
        mask = tenants == 0
    mask[..., 256:384] = False
    mask[..., [10, 127, 128, 394, 16906]] = True
    return torch.from_numpy(queries), torch.from_numpy(corpus), torch.from_numpy(mask)


def _blocked(queries, corpus, mask, k, grid):
    """``approx_cosine_topk`` by the kernels' algorithm at ``grid`` blocks:
    the search's own query padding and 32-query launches, each launch
    ``bucket_topk_plain`` then ``topk_merge_plain``."""

    return tpallas._approx_cosine_topk(
        queries, corpus, mask, k,
        lambda qs, c, ms, k: kernels.topk_merge_plain(
            *kernels.bucket_topk_plain(qs, c, ms, k, grid), k))


def _same(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [1, 12, 48, 50])
@pytest.mark.parametrize("grid", GRIDS)
def test_blocked_route_equals_plain(grid, k, per_query):
    queries, corpus, mask = _inputs(per_query, seed=k)
    want = tpallas.approx_cosine_topk_plain(queries, corpus, mask, k)
    _same(_blocked(queries, corpus, mask, k, grid), want)
    if k >= 3:  # the copies tie at the top: the lower row first
        assert want[1][0, :3].tolist() == [10, 394, 16906]
        assert want[1][1, :2].tolist() == [127, 128]


@pytest.mark.parametrize("k", [CAP + 1, 100, 200])
def test_above_the_list_capacity_each_block_takes_what_its_list_holds(k):
    """Above TOPK_CAP a block may take only TOPK_CAP // 48 buckets (one), so
    its whole union fits its list: the grid is the bucket count, and a
    coarser grid is refused rather than answered wrong."""

    queries, corpus, mask = _inputs(True, seed=k)
    nb = -(-corpus.shape[0] // 128)
    grid = kernels.topk_grid(nb, k, 132, torch.bfloat16)
    assert grid == -(-nb // (CAP // T))
    want = tpallas.approx_cosine_topk_plain(queries, corpus, mask, k)
    _same(_blocked(queries, corpus, mask, k, grid), want)
    with pytest.raises(ValueError, match="overflow"):
        kernels.bucket_topk_plain(queries, corpus, mask, k, 3)


@pytest.mark.parametrize("grid", GRIDS)
def test_block_lists_are_each_blocks_best(grid):
    """Each block's list is the top of its own buckets' union by the key,
    sorted, sentinels past its candidates; nothing else is in it."""

    queries, corpus, mask = _inputs(True)
    k = 50
    vals, rows = kernels.bucket_topk_plain(queries, corpus, mask, k, grid)
    uv, ur = kernels.bucket_max_argmax_plain(queries, corpus, mask)
    nb = uv.shape[1]
    assert vals.shape == rows.shape == (queries.shape[0], min(grid, nb), min(k, T * -(-nb // grid)))
    for g in range(vals.shape[1]):
        mine = torch.arange(g, nb, vals.shape[1])
        want = kernels.topk_merge_plain(uv[:, mine], ur[:, mine], min(k, T * len(mine)))
        got_v, got_r = vals[:, g], rows[:, g]
        m = want[0].shape[1]
        assert torch.equal(got_v[:, :m], want[0]) and torch.equal(got_r[:, :m], want[1])
        assert torch.all(got_v[:, m:] == float("-inf"))
        assert torch.all(got_r[:, m:] == kernels.SENTINEL_ROW)


@pytest.mark.parametrize("grid", GRIDS)
def test_fewer_live_rows_than_k_fill_in_row_order(grid):
    """20 live rows of 5,000 at k 50: 30 fillers at -1e30, the lowest rows
    of the union first (each bucket gives its 48 lowest dead rows)."""

    rng = np.random.default_rng(7)
    n = 5000
    corpus = torch.from_numpy(_unit(rng.standard_normal((n, 16))))
    queries = torch.from_numpy(_unit(rng.standard_normal((5, 16))))
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.from_numpy(rng.choice(n, 20, replace=False))] = True
    want = tpallas.approx_cosine_topk_plain(queries, corpus, mask, 50)
    got = _blocked(queries, corpus, mask, 50, grid)
    _same(got, want)
    dead = got[0][:, 20:]
    assert torch.all(dead == kernels.NEG)
    fill = got[1][:, 20:]
    assert torch.all(fill[:, 1:] > fill[:, :-1])  # row order


@pytest.mark.parametrize("grid", GRIDS)
def test_scores_rising_with_the_row(grid):
    """The worst case for the skip: each bucket beats every list, so every
    bucket's 48 best enter (the kernel sorts each bucket, as before)."""

    n = 200 * 128 + 5
    theta = (np.pi / 2) * (n - np.arange(n)) / n
    corpus = np.zeros((n, 8), np.float32)
    corpus[:, 0], corpus[:, 1] = np.cos(theta), np.sin(theta)
    queries = np.zeros((3, 8), np.float32)
    queries[:, 0] = 1.0
    q, c = torch.from_numpy(queries), torch.from_numpy(corpus)
    mask = torch.ones(n, dtype=torch.bool)
    want = tpallas.approx_cosine_topk_plain(q, c, mask, 50)
    _same(_blocked(q, c, mask, 50, grid), want)
    assert int(want[1].min()) >= 199 * 128  # the last two buckets' rows


def test_cpu_wrappers_compose_to_the_plain_version():
    """On CPU tensors ``bucket_topk`` (the plain form at one bucket a block)
    and ``topk_merge`` give ``approx_topk_plain``'s answer, and
    ``approx_topk`` is that plain version."""

    queries, corpus, mask = _inputs(False)
    m = mask[None, :]
    want = kernels.approx_topk_plain(queries, corpus, m, 50)
    lists = kernels.bucket_topk(queries, corpus, m, 50)
    assert lists[0].shape[1] == 133
    _same(kernels.topk_merge(*lists, 50), want)
    _same(kernels.approx_topk(queries, corpus, m, 50), want)


def test_merge_buffers_hold_every_level():
    """The level buffers the merge kernel is given hold every level its loop
    writes (odd list counts included), and its last level is k long."""

    for lists, m, k in [(132, 50, 50), (264, 64, 64), (5, 48, 200), (133, 48, 1000),
                        (2, 1, 2), (3, 7, 21), (8192, 48, 6000)]:
        size_a, size_b = kernels._merge_buffers(lists, m, k)
        nl, ln, in_a = lists, m, True
        while nl > 1:
            ln, nl = min(k, 2 * ln), (nl + 1) // 2
            if nl > 1:
                assert nl * ln <= (size_b if in_a else size_a)
            in_a = not in_a
        assert size_a >= lists * m and ln == k


@settings(max_examples=40, deadline=None, database=None)
@given(n=st.integers(1, 3000), q=st.integers(1, 12), k=st.integers(1, 80),
       grid=st.integers(1, 40), density=st.floats(0.0, 1.0), seed=st.integers(0, 2**16))
def test_property_any_grid_gives_the_plain_answer(n, q, k, grid, density, seed):
    """Rows and queries on a coarse grid of values (exact ties everywhere),
    any mask density, any k the search accepts: the blocked route's ids
    and scores equal the plain version's."""

    rng = np.random.default_rng(seed)
    nb = -(-n // 128)
    k = min(k, n, nb * T)
    corpus = torch.from_numpy(rng.integers(-2, 3, (n, 4)).astype(np.float32) / 4)
    queries = torch.from_numpy(rng.integers(-2, 3, (q, 4)).astype(np.float32) / 4)
    mask = torch.from_numpy(rng.random((q, n)) < density)
    if k > CAP:
        grid = kernels.topk_grid(nb, k, grid, torch.float32)
    want = tpallas.approx_cosine_topk_plain(queries, corpus, mask, k)
    _same(_blocked(queries, corpus, mask, k, grid), want)
    # the plain answer is the union's top-k by the key
    uv, ur = kernels.bucket_max_argmax_plain(queries, corpus, mask)
    order = topk_first(uv.reshape(q, -1), k)
    assert torch.equal(want[0], order.values)
