"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA card is present (the decision
is taken inside the fixture, never at import). On a machine with the card::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not need.) Shapes here are small and ragged, to reach the edge
handling; ``chip_smoke.py`` holds the kernels at the main path's shapes.
Tolerances: bf16 outputs within 2 bf16 ulps of the value's scale, f32 within
1e-4 (sums taken in another order). The int8 path: K-quant's codes and
scales and K-gemm-i8's outputs bit for bit (the same IEEE steps: an exact
int32 sum, true division, half-to-even rounding, each epilogue step rounded
on its own), except where an f32 input was itself summed in another order
(a LayerNorm's statistics, the attention context): there a value within an
ulp of a rounding boundary may take the next code, so the B6/B7 blocks are
held within 1e-2 of the output's scale at most and 5e-5 on average (one
int8 step of a product's input row is about 1/127 of the row, a flip in a
first product can flip more codes in the second, and a block sees a few
such flips), plus 2 bf16 ulps at most and 1 on average for a bf16 stream.
B8 within 1e-5 (unit vectors: f32 sums in another order); B9 and B10/B11 bit
for bit (an exact integer dot times one scale; sums of bf16 table entries in
the same order). K-probe groups the (query, probe) pairs by cluster and reads
each probed block once for all of them: ``test_b8_probe_shared_blocks`` and
``test_b9_probe_q_shared_blocks`` hold it, at the same tolerances, where
every query probes the same clusters, where 40 pairs share a cluster, over
every cluster for one query, and where a query lists a cluster twice; d = 33
and 36 reach its copies for rows that are not 16-byte aligned (8-, 4-byte
and byte copies).
K-attn with bf16 operands runs on the tensor cores and skips key tiles that
are all padding; its modes and the skip are held against the plain version
below (``test_kattn_*``, ``test_b12_*``) at the bf16 tolerance above. The
bf16 K-gemm (``wgmma`` on TMA-fed shared memory) and K-bmax (``mma.sync`` on
a cp.async ring, reading the bool mask) are held at ragged shapes in
``test_kgemm_*`` and ``test_kbmax_*`` at the same tolerances (K-bmax: 1e-4,
unit vectors, f32 sums in another order; -1e30 exactly where masked).
K-gemm-i8 (``wgmma`` s8 on TMA-fed shared memory, the weight stored N x K)
is held in ``test_kgemm_i8_*`` (``-k kgemm_i8``) at ragged M, N and K, M = 0
and small M, every epilogue, a bf16 and an f32 residual: bit for bit without
an activation; with one, within one ulp of each value (bf16 out; 4 ulps for
f32) plus 2**-20 of the output's scale (the activation's transcendental is
another implementation); other weight layouts raise.
"""

import pytest
import torch

from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import quant
from mmrag_tpu_torch.ops.attention import (
    fused_attention_block, fused_attention_block_plain, fused_attention_block_q8,
    fused_attention_block_q8_plain, fused_encoder_attention, fused_encoder_attention2d,
    fused_encoder_attention2d_plain, fused_encoder_attention_plain,
)
from mmrag_tpu_torch.ops.layernorm import fused_add_layer_norm
from mmrag_tpu_torch.ops.mlp import (
    fused_mlp_block, fused_mlp_block_plain, fused_mlp_block_q8, fused_mlp_block_q8_plain,
)
from mmrag_tpu_torch.ops.pallas_topk import fused_cosine_topk, fused_cosine_topk_plain
from mmrag_tpu_torch.ops import ivf as ivf_ops
from mmrag_tpu_torch.ops import pq as pq_ops

pytestmark = pytest.mark.cuda

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    clear_all_caches()
    yield
    clear_all_caches()


def _tol(dtype, scale=1.0):
    return (2 * 2 ** -8 if dtype == torch.bfloat16 else 1e-4) * max(scale, 1.0)


def _close(got, want, dtype, scale=1.0):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, scale), err


def _layer(h, inter, dtype, gen):
    def mat(i, o, s=0.05):
        return (torch.randn((i, o), generator=gen) * s).cuda().to(dtype)

    def vec(n, s=0.02, mean=0.0):
        return (torch.randn((n,), generator=gen) * s + mean).cuda()

    return {"qkv": {"kernel": mat(h, 3 * h), "bias": vec(3 * h)},
            "attn_out": {"kernel": mat(h, h), "bias": vec(h)},
            "attn_ln": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
            "ln1": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
            "ln2": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
            "fc1": {"kernel": mat(h, inter, 0.03), "bias": vec(inter)},
            "fc2": {"kernel": mat(inter, h, 0.03), "bias": vec(h)}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,epi,resid", [
    (1, 8, 8, "none", False), (70, 72, 40, "quick_gelu", False),
    (129, 200, 96, "none", True), (64, 1152, 384, "none", False)])
def test_gemm(dtype, m, n, k, epi, resid):
    gen = torch.Generator().manual_seed(m + n)
    a = torch.randn((m, k), generator=gen).cuda().to(dtype)
    w = (torch.randn((k, n), generator=gen) * 0.1).cuda().to(dtype)
    b = torch.randn((n,), generator=gen).cuda()
    r = torch.randn((m, n), generator=gen).cuda().to(dtype) if resid else None
    got = kernels.gemm(a, w, b, r, epi)
    want = kernels.gemm_plain(a, w, b, r, epi)
    torch.cuda.synchronize()
    _close(got, want, dtype, want.float().abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,h,with_delta", [(1, 32, True), (13, 384, True), (37, 768, False),
                                               (1000, 1024, True)])
def test_layer_norm(dtype, rows, h, with_delta):
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, h), generator=gen).cuda().to(dtype)
    d = torch.randn((rows, h), generator=gen).cuda().float() if with_delta else None
    scale = torch.randn((h,), generator=gen).cuda()
    bias = torch.randn((h,), generator=gen).cuda()
    for out_dtype in (dtype, torch.float32):
        got = kernels.layer_norm(x, d, scale, bias, 1e-5, out_dtype)
        want = kernels.layer_norm_plain(x, d, scale, bias, 1e-5, out_dtype)
        torch.cuda.synchronize()
        _close(got, want, out_dtype, scale.abs().max().item() * 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,nh", [(1, 1, 64, 2), (3, 56, 128, 2), (2, 100, 128, 4),
                                      (2, 130, 768, 12)])
def test_attention_and_fully_masked_rows(dtype, b, s, h, nh):
    gen = torch.Generator().manual_seed(b * s)
    qkv = torch.randn((b * s, 3 * h), generator=gen).cuda().to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[-1] = 0  # a batch-padding row: every key masked
    mask = (torch.arange(s)[None, :] < lengths[:, None]).float()
    kbias = ((1.0 - mask) * -1e9).cuda()
    got = kernels.attention(qkv, kbias, nh, s)
    want = kernels.attention_plain(qkv, kbias, nh, s)
    torch.cuda.synchronize()
    _close(got, want, dtype, 4.0)
    assert torch.all(got[(b - 1) * s:] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pre_ln", [False, True])
def test_attention_block(dtype, pre_ln):
    gen = torch.Generator().manual_seed(7)
    b, s, h, nh = 3, 40, 128, 4
    layer = _layer(h, 4 * h, dtype, gen)
    x = torch.randn((b * s, h), generator=gen).cuda().to(dtype)
    mask = (torch.arange(s)[None, :] < torch.tensor([40, 17, 3])[:, None]).int().cuda()
    key = "ln1" if pre_ln else "attn_ln"
    before = kernels.LAUNCHES["B1"]
    got = fused_attention_block(x, layer, nh, s, 1e-5, mask, pre_ln, key)
    assert kernels.LAUNCHES["B1"] == before + 1
    want = fused_attention_block_plain(x, layer, nh, s, 1e-5, mask, pre_ln, key)
    torch.cuda.synchronize()
    _close(got, want, dtype, 8.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_block_and_add_layer_norm(dtype):
    gen = torch.Generator().manual_seed(3)
    layer = _layer(64, 256, dtype, gen)
    x = torch.randn((45, 64), generator=gen).cuda().to(dtype)
    _close(fused_mlp_block(x, layer, 1e-5), fused_mlp_block_plain(x, layer, 1e-5), dtype, 8.0)
    ln = layer["ln2"]
    got = fused_add_layer_norm(x, x, ln["scale"], ln["bias"], 1e-5, dtype)
    want = kernels.layer_norm_plain(x, x, ln["scale"], ln["bias"], 1e-5, dtype)
    _close(got, want, dtype, 4.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,q,per_query", [(1, 8, 1, False), (300, 64, 3, True),
                                             (5000, 384, 17, True), (4096, 512, 40, False)])
def test_bucket_topk(dtype, n, d, q, per_query):
    gen = torch.Generator().manual_seed(n + q)
    corpus = torch.nn.functional.normalize(torch.randn((n, d), generator=gen), dim=1)
    corpus = corpus.cuda().to(dtype)
    queries = torch.nn.functional.normalize(torch.randn((q, d), generator=gen), dim=1).cuda()
    tenants = torch.randint(0, 3, (n,), generator=gen).cuda()
    if per_query:
        mask = tenants[None, :] == (torch.arange(q).cuda() % 3)[:, None]
    else:
        mask = tenants == 0
    k = min(10, n)
    gs, gi = fused_cosine_topk(queries, corpus, mask, k)
    ws, wi = fused_cosine_topk_plain(queries, corpus, mask, k)
    torch.cuda.synchronize()
    assert (gs - ws).abs().max().item() <= 1e-4
    differ = gi != wi
    assert torch.all((gs - ws).abs()[differ] < 1e-3)


def test_wrapper_rejects_bad_input():
    a = torch.zeros((4, 12), device="cuda", dtype=torch.bfloat16)
    w = torch.zeros((12, 8), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.gemm(a, w, torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.layer_norm(a.T, None, torch.ones(4, device="cuda"), torch.zeros(4, device="cuda"),
                           1e-5, torch.float32)


# ---------------------------------------------------------------------------
# The Hopper designs of K-gemm (wgmma fed by TMA) and K-bmax (mma.sync on a
# cp.async ring, the bool mask read in the kernel)
# ---------------------------------------------------------------------------

# the last two: many tiles a persistent block (ragged M and N)
KGEMM_SHAPES = [(64, 64, 16)] + [(m, n, k) for m in (1, 70, 129, 7169)
                                 for n, k in ((72, 40), (72, 3072), (200, 40), (1160, 3072))] + [
    (67000, 1160, 40), (20000, 1160, 3072)]


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("epi", ["none", "quick_gelu"])
@pytest.mark.parametrize("m,n,k", KGEMM_SHAPES)
def test_kgemm_wgmma_tiles(m, n, k, epi, resid, out_dtype):
    """The bf16 K-gemm: one 64 x 64 x 16 tile first (the shared-memory
    descriptors), then ragged M, N that is not a multiple of the 128-wide
    tile, K of 40 (one zero-filled slice) and 3072 (48 slices through the
    ring), blocks that walk many tiles, each epilogue, each output dtype,
    with and without a residual."""

    gen = torch.Generator().manual_seed(m * 7 + n + k)
    a = torch.randn((m, k), generator=gen).cuda().to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen) * k ** -0.5).cuda().to(torch.bfloat16)
    b = (torch.randn((n,), generator=gen) * 0.1).cuda()
    r = torch.randn((m, n), generator=gen).cuda().to(torch.bfloat16) if resid else None
    got = kernels.gemm(a, w, b, r, epi, out_dtype)
    want = kernels.gemm_plain(a, w, b, r, epi, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    _close(got, want, out_dtype, want.float().abs().max().item())


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("d", [8, 64, 384, 512])
@pytest.mark.parametrize("qp", [8, 16, 24, 32])
def test_kbmax_tensor_cores(qp, d, per_query, mask_dtype):
    """The bf16 K-bmax at 1-4 n-tiles of 8 queries, n not a multiple of 128,
    a bucket that the mask kills whole (and, per query, a query it kills
    whole): -1e30 exactly there and past n, the plain maxima elsewhere."""

    gen = torch.Generator().manual_seed(qp * 1000 + d)
    n = 1000 + 8 * qp + d
    corpus = torch.nn.functional.normalize(torch.randn((n, d), generator=gen), dim=1)
    corpus = corpus.cuda().to(torch.bfloat16)
    queries = torch.nn.functional.normalize(torch.randn((qp, d), generator=gen), dim=1)
    queries = queries.cuda().to(torch.bfloat16)
    tenants = torch.randint(0, 3, (n,), generator=gen).cuda()
    if per_query:
        mask = tenants[None, :] == (torch.arange(qp).cuda() % 3)[:, None]
        mask[1] = False
    else:
        mask = tenants == 0
    mask[..., 256:384] = False  # bucket 2
    mask = mask.to(mask_dtype)
    got = kernels.bucket_max(queries, corpus, mask)
    want = kernels.bucket_max_plain(queries, corpus, mask)
    torch.cuda.synchronize()
    assert got.shape == (qp, -(-n // 128))
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.all(got[:, 2] == -1e30)
    if per_query:
        assert torch.all(got[1] == -1e30)


def test_kbmax_and_kgemm_reject_what_they_cannot_take():
    """K-bmax reads a bool or uint8 mask, never an f32 bias, and its bf16
    rows are 16-byte copies; K-gemm's TMA needs 16-byte-aligned operands."""

    corpus = torch.zeros((300, 64), device="cuda", dtype=torch.bfloat16)
    queries = torch.zeros((8, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        kernels.bucket_max(queries, corpus, torch.zeros((1, 300), device="cuda"))
    with pytest.raises(ValueError, match="mask shape"):
        kernels.bucket_max(queries, corpus, torch.ones((3, 300), device="cuda", dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.bucket_max(queries[:, :12].contiguous(), corpus[:, :12].contiguous(),
                           torch.ones(300, device="cuda", dtype=torch.bool))
    buf = torch.zeros((16 * 64 + 8,), device="cuda", dtype=torch.bfloat16)
    a = buf[1:1 + 16 * 64].view(16, 64)  # 2 bytes past an aligned base
    w = torch.zeros((64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.gemm(a, w, torch.zeros(64, device="cuda"))


def test_b4_counts_each_bucket_max_launch():
    # 40 queries take two K-bmax launches (at most 32 a launch); the plain
    # version launches nothing and counts nothing
    gen = torch.Generator().manual_seed(3)
    corpus = torch.nn.functional.normalize(torch.randn((4096, 64), generator=gen), dim=1).cuda()
    queries = torch.nn.functional.normalize(torch.randn((40, 64), generator=gen), dim=1).cuda()
    mask = torch.ones(4096, dtype=torch.bool, device="cuda")
    kernels.reset_launches()
    fused_cosine_topk(queries, corpus, mask, 5)
    fused_cosine_topk_plain(queries, corpus, mask, 5)
    assert kernels.LAUNCHES["B4"] == 2


# K-bmax's top-k form and its merge (X1, ``-k approx``): K-bmax-top keeps
# each persistent block's best k of its buckets' APPROX_TOP-row union while
# the corpus streams, K-bmax-topk-merge takes the blocks' lists to the top-k.
# The lists against ``bucket_topk_plain`` at the kernel's grid, the answer
# against ``approx_topk_plain``: scores within 1e-4 (unit vectors, f32 sums
# in another order), -1e30 exactly where masked and past n, and the same
# rows wherever a score is more than 1e-4 from its neighbours in the plain
# order (a closer pair may swap); masked rows (equal -1e30) in row order on
# both sides. The merge alone is a selection: equal to its plain version.


def _bucket_gaps(queries, corpus, mask):
    """Each bucket's scores sorted (plain f32, masked at -1e30), and at each
    of the first APPROX_TOP places its distance to the nearer neighbour."""

    n = corpus.shape[0]
    s = torch.where(mask if mask.ndim == 2 else mask[None, :], queries.float() @ corpus.float().T,
                    kernels.NEG)
    nb = -(-n // 128)
    s = torch.nn.functional.pad(s, (0, nb * 128 - n), value=kernels.NEG)
    srt = torch.sort(s.reshape(s.shape[0], nb, 128), dim=-1, descending=True).values
    t = kernels.APPROX_TOP
    up = torch.cat([torch.full_like(srt[..., :1], float("inf")), srt[..., :-1] - srt[..., 1:]],
                   dim=-1)
    return torch.minimum(up[..., :t], srt[..., :t] - srt[..., 1:t + 1])


def _list_gaps(vals, below):
    """At each place of sorted lists ``vals`` (..., m), the distance to the
    nearer neighbour, the one past the end given by ``below`` (..., 1)."""

    inf = torch.full_like(vals[..., :1], float("inf"))
    up = torch.cat([inf, vals[..., :-1] - vals[..., 1:]], -1)
    down = torch.cat([vals[..., 1:], below], -1)
    return torch.minimum(up, vals - down)


def _ids_held(got_i, want_s, want_i, tol=1e-4):
    """Ids of a top-k against its plain version's top-(k + 1): equal
    wherever the plain score is more than ``tol`` from both neighbours, and
    wherever it is -1e30 (rows in row order on both sides)."""

    k = got_i.shape[1]
    gaps = _list_gaps(want_s[:, :k], want_s[:, k:k + 1])
    held = (gaps > tol) | (want_s[:, :k] == kernels.NEG)
    return torch.equal(got_i[held], want_i[:, :k][held])


def _approx_inputs(qp, d, per_query, dtype, seed, n):
    gen = torch.Generator().manual_seed(seed)
    corpus = torch.nn.functional.normalize(torch.randn((n, d), generator=gen), dim=1)
    corpus[5] = corpus[40]  # an exact tie inside bucket 0
    corpus = corpus.cuda().to(dtype)
    queries = torch.nn.functional.normalize(torch.randn((qp, d), generator=gen), dim=1)
    queries[0] = corpus[40].float().cpu()  # both tied rows at the top of bucket 0
    queries = queries.cuda().to(dtype)
    tenants = torch.randint(0, 3, (n,), generator=gen).cuda()
    if per_query:
        mask = tenants[None, :] == (torch.arange(qp).cuda() % 3)[:, None]
        mask[1] = False  # a query with no live row: every place a filler
    else:
        mask = tenants == 0
    mask[..., 256:384] = False  # bucket 2: every row masked
    mask[..., 5] = mask[..., 40] = True
    return queries, corpus, mask


@pytest.mark.parametrize("k", [1, 12, 48, 50, 100])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("d", [8, 384])
@pytest.mark.parametrize("qp", [8, 16, 24, 32])
def test_kbmax_top_form_matches_plain(qp, d, per_query, dtype, k):
    """At 60,000 rows (a ragged last bucket; 3-4 buckets a bf16 block, 1-2 an
    f32 one) and k 100, above the lists' capacity (one bucket a block)."""

    n = 60000 + 8 * qp + d
    queries, corpus, mask = _approx_inputs(qp, d, per_query, dtype, qp * 100 + d, n)
    m = mask if per_query else mask[None, :]
    kernels.reset_launches()
    vals, rows = kernels.bucket_topk(queries, corpus, m, k)
    torch.cuda.synchronize()
    assert kernels.KERNEL_LAUNCHES["K-bmax-top"] == 1 and kernels.KERNEL_LAUNCHES["K-bmax"] == 0
    nb = -(-n // 128)
    grid = vals.shape[1]
    assert grid == kernels.topk_grid(nb, k, torch.cuda.get_device_properties(0)
                                     .multi_processor_count, dtype)
    assert rows.dtype == torch.int32 and rows.shape == vals.shape
    # the lists against the plain form at the kernel's grid, one place longer
    # where the list has room (its gaps), else each bucket's order's gaps
    want_v, want_r = kernels.bucket_topk_plain(queries, corpus, m, k, grid)
    assert vals.shape == want_v.shape
    live = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(vals), live)
    assert (vals[live] - want_v[live]).abs().max().item() <= 1e-4
    dead = want_v == kernels.NEG
    assert torch.equal(vals == kernels.NEG, dead)
    if k < kernels.TOPK_CAP:
        longer = kernels.bucket_topk_plain(queries, corpus, m, k + 1, grid)[0]
        below = longer[..., vals.shape[2]:vals.shape[2] + 1]
        if below.shape[-1] == 0:
            below = torch.full_like(vals[..., :1], float("-inf"))
        apart = _list_gaps(want_v, below) > 1e-4
    else:  # one bucket a block: its list is the bucket's top 48
        apart = _bucket_gaps(queries, corpus, m) > 1e-4
    held = (apart & live) | dead
    assert torch.equal(rows[held], want_r[held])
    assert torch.equal(rows[~live], want_r[~live])  # sentinels
    # the merge alone: a selection, equal to its plain version
    kernels.reset_launches()
    got = kernels.topk_merge(vals, rows, k)
    plain = kernels.topk_merge_plain(vals, rows, k)
    torch.cuda.synchronize()
    assert kernels.KERNEL_LAUNCHES["K-bmax-topk-merge"] == 1
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    # the pair against the plain answer
    kernels.reset_launches()
    got_s, got_i = kernels.approx_topk(queries, corpus, m, k)
    want_s, want_i = kernels.approx_topk_plain(queries, corpus, m, k + 1)
    torch.cuda.synchronize()
    assert {key: v for key, v in kernels.KERNEL_LAUNCHES.items() if v} == {
        "K-bmax-top": 1, "K-bmax-topk-merge": 1}
    assert got_s.shape == got_i.shape == (qp, k) and got_i.dtype == torch.int32
    assert (got_s - want_s[:, :k]).abs().max().item() <= 1e-4
    assert torch.equal(got_s == kernels.NEG, want_s[:, :k] == kernels.NEG)
    assert _ids_held(got_i, want_s, want_i)
    if k >= 2:
        assert got_i[0, :2].tolist() == [5, 40]  # the tie: the lower row first
    if per_query:
        assert got_i[1].tolist() == want_i[1, :k].tolist()  # fillers only, in row order


@pytest.mark.parametrize("dtype", DTYPES)
def test_kbmax_top_scores_rising_with_the_row(dtype):
    """Every bucket beats every list (each is sorted by a warp, as the
    lists fill in row order): the answer is the plain version's."""

    n = 100000 + 3
    theta = (torch.pi / 2) * (n - torch.arange(n, dtype=torch.float64)) / n
    corpus = torch.zeros((n, 8), dtype=torch.float64)
    corpus[:, 0], corpus[:, 1] = torch.cos(theta), torch.sin(theta)
    corpus = corpus.float().cuda().to(dtype)
    queries = torch.zeros((8, 8), device="cuda", dtype=dtype)
    queries[:, 0] = 1.0
    mask = torch.ones((1, n), dtype=torch.bool, device="cuda")
    got_s, got_i = kernels.approx_topk(queries, corpus, mask, 50)
    want_s, want_i = kernels.approx_topk_plain(queries, corpus, mask, 51)
    torch.cuda.synchronize()
    assert (got_s - want_s[:, :50]).abs().max().item() <= 1e-4
    assert _ids_held(got_i, want_s, want_i)
    assert int(got_i.min()) >= 0.9 * n  # bf16 rounds the last 3% of rows to 1.0: ties


@pytest.mark.parametrize("lists,m,k", [(132, 50, 50), (264, 64, 64), (3, 48, 100), (2, 1, 2),
                                       (600, 64, 64), (2000, 48, 500)])
def test_topk_merge_in_shared_and_global_buffers(lists, m, k):
    """The merge alone on sorted lists full of exact ties and sentinels, in
    shared memory (the first four) and in the global scratch (the last two,
    past MERGE_SMEM): equal to its plain version."""

    gen = torch.Generator().manual_seed(lists + m + k)
    qp = 5
    vals = torch.randint(-3, 4, (qp, lists, m), generator=gen).float() / 4
    vals[:, :, m // 2:][torch.rand((qp, lists, m - m // 2), generator=gen) < 0.2] = float("-inf")
    rows = torch.randperm(qp * lists * m, generator=gen).reshape(qp, lists, m).int()
    rows[torch.isinf(vals)] = kernels.SENTINEL_ROW
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    rows = torch.gather(rows, -1, order)
    # within a list, equal scores in row order (each list sorted by the key)
    by_row = torch.sort(rows, dim=-1, stable=True)
    v2 = torch.gather(vals, -1, by_row.indices)
    vals, order = torch.sort(v2, dim=-1, descending=True, stable=True)
    rows = torch.gather(by_row.values, -1, order)
    vals, rows = vals.cuda().contiguous(), rows.cuda().contiguous()
    kernels.reset_launches()
    got = kernels.topk_merge(vals, rows, k)
    want = kernels.topk_merge_plain(vals, rows, k)
    torch.cuda.synchronize()
    assert kernels.KERNEL_LAUNCHES["K-bmax-topk-merge"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_approx_wrappers_reject_what_they_cannot_take():
    corpus = torch.zeros((300, 64), device="cuda", dtype=torch.bfloat16)
    queries = torch.zeros((8, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k >= 1"):
        kernels.bucket_topk(queries, corpus, torch.ones(300, device="cuda", dtype=torch.bool), 0)
    with pytest.raises(ValueError, match="mask shape"):
        kernels.bucket_topk(queries, corpus, torch.ones((3, 300), device="cuda", dtype=torch.bool),
                            5)
    vals = torch.zeros((8, 1, 10), device="cuda")
    with pytest.raises(ValueError, match="2 or more lists"):
        kernels.topk_merge(vals, vals.int(), 5)
    with pytest.raises(ValueError, match="2 or more lists"):
        kernels.topk_merge(vals.expand(8, 2, 10).contiguous(), vals.expand(8, 2, 10).int()
                           .contiguous(), 21)


@pytest.mark.parametrize("doc", [16, 64])
def test_approx_search_on_the_card_meets_recall_without_phases_b_c(monkeypatch, doc):
    """``VectorIndex(backend="approx")`` at 65,536 x 64 rows in contiguous
    documents of ``doc`` rows of three tenants (64: two documents a bucket,
    a query's top-50 mostly in one): recall@50 against the exact top-k at
    least 0.95 and every query's at least ``min(1, APPROX_TOP / 50)``, tenant
    isolation, K-bmax-top and its merge launched once a search, and neither
    K-bmax, B4 nor phases B and C."""

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.ops import pallas_topk
    from mmrag_tpu_torch.storage.records import VectorRow

    def never(*a, **k):
        raise AssertionError("phases B and C ran under approx")

    monkeypatch.setattr(pallas_topk, "_topk_rows", never)
    gen = torch.Generator().manual_seed(21)
    n, d = 65536, 64
    centers = torch.randn((n // doc, d), generator=gen)
    x = centers.repeat_interleave(doc, 0) + 0.25 * torch.randn((n, d), generator=gen)
    mat = torch.nn.functional.normalize(x, dim=1).numpy()
    tenant = [f"t{(i // doc) % 3}" for i in range(n)]
    index = VectorIndex(dim=d, backend="approx")
    index.upsert([VectorRow(chunk_id=f"c{i}", user_id=tenant[i], document_id=f"d{i // doc}",
                            modality="text", embedding=mat[i]) for i in range(n)])
    sel = torch.randint(0, n, (16,), generator=gen).tolist()
    q = mat[sel] + 0.02 * torch.randn((16, d), generator=gen).numpy()
    q = q / (q ** 2).sum(1, keepdims=True) ** 0.5
    users = [tenant[i] for i in sel]
    kernels.reset_launches()
    hits = index.search_batch_multi(q, users, 50)
    torch.cuda.synchronize()
    assert kernels.KERNEL_LAUNCHES["K-bmax-top"] == 1
    assert kernels.KERNEL_LAUNCHES["K-bmax-topk-merge"] == 1
    assert kernels.KERNEL_LAUNCHES["K-bmax"] == 0 and kernels.LAUNCHES["B4"] == 0
    scores = torch.from_numpy(q) @ torch.from_numpy(mat).T
    recall = []
    for j, h in enumerate(hits):
        live = torch.tensor([t == users[j] for t in tenant])
        exact = set(torch.topk(torch.where(live, scores[j], -1e30), 50).indices.tolist())
        got = {int(c[1:]) for c, _ in h}
        assert all(tenant[i] == users[j] for i in got)
        recall.append(len(got & exact) / 50)
    assert sum(recall) / len(recall) >= 0.95
    assert min(recall) >= min(1.0, kernels.APPROX_TOP / 50)


# ---------------------------------------------------------------------------
# B5-B7 and their building kernels (K-quant, K-gemm-i8, K-attn's new modes)
# ---------------------------------------------------------------------------


def _close_q8(got, want, dtype, scale=1.0):
    diff = (got.float() - want.float()).abs()
    ulp = 2 ** -8 if dtype == torch.bfloat16 else 0.0
    max_tol = (2 * ulp + 1e-2) * max(scale, 1.0)
    mean_tol = (ulp + 5e-5) * max(scale, 1.0)
    assert diff.max().item() <= max_tol and diff.mean().item() <= mean_tol, (
        diff.max().item(), diff.mean().item())


def _edge_rows(rows, h, dtype, gen):
    """Activations with an all-zero row (the 1e-12 clamp) and a row of exact
    .5 ties (amax 127: scale exactly 1.0)."""

    x = torch.randn((rows, h), generator=gen) * 3
    if rows > 2:
        x[1] = 0.0
        x[2] = torch.randint(-126, 126, (h,), generator=gen).float() + 0.5
        x[2, 0] = 127.0
    return x.cuda().to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,h,ln", [
    (1, 64, False), (37, 384, False), (5, 3072, False), (7, 1536, False), (64, 384, True),
    (129, 768, True),
    # every width class of the 16-byte-load kernel (lanes a row x vectors a lane), rows
    # that fill no whole block, and widths the 16-byte loads cannot take (h % 8 for
    # bf16, h % 4 for f32), which run the scalar-load instances
    (33, 128, False), (3, 200, False), (259, 512, False), (1000, 1000, False),
    (17, 100, False), (5, 300, False), (11, 700, False), (9, 1500, False), (2, 3071, False),
    (66, 1500, True), (3, 3071, True), (30, 200, True)])
def test_row_quant(dtype, rows, h, ln):
    gen = torch.Generator().manual_seed(rows + h)
    x = _edge_rows(rows, h, dtype, gen)
    args = ()
    if ln:
        args = ((torch.randn((h,), generator=gen) * 0.1 + 1).cuda(),
                (torch.randn((h,), generator=gen) * 0.02).cuda(), 1e-5)
    q, scale = kernels.row_quant(x, *args)
    wq, wscale = kernels.row_quant_plain(x, *args)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and scale.shape == (rows,)
    differ = (q.int() - wq.int()).abs()
    if ln:  # f32 statistics summed in another order: rare one-code flips
        assert differ.max().item() <= 1 and differ.sum().item() <= max(1, q.numel() // 1000)
        torch.testing.assert_close(scale, wscale, rtol=1e-5, atol=0)
    else:
        assert differ.max().item() == 0, f"{int((differ > 0).sum())} codes differ"
        assert torch.equal(scale, wscale)
    if rows > 2 and not ln:
        assert torch.all(q[1] == 0) and scale[1].item() == quant.quantize_rows(
            torch.zeros(1, 1))[1].item()
        assert scale[2].item() == 1.0
        assert torch.equal(q[2, 1:].cpu(), torch.round(x[2, 1:].float().cpu()).to(torch.int8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_row_quant_unaligned_rows_take_the_scalar_loads(dtype, offset):
    """A contiguous view that starts off a 16-byte boundary runs the scalar
    loads; its codes are the same."""

    gen = torch.Generator().manual_seed(offset)
    rows, h = 45, 384
    flat = torch.randn((rows * h + offset,), generator=gen).cuda().to(dtype) * 3
    x = flat[offset:].view(rows, h)
    q, scale = kernels.row_quant(x)
    wq, wscale = kernels.row_quant_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, wq) and torch.equal(scale, wscale)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_quant_codes_next_to_every_half_integer(dtype):
    """Values a few ulps either side of every (k + 0.5) * scale: the codes
    hang on the exact quotient there, which the kernel forms from a
    reciprocal and two FMA corrections instead of a division."""

    rows, h = 254, 384
    scale = torch.tensor(3.7, dtype=torch.float32) * (1.0 / 127.0)
    k = torch.arange(-127, 127, dtype=torch.float32)[:, None]  # one row per k
    base = ((k + 0.5) * scale).expand(rows, h).contiguous()
    steps = torch.arange(h, dtype=torch.int32) - h // 2  # -192 .. 191 ulps
    x = (base.view(torch.int32) + steps).view(torch.float32)
    x[:, 0] = 3.7  # the row's amax: the same scale in every row
    x = x.cuda().to(dtype)
    q, s = kernels.row_quant(x)
    wq, ws = kernels.row_quant_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, wq), f"{int((q != wq).sum())} codes differ"
    assert torch.equal(s, ws)


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,epi,resid", [
    (1, 16, 16, "none", None), (70, 48, 32, "quick_gelu", None),
    (129, 96, 64, "gelu_tanh", torch.bfloat16), (128, 1536, 384, "gelu_erf", None),
    (64, 384, 3072, "none", torch.float32), (300, 1152, 384, "none", torch.bfloat16)])
def test_gemm_i8(out_dtype, m, n, k, epi, resid):
    gen = torch.Generator().manual_seed(m + n + k)
    aq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    wq = _nk(torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)).cuda()
    a_scale = (torch.rand((m,), generator=gen) * 0.02).cuda()
    w_scale = (torch.rand((n,), generator=gen) * 0.002).cuda()
    bias = (torch.randn((n,), generator=gen) * 0.1).cuda()
    r = torch.randn((m, n), generator=gen).cuda().to(resid) if resid is not None else None
    got = kernels.gemm_i8(aq, a_scale, wq, w_scale, bias, r, epi, out_dtype)
    want = kernels.gemm_i8_plain(aq, a_scale, wq, w_scale, bias, r, epi, out_dtype)
    torch.cuda.synchronize()
    if epi == "none":  # exact int32 sum, the same rounded steps
        assert torch.equal(got, want)
    else:  # the activation's transcendental differs by an ulp or so
        _close(got, want, out_dtype, 1e-2 * want.float().abs().max().item())


def _nk(w):
    """An (in, out) int8 weight stored N x K (strides (1, K)), the layout of
    ``quant.quantize_weight`` that K-gemm-i8's wgmma reads."""

    return w.t().contiguous().t()


# K-gemm-i8 on wgmma s8: ragged M, N and K around the 128 x 128 tile and the
# 128-byte K-slice, small M (the query embeds), many tiles a persistent block
KGEMM_I8_SHAPES = [(m, n, k) for m in (1, 7, 64, 129, 300)
                   for n, k in ((16, 16), (48, 144), (400, 384), (1152, 1536))] + [
    (4100, 784, 272), (20000, 1536, 384)]


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("resid", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epi", ["none", "quick_gelu", "gelu_tanh", "gelu_erf"])
@pytest.mark.parametrize("m,n,k", KGEMM_I8_SHAPES)
def test_kgemm_i8_wgmma_tiles(m, n, k, epi, resid, out_dtype):
    gen = torch.Generator().manual_seed(3 * m + n + k)
    aq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    aq[0, :] = 127  # the largest sums: 127 * 127 * K, exact in int32
    wq[:, 0] = 127
    aq, wq = aq.cuda(), _nk(wq).cuda()
    a_scale = (torch.rand((m,), generator=gen) * 0.02).cuda()
    w_scale = (torch.rand((n,), generator=gen) * 0.002).cuda()
    bias = (torch.randn((n,), generator=gen) * 0.1).cuda()
    r = torch.randn((m, n), generator=gen).cuda().to(resid) if resid is not None else None
    got = kernels.gemm_i8(aq, a_scale, wq, w_scale, bias, r, epi, out_dtype)
    want = kernels.gemm_i8_plain(aq, a_scale, wq, w_scale, bias, r, epi, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == out_dtype
    if epi == "none":  # exact int32 sum, the same rounded steps
        assert torch.equal(got, want)
    else:  # the activation's transcendental may differ by an f32 ulp or two,
        # and a bf16 output then by one ulp of its own value; near-cancellation
        # in gelu is absolute, within a few f32 ulps of the output's scale
        rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 2 ** -21
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=2 ** -20 * want.float().abs().max().item())


def test_kgemm_i8_empty_rows():
    wq = _nk(torch.ones((32, 16), dtype=torch.int8)).cuda()
    ones = torch.ones(16, device="cuda")
    aq = torch.zeros((0, 32), dtype=torch.int8, device="cuda")
    out = kernels.gemm_i8(aq, torch.ones(0, device="cuda"), wq, ones, ones,
                          out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (0, 16) and out.dtype == torch.bfloat16


def test_kgemm_i8_rejects_other_weight_layouts():
    aq = torch.zeros((4, 32), device="cuda", dtype=torch.int8)
    one4 = torch.ones(4, device="cuda")
    ones = torch.ones(16, device="cuda")
    row_major = torch.zeros((32, 16), device="cuda", dtype=torch.int8)  # (K, N) contiguous
    with pytest.raises(ValueError, match="stored N x K"):
        kernels.gemm_i8(aq, one4, row_major, ones, ones)
    # the first 16 output columns of a wider N x K buffer: strides (1, K), taken in place
    part = _nk(torch.ones((32, 48), dtype=torch.int8)).cuda()[:, :16]
    assert part.stride() == (1, 32)
    out = kernels.gemm_i8(aq, one4, part, ones, ones)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones((4, 16), device="cuda"))  # 0 . w * 1 * 1 + 1
    shifted = torch.zeros(4 * 32 + 1, dtype=torch.int8, device="cuda")[1:].view(4, 32)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        kernels.gemm_i8(shifted, one4, part, ones, ones)


def test_kgemm_i8_keeps_quantize_weight_layout_on_the_card():
    q8 = quant.quantize_linear({"kernel": torch.randn((384, 1152)), "bias": torch.zeros(1152)})
    assert q8["q"].stride() == (1, 384)
    assert {k: v.cuda() for k, v in q8.items()}["q"].stride() == (1, 384)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,nh", [(1, 16, 64, 2), (3, 77, 128, 2), (2, 130, 384, 12)])
def test_attention_f32_context(dtype, b, s, h, nh):
    """K-attn's B6 mode: the stream-dtype MHA with its context written in f32."""

    gen = torch.Generator().manual_seed(b * s + 1)
    qkv = torch.randn((b * s, 3 * h), generator=gen).cuda().to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[-1] = 0
    kbias = ((1.0 - (torch.arange(s)[None, :] < lengths[:, None]).float()) * -1e9).cuda()
    got = kernels.attention(qkv, kbias, nh, s, out_dtype=torch.float32)
    want = kernels.attention_plain(qkv, kbias, nh, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _close(got, want, torch.float32 if dtype == torch.float32 else torch.bfloat16, 4.0)
    assert torch.all(got[(b - 1) * s:] == 0)


def _text_bias(b, s, lengths):
    causal = torch.triu(torch.full((s, s), -1e9), diagonal=1)
    pad = (1.0 - (torch.arange(s)[None, :] < lengths[:, None]).float())[:, None, :] * -1e9
    return (causal[None] + pad).cuda()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,nh", [(1, 512, 8), (3, 64, 2), (16, 512, 8), (17, 128, 4)])
def test_b5_text_attention(dtype, b, h, nh):
    s = 77
    gen = torch.Generator().manual_seed(b + h)
    qkv = torch.randn((b, s, 3 * h), generator=gen).cuda().to(dtype)
    q, k, v = qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:]  # strided views
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    if b > 1:
        lengths[-1] = 0  # batch padding: every key masked, context 0
    bias = _text_bias(b, s, lengths)
    before = kernels.LAUNCHES["B5"]
    got = fused_encoder_attention(q, k, v, nh, bias=bias)
    assert kernels.LAUNCHES["B5"] == before + 1
    want = fused_encoder_attention_plain(q, k, v, nh, bias=bias)
    torch.cuda.synchronize()
    _close(got, want, dtype, 4.0)
    if b > 1:
        assert torch.all(got[-1] == 0)
    # a shared (s, s) causal bias with a key mask, and with no mask (stride 0)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).int().cuda()
    causal = torch.triu(torch.full((s, s), -1e9), diagonal=1).cuda()
    for kwargs in ({"attention_mask": mask, "bias": causal}, {"bias": causal}):
        _close(fused_encoder_attention(q, k, v, nh, **kwargs),
               fused_encoder_attention_plain(q, k, v, nh, **kwargs), dtype, 4.0)


def _q8_layer(h, inter, gen):
    def dense(i, o, std):
        return {"kernel": torch.randn((i, o), generator=gen) * std,
                "bias": torch.randn((o,), generator=gen) * 0.02}

    def ln():
        return {"scale": torch.randn((h,), generator=gen) * 0.1 + 1,
                "bias": torch.randn((h,), generator=gen) * 0.02}

    layer = {"qkv": dense(h, 3 * h, 0.05), "attn_out": dense(h, h, 0.05),
             "fc1": dense(h, inter, 0.03), "fc2": dense(inter, h, 0.03),
             "attn_ln": ln(), "ln1": ln(), "ln2": ln()}
    q8 = quant.quantize_encoder_layer(layer, ("qkv", "attn_out", "fc1", "fc2"))
    return {k: {kk: vv.cuda() for kk, vv in v.items()} for k, v in q8.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("b,s,h,nh", [(1, 16, 64, 2), (7, 77, 128, 4), (128, 16, 384, 12)])
def test_b6_attention_block_q8(dtype, pre_ln, b, s, h, nh):
    gen = torch.Generator().manual_seed(b * s + h)
    qlayer = _q8_layer(h, 2 * h, gen)
    x = _edge_rows(b * s, h, dtype, gen)
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    if b > 1:
        lengths[-1] = 0
    mask = (torch.arange(s)[None, :] < lengths[:, None]).int().cuda()
    key = "ln1" if pre_ln else "attn_ln"
    before = kernels.LAUNCHES["B6"]
    got = fused_attention_block_q8(x, qlayer, nh, s, 1e-5, mask, pre_ln, key)
    assert kernels.LAUNCHES["B6"] == before + 1
    want = fused_attention_block_q8_plain(x, qlayer, nh, s, 1e-5, mask, pre_ln, key)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close_q8(got, want, dtype, 4.0 if not pre_ln else x.float().abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pre_ln,act,h,inter", [(True, "quick_gelu", 768, 3072),
                                                (False, "gelu_tanh", 384, 1536),
                                                (False, "gelu_erf", 64, 128)])
@pytest.mark.parametrize("rows", [1, 45, 128])
def test_b7_mlp_block_q8(dtype, pre_ln, act, h, inter, rows):
    gen = torch.Generator().manual_seed(rows + h)
    qlayer = _q8_layer(h, inter, gen)
    x = _edge_rows(rows, h, dtype, gen)
    before = kernels.LAUNCHES["B7"]
    got = fused_mlp_block_q8(x, qlayer, 1e-5, pre_ln, act)
    assert kernels.LAUNCHES["B7"] == before + 1
    want = fused_mlp_block_q8_plain(x, qlayer, 1e-5, pre_ln, act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close_q8(got, want, dtype, 4.0 if not pre_ln else x.float().abs().max().item())


def test_building_kernels_count_each_launch():
    """Each building call on the card adds one to its kernel's count; a B
    block adds its composition (B6 post-LN: 2 K-quant, 2 K-gemm-i8, 1
    K-attn, 1 K-ln); plain versions add nothing."""

    gen = torch.Generator().manual_seed(5)
    b, s, h, nh = 2, 16, 64, 2
    x = torch.randn((b * s, h), generator=gen).cuda()
    q8 = _q8_layer(h, 2 * h, gen)
    kernels.reset_launches()
    kernels.row_quant(x)
    kernels.row_quant_plain(x)
    assert kernels.KERNEL_LAUNCHES["K-quant"] == 1
    kernels.reset_launches()
    fused_attention_block_q8(x, q8, nh, s, 1e-12)
    fused_attention_block_q8_plain(x, q8, nh, s, 1e-12)
    assert kernels.KERNEL_LAUNCHES == {"K-gemm": 0, "K-gemm-i8": 2, "K-ln": 1, "K-quant": 2,
                                       "K-attn": 1, "K-bmax": 0, "K-bmax-top": 0,
                                       "K-bmax-topk-merge": 0}
    assert kernels.LAUNCHES["B6"] == 1


def test_int8_wrappers_reject_bad_input():
    aq = torch.zeros((4, 24), device="cuda", dtype=torch.int8)
    wq = torch.zeros((24, 16), device="cuda", dtype=torch.int8)
    ones = torch.ones(16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.gemm_i8(aq, torch.ones(4, device="cuda"), wq, ones, ones)
    with pytest.raises(ValueError, match="h <= 3072"):
        kernels.row_quant(torch.zeros((2, 4096), device="cuda"))


# ---------------------------------------------------------------------------
# B8-B11: the IVF probe (K-probe) and the ADC kernels (K-adc)
# ---------------------------------------------------------------------------


def _probe_case(gen, C, B, d, q=5, nprobe=4):
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32).cuda()

    planes = {
        "bucket_ids": torch.randperm(C * B, generator=gen).to(torch.int32).reshape(C, 1, B).cuda(),
        "users_b": ints(0, 3, (C, 1, B)),
        "docs_b": ints(0, 5, (C, 1, B)),
        "live_b": (torch.rand((C, 1, B), generator=gen) > 0.2).to(torch.int32).cuda(),
    }
    probes = ints(0, C, (q, nprobe))
    uids = torch.tensor([0, 1, 2, 9, 0][:q], dtype=torch.int32).cuda()  # tenant 9: all masked
    dids = torch.tensor([-1, 2, -1, -1, 4][:q], dtype=torch.int32).cuda()
    return planes, probes, uids, dids


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,d", [(40, 64), (256, 384), (768, 512), (40, 40), (8, 384),
                                 (40, 33), (40, 36)])
def test_b8_probe(dtype, B, d):
    gen = torch.Generator().manual_seed(B + d)
    C = 16
    planes, probes, uids, dids = _probe_case(gen, C, B, d)
    buckets = torch.nn.functional.normalize(torch.randn((C, B, d), generator=gen), dim=-1)
    queries = torch.nn.functional.normalize(torch.randn((5, d), generator=gen), dim=-1).cuda()
    buckets = buckets.cuda().to(dtype)
    args = (planes["bucket_ids"], planes["users_b"], planes["docs_b"], planes["live_b"],
            probes, uids, dids)
    before = kernels.LAUNCHES["B8"]
    gs, gi = ivf_ops.pallas_probe_scores(queries, buckets, *args)
    assert kernels.LAUNCHES["B8"] == before + 1
    ws, wi = kernels.probe_scores_plain(queries, buckets, *args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert (gs - ws).abs().max().item() <= 1e-5
    assert torch.all(gs[3] == -1e30)


@pytest.mark.parametrize("B,d", [(40, 64), (768, 384), (256, 512), (40, 40), (40, 33),
                                 (40, 36)])
def test_b9_probe_q(B, d):
    gen = torch.Generator().manual_seed(B * d)
    C = 16
    planes, probes, uids, dids = _probe_case(gen, C, B, d)
    buckets = torch.randint(-127, 128, (C, B, d), generator=gen, dtype=torch.int8).cuda()
    scales = (torch.rand((C, 1, B), generator=gen) * 0.01 + 1e-3).cuda()
    qq = torch.randint(-127, 128, (5, d), generator=gen, dtype=torch.int8).cuda()
    args = (planes["bucket_ids"], planes["users_b"], planes["docs_b"], planes["live_b"],
            probes, uids, dids)
    before = kernels.LAUNCHES["B9"]
    gs, gi = ivf_ops.pallas_probe_scores_q(qq, buckets, scales, *args)
    assert kernels.LAUNCHES["B9"] == before + 1
    ws, wi = kernels.probe_scores_q_plain(qq, buckets, scales, *args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gs, ws)  # -inf included
    assert torch.all(torch.isneginf(gs[3]))
    ones = torch.ones_like(scales)  # the raw integer dot itself
    assert torch.equal(ivf_ops.pallas_probe_scores_q(qq, buckets, ones, *args)[0],
                       kernels.probe_scores_q_plain(qq, buckets, ones, *args)[0])


def _shared_probes(gen, pattern, C, q, nprobe):
    """Probe lists that make K-probe share blocks across pairs: every query
    on the same clusters; 40 queries all on clusters 0-3 (40 pairs a
    cluster: more than one tile of 16 and one job of 32); one query over
    every cluster; queries that list one cluster twice."""

    if pattern == "same":
        row = torch.randperm(C, generator=gen)[:nprobe]
        return row.expand(q, nprobe).to(torch.int32).contiguous().cuda()
    if pattern == "many":
        return torch.arange(4, dtype=torch.int32).expand(q, 4).contiguous().cuda()
    if pattern == "all":
        return torch.randperm(C, generator=gen).to(torch.int32)[None].cuda()
    probes = torch.randint(0, C, (q, nprobe), generator=gen, dtype=torch.int32)
    probes[:, 1] = probes[:, 0]  # "twice"
    return probes.cuda()


_SHARING = [("same", 5, 6), ("many", 40, 4), ("all", 1, 16), ("twice", 5, 3)]


def _sharing_case(pattern, q, nprobe, B, d):
    gen = torch.Generator().manual_seed(B * 7 + d + q)
    C = 16
    planes, _, _, _ = _probe_case(gen, C, B, d)
    probes = _shared_probes(gen, pattern, C, q, nprobe)
    uids = torch.tensor([0, 1, 2, 9, 0] * 8, dtype=torch.int32)[:q].cuda()  # 9: all masked
    dids = torch.tensor([-1, 2, -1, -1, 4] * 8, dtype=torch.int32)[:q].cuda()
    args = (planes["bucket_ids"], planes["users_b"], planes["docs_b"], planes["live_b"],
            probes, uids, dids)
    return gen, C, args


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,d", [(40, 40), (8, 384), (300, 64)])
@pytest.mark.parametrize("pattern,q,nprobe", _SHARING)
def test_b8_probe_shared_blocks(pattern, q, nprobe, B, d, dtype):
    gen, C, args = _sharing_case(pattern, q, nprobe, B, d)
    buckets = torch.nn.functional.normalize(torch.randn((C, B, d), generator=gen), dim=-1)
    queries = torch.nn.functional.normalize(torch.randn((q, d), generator=gen), dim=-1).cuda()
    buckets = buckets.cuda().to(dtype)
    before = kernels.LAUNCHES["B8"]
    gs, gi = ivf_ops.pallas_probe_scores(queries, buckets, *args)
    assert kernels.LAUNCHES["B8"] == before + 1
    ws, wi = kernels.probe_scores_plain(queries, buckets, *args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert (gs - ws).abs().max().item() <= 1e-5
    if q > 3:
        assert torch.all(gs[3] == -1e30)


@pytest.mark.parametrize("B,d", [(40, 40), (8, 384), (300, 64)])
@pytest.mark.parametrize("pattern,q,nprobe", _SHARING)
def test_b9_probe_q_shared_blocks(pattern, q, nprobe, B, d):
    gen, C, args = _sharing_case(pattern, q, nprobe, B, d)
    buckets = torch.randint(-127, 128, (C, B, d), generator=gen, dtype=torch.int8).cuda()
    scales = (torch.rand((C, 1, B), generator=gen) * 0.01 + 1e-3).cuda()
    qq = torch.randint(-127, 128, (q, d), generator=gen, dtype=torch.int8).cuda()
    before = kernels.LAUNCHES["B9"]
    gs, gi = ivf_ops.pallas_probe_scores_q(qq, buckets, scales, *args)
    assert kernels.LAUNCHES["B9"] == before + 1
    ws, wi = kernels.probe_scores_q_plain(qq, buckets, scales, *args)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gs, ws)  # -inf included
    if q > 3:
        assert torch.all(torch.isneginf(gs[3]))
    ones = torch.ones_like(scales)  # the raw integer dot itself
    assert torch.equal(ivf_ops.pallas_probe_scores_q(qq, buckets, ones, *args)[0],
                       kernels.probe_scores_q_plain(qq, buckets, ones, *args)[0])


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_probe_counts_clusters_past_shared_memory(kind):
    """More clusters than K-probe's grouping counts in shared memory: the
    counts go to the scratch buffer, with the same results."""

    gen = torch.Generator().manual_seed(12000)
    C, B, d = 12000, 8, 64
    planes, probes, uids, dids = _probe_case(gen, C, B, d)
    args = (planes["bucket_ids"], planes["users_b"], planes["docs_b"], planes["live_b"],
            probes, uids, dids)
    if kind == "int8":
        buckets = torch.randint(-127, 128, (C, B, d), generator=gen, dtype=torch.int8).cuda()
        scales = (torch.rand((C, 1, B), generator=gen) * 0.01 + 1e-3).cuda()
        qq = torch.randint(-127, 128, (5, d), generator=gen, dtype=torch.int8).cuda()
        gs, gi = ivf_ops.pallas_probe_scores_q(qq, buckets, scales, *args)
        ws, wi = kernels.probe_scores_q_plain(qq, buckets, scales, *args)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(gs, ws)
    else:
        buckets = torch.nn.functional.normalize(torch.randn((C, B, d), generator=gen), dim=-1)
        buckets = buckets.cuda().to(torch.bfloat16)
        queries = torch.nn.functional.normalize(torch.randn((5, d), generator=gen), dim=-1).cuda()
        gs, gi = ivf_ops.pallas_probe_scores(queries, buckets, *args)
        ws, wi = kernels.probe_scores_plain(queries, buckets, *args)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi)
        assert (gs - ws).abs().max().item() <= 1e-5


def _adc_tables(gen, m, q):
    return (torch.randn((m, q, 256), generator=gen) * 0.1).to(torch.bfloat16).cuda()


@pytest.mark.parametrize("m", [8, 16, 64])
@pytest.mark.parametrize("n,q,per_query", [(1000, 1, False), (4096 + 300, 16, True),
                                           (70000, 3, False), (129, 16, False)])
def test_b10_bucket_max(m, n, q, per_query):
    gen = torch.Generator().manual_seed(n + q + m)
    q = min(q, kernels.adc_max_queries(m))
    tables = _adc_tables(gen, m, q)
    codes = torch.randint(-128, 128, (n, m), generator=gen, dtype=torch.int8).cuda()
    rows = q if per_query else 1
    bias = torch.where(torch.rand((rows, n), generator=gen) > 0.2, 0.0, -1e30).float().cuda()
    got = kernels.adc_bucket_max(tables, codes, bias)
    want = kernels.adc_bucket_max_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert got.shape == (q, -(-n // 128)) and torch.equal(got, want)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("q", list(range(1, 17)))
def test_b10_bucket_max_every_query_count(q, per_query):
    """Every query count of one launch (the kernel rounds it up to 1, 2, 4, 8
    or 16 and splits 16 over two lanes a row), a ragged last bucket, and with
    per-query masks a query that keeps no row."""

    gen = torch.Generator().manual_seed(100 + q)
    n, m = 3000 + 77, 16
    tables = _adc_tables(gen, m, q)
    codes = torch.randint(-128, 128, (n, m), generator=gen, dtype=torch.int8).cuda()
    bias = torch.where(torch.rand((q if per_query else 1, n), generator=gen) > 0.2, 0.0, -1e30)
    if per_query:
        bias[q // 2] = -1e30
    bias = bias.float().cuda()
    got = kernels.adc_bucket_max(tables, codes, bias)
    want = kernels.adc_bucket_max_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if per_query:
        assert torch.all(got[q // 2] <= -1e29)


@pytest.mark.parametrize("m,offset", [(16, 4), (16, 1), (8, 0), (12, 0), (7, 0), (64, 16)])
def test_b10_code_loads_at_any_alignment(m, offset):
    """Codes read 16 bytes at a time where m % 16 == 0 and the rows are
    16-byte aligned, 4 at a time or byte by byte otherwise."""

    gen = torch.Generator().manual_seed(m + offset)
    n = 2000
    q = min(16, kernels.adc_max_queries(m))
    tables = _adc_tables(gen, m, q)
    flat = torch.randint(-128, 128, (n * m + offset,), generator=gen, dtype=torch.int8).cuda()
    codes = flat[offset:].view(n, m)
    bias = torch.where(torch.rand((q, n), generator=gen) > 0.2, 0.0, -1e30).float().cuda()
    got = kernels.adc_bucket_max(tables, codes, bias)
    want = kernels.adc_bucket_max_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("m,q,S", [(16, 1, 1), (16, 16, 3000), (16, 16, 49152), (8, 5, 2048),
                                   (64, 3, 5000)])
def test_b11_rescore(shared, m, q, S):
    gen = torch.Generator().manual_seed(m + q + S)
    tables = _adc_tables(gen, m, q)
    codes = torch.randint(-128, 128, (1 if shared else q, m, S), generator=gen,
                          dtype=torch.int8).cuda()
    bias = torch.where(torch.rand((q, S), generator=gen) > 0.1, 0.0, -1e30).float().cuda()
    before = kernels.LAUNCHES["B11"]
    got = pq_ops.adc_rescore_scores(tables, codes, bias)
    assert kernels.LAUNCHES["B11"] == before + 1
    want = kernels.adc_rescore_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [1, 16, 32])
def test_pq_topk_kernels_match_plain_and_count_each_chunk(q):
    """B10 takes at most 16 queries a launch at m 16 (its tables fill 128 KB
    of shared memory): 32 queries make two B10 and two B11 launches. Scores
    bit for bit; an all-masked query gets fillers only."""

    gen = torch.Generator().manual_seed(q)
    n, d, m = 6000, 64, 16
    rows = torch.nn.functional.normalize(torch.randn((n, d), generator=gen), dim=-1).cuda()
    books = pq_ops.train_pq(rows, m=m, iters=3)
    codes = pq_ops.pq_encode(rows, books)
    queries = rows[:q] + 0.01
    tenants = torch.randint(0, 3, (n,), generator=gen).cuda()
    mask = tenants[None, :] == (torch.arange(q).cuda() % 4)[:, None]  # query 3: tenant 3, none
    kernels.reset_launches()
    gs, gi = pq_ops.pq_topk(queries, books, codes, mask, 40)
    chunks = -(-q // 16)
    assert kernels.LAUNCHES["B10"] == chunks and kernels.LAUNCHES["B11"] == chunks
    ws, wi = pq_ops._pq_topk_scan(queries, books, codes, mask, 40)
    assert kernels.LAUNCHES["B10"] == chunks  # the plain scan launches nothing
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(gs, dim=1).values, torch.sort(ws, dim=1).values)
    if q > 3:
        assert torch.all(gs[3] <= -1e29)
    valid = gs > -1e29
    assert torch.all(mask.gather(1, gi.long())[valid])


# ---------------------------------------------------------------------------
# B12 and the tensor-core K-attn (bf16 operands): every mode, ragged s, the
# skip of key tiles that are all padding, and the checks its copies need
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,nh", [(3, 77, 384, 12), (2, 512, 384, 12), (5, 64, 128, 2),
                                      (17, 50, 64, 2)])
def test_b12_attention2d(dtype, b, s, h, nh):
    """B12 over three separate (b*s, h) tensors against its plain version; a
    batch-padding row gets exactly 0; one launch a call."""

    gen = torch.Generator().manual_seed(b * s + h)
    q, k, v = (torch.randn((b * s, h), generator=gen).cuda().to(dtype) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[-1] = 0
    mask = (torch.arange(s)[None, :] < lengths[:, None]).int().cuda()
    before = kernels.LAUNCHES["B12"]
    got = fused_encoder_attention2d(q, k, v, nh, s, mask)
    assert kernels.LAUNCHES["B12"] == before + 1
    want = fused_encoder_attention2d_plain(q, k, v, nh, s, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b * s, h)
    _close(got, want, dtype, 4.0)
    assert torch.all(got[(b - 1) * s:] == 0)
    _close(fused_encoder_attention2d(q, k, v, nh, s), fused_encoder_attention2d_plain(q, k, v, nh, s),
           dtype, 4.0)


def _kattn_inputs(b, s, hd, gen, nh=2):
    h = nh * hd
    qkv = torch.randn((b * s, 3 * h), generator=gen).cuda().to(torch.bfloat16)
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    if b > 1:
        lengths[-1] = 0  # batch padding: every key masked
    return qkv, lengths, h, nh


@pytest.mark.parametrize("s", [1, 50, 56, 64, 77, 130, 512])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("mode", ["key row", "key row f32 context", "full bias",
                                  "shared bias"])
def test_kattn_tensor_core_modes(s, hd, mode):
    """Every mode of the bf16 (tensor-core) K-attn at ragged s: the (b, s) key
    row with a bf16 or f32 context (B1, B6), the (b, s, s) bias and the
    shared (s, s) bias at batch stride 0 (B5)."""

    gen = torch.Generator().manual_seed(s * hd)
    b = 3
    qkv, lengths, h, nh = _kattn_inputs(b, s, hd, gen)
    keep = (torch.arange(s)[None, :] < lengths[:, None]).float()
    if mode.startswith("key row"):
        kbias = ((1.0 - keep) * -1e9).cuda()
        out_dtype = torch.float32 if "f32" in mode else None
        got = kernels.attention(qkv, kbias, nh, s, out_dtype=out_dtype)
        want = kernels.attention_plain(qkv, kbias, nh, s, out_dtype=out_dtype)
        assert got.dtype == (out_dtype or torch.bfloat16)
    else:
        t = qkv.reshape(b, s, 3 * h)
        q, k, v = t[..., :h], t[..., h:2 * h], t[..., 2 * h:]
        causal = torch.triu(torch.full((s, s), -1e9), diagonal=1)
        if mode == "full bias":
            bias = (causal[None] + (1.0 - keep)[:, None, :] * -1e9).cuda()
        else:
            bias = causal.cuda()
        got = kernels.attention_full_bias(q, k, v, bias, nh).reshape(b * s, h)
        want = kernels.attention_full_bias_plain(q, k, v, bias, nh).reshape(b * s, h)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, 4.0)
    if mode != "shared bias" and b > 1:
        assert torch.all(got[(b - 1) * s:] == 0)


@pytest.mark.parametrize("hd", [32, 64])
def test_kattn_skips_dead_tiles_anywhere_in_the_row(hd):
    """Key tiles that are all padding may sit anywhere in the row (the JAX
    semantics allow holes): a masked 64-key tile in the middle, scattered
    masked keys in the live tiles, a live tile after a dead one."""

    gen = torch.Generator().manual_seed(hd)
    b, s = 2, 512
    qkv, _, h, nh = _kattn_inputs(b, s, hd, gen)
    keep = (torch.rand((b, s), generator=gen) > 0.3).float()
    keep[:, 64:128] = 0.0  # a whole dead tile in the middle
    keep[0, 256:448] = 0.0  # three more in row 0, then a live last tile
    keep[1, :64] = 0.0  # the first tile dead in row 1
    kbias = ((1.0 - keep) * -1e9).cuda()
    got = kernels.attention(qkv, kbias, nh, s)
    want = kernels.attention_plain(qkv, kbias, nh, s)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, 4.0)  # the plain version computes every key


def test_kattn_rejects_what_its_copies_cannot_take():
    """16-byte-aligned bases, a row stride that is a multiple of 8 elements,
    head dims of 32 or 64: the tensor-core kernel's cp.async and ldmatrix
    need them, and the wrappers raise before launching."""

    kbias = torch.zeros((2, 16), device="cuda")
    buf = torch.zeros((32 * 64 + 8,), device="cuda", dtype=torch.bfloat16)
    q = buf[1:1 + 32 * 64].view(32, 64)  # 2 bytes past an aligned base
    ok = torch.zeros((32, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.attention_separate(q, ok, ok, kbias, 2, 16)
    wide = torch.zeros((32, 3 * 64 + 4), device="cuda", dtype=torch.bfloat16)
    views = wide[:, :64], wide[:, 64:128], wide[:, 128:192]  # row stride 196
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.attention_separate(*views, kbias, 2, 16)
    with pytest.raises(ValueError, match="head dim"):
        kernels.attention_separate(ok, ok, ok, kbias, 4, 16)  # head dim 16
    with pytest.raises(ValueError, match="head dim"):
        fused_encoder_attention2d(ok, ok, ok, 4, 16)


# ---------------------------------------------------------------------------
# K-ln's width classes and B11's runs and query groups
# ---------------------------------------------------------------------------


def _dt_id(dt):
    return "none" if dt is None else str(dt).replace("torch.", "")


KLN_TYPES = [(x, d, o) for x in DTYPES for d in (None, *DTYPES) for o in DTYPES]


def _kln_case(rows, h, x_dt, d_dt, gen, offset=0, which="x"):
    """x (and delta) as contiguous views ``offset`` elements past an aligned
    base when ``which`` names them; scale and bias as on the path."""

    def make(dt, s, off):
        flat = (torch.randn((rows * h + off,), generator=gen) * s).cuda().to(dt)
        return flat[off:].view(rows, h)

    x = make(x_dt, 1.0, offset if which == "x" else 0)
    d = None if d_dt is None else make(d_dt, 0.5, offset if which == "delta" else 0)
    scale = (torch.randn((h,), generator=gen) * 0.1 + 1).cuda()
    bias = (torch.randn((h,), generator=gen) * 0.02).cuda()
    return x, d, scale, bias


@pytest.mark.parametrize("x_dt,d_dt,out_dt", KLN_TYPES,
                         ids=["-".join(map(_dt_id, t)) for t in KLN_TYPES])
@pytest.mark.parametrize("rows", [1, 7, 513, 4096])
@pytest.mark.parametrize("h", [32, 33, 40, 128, 192, 256, 384, 512, 768, 1024])
def test_kln_width_classes(h, rows, x_dt, d_dt, out_dt):
    """Every width class of K-ln's 16-byte vectors of x, lanes a row x
    vectors a lane (bf16, 8 values a vector: h 32/40 8 x 1, 128 16 x 1,
    192/256 16 x 2, 384 16 x 3, 512 32 x 2, 768 32 x 3, 1024 32 x 4; f32, 4
    values: h 32 8 x 1, 40 16 x 1, 128 16 x 2, 192 16 x 3, 256 32 x 2, 384
    32 x 3, 512 32 x 4, 768 32 x 6, 1024 32 x 8), h 33 on the scalar loads,
    rows that fill no whole warp or block, and every (x, delta, out) type.
    The statistics are f32 sums in another order than the plain version's:
    f32 out within 1e-4 of the output's scale, bf16 out within 2 ulps of it."""

    gen = torch.Generator().manual_seed(rows * 7 + h)
    x, d, scale, bias = _kln_case(rows, h, x_dt, d_dt, gen)
    before = kernels.KERNEL_LAUNCHES["K-ln"]
    got = kernels.layer_norm(x, d, scale, bias, 1e-12, out_dt)
    assert kernels.KERNEL_LAUNCHES["K-ln"] == before + 1
    want = kernels.layer_norm_plain(x, d, scale, bias, 1e-12, out_dt)
    torch.cuda.synchronize()
    assert got.dtype == out_dt and got.shape == (rows, h)
    _close(got, want, out_dt, want.float().abs().max().item())


@pytest.mark.parametrize("x_dt,d_dt", [(torch.bfloat16, torch.bfloat16), (torch.float32, None)],
                         ids=["bfloat16-bfloat16", "float32-none"])
@pytest.mark.parametrize("h", [40, 384, 768, 1024])
def test_kln_launch_larger_than_the_card_holds(h, x_dt, d_dt):
    """50,000 rows: more than the card holds at once, so scale and bias are
    loaded after the statistics (the rerank's post-LN at 65,536 rows, CLIP
    vision's pre-LN at 7,168 x 768); bf16 out, as on the path."""

    gen = torch.Generator().manual_seed(h)
    x, d, scale, bias = _kln_case(50000, h, x_dt, d_dt, gen)
    got = kernels.layer_norm(x, d, scale, bias, 1e-12, torch.bfloat16)
    want = kernels.layer_norm_plain(x, d, scale, bias, 1e-12, torch.bfloat16)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, want.float().abs().max().item())


@pytest.mark.parametrize("which", ["x", "delta"])
@pytest.mark.parametrize("d_dt", DTYPES)
@pytest.mark.parametrize("x_dt", DTYPES)
@pytest.mark.parametrize("h", [384, 768, 1024])
def test_kln_unaligned_views_take_the_scalar_loads(h, x_dt, d_dt, which):
    """x or delta one element past a 16-byte boundary runs the scalar-load
    classes (h 384: 32 lanes x 12, 768: x 24, 1024: x 32)."""

    gen = torch.Generator().manual_seed(h + 1)
    x, d, scale, bias = _kln_case(45, h, x_dt, d_dt, gen, offset=1, which=which)
    got = kernels.layer_norm(x, d, scale, bias, 1e-12, x_dt)
    want = kernels.layer_norm_plain(x, d, scale, bias, 1e-12, x_dt)
    torch.cuda.synchronize()
    _close(got, want, x_dt, want.float().abs().max().item())


def _b11_case(m, q, S, shared, seed, offset=0, tables_offset=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = 1 if shared else q
    flat = torch.randint(-128, 128, (lead * m * S + offset,), generator=gen, device="cuda",
                         dtype=torch.int8)
    codes = flat[offset:].view(lead, m, S)
    tflat = (torch.randn((m * q * 256 + tables_offset,), generator=gen, device="cuda") * 0.1)
    tables = tflat.to(torch.bfloat16)[tables_offset:].view(m, q, 256)
    bias = torch.where(torch.rand((q, S), generator=gen, device="cuda") > 0.1, 0.0, -1e30).float()
    return tables, codes, bias


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("q", [1, 5, 16, 17, 40])
@pytest.mark.parametrize("m", [8, 16, 17, 64])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 3000, 4096, 49152, 49153])
def test_b11_rescore_runs_and_query_groups(S, m, q, shared):
    """Runs of 16 candidates a thread (S % 16 == 0), of 4 (q 1, or S % 4 ==
    0) and of 1 (any S); in the shared form query groups of 8 (of 4 or 2 at
    m 64, whose tables would not fit), q 17 and 40 over several groups with
    a partial last one. Bit for bit: sums of bf16 entries in j order."""

    tables, codes, bias = _b11_case(m, q, S, shared, S * 31 + m * 7 + q)
    before = kernels.LAUNCHES["B11"]
    got = pq_ops.adc_rescore_scores(tables, codes, bias)
    assert kernels.LAUNCHES["B11"] == before + 1
    want = kernels.adc_rescore_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert got.shape == (q, S) and torch.equal(got, want)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("what", ["codes", "tables"])
@pytest.mark.parametrize("m,q,S", [(16, 16, 49152), (16, 1, 4096), (8, 5, 3000)])
def test_b11_rescore_at_any_alignment(m, q, S, what, shared):
    """Codes one byte past an aligned base take the runs of 1 (byte loads);
    tables one entry past one are staged entry by entry."""

    offset, tables_offset = (1, 0) if what == "codes" else (0, 1)
    tables, codes, bias = _b11_case(m, q, S, shared, S + q, offset, tables_offset)
    got = kernels.adc_rescore(tables, codes, bias)
    want = kernels.adc_rescore_plain(tables, codes, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Whisper (X4 log-mel, X5 greedy decode, X6 alignment matrix) on the card
# against the port on the CPU, f32 on the same inputs: log-mel within 1e-4,
# encoder states and the alignment matrix within 2e-4, greedy tokens equal
# (or first different where the CPU's top-2 logit gap is below 1e-4)
# ---------------------------------------------------------------------------


def _whisper_tiny():
    from mmrag_tpu_torch.models import whisper as twhisper

    return twhisper.WhisperConfig(
        d_model=64, encoder_layers=2, encoder_heads=2, decoder_layers=2, decoder_heads=2,
        ffn_dim=128, vocab_size=51865, max_source_positions=75, max_target_positions=48)


def test_whisper_on_the_card_matches_the_cpu():
    import numpy as np

    from mmrag_tpu_torch.models import align as talign
    from mmrag_tpu_torch.models import convert as tconvert
    from mmrag_tpu_torch.models import whisper as twhisper

    cfg = _whisper_tiny()
    tree = twhisper.init_whisper_params(0, cfg)
    on = {d: tconvert.params_from_jax(tree, "whisper", cfg, device=d) for d in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    audio = np.zeros((2, cfg.max_source_positions * 320), np.float32)
    audio[0] = rng.standard_normal(audio.shape[1]) * 0.1  # row 1 stays padding
    x = torch.from_numpy(audio)
    mel = twhisper.log_mel_spectrogram(x)
    assert (twhisper.log_mel_spectrogram(x.cuda()).cpu() - mel).abs().max() <= 1e-4
    enc = twhisper.whisper_encode(on["cpu"], mel, cfg)
    card_enc = twhisper.whisper_encode(on["cuda"], mel.cuda(), cfg)
    assert (card_enc.cpu() - enc).abs().max() <= 2e-4
    prefix = cfg.forced_prefix()[:-1]
    tokens, lengths = twhisper.whisper_greedy_decode(on["cpu"], enc, cfg, prefix, max_len=40)
    got, got_len = twhisper.whisper_greedy_decode(on["cuda"], enc.cuda(), cfg, prefix,
                                                  max_len=40)
    for row in range(2):
        diff = np.nonzero(got[row].cpu().numpy() != tokens[row].numpy())[0]
        if diff.size:
            first = int(diff[0])
            logits = twhisper.whisper_decode_logits(on["cpu"], tokens[row:row + 1, :first],
                                                    enc[row:row + 1], cfg)
            top2 = torch.topk(logits[0, -1], 2).values
            assert float(top2[0] - top2[1]) < 1e-4, (row, first)
        else:
            assert int(got_len[row]) == int(lengths[row])
    _, cross = talign.decoder_cross_attention(on["cpu"], tokens, enc, cfg)
    _, card_cross = talign.decoder_cross_attention(on["cuda"], tokens.cuda(), enc.cuda(), cfg)
    for row in range(2):
        want = talign.alignment_matrix_device(cross[:, row])
        assert (talign.alignment_matrix_device(card_cross[:, row]).cpu() - want).abs().max() \
            <= 2e-4


@pytest.mark.parametrize("shape", [(16, 1, 64), (16, 40, 75), (3, 448, 64)])
def test_whisper_bmm_f32_keeps_f32_results(shape):
    """bf16 operands, f32 results (``torch.bmm(..., out_dtype=float32)``):
    within f32 summation order of the CPU's f32 products of the same values."""

    from mmrag_tpu_torch.models.whisper import bmm_f32

    b, m, k = shape
    g = torch.Generator().manual_seed(1)
    a = torch.randn(b, m, k, generator=g).to(torch.bfloat16)
    w = torch.randn(b, k, 33, generator=g).to(torch.bfloat16)
    got = bmm_f32(a.cuda(), w.cuda())
    assert got.dtype == torch.float32
    want = bmm_f32(a, w)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


def test_serve_asr_job_on_the_card(tmp_path):
    """The served YouTube job whose captions fail runs the port's Whisper on
    the card (tiny weights the port writes, a 3.3 s wav: one bucket-4
    dispatch); its segments equal a direct transcription, no kernel launches
    during the transcription, and the segments' embeds launch B1 and B2."""

    import dataclasses
    import json
    import threading
    import time
    import urllib.request
    import wave

    import numpy as np

    from mmrag_tpu_torch.ingest import asr
    from mmrag_tpu_torch.ingest import youtube as yt
    from mmrag_tpu_torch.models import convert as tconvert
    from mmrag_tpu_torch.models import whisper as twhisper
    from mmrag_tpu_torch.models.tokenizer import _bytes_to_unicode
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.serving import tasks
    from mmrag_tpu_torch.serving.http import make_server
    from mmrag_tpu_torch.serving.jobs import LocalJobQueue
    from mmrag_tpu_torch.settings import load_settings

    cfg_w = _whisper_tiny()
    wdir = tmp_path / "weights" / "openai__whisper-tinytest"
    tconvert.save_params(twhisper.init_whisper_params(2, cfg_w), str(wdir), "model",
                         meta={"arch": "whisper", "config": dataclasses.asdict(cfg_w)})
    b2u = _bytes_to_unicode()
    vocab = {"".join(b2u[c] for c in f" tok{i}".encode()): i for i in range(cfg_w.eot_id)}
    (wdir / "vocab.json").write_text(json.dumps(vocab))
    wav = str(tmp_path / "a.wav")
    t = np.arange(int(16000 * 3.3)) / 16000
    with wave.open(wav, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(16000)
        fh.writeframes((np.sin(2 * np.pi * 330 * t) * 0.3 * 32767).astype(np.int16).tobytes())
    cfg = load_settings({"TPU_INDEX_DIR": str(tmp_path / "i"), "NOTES_DB_PATH": str(tmp_path / "n"),
                         "WEIGHTS_DIR": str(tmp_path / "weights"),
                         "MODEL_ASR": "openai/whisper-tinytest", "YT_LAZY_FRAMES": "1",
                         "INGEST_CACHE_DIR": str(tmp_path / "c"), "API_KEYS": '{"k": "u1"}',
                         "TPU_INDEX_JOURNAL": "0"})
    asr.reset_asr_runtime()
    engine = RagEngine(cfg)
    queue = LocalJobQueue(str(tmp_path / "jobs.db"), workers=1)
    server = make_server("127.0.0.1", 0, cfg=cfg, engine=engine, queue=queue)
    ladders, during = [], []

    def ladder_fn(url, work_dir, cfg_, **kwargs):
        before = {**kernels.LAUNCHES, **kernels.KERNEL_LAUNCHES}
        out = yt.transcript_or_fallback(
            url, work_dir, cfg_, transcript_fn=lambda vid: [],
            download_fn=lambda *a: str(tmp_path / "v.mp4"), audio_fn=lambda *a: wav, **kwargs)
        torch.cuda.synchronize()
        after = {**kernels.LAUNCHES, **kernels.KERNEL_LAUNCHES}
        during.append({k: after[k] - before[k] for k in after})
        ladders.append(out)
        return out

    server.ctx.queue.register("ingest_youtube", lambda progress, user_id, url:
                              tasks.ingest_youtube_task(
                                  progress, user_id=user_id, url=url, engine=engine,
                                  info_fn=lambda u, c: {"video_id": "asrCardTest", "title": "t"},
                                  ladder_fn=ladder_fn))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(method, path, body=None):
        req = urllib.request.Request(base + path, method=method, headers={
            "X-API-Key": "k", "Content-Type": "application/json"},
            data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        kernels.reset_launches()
        job = call("POST", "/ingest/youtube", {"url": "https://youtu.be/asrCardTest"})
        deadline = time.monotonic() + 120
        while True:
            st = call("GET", f"/yt_status/{job['job_id']}")
            if st["state"] in ("SUCCESS", "FAILURE") or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert st["state"] == "SUCCESS" and st["source"] == "asr", st
        runtime = asr.get_asr_runtime(cfg, engine.device)
        assert runtime.device.type == "cuda" and runtime.compute_dtype == torch.bfloat16
        assert ladders[0]["segments"] == asr.WhisperRuntime(cfg).transcribe_wav(wav)
        assert not any(during[0].values()), during
        assert kernels.LAUNCHES["B1"] > 0 and kernels.LAUNCHES["B2"] > 0
    finally:
        server.shutdown()
        queue.shutdown(wait=True)
        engine.close()
        server.server_close()
        asr.reset_asr_runtime()


# ---------------------------------------------------------------------------
# The mesh: the row-sharded index and the data-parallel runtime on the card
# (``-k "mesh or sharded or dp_"``). A mesh of N shards over cuda:0 runs each
# shard's kernels on the card; each layout's hits must equal the
# single-device index's on the same rows (unit vectors: scores within 1e-5,
# the kernels' own agreement) and each kernel launch once per shard.
# ---------------------------------------------------------------------------


def _mesh_rows(n, d, seed, centers=32):
    gen = torch.Generator().manual_seed(seed)
    c = torch.randn((centers, d), generator=gen)
    x = c[torch.randint(0, centers, (n,), generator=gen)] + 0.25 * torch.randn((n, d),
                                                                            generator=gen)
    return (x / x.norm(dim=1, keepdim=True)).numpy()


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("dtype,backend", [("bfloat16", "auto"), ("int8", "auto"),
                                           ("pq", "auto"), ("bfloat16", "ivf"),
                                           ("int8", "ivf"), ("pq", "ivf")])
def test_sharded_index_matches_one_device_on_the_card(dtype, backend, shards):
    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.parallel.mesh import build_mesh
    from mmrag_tpu_torch.storage.records import VectorRow

    n, d = 12_000, 64
    mat = _mesh_rows(n, d, 3)
    rows = [VectorRow(chunk_id=f"c{i}", user_id=f"u{i % 2}", document_id=f"d{i % 5}",
                      modality="text", embedding=mat[i]) for i in range(n)]
    single = VectorIndex(dim=d, dtype=dtype, backend=backend, ivf_min_rows=1024,
                         ivf_nprobe=8)
    sharded = VectorIndex(dim=d, dtype=dtype, backend=backend, ivf_min_rows=1024,
                          ivf_nprobe=10_000 if backend == "ivf" else 8,
                          mesh=build_mesh(devices=["cuda:0"] * shards))
    single.ivf_nprobe = sharded.ivf_nprobe  # every cluster probed: the same candidates
    for index in (single, sharded):
        index.ivf_build_async = False
        index.upsert(rows)
    q = mat[:6] + 0.05 * _mesh_rows(6, d, 4)
    q = q / (q ** 2).sum(1, keepdims=True) ** 0.5
    users = ["u0", "u1"] * 3
    docs = [None, "d1", None, None, "d3", None]
    kernels.reset_launches()
    want = single.search_batch_multi(q, users, 10, docs)
    one = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    got = sharded.search_batch_multi(q, users, 10, docs)
    assert sharded._capacity % shards == 0
    for g, w in zip(got, want):
        assert [c for c, _ in g] == [c for c, _ in w]
        assert max(abs(a - b) for (_, a), (_, b) in zip(g, w)) <= 1e-5
    if backend != "ivf" or dtype != "pq":  # ivf_pq: the spill launches differ per layout
        assert {k: v for k, v in kernels.LAUNCHES.items()} == {
            k: shards * v for k, v in one.items()}
    kernels.reset_launches()


@pytest.mark.parametrize("quant", ["", "int8"])
def test_dp_runtime_launches_once_per_shard_and_matches_one_device(quant, tmp_path):
    from mmrag_tpu_torch.models.bert import BertConfig
    from mmrag_tpu_torch.models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.parallel.mesh import build_mesh
    from mmrag_tpu_torch.settings import load_settings

    bert = BertConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
    clip = CLIPConfig(vision=CLIPVisionConfig(hidden_size=128, num_layers=2, num_heads=2,
                                              intermediate_size=256),
                      text=CLIPTextConfig(hidden_size=128, num_layers=2, num_heads=2,
                                          intermediate_size=256), projection_dim=512)
    cfg = load_settings({"WEIGHTS_DIR": str(tmp_path / "w"), "TPU_ENCODER_QUANT": quant,
                         "TPU_TEXT_BATCH_BUCKETS": "4,16", "TPU_TEXT_SEQ_BUCKETS": "32,128",
                         "TPU_IMAGE_BATCH_BUCKETS": "4,8"})
    single = EncoderRuntime(cfg, bert_cfg=bert, clip_cfg=clip)
    dp = EncoderRuntime(cfg, bert_cfg=bert, clip_cfg=clip,
                        mesh=build_mesh(devices=["cuda:0"] * 2))
    texts = [f"sentence {i} about the cell and its energy" for i in range(6)]
    gen = torch.Generator().manual_seed(5)
    imgs = [torch.randint(0, 256, (224, 224, 3), generator=gen, dtype=torch.uint8).numpy()
            for _ in range(5)]
    for fn in (lambda r: r.embed_text_batch(texts), lambda r: r.embed_images_batch(imgs),
               lambda r: r.embed_queries_for_images(texts[:3]),
               lambda r: r.rerank_scores("energy", texts)):
        kernels.reset_launches()
        want = fn(single)
        one = {**kernels.LAUNCHES, **kernels.KERNEL_LAUNCHES}
        kernels.reset_launches()
        got = fn(dp)
        two = {**kernels.LAUNCHES, **kernels.KERNEL_LAUNCHES}
        assert any(one.values()) and two == {k: 2 * v for k, v in one.items()}
        assert abs(got - want).max() <= (4e-3 if quant else 2e-3)
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# Fine-tuning on the card (parallel/training.py): plain torch, no kernel
# ---------------------------------------------------------------------------

_TRAIN = {"clip": ("train_state_init", "make_train_step"),
          "minilm": ("minilm_train_state_init", "make_minilm_train_step"),
          "cross": ("cross_encoder_train_state_init", "make_cross_encoder_train_step")}


def _train_step(kind, mesh, device, batch):
    from mmrag_tpu_torch.parallel import training as ttr
    from tiny_train import TRAIN_BERT, TRAIN_CLIP

    cfg = TRAIN_CLIP if kind == "clip" else TRAIN_BERT
    init, make = (getattr(ttr, name) for name in _TRAIN[kind])
    params, opt, _ = init(0, mesh, cfg, device=device)
    params, opt, loss = make(mesh, cfg)(params, opt, *batch)
    return params, loss.item()


@pytest.mark.parametrize("kind", list(_TRAIN))
def test_train_step_on_the_card_matches_the_cpu(kind):
    """One step of each tower's loss on the card and on the CPU: the loss
    within 1e-5 relative, every gradient within 1e-4 of its leaf's max-abs,
    and no B1-B12 or building kernel launched."""

    from mmrag_tpu_torch.parallel.training import param_leaves
    from tiny_train import train_batch

    batch = train_batch(kind, 8)
    kernels.reset_launches()
    card, loss = _train_step(kind, None, "cuda", batch)
    torch.cuda.synchronize()
    assert not any(kernels.LAUNCHES.values()) and not any(kernels.KERNEL_LAUNCHES.values())
    cpu, want = _train_step(kind, None, "cpu", batch)
    assert abs(loss - want) <= 1e-5 * abs(want)
    for a, b in zip(param_leaves(card), param_leaves(cpu)):
        assert (a.grad.cpu() - b.grad).abs().max() <= 1e-4 * b.grad.abs().max()


@pytest.mark.parametrize("kind", list(_TRAIN))
def test_mesh_train_step_on_the_card_matches_one_device(kind):
    """A (data 2, model 2) mesh of the card against one device: the loss
    within 1e-6 relative, the gathered parameters within 1e-6 (2 lr where the
    first gradient is below 1e-6 of its leaf's max-abs)."""

    from mmrag_tpu_torch.parallel import mesh as tmesh
    from mmrag_tpu_torch.parallel.training import param_leaves
    from tiny_train import train_batch

    batch = train_batch(kind, 8)
    one, want = _train_step(kind, None, "cuda", batch)
    grid, loss = _train_step(kind, tmesh.build_mesh(model_parallel=2, devices=["cuda:0"] * 4),
                             None, batch)
    assert abs(loss - want) <= 1e-6 * abs(want)
    lr = {"clip": 1e-5}.get(kind, 2e-5)  # the state inits' defaults
    for a, b in zip(param_leaves(tmesh.gather_params(grid)), param_leaves(one)):
        g = b.grad.abs()
        tol = torch.where(g < 1e-6 * g.max(), 2 * lr + 1e-6, 1e-6)
        assert ((a.detach() - b.detach()).abs() <= tol).all()
