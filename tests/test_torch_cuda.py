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
the same order).
"""

import pytest
import torch

from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops import quant
from mmrag_tpu_torch.ops.attention import (
    fused_attention_block, fused_attention_block_plain, fused_attention_block_q8,
    fused_attention_block_q8_plain, fused_encoder_attention, fused_encoder_attention_plain,
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
@pytest.mark.parametrize("rows,h,ln", [(1, 64, False), (37, 384, False), (5, 3072, False),
                                       (7, 1536, False), (64, 384, True), (129, 768, True)])
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


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,epi,resid", [
    (1, 16, 16, "none", None), (70, 48, 32, "quick_gelu", None),
    (129, 96, 64, "gelu_tanh", torch.bfloat16), (128, 1536, 384, "gelu_erf", None),
    (64, 384, 3072, "none", torch.float32), (300, 1152, 384, "none", torch.bfloat16)])
def test_gemm_i8(out_dtype, m, n, k, epi, resid):
    gen = torch.Generator().manual_seed(m + n + k)
    aq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    wq = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).cuda()
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
@pytest.mark.parametrize("B,d", [(40, 64), (256, 384), (768, 512), (40, 40), (8, 384)])
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


@pytest.mark.parametrize("B,d", [(40, 64), (768, 384), (256, 512), (40, 40)])
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
