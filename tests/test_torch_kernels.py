"""The port's B1-B4 wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and go through the JAX wrapper (in
interpret mode on the CPU, as tests/test_ops_*.py run them) and through the
port's wrapper on CPU tensors, which runs the plain version of the port's
CUDA kernel composition. f32 throughout, atol 2e-5 (f32 sums in another
order). Kernel launches themselves need the card: see ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mmrag_tpu.ops.attention import fused_attention_block as jax_attention_block
from mmrag_tpu.ops.layernorm import fused_add_layer_norm as jax_add_ln
from mmrag_tpu.ops.mlp import fused_mlp_block as jax_mlp_block
from mmrag_tpu.ops.pallas_topk import BUCKET, TILE_N, _bucket_max_kernel
from mmrag_tpu.ops.pallas_topk import fused_cosine_topk as jax_topk
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models.convert import params_from_jax
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops.attention import fused_attention_block
from mmrag_tpu_torch.ops.layernorm import fused_add_layer_norm
from mmrag_tpu_torch.ops.mlp import fused_mlp_block
from mmrag_tpu_torch.ops.pallas_topk import fused_cosine_topk
from mmrag_tpu_torch.ops.topk import cosine_topk, cosine_topk_dense, merge_topk, pad_topk

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _jax_layer(rng, h, inter, ln_key):
    def dense(i, o, std=0.05):
        return {"kernel": rng.standard_normal((i, o)).astype(np.float32) * std,
                "bias": rng.standard_normal(o).astype(np.float32) * 0.02}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(h)).astype(np.float32)}

    layer = {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h), "attn_out": dense(h, h),
             ln_key: ln(), "ln2": ln(), "fc1": dense(h, inter), "fc2": dense(inter, h)}
    return layer


def _port_layer(layer):
    """The JAX layer dict through the port's converter (q|k|v fused)."""

    tree = {"embeddings": {"word": np.zeros((2, 1), np.float32),
                           "position": np.zeros((2, 1), np.float32),
                           "token_type": np.zeros((2, 1), np.float32),
                           "ln": {"scale": np.ones(1, np.float32), "bias": np.zeros(1, np.float32)}},
            "layers": [layer]}
    return params_from_jax(tree, "minilm")["layers"][0]


def _jnp_tree(layer):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in layer.items()}


@pytest.mark.parametrize(
    "b,s,h,nh,pre_ln",
    [
        (3, 64, 128, 4, False),  # hd 32, post-LN (BERT)
        (3, 64, 128, 2, True),  # hd 64, pre-LN (CLIP)
        (2, 56, 128, 2, True),  # the CLIP 50 -> 56 padded row
        (4, 16, 64, 2, False),
    ],
)
def test_attention_block_matches_jax(b, s, h, nh, pre_ln):
    rng = np.random.default_rng(10 + b + s)
    ln_key = "ln1" if pre_ln else "attn_ln"
    layer = _jax_layer(rng, h, 2 * h, ln_key)
    x = rng.standard_normal((b * s, h)).astype(np.float32)
    lengths = rng.integers(s // 4, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    eps = 1e-5 if pre_ln else 1e-12
    want = np.asarray(jax_attention_block(
        jnp.asarray(x), _jnp_tree(layer), nh, s, eps, jnp.asarray(mask),
        pre_ln=pre_ln, ln_key=ln_key))
    got = fused_attention_block(
        torch.from_numpy(x), _port_layer(layer), nh, s, eps, torch.from_numpy(mask),
        pre_ln=pre_ln, ln_key=ln_key).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fully_masked_row_gives_zero_context(pre_ln):
    """A batch row whose keys are all masked (batch padding) gets a context of
    exactly 0 before the output projection, as the JAX fused kernel gives."""

    rng = np.random.default_rng(3)
    b, s, h, nh = 3, 16, 64, 2
    ln_key = "ln1" if pre_ln else "attn_ln"
    layer = _jax_layer(rng, h, 2 * h, ln_key)
    x = rng.standard_normal((b * s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1] = 0
    port = _port_layer(layer)
    qkv = kernels.gemm(torch.from_numpy(x), port["qkv"]["kernel"], port["qkv"]["bias"])
    kbias = torch.from_numpy((1.0 - mask.astype(np.float32)) * -1e9)
    ctx = kernels.attention(qkv, kbias, nh, s).numpy()
    assert np.isfinite(ctx).all()
    np.testing.assert_array_equal(ctx[s:2 * s], np.zeros((s, h), np.float32))
    want = np.asarray(jax_attention_block(
        jnp.asarray(x), _jnp_tree(layer), nh, s, 1e-5, jnp.asarray(mask),
        pre_ln=pre_ln, ln_key=ln_key))
    got = fused_attention_block(
        torch.from_numpy(x), port, nh, s, 1e-5, torch.from_numpy(mask),
        pre_ln=pre_ln, ln_key=ln_key).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# 512 x 384: the query towers' K-ln launches (8 x 64 tokens); 56 x 768: a
# CLIP vision image's pre-LN rows
@pytest.mark.parametrize("rows,h,out_dtype", [(64, 128, torch.float32), (37, 96, torch.float32),
                                              (1024, 384, torch.float32),
                                              (512, 384, torch.float32),
                                              (56, 768, torch.float32)])
def test_add_layer_norm_matches_jax(rows, h, out_dtype):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    d = rng.standard_normal((rows, h)).astype(np.float32) * 0.5
    scale = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.02 * rng.standard_normal(h)).astype(np.float32)
    want = np.asarray(jax_add_ln(jnp.asarray(x), jnp.asarray(d), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-12))
    got = fused_add_layer_norm(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(scale),
                               torch.from_numpy(bias), 1e-12, out_dtype).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("rows,h,inter", [(48, 64, 128), (100, 128, 256)])
def test_mlp_block_matches_jax(rows, h, inter):
    rng = np.random.default_rng(rows + h)
    layer = _jax_layer(rng, h, inter, "ln1")
    x = rng.standard_normal((rows, h)).astype(np.float32)
    want = np.asarray(jax_mlp_block(jnp.asarray(x), _jnp_tree(layer), 1e-5))
    got = fused_mlp_block(torch.from_numpy(x), _port_layer(layer), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _same_ids_up_to_ties(got_s, got_i, want_s, want_i):
    np.testing.assert_allclose(got_s, want_s, atol=ATOL)
    differ = got_i != want_i
    # where ids differ, the scores must tie
    assert np.all(np.abs(got_s - want_s)[differ] < 1e-6)


@pytest.mark.parametrize(
    "n,d,q,per_query",
    [
        (4096, 64, 4, False),  # shared (1, n) bias
        (4096, 64, 5, True),  # per-query (q, n) bias
        (6000, 32, 3, True),  # n not a multiple of 2048 (nor of 128)
        (2048, 128, 9, False),
    ],
)
def test_bucket_topk_matches_jax(n, d, q, per_query):
    rng = np.random.default_rng(n + q)
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    tenants = rng.integers(0, 3, n)
    if per_query:
        mask = tenants[None, :] == (np.arange(q) % 3)[:, None]
    else:
        mask = tenants == 1
    k = 20
    ws, wi = jax_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k)
    gs, gi = fused_cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(mask), k)
    _same_ids_up_to_ties(gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi))
    # and the plain dense top-k agrees
    ds, di = cosine_topk_dense(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(mask), k)
    _same_ids_up_to_ties(gs.numpy(), gi.numpy(), ds.numpy(), di.numpy())


def _jax_phase_a(queries, corpus, mask):
    """Phase A of the JAX package: its Pallas ``_bucket_max_kernel`` in
    interpret mode over the corpus padded to a tile multiple, with the mask
    turned into the f32 bias as ``fused_cosine_topk`` does; the first
    ``ceil(n/128)`` bucket maxima."""

    qp, d = queries.shape
    n = corpus.shape[0]
    np_ = -(-n // TILE_N) * TILE_N
    bias = np.where(mask.reshape(-1, n), 0.0, -1e30).astype(np.float32)
    bias = np.pad(bias, ((0, 0), (0, np_ - n)), constant_values=-1e30)
    corpus_p = np.pad(corpus, ((0, np_ - n), (0, 0)))
    tiles = np_ // TILE_N
    out = pl.pallas_call(
        _bucket_max_kernel,
        grid=(tiles,),
        in_specs=[
            pl.BlockSpec((qp, d), lambda i: (0, 0)),
            pl.BlockSpec((TILE_N, d), lambda i: (i, 0)),
            pl.BlockSpec((bias.shape[0], TILE_N), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((1, qp, TILE_N // BUCKET), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((tiles, qp, TILE_N // BUCKET), jnp.float32),
        interpret=True,
    )(jnp.asarray(queries), jnp.asarray(corpus_p), jnp.asarray(bias))
    return np.asarray(out).transpose(1, 0, 2).reshape(qp, -1)[:, :-(-n // BUCKET)]


@pytest.mark.parametrize(
    "n,d,q,per_query",
    [
        (5000, 64, 8, False),  # ragged n, shared mask
        (2348, 32, 16, True),  # ragged n, per-query masks, a dead query and bucket
        (6000, 128, 40, True),  # more than 32 queries (two launches on the card)
    ],
)
def test_bucket_max_plain_matches_jax_phase_a(n, d, q, per_query):
    """K-bmax's plain version, given the bool mask, against the JAX phase A
    given the f32 bias made from the same mask: equal maxima (f32 sums in
    another order), -1e30 exactly where every row is masked."""

    rng = np.random.default_rng(n + q)
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    tenants = rng.integers(0, 3, n)
    mask = tenants[None, :] == (np.arange(q) % 3)[:, None] if per_query else tenants == 2
    mask[..., 128:256] = False  # bucket 1 dead for every query
    if per_query:
        mask[3] = False  # a query whose every row is masked
    want = _jax_phase_a(queries, corpus, mask)
    got = kernels.bucket_max_plain(torch.from_numpy(queries), torch.from_numpy(corpus),
                                   torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (q, -(-n // 128))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[:, 1] == -1e30) and np.all(want[:, 1] == -1e30)
    if per_query:
        assert np.all(got[3] == -1e30)
    # the mask as uint8 (the kernel's other argument form) gives the same
    as_u8 = kernels.bucket_max_plain(torch.from_numpy(queries), torch.from_numpy(corpus),
                                     torch.from_numpy(mask.astype(np.uint8))).numpy()
    np.testing.assert_array_equal(as_u8, got)


def test_bucket_topk_matches_jax_past_32_queries_with_dead_rows():
    """fused_cosine_topk at 40 per-query masks (two chunks of K-bmax on the
    card), one query with every row masked and a ragged n, against JAX's."""

    rng = np.random.default_rng(40)
    n, d, q, k = 4500, 64, 40, 12
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    tenants = rng.integers(0, 3, n)
    mask = tenants[None, :] == (np.arange(q) % 3)[:, None]
    mask[5] = False
    ws, wi = jax_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k)
    gs, gi = fused_cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(mask), k)
    _same_ids_up_to_ties(gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi))
    assert np.all(gs.numpy()[5] <= -1e29)


def test_bucket_topk_fewer_valid_rows_than_k():
    rng = np.random.default_rng(5)
    n, d, k = 4096, 64, 10
    corpus = _unit(rng, n, d)
    queries = _unit(rng, 2, d)
    mask = np.zeros(n, bool)
    valid = rng.choice(n, 4, replace=False)
    mask[valid] = True
    ws, wi = jax_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k)
    gs, gi = fused_cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(mask), k)
    gs, gi = gs.numpy(), gi.numpy()
    np.testing.assert_allclose(gs[:, :4], np.asarray(ws)[:, :4], atol=ATOL)
    np.testing.assert_array_equal(gi[:, :4], np.asarray(wi)[:, :4])
    assert set(gi[0, :4]) == set(valid)
    assert np.all(gs[:, 4:] <= -1e29)


def test_topk_fillers():
    """cosine_topk pads ids with 0 past the corpus; pad_topk pads with -1."""

    rng = np.random.default_rng(1)
    corpus = torch.from_numpy(_unit(rng, 5, 8))
    queries = torch.from_numpy(_unit(rng, 2, 8))
    s, i = cosine_topk(queries, corpus, torch.ones(5, dtype=torch.bool), 8)
    assert s.shape == (2, 8) and torch.all(s[:, 5:] <= -1e29) and torch.all(i[:, 5:] == 0)
    ps, pi = pad_topk(s[:, :3], i[:, :3], 6)
    assert torch.all(ps[:, 3:] <= -1e29) and torch.all(pi[:, 3:] == -1)
    ms, mi = merge_topk(s[:, :2], i[:, :2], s[:, 2:4], i[:, 2:4], 3)
    np.testing.assert_allclose(ms.numpy(), s[:, :3].numpy())
    np.testing.assert_array_equal(mi.numpy(), i[:, :3].numpy())


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launches()
    x = torch.zeros((8, 32))
    fused_add_layer_norm(x, x, torch.ones(32), torch.zeros(32), 1e-5)
    assert kernels.LAUNCHES == {f"B{i}": 0 for i in range(1, 13)}


def test_cpu_building_calls_count_no_kernel_launch():
    """The building kernels' counts start at 0 after ``reset_launches`` and
    a call on CPU tensors (its plain version) adds nothing to them."""

    kernels.KERNEL_LAUNCHES["K-quant"] = 5
    kernels.reset_launches()
    assert kernels.KERNEL_LAUNCHES == {k: 0 for k in ("K-gemm", "K-gemm-i8", "K-ln", "K-quant",
                                                      "K-attn", "K-bmax", "K-bmax-top",
                                                      "K-bmax-topk-merge")}
    x = torch.randn((8, 32))
    kernels.row_quant(x)
    kernels.layer_norm(x, None, torch.ones(32), torch.zeros(32), 1e-5, torch.float32)
    kernels.gemm(x, torch.randn((32, 16)), torch.zeros(16))
    lists = kernels.bucket_topk(x, torch.randn((300, 32)), torch.ones(300, dtype=torch.bool), 10)
    kernels.topk_merge(*lists, 10)
    kernels.approx_topk(x, torch.randn((300, 32)), torch.ones(300, dtype=torch.bool), 10)
    assert not any(kernels.KERNEL_LAUNCHES.values())
