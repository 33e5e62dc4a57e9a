"""The port's W8A8 scheme, B6 and B7 against the JAX package's.

Inputs are made with numpy from a seed and go through the JAX functions (the
q8 Pallas kernels run in interpret mode on the CPU, as
``tests/test_ops_quant.py`` runs them) and through the port's wrappers on
CPU tensors, which run the plain versions of the port's CUDA compositions.
f32 throughout.

Tolerances and why:
* the quantizers: int8 codes and f32 scales bit for bit (the same f32
  formulas, a true division, half-to-even rounding);
* B6, B7 and ``q8_dense``: JAX's own block tolerances, 3e-4 for the
  attention block and 2e-4 for the MLP block (``test_ops_quant.py:93,138``):
  f32 sums taken in another order can move a value across a rounding
  boundary of its int8 code, and one code is worth about amax/127 of its row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.ops import quant as jquant
from mmrag_tpu.ops.attention import fused_attention_block_q8 as jax_block_q8
from mmrag_tpu.ops.mlp import fused_mlp_block_q8 as jax_mlp_q8
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models import bert, clip
from mmrag_tpu_torch.models.convert import params_from_jax
from mmrag_tpu_torch.ops import kernels, quant
from mmrag_tpu_torch.ops.attention import fused_attention_block_q8
from mmrag_tpu_torch.ops.mlp import fused_mlp_block_q8

ATTN_ATOL = 3e-4
MLP_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _same_codes(got, want, what):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    differ = got != want
    n = int(differ.sum())
    worst = int(np.abs(got - want).max()) if n else 0
    assert n == 0, f"{what}: {n} of {got.size} int8 codes differ, by at most {worst}"


def _rows(kind, rng):
    """(rows, h) f32 activations with the quantizer's edge cases."""

    if kind == "normal":
        return rng.standard_normal((37, 96)).astype(np.float32) * 3
    if kind == "zero_rows":
        a = rng.standard_normal((8, 64)).astype(np.float32)
        a[[1, 5]] = 0.0
        return a
    if kind == "ties":
        # amax 127 gives a scale of exactly 1.0 (127 * f32(1/127) == 1), so
        # every k + 0.5 is an exact tie: half to even, as jnp.round
        a = (rng.integers(-126, 126, (6, 64)) + 0.5).astype(np.float32)
        a[:, 0] = 127.0
        a[3, 0] = -127.0
        return a
    if kind == "tiny_and_huge":
        a = rng.standard_normal((6, 48)).astype(np.float32)
        a[0] *= 1e-14  # below the 1e-12 scale clamp
        a[1] *= 1e30
        a[2, :] = 0.0
        a[2, 7] = -3e-38
        return a
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["normal", "zero_rows", "ties", "tiny_and_huge"])
def test_quantize_rows_matches_jax_bit_for_bit(kind):
    a = _rows(kind, np.random.default_rng(len(kind)))
    jq, js = jquant.quantize_rows(jnp.asarray(a))
    tq, ts = quant.quantize_rows(torch.from_numpy(a))
    assert tq.dtype == torch.int8 and ts.shape == (a.shape[0], 1)
    _same_codes(tq.numpy(), jq, kind)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if kind == "ties":
        assert np.all(ts.numpy() == 1.0)
        np.testing.assert_array_equal(tq.numpy()[:, 1:], np.round(a[:, 1:]).astype(np.int8))
    if kind == "zero_rows":
        assert np.all(tq.numpy()[[1, 5]] == 0)
        assert np.all(ts.numpy()[[1, 5]] == np.float32(1e-12))


@pytest.mark.parametrize("ln", [False, True])
def test_row_quant_plain_matches_jax(ln):
    """K-quant's plain form: the codes of x, or of its f32 LayerNorm, as the
    q8 kernels quantize them (``_attn_block_kernel_q8``'s ``ln``)."""

    rng = np.random.default_rng(7)
    h = 96
    x = rng.standard_normal((29, h)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.02 * rng.standard_normal(h)).astype(np.float32)
    y = jnp.asarray(x)
    if ln:
        mean = jnp.mean(y, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(y - mean), axis=-1, keepdims=True)
        y = (y - mean) * jax.lax.rsqrt(var + 1e-5) * scale + bias
    jq, js = jquant.quantize_rows(y)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), 1e-5) if ln else ()
    tq, ts = kernels.row_quant(torch.from_numpy(x), *args)
    assert ts.shape == (29,)
    _same_codes(tq.numpy(), jq, "row_quant")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, 0], rtol=1e-6)


def test_quantize_weight_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((96, 64)) * 0.3).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero column: scale 1e-12, codes 0
    w[:, 9] = (rng.integers(-126, 126, 96) + 0.5).astype(np.float32)
    w[0, 9] = 127.0  # column 9: scale exactly 1.0 and every other value a tie
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = quant.quantize_weight(torch.from_numpy(w))
    _same_codes(tw["q"].numpy(), jw["q"], "weights")
    np.testing.assert_array_equal(tw["scale"].numpy(), np.asarray(jw["scale"])[0])


def test_q8_dense_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((8, 64)).astype(np.float32)
    lin = {"kernel": (rng.standard_normal((64, 32)) * 0.1).astype(np.float32),
           "bias": rng.standard_normal(32).astype(np.float32)}
    jl = jquant.quantize_linear({k: jnp.asarray(v) for k, v in lin.items()})
    tl = quant.quantize_linear({k: torch.from_numpy(v) for k, v in lin.items()})
    jaq, jas = jquant.quantize_rows(jnp.asarray(a))
    taq, tas = quant.quantize_rows(torch.from_numpy(a))
    want = np.asarray(jquant.q8_dense(jaq, jas, jl))
    got = quant.q8_dense(taq, tas, tl).numpy()
    np.testing.assert_array_equal(got, want)  # exact sum, same epilogue order
    # the K-gemm-i8 plain form is the same epilogue
    np.testing.assert_array_equal(
        kernels.gemm_i8_plain(taq, tas[:, 0], tl["q"], tl["scale"], tl["bias"]).numpy(), want)


def _bert_small():
    return (jbert.BertConfig(vocab_size=500, hidden_size=64, num_layers=2, num_heads=2,
                             intermediate_size=128, max_position=64),
            bert.BertConfig(vocab_size=500, hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128, max_position=64))


def _assert_q8_layer_matches(tl, jl, linears):
    """The port's fused q|k|v codes and scales are JAX's three side by side."""

    jqkv = [jl[k] for k in ("q", "k", "v")]
    _same_codes(tl["qkv"]["q"].numpy(), np.concatenate([np.asarray(p["q"]) for p in jqkv], 1),
                "qkv")
    np.testing.assert_array_equal(
        tl["qkv"]["scale"].numpy(), np.concatenate([np.asarray(p["scale"])[0] for p in jqkv]))
    np.testing.assert_array_equal(
        tl["qkv"]["bias"].numpy(), np.concatenate([np.asarray(p["bias"])[0] for p in jqkv]))
    for key in linears:
        _same_codes(tl[key]["q"].numpy(), jl[key]["q"], key)
        np.testing.assert_array_equal(tl[key]["scale"].numpy(), np.asarray(jl[key]["scale"])[0])
        np.testing.assert_array_equal(tl[key]["bias"].numpy(), np.asarray(jl[key]["bias"])[0])


@pytest.mark.parametrize("kind", ["minilm", "cross"])
def test_quantize_bert_matches_jax(kind):
    jcfg, tcfg = _bert_small()
    if kind == "minilm":
        jp = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
        jq8 = jbert.quantize_bert(jp)
    else:
        jp = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), jcfg)
        jq8 = jbert.quantize_bert(jp["bert"])
    tq8 = params_from_jax(jconvert.flatten_params(jp), kind, tcfg, q8=True)
    assert len(tq8["layers"]) == len(jq8["layers"]) == 2
    for tl, jl in zip(tq8["layers"], jq8["layers"]):
        _assert_q8_layer_matches(tl, jl, ("attn_out", "ffn_in", "ffn_out"))
        for ln in ("attn_ln", "ffn_ln"):
            np.testing.assert_array_equal(tl[ln]["scale"].numpy(), np.asarray(jl[ln]["scale"]))
    # the bf16 tree cannot be quantized: the codes come from the f32 weights
    with pytest.raises(ValueError, match="f32"):
        bert.quantize_bert(params_from_jax(jconvert.flatten_params(
            jp if kind == "minilm" else jp["bert"]), "minilm", tcfg, dtype=torch.bfloat16))


def test_quantize_clip_vision_matches_jax():
    jcfg = jclip.CLIPConfig(
        vision=jclip.CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=2,
                                      intermediate_size=128),
        text=jclip.CLIPTextConfig(vocab_size=300, hidden_size=32, num_layers=1, num_heads=1,
                                  intermediate_size=64),
        projection_dim=32)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    jq8 = jclip.quantize_clip_vision(jp)
    tq8 = params_from_jax(jconvert.flatten_params(jp), "clip", q8=True)
    assert len(tq8["layers"]) == 2
    for tl, jl in zip(tq8["layers"], jq8["layers"]):
        _assert_q8_layer_matches(tl, jl, ("attn_out", "fc1", "fc2"))
    direct = clip.quantize_clip_vision(params_from_jax(jconvert.flatten_params(jp), "clip"))
    _same_codes(direct["layers"][1]["fc2"]["q"].numpy(), tq8["layers"][1]["fc2"]["q"].numpy(),
                "fc2")


def _layer(rng, h, inter, ln_keys, linears):
    def dense(i, o):
        return {"kernel": (rng.standard_normal((i, o)) * 0.08).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.01).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(h)).astype(np.float32)}

    k1, k2 = linears
    layer = {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h), "attn_out": dense(h, h),
             k1: dense(h, inter), k2: dense(inter, h)}
    layer.update({key: ln() for key in ln_keys})
    return layer


def _both_q8(layer, linears):
    """JAX's ``quantize_encoder_layer`` tree and the port's q8 layer (through
    ``params_from_jax(q8=True)``, q|k|v fused) of the same f32 weights."""

    jl = jquant.quantize_encoder_layer(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in layer.items()},
        ("q", "k", "v", "attn_out") + linears)
    tree = {"embeddings": {"word": np.zeros((2, 1), np.float32),
                           "position": np.zeros((2, 1), np.float32),
                           "token_type": np.zeros((2, 1), np.float32),
                           "ln": {"scale": np.ones(1, np.float32),
                                  "bias": np.zeros(1, np.float32)}},
            "layers": [layer]}
    f32 = params_from_jax(tree, "minilm")["layers"][0]
    tl = quant.quantize_encoder_layer(f32, ("qkv", "attn_out") + linears)
    return jl, tl


@pytest.mark.parametrize(
    "b,s,h,nh,pre_ln",
    [
        (3, 16, 64, 2, True),  # CLIP-vision form, hd 32
        (3, 16, 64, 2, False),  # BERT form
        (2, 24, 128, 4, False),  # hd 32, 4 heads
    ],
)
def test_attention_block_q8_matches_jax(b, s, h, nh, pre_ln):
    rng = np.random.default_rng(b * s + h)
    ln_key = "ln1" if pre_ln else "attn_ln"
    jl, tl = _both_q8(_layer(rng, h, 2 * h, (ln_key,), ("fc1", "fc2")), ("fc1", "fc2"))
    x = rng.standard_normal((b * s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2:] = 0  # padded keys
    mask[-1] = 0  # a batch-padding row: every key masked, context 0
    eps = 1e-5 if pre_ln else 1e-12
    want = np.asarray(jax_block_q8(jnp.asarray(x), jl, nh, s, eps, jnp.asarray(mask),
                                   pre_ln=pre_ln, ln_key=ln_key))
    got = fused_attention_block_q8(torch.from_numpy(x), tl, nh, s, eps, torch.from_numpy(mask),
                                   pre_ln=pre_ln, ln_key=ln_key).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)


@pytest.mark.parametrize(
    "pre_ln,act,linears,ln_key",
    [
        (True, "quick_gelu", ("fc1", "fc2"), "ln2"),  # CLIP
        (False, "gelu_tanh", ("ffn_in", "ffn_out"), "ffn_ln"),  # BERT default
        (False, "gelu_erf", ("ffn_in", "ffn_out"), "ffn_ln"),  # BERT exact gelu
    ],
)
def test_mlp_block_q8_matches_jax(pre_ln, act, linears, ln_key):
    rng = np.random.default_rng(len(act))
    h, inter, rows = 64, 128, 48
    jl, tl = _both_q8(_layer(rng, h, inter, (ln_key,), linears), linears)
    x = rng.standard_normal((rows, h)).astype(np.float32)
    x[5] = 0.0  # an all-zero row reaches the 1e-12 clamp (post-LN: unnormed)
    k1, k2 = linears
    eps = 1e-5 if pre_ln else 1e-12
    want = np.asarray(jax_mlp_q8(jnp.asarray(x), jl, eps, pre_ln=pre_ln, act=act, k1=k1, k2=k2,
                                 ln_key=ln_key))
    got = fused_mlp_block_q8(torch.from_numpy(x), tl, eps, pre_ln=pre_ln, act=act, k1=k1, k2=k2,
                             ln_key=ln_key).numpy()
    np.testing.assert_allclose(got, want, atol=MLP_ATOL)


def test_cpu_q8_wrappers_count_no_launch():
    rng = np.random.default_rng(0)
    _, tl = _both_q8(_layer(rng, 64, 128, ("attn_ln", "ln2"), ("fc1", "fc2")), ("fc1", "fc2"))
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    kernels.reset_launches()
    fused_attention_block_q8(x, tl, 2, 16, 1e-12)
    fused_mlp_block_q8(x, tl, 1e-5)
    assert kernels.LAUNCHES == {f"B{i}": 0 for i in range(1, 12)}
