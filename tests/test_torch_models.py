"""The port's encoders against the JAX package's, on the same weights.

The JAX functions run on their default CPU path; the port runs on CPU
tensors (its kernels' plain versions). Weights come from the JAX package's
seeded init and reach the port through ``params_from_jax``. f32, small
widths; features within atol 1e-4 (``tests/test_ops_attention.py:74,99``),
embedding cosine drift <= 1e-5, rerank order kept at depth 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models import bert, clip
from mmrag_tpu_torch.models.convert import flatten_params, params_from_jax, unflatten_params

ATOL = 1e-4

BERT_J = jbert.BertConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                          intermediate_size=128, max_position=128)
BERT_T = bert.BertConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                         intermediate_size=128, max_position=128)
CLIP_J = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
                                  num_heads=2, intermediate_size=128),
    text=jclip.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                              intermediate_size=128, max_position=77),
    projection_dim=32,
)
CLIP_T = clip.CLIPConfig(
    vision=clip.CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
                                 num_heads=2, intermediate_size=128),
    text=clip.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                             intermediate_size=128, max_position=77),
    projection_dim=32,
)


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _flat(params):
    return jconvert.flatten_params(params)


def _ids(rng, b, s, vocab, min_len=3):
    lengths = rng.integers(min_len, s + 1, b)
    lengths[0] = s
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def _cos_drift(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return float(1.0 - (a * b).sum(1).min())


@pytest.mark.parametrize("b,s", [(4, 32), (3, 64)])
def test_minilm_embed_matches_jax(b, s):
    rng = np.random.default_rng(s)
    jp = jbert.init_bert_params(jax.random.PRNGKey(0), BERT_J)
    tp = params_from_jax(_flat(jp), "minilm", BERT_T)
    ids, mask = _ids(rng, b, s, BERT_J.vocab_size)
    want = np.asarray(jbert.minilm_embed(jp, jnp.asarray(ids), jnp.asarray(mask), BERT_J))
    got = bert.minilm_embed(tp, torch.from_numpy(ids), torch.from_numpy(mask), BERT_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert _cos_drift(got, want) <= 1e-5


def test_cross_encoder_matches_jax_and_keeps_rerank_order():
    rng = np.random.default_rng(8)
    jp = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), BERT_J)
    # spread the classifier so the 8 logits are well apart (random-init
    # logits otherwise sit ~1e-5 apart and any f32 reordering swaps them)
    jp["classifier"]["kernel"] = jp["classifier"]["kernel"] * 50.0
    tp = params_from_jax(_flat(jp), "cross", BERT_T)
    ids, mask = _ids(rng, 8, 64, BERT_J.vocab_size, min_len=10)
    tt = ((np.arange(64)[None, :] > 5) & (mask > 0)).astype(np.int32)
    want = np.asarray(jbert.cross_encoder_score(
        jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt), BERT_J))
    got = bert.cross_encoder_score(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                   torch.from_numpy(tt), BERT_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(np.argsort(-got), np.argsort(-want))


@pytest.mark.parametrize("b", [1, 3])
def test_clip_image_features_match_jax(b):
    rng = np.random.default_rng(b)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), CLIP_J)
    tp = params_from_jax(_flat(jp), "clip", CLIP_T)
    pixels = rng.standard_normal((b, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jclip.clip_image_features(jp, jnp.asarray(pixels), CLIP_J))
    got = clip.clip_image_features(tp, torch.from_numpy(pixels), CLIP_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert _cos_drift(got, want) <= 1e-5


def test_clip_text_features_match_jax():
    rng = np.random.default_rng(4)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), CLIP_J)
    tp = params_from_jax(_flat(jp), "clip", CLIP_T)
    b, s = 3, 77
    lengths = np.array([77, 12, 30])
    ids = rng.integers(1, 990, (b, s)).astype(np.int32)
    ids[np.arange(b), lengths - 1] = 999  # EOT: the largest id
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = ids * mask
    want = np.asarray(jclip.clip_text_features(jp, jnp.asarray(ids), jnp.asarray(mask), CLIP_J))
    got = clip.clip_text_features(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                  CLIP_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert _cos_drift(got, want) <= 1e-5


def test_params_round_trip_through_npz(tmp_path):
    """Each package reads the flat npz the other writes."""

    from mmrag_tpu_torch.models import convert

    jp = jbert.init_bert_params(jax.random.PRNGKey(0), BERT_J)
    jconvert.save_params(jp, str(tmp_path), "jax")
    loaded = convert.load_params(str(tmp_path), "jax")
    assert convert.params_available(str(tmp_path), "jax")
    flat = flatten_params(loaded)
    for key, val in _flat(jp).items():
        np.testing.assert_array_equal(flat[key], val)
    convert.save_params(unflatten_params(flat), str(tmp_path), "port")
    back = jconvert.load_params(str(tmp_path), "port")
    for key, val in _flat(back).items():
        np.testing.assert_array_equal(val, flat[key])


def test_params_from_jax_fuses_qkv_and_casts_matrices():
    jp = jbert.init_bert_params(jax.random.PRNGKey(0), BERT_J)
    tp = params_from_jax(_flat(jp), "minilm", BERT_T, dtype=torch.bfloat16)
    layer = tp["layers"][0]
    assert layer["qkv"]["kernel"].shape == (64, 192)
    assert layer["qkv"]["kernel"].dtype == torch.bfloat16
    assert layer["qkv"]["bias"].dtype == torch.float32
    assert tp["embeddings"]["word"].dtype == torch.float32
    q = np.array(jp["layers"][0]["q"]["kernel"])
    np.testing.assert_array_equal(layer["qkv"]["kernel"][:, :64].float().numpy(),
                                  torch.from_numpy(q).to(torch.bfloat16).float().numpy())
    with pytest.raises(ValueError):
        params_from_jax(_flat(jp), "minilm", bert.BertConfig(num_layers=3))


# ---------------------------------------------------------------------------
# W8A8 towers (TPU_ENCODER_QUANT=int8): the port's q8 towers against the JAX
# package's, whose q8 blocks run only where its fused kernels engage; on the
# CPU that takes MMRAG_ATTN_IMPL=fused (interpret mode), as
# tests/test_ops_quant.py sets it. Tolerance 1e-3 on features and 1e-5
# cosine drift: the blocks agree within 3e-4 / 2e-4 (test_torch_quant.py), and
# a code flip in one layer moves the next layers' inputs by a fraction of a
# code. Against the port's own f32 tower: cosine >= 0.995, the JAX package's
# W8A8 contract (test_ops_quant.py:189,245).
# ---------------------------------------------------------------------------

Q8_ATOL = 1e-3


@pytest.fixture()
def fused_jax(monkeypatch):
    monkeypatch.setenv("MMRAG_ATTN_IMPL", "fused")


@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_minilm_embed_q8_matches_jax(fused_jax, gelu_approximate):
    from dataclasses import replace

    rng = np.random.default_rng(11)
    jcfg = replace(BERT_J, gelu_approximate=gelu_approximate)
    tcfg = replace(BERT_T, gelu_approximate=gelu_approximate)
    jp = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_flat(jp), "minilm", tcfg)
    tq8 = params_from_jax(_flat(jp), "minilm", tcfg, q8=True)
    ids, mask = _ids(rng, 4, 32, jcfg.vocab_size)
    want = np.asarray(jbert.minilm_embed(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                         q8_layers=jbert.quantize_bert(jp)))
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got = bert.minilm_embed(tp, ti, tm, tcfg, q8_layers=tq8).numpy()
    np.testing.assert_allclose(got, want, atol=Q8_ATOL)
    assert _cos_drift(got, want) <= 1e-5
    full = bert.minilm_embed(tp, ti, tm, tcfg).numpy()
    assert _cos_drift(got, full) <= 0.005


def test_cross_encoder_q8_matches_jax_and_keeps_rerank_order(fused_jax):
    rng = np.random.default_rng(12)
    jp = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), BERT_J)
    jp["classifier"]["kernel"] = jp["classifier"]["kernel"] * 50.0  # logits well apart
    tp = params_from_jax(_flat(jp), "cross", BERT_T)
    tq8 = params_from_jax(_flat(jp), "cross", BERT_T, q8=True)
    ids, mask = _ids(rng, 8, 64, BERT_J.vocab_size, min_len=10)
    tt = ((np.arange(64)[None, :] > 5) & (mask > 0)).astype(np.int32)
    want = np.asarray(jbert.cross_encoder_score(
        jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt), BERT_J,
        q8_layers=jbert.quantize_bert(jp["bert"])))
    args = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(tt), BERT_T)
    got = bert.cross_encoder_score(tp, *args, q8_layers=tq8).numpy()
    np.testing.assert_allclose(got, want, atol=Q8_ATOL)
    np.testing.assert_array_equal(np.argsort(-got), np.argsort(-want))
    full = bert.cross_encoder_score(tp, *args).numpy()
    np.testing.assert_array_equal(np.argsort(-got), np.argsort(-full))


@pytest.mark.parametrize("b", [1, 3])
def test_clip_image_features_q8_match_jax(fused_jax, b):
    rng = np.random.default_rng(20 + b)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), CLIP_J)
    tp = params_from_jax(_flat(jp), "clip", CLIP_T)
    tq8 = params_from_jax(_flat(jp), "clip", CLIP_T, q8=True)
    pixels = rng.standard_normal((b, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jclip.clip_image_features(jp, jnp.asarray(pixels), CLIP_J,
                                                q8_layers=jclip.quantize_clip_vision(jp)))
    got = clip.clip_image_features(tp, torch.from_numpy(pixels), CLIP_T, q8_layers=tq8).numpy()
    np.testing.assert_allclose(got, want, atol=Q8_ATOL)
    assert _cos_drift(got, want) <= 1e-5
    full = clip.clip_image_features(tp, torch.from_numpy(pixels), CLIP_T).numpy()
    assert _cos_drift(got, full) <= 0.005
