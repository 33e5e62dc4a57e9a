"""The port's HF converters against the JAX package's, on the same state dicts.

Tiny random-init HF checkpoints (``transformers``, as
``tests/test_validate_cli.py`` builds them) go through JAX's
``convert_bert`` / ``convert_cross_encoder`` / ``convert_clip`` +
``save_params`` and through the port's: the two flat npz files hold the same
keys and bit-equal arrays (the conversion only transposes and reshapes).
``params_from_jax`` of the port's file then gives the port's forward within
1e-5 (atol) of JAX's forward on JAX's converted tree: f32 at width 32, where
the two sums differ only in order (``tests/test_torch_models.py`` holds 1e-4
at width 64 and 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mmrag_tpu.models import bert as jbert  # noqa: E402
from mmrag_tpu.models import clip as jclip  # noqa: E402
from mmrag_tpu.models import convert as jconvert  # noqa: E402
from mmrag_tpu.models import validate as jval  # noqa: E402
from mmrag_tpu_torch.models import bert as tbert  # noqa: E402
from mmrag_tpu_torch.models import clip as tclip  # noqa: E402
from mmrag_tpu_torch.models import convert as tconvert  # noqa: E402
from mmrag_tpu_torch.models import validate as tval  # noqa: E402

ATOL = 1e-5


def _bert_cfg(**extra):
    return transformers.BertConfig(
        vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, **extra)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    clip_cfg = transformers.CLIPConfig(
        text_config_dict=dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64,
                              max_position_embeddings=16, bos_token_id=126, eos_token_id=127),
        vision_config_dict=dict(image_size=32, patch_size=16, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=64),
        projection_dim=32)
    return {
        "minilm": transformers.BertModel(_bert_cfg()).eval(),
        "cross": transformers.BertForSequenceClassification(_bert_cfg(num_labels=1)).eval(),
        "clip": transformers.CLIPModel(clip_cfg).eval(),
    }


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _convert_both(kind, model):
    """JAX's and the port's converted trees and the port's config."""

    sd = _sd(model)
    if kind == "clip":
        jcfg, tcfg = jval.clip_config_from_hf(model.config), tval.clip_config_from_hf(model.config)
        return jconvert.convert_clip(sd, jcfg), tconvert.convert_clip(sd, tcfg), jcfg, tcfg
    jcfg, tcfg = jval.bert_config_from_hf(model.config), tval.bert_config_from_hf(model.config)
    if kind == "cross":
        return (jconvert.convert_cross_encoder(sd, jcfg), tconvert.convert_cross_encoder(sd, tcfg),
                jcfg, tcfg)
    return jconvert.convert_bert(sd, jcfg), tconvert.convert_bert(sd, tcfg), jcfg, tcfg


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("kind", ["minilm", "cross", "clip"])
def test_converted_npz_equals_jax_key_for_key(kind, models, tmp_path):
    jtree, ttree, _, _ = _convert_both(kind, models[kind])
    jpath = jconvert.save_params(jtree, str(tmp_path / "jax"), "model")
    tpath = tconvert.save_params(ttree, str(tmp_path / "port"), "model")
    want, got = _npz(jpath), _npz(tpath)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
        if got[key].ndim == 2:
            assert got[key].flags["C_CONTIGUOUS"], key
    if kind == "clip":  # carried, not dropped (params_from_jax reads it too)
        assert "logit_scale" in got


def test_clip_accepts_both_pre_layernorm_spellings(models):
    """HF spells the vision tower's pre-LN ``pre_layrnorm``; a state dict
    with ``pre_layernorm`` converts to the same tree."""

    model = models["clip"]
    sd = _sd(model)
    assert "vision_model.pre_layrnorm.weight" in sd
    renamed = {k.replace("pre_layrnorm", "pre_layernorm"): v for k, v in sd.items()}
    cfg = tval.clip_config_from_hf(model.config)
    a = tconvert.flatten_params(tconvert.convert_clip(sd, cfg))
    b = tconvert.flatten_params(tconvert.convert_clip(renamed, cfg))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_patch_kernel_is_the_flattened_convolution(models):
    model = models["clip"]
    cfg = tval.clip_config_from_hf(model.config)
    w = _sd(model)["vision_model.embeddings.patch_embedding.weight"]  # (h, 3, p, p)
    kernel = tconvert.convert_clip(_sd(model), cfg)["vision"]["patch_kernel"]
    assert kernel.shape == (3 * 16 * 16, 32)
    np.testing.assert_array_equal(kernel, w.reshape(32, -1).T)


def _port(tmp_path, ttree, kind, tcfg):
    path = tconvert.save_params(ttree, str(tmp_path / "port"), "model")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return tconvert.params_from_jax(flat, kind, tcfg)


def _tokens(rng, b, s, vocab):
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2:] = 0
    return ids * mask, mask


def test_bert_forward_matches_jax(models, tmp_path):
    jtree, ttree, jcfg, tcfg = _convert_both("minilm", models["minilm"])
    ids, mask = _tokens(np.random.default_rng(0), 3, 24, tcfg.vocab_size)
    want = np.asarray(jbert.minilm_embed(jtree, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = tbert.minilm_embed(_port(tmp_path, ttree, "minilm", tcfg), torch.from_numpy(ids),
                             torch.from_numpy(mask), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_cross_encoder_forward_matches_jax(models, tmp_path):
    jtree, ttree, jcfg, tcfg = _convert_both("cross", models["cross"])
    ids, mask = _tokens(np.random.default_rng(1), 4, 24, tcfg.vocab_size)
    tt = np.zeros_like(ids)
    tt[:, 10:] = 1
    tt[mask == 0] = 0
    want = np.asarray(jbert.cross_encoder_score(
        jtree, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt), jcfg))
    got = tbert.cross_encoder_score(_port(tmp_path, ttree, "cross", tcfg), torch.from_numpy(ids),
                                    torch.from_numpy(mask), torch.from_numpy(tt), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_clip_forward_matches_jax(models, tmp_path):
    jtree, ttree, jcfg, tcfg = _convert_both("clip", models["clip"])
    params = _port(tmp_path, ttree, "clip", tcfg)
    pixels, ids, mask = tval.clip_inputs(tcfg, 126, 127)
    want_im = np.asarray(jclip.clip_image_features(jtree, jnp.asarray(pixels), jcfg))
    got_im = tclip.clip_image_features(params, torch.from_numpy(pixels), tcfg).numpy()
    np.testing.assert_allclose(got_im, want_im, rtol=0, atol=ATOL)
    want_tx = np.asarray(jclip.clip_text_features(jtree, jnp.asarray(ids), jnp.asarray(mask),
                                                  jcfg))
    got_tx = tclip.clip_text_features(params, torch.from_numpy(ids), torch.from_numpy(mask),
                                      tcfg).numpy()
    np.testing.assert_allclose(got_tx, want_tx, rtol=0, atol=ATOL)
    np.testing.assert_allclose(params["logit_scale"].numpy(), jtree["logit_scale"], rtol=0, atol=0)
