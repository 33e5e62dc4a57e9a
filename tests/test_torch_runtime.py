"""The port's tokenizers and ``EncoderRuntime`` against the JAX package's.

Both runtimes load the same ``WEIGHTS_DIR`` (flat npz weights, a WordPiece
``vocab.txt`` and a CLIP ``vocab.json`` + ``merges.txt``), so the bucketed
batch paths — ``tokenize_matrix`` + numpy assembly, seq buckets, batch
padding, the device embed pair, the rerank chunks, image files decoded on
the host — are held against the JAX runtime on the CPU, f32, atol 1e-4.
"""

import json
import os

import jax
import numpy as np
import pytest

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.models import tokenizer as jtok
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models import bert as tbert
from mmrag_tpu_torch.models import clip as tclip
from mmrag_tpu_torch.models import tokenizer as ttok

_WORDS = ("the camera sees a worker lifting heavy boxes in the warehouse while the "
          "model scores posture risk with high accuracy café naïve résumé").split()
_BERT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
             max_position=128)
_VISION = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2, num_heads=2,
               intermediate_size=128)
_TEXT = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
             max_position=77)
TEXTS = [
    "the worker lifts a box",
    " ".join(_WORDS * 3),
    "posture risk, model accuracy: high!",
    "café naïve résumé",
    " ".join(_WORDS * 6),
]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _bert_vocab():
    pieces = sorted({w.lower() for w in _WORDS} | {"##s", "##ing", "##e", "##y", ",", ":", "!"})
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + pieces


def _clip_files(root):
    b2u = jtok._bytes_to_unicode()
    chars = sorted(set(b2u.values()))
    merges = [("t", "h"), ("th", "e</w>"), ("o", "x</w>"), ("b", "ox</w>"), ("a", "r"),
              ("c", "a"), ("ca", "m")]
    vocab = chars + [c + "</w>" for c in chars] + ["th", "the</w>", "ox</w>", "box</w>", "ar",
                                                   "ca", "cam"]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump({tok: i for i, tok in enumerate(vocab)}, fh)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return len(vocab)


def test_tokenizers_give_the_same_ids(tmp_path):
    vocab = {w: i for i, w in enumerate(_bert_vocab())}
    j = jtok.WordPieceTokenizer(vocab)
    t = ttok.WordPieceTokenizer(vocab)
    for text in TEXTS:
        assert t.tokenize_ids(text) == j.tokenize_ids(text)
    jb, jl = j.tokenize_matrix(TEXTS)
    tb, tl = t.tokenize_matrix(TEXTS)
    np.testing.assert_array_equal(tl, jl)
    for i, n in enumerate(tl):
        np.testing.assert_array_equal(tb[i, :n], jb[i, :n])
    for a, b in zip(t.encode_pairs(TEXTS, TEXTS[::-1], 32), j.encode_pairs(TEXTS, TEXTS[::-1], 32)):
        np.testing.assert_array_equal(a, b)
    _clip_files(str(tmp_path))
    jc = jtok.load_clip_tokenizer(str(tmp_path))
    tc = ttok.load_clip_tokenizer(str(tmp_path))
    assert isinstance(tc, ttok.ClipBPETokenizer)
    for a, b in zip(tc.encode(TEXTS), jc.encode(TEXTS)):
        np.testing.assert_array_equal(a, b)
    for style in ("bert", "clip"):
        jh, th = jtok.HashTokenizer(style), ttok.HashTokenizer(style)
        for a, b in zip(th.encode(TEXTS, 40), jh.encode(TEXTS, 40)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    from mmrag_tpu.models.runtime import EncoderRuntime as JRuntime, _sanitize
    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu_torch.models.runtime import EncoderRuntime as TRuntime
    from mmrag_tpu_torch.settings import load_settings as tload

    root = tmp_path_factory.mktemp("runtime")
    weights = str(root / "weights")
    bcfg = jbert.BertConfig(**_BERT)
    ccfg = jclip.CLIPConfig(vision=jclip.CLIPVisionConfig(**_VISION),
                            text=jclip.CLIPTextConfig(**_TEXT), projection_dim=32)
    cross = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), bcfg)
    cross["classifier"]["kernel"] = cross["classifier"]["kernel"] * 50.0  # spread the logits
    for model_id, params in (
        ("sentence-transformers/all-MiniLM-L6-v2", jbert.init_bert_params(jax.random.PRNGKey(0), bcfg)),
        ("cross-encoder/ms-marco-MiniLM-L-6-v2", cross),
        ("openai/clip-vit-base-patch32", jclip.init_clip_params(jax.random.PRNGKey(1), ccfg)),
    ):
        wdir = os.path.join(weights, _sanitize(model_id))
        jconvert.save_params(params, wdir, "model")
        if "clip" in model_id:
            assert _clip_files(wdir) <= _TEXT["vocab_size"]
        else:
            with open(os.path.join(wdir, "vocab.txt"), "w") as fh:
                fh.write("\n".join(_bert_vocab()) + "\n")
    env = {"WEIGHTS_DIR": weights, "TPU_COMPUTE_DTYPE": "float32", "TPU_DATA_PARALLEL": "off",
           "TPU_TEXT_SEQ_BUCKETS": "16,32,64,128", "TPU_TEXT_BATCH_BUCKETS": "2,4,8",
           "TPU_TEXT_EMBED_MAX_LEN": "64", "TPU_RERANK_SEQ_LEN": "64",
           "TPU_IMAGE_BATCH_BUCKETS": "2,4"}
    j = JRuntime(jload(env), bcfg, ccfg)
    t = TRuntime(tload(env), tbert.BertConfig(**_BERT),
                 tclip.CLIPConfig(vision=tclip.CLIPVisionConfig(**_VISION),
                                  text=tclip.CLIPTextConfig(**_TEXT), projection_dim=32),
                 device="cpu")
    return j, t


def test_runtime_text_paths_match_jax(runtimes):
    j, t = runtimes
    np.testing.assert_allclose(t.embed_text_batch(TEXTS), j.embed_text_batch(TEXTS), atol=1e-4)
    np.testing.assert_allclose(t.embed_queries_for_images(TEXTS),
                               j.embed_queries_for_images(TEXTS), atol=1e-4)
    td, ti = t.embed_queries_device(TEXTS[:3])
    jd, ji = j.embed_queries_device(TEXTS[:3])
    assert td.device.type == "cpu" and td.shape == (3, 64) and ti.shape == (3, 32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
    # 10 pairs: two rerank chunks of the capped batch, the last one padded
    qs, ps = [TEXTS[0]] * 10, (TEXTS * 2)
    assert t._rerank_chunks(10) == j._rerank_chunks(10)
    np.testing.assert_allclose(t.rerank_pairs(qs, ps), j.rerank_pairs(qs, ps), atol=1e-4)
    np.testing.assert_allclose(t.rerank_scores(TEXTS[1], TEXTS), j.rerank_scores(TEXTS[1], TEXTS),
                               atol=1e-4)


def test_runtime_image_files_match_jax(runtimes, tmp_path):
    from PIL import Image

    j, t = runtimes
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(224, 224, 3), (300, 240, 3), (224, 300, 3)]):
        path = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(path)
        paths.append(path)
    got = t.embed_image_files(paths)
    want = j.embed_image_files(paths)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_preprocess_refuses_other_canvas_sizes():
    """A canvas other than 224 was refused until X2 was ported; it is now
    resized as ``mmrag_tpu.ops.images.preprocess_batch`` resizes it."""

    import torch

    from mmrag_tpu.ops.images import preprocess_batch as jpreprocess
    from mmrag_tpu_torch.ops.images import preprocess_batch

    batch = np.random.default_rng(0).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    got = preprocess_batch(torch.from_numpy(batch))
    assert got.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpreprocess(batch)), rtol=0, atol=1e-5)
