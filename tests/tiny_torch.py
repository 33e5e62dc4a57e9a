"""The port's copy of ``tests/tiny.py``: the same tiny geometries for
``mmrag_tpu_torch``, with weights the JAX package initializes and saves
(``convert.save_params``), so the port reads them through
``params_from_jax`` and a JAX engine over the same directory holds the same
weights."""

import os

import jax

from mmrag_tpu_torch.models.bert import BertConfig
from mmrag_tpu_torch.models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

TINY_BERT = BertConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
TINY_CLIP = CLIPConfig(
    vision=CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128),
    text=CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64),
    projection_dim=512,
)

_MODELS = ("sentence-transformers/all-MiniLM-L6-v2", "cross-encoder/ms-marco-MiniLM-L-6-v2",
           "openai/clip-vit-base-patch32")


def write_tiny_weights(root) -> str:
    """Seeded JAX weights of the tiny geometries (``tests/tiny.py``) under
    ``root`` in the converted-weights layout; returns ``root``. The
    cross-encoder's classifier is scaled so rerank logits sit well apart."""

    from mmrag_tpu.models import bert as jbert
    from mmrag_tpu.models import clip as jclip
    from mmrag_tpu.models import convert as jconvert
    from mmrag_tpu.models.runtime import _sanitize

    from tiny import TINY_BERT as JBERT, TINY_CLIP as JCLIP

    root = str(root)
    if all(os.path.exists(os.path.join(root, _sanitize(m), "model.npz")) for m in _MODELS):
        return root
    minilm = jbert.init_bert_params(jax.random.PRNGKey(0), JBERT)
    cross = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), JBERT)
    cross["classifier"]["kernel"] = cross["classifier"]["kernel"] * 50.0
    clip_p = jclip.init_clip_params(jax.random.PRNGKey(1), JCLIP)
    for model_id, params in zip(_MODELS, (minilm, cross, clip_p)):
        jconvert.save_params(params, os.path.join(root, _sanitize(model_id)), "model")
    return root


def tiny_env(tmp_path, weights, extra_env=None) -> dict:
    env = {
        "TPU_INDEX_DIR": str(tmp_path / "index"),
        "NOTES_DB_PATH": str(tmp_path / "notes.db"),
        "WEIGHTS_DIR": str(weights),
        "MEDIA_DIR": str(tmp_path / "media"),
        "INGEST_CACHE_DIR": str(tmp_path / "cache"),
        "TPU_COMPUTE_DTYPE": "float32",
        "TPU_TEXT_BATCH_BUCKETS": "4,16",
        "TPU_TEXT_SEQ_BUCKETS": "32,128",
        "TPU_IMAGE_BATCH_BUCKETS": "4,8",
    }
    env.update(extra_env or {})
    return env


def tiny_engine(tmp_path, weights, extra_env=None):
    """An isolated port ``RagEngine`` on the CPU over the tiny encoders in
    ``tmp_path``, under the default serving settings (the coalescing
    batchers on) unless ``extra_env`` says otherwise."""

    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    cfg = load_settings(tiny_env(tmp_path, weights, extra_env))
    runtime = EncoderRuntime(cfg, bert_cfg=TINY_BERT, clip_cfg=TINY_CLIP, device="cpu")
    return RagEngine(cfg, runtime)


def jax_tiny_engine(tmp_path, weights, extra_env=None):
    """The JAX package's engine over the same weights and settings."""

    from mmrag_tpu.models.runtime import EncoderRuntime
    from mmrag_tpu.rag.engine import RagEngine
    from mmrag_tpu.settings import load_settings

    from tiny import TINY_BERT as JBERT, TINY_CLIP as JCLIP

    cfg = load_settings({**tiny_env(tmp_path, weights, extra_env), "TPU_DATA_PARALLEL": "off"})
    return RagEngine(cfg, EncoderRuntime(cfg, bert_cfg=JBERT, clip_cfg=JCLIP))


def write_tiny_whisper(root, cfg, seed: int, model_id: str) -> str:
    """Seeded JAX Whisper weights of ``cfg`` (a JAX ``WhisperConfig``) under
    ``root`` in the converted-weights layout, with a byte-level
    ``vocab.json`` of ``" tok{i}"`` pieces for the text ids; returns
    ``root`` (the WEIGHTS_DIR)."""

    import dataclasses
    import json

    from mmrag_tpu.models import convert as jconvert
    from mmrag_tpu.models import whisper as jwhisper
    from mmrag_tpu_torch.models.tokenizer import _bytes_to_unicode

    wdir = os.path.join(str(root), model_id.replace("/", "__"))
    jconvert.save_params(jwhisper.init_whisper_params(jax.random.PRNGKey(seed), cfg), wdir,
                         "model", meta={"arch": "whisper", "config": dataclasses.asdict(cfg)})
    b2u = _bytes_to_unicode()
    vocab = {"".join(b2u[b] for b in f" tok{i}".encode()): i for i in range(cfg.eot_id)}
    with open(os.path.join(wdir, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh)
    return str(root)


def write_wav(path, seconds: float, freq: float = 440.0) -> str:
    """A 16 kHz mono 16-bit sine of ``seconds``; returns its path."""

    import wave

    import numpy as np

    t = np.arange(int(16000 * seconds)) / 16000
    with wave.open(str(path), "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(16000)
        fh.writeframes((np.sin(2 * np.pi * freq * t) * 0.3 * 32767).astype(np.int16).tobytes())
    return str(path)
