"""Real-checkpoint validation battery.

Port of ``mmrag_tpu/models/validate.py``: the one-command proof that
converted weights reproduce the torch reference on an operator's own
checkpoint files (MiniLM, ms-marco cross-encoder, CLIP, whisper); ``python -m
mmrag_tpu_torch.models.cli validate`` drives it.

Per family it (1) loads the HF checkpoint on the CPU with ``transformers``
(imported lazily: nothing of this module needs it at import time), (2)
derives the architecture FROM the checkpoint config, never from a preset
guessed by name, (3) computes the torch reference outputs in f32 on fixed
probe inputs, and then (4) hands the state dict, the config and those outputs
to the family's battery (``*_battery``), which converts the weights and runs
the port's towers on ``device`` (the card unless ``"cpu"`` is asked for):

* embedding / score parity against the torch forward, the f32 towers through
  the fused kernels: gate cosine drift <= 1e-3, scores atol 2e-3;
* W8A8 accuracy: the int8 towers (``quantize_bert`` /
  ``quantize_clip_vision`` of the f32 weights, bf16 compute) against the
  converted f32 tower, and the rerank ORDER at the reference's depth 8;
* PQ refined recall@10 on this checkpoint's embedding geometry (MiniLM):
  ``train_pq`` / ``pq_encode`` / ``pq_topk`` / ``refine_exact`` at m 16 over
  a built-in text corpus, tokenized by a crc32 hash so that no tokenizer
  file is needed and the verdict is the same in every process.

The batteries take numpy state dicts and outputs, so a caller without
``transformers`` (``chip_smoke.py`` on the card's machine) calls them
directly with seeded weights and the port's own CPU outputs as the reference.
Everything runs on small fixed probe batches; zero egress.
"""

from __future__ import annotations

import itertools
import zlib
from dataclasses import asdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import bert as tbert
from . import clip as tclip
from . import convert
from . import whisper as twhisper

COSINE_GATE = 1e-3  # max drift vs torch (BASELINE.md judge metric)
W8A8_COSINE_GATE = 0.99
PQ_RECALL_GATE = 0.9
RERANK_DEPTH = 8  # the reference's rerank_topk (config.py:48)
PQ_CANDIDATES = 160  # ADC shortlist refined to the top 10


def cosine_drift(a: np.ndarray, b: np.ndarray) -> float:
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)
    return float(np.max(1.0 - cos))


def _mean_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
    b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-12)
    return float(np.mean(np.sum(a * b, axis=-1)))


def state_dict_numpy(model) -> Dict[str, np.ndarray]:
    """A torch model's state dict as numpy arrays: the converters' input."""

    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def bert_config_from_hf(hf) -> tbert.BertConfig:
    """Architecture from the checkpoint, not a name-guessed preset."""

    return tbert.BertConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        max_position=hf.max_position_embeddings,
        type_vocab_size=hf.type_vocab_size,
        layer_norm_eps=hf.layer_norm_eps,
        pad_token_id=hf.pad_token_id or 0,
    )


def clip_config_from_hf(hf) -> tclip.CLIPConfig:
    v, t = hf.vision_config, hf.text_config
    return tclip.CLIPConfig(
        vision=tclip.CLIPVisionConfig(
            image_size=v.image_size, patch_size=v.patch_size,
            hidden_size=v.hidden_size, num_layers=v.num_hidden_layers,
            num_heads=v.num_attention_heads, intermediate_size=v.intermediate_size,
            layer_norm_eps=v.layer_norm_eps,
        ),
        text=tclip.CLIPTextConfig(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            num_layers=t.num_hidden_layers, num_heads=t.num_attention_heads,
            intermediate_size=t.intermediate_size,
            max_position=t.max_position_embeddings, layer_norm_eps=t.layer_norm_eps,
        ),
        projection_dim=hf.projection_dim,
    )


def whisper_config_from_hf(hf) -> twhisper.WhisperConfig:
    """The ``WhisperConfig`` of an HF whisper config (JAX ``validate.py:357-368``)."""

    return twhisper.WhisperConfig(
        num_mel_bins=hf.num_mel_bins,
        d_model=hf.d_model,
        encoder_layers=hf.encoder_layers,
        encoder_heads=hf.encoder_attention_heads,
        decoder_layers=hf.decoder_layers,
        decoder_heads=hf.decoder_attention_heads,
        ffn_dim=hf.encoder_ffn_dim,
        vocab_size=hf.vocab_size,
        max_source_positions=hf.max_source_positions,
        max_target_positions=hf.max_target_positions,
    )


# ---------------------------------------------------------------------------
# Probe inputs (numpy, seeded): the load step and the battery draw the same
# ---------------------------------------------------------------------------


def _probe_tokens(rng, b: int, s: int, vocab: int):
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if b > 1:
        mask[1, s // 2:] = 0  # ragged padding exercises mask semantics
    ids[mask == 0] = 0
    return ids, mask


def _probe_texts(n: int) -> List[str]:
    subjects = ["the mitochondria", "photosynthesis", "newton's law",
                "the ocean current", "a neural network", "the roman empire"]
    verbs = ["explains", "produces", "describes", "transforms", "regulates"]
    objects = ["cellular energy", "light into sugar", "classical mechanics",
               "global climate", "pattern recognition", "ancient trade"]
    combos = itertools.cycle(itertools.product(subjects, verbs, objects))
    return [f"{s} {v} {o} in chapter {i % 97}"
            for i, (s, v, o) in enumerate(itertools.islice(combos, n))]


def _hash_tokens(texts: List[str], vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """[CLS] words [SEP] with each word's id from its crc32 (Python's
    ``hash`` is randomized per process, which would make the gate verdict
    flip between runs of the same checkpoint). PQ recall needs only the
    checkpoint's embedding GEOMETRY, which the encoder defines."""

    toks = [t.split() for t in texts]
    s = max(len(t) for t in toks) + 2
    ids = np.zeros((len(toks), s), np.int32)
    mask = np.zeros((len(toks), s), np.int32)
    for i, t in enumerate(toks):
        ids[i, 0] = 101 % vocab
        for j, w in enumerate(t):
            ids[i, j + 1] = (zlib.crc32(w.encode()) % (vocab - 10)) + 5
        ids[i, len(t) + 1] = 102 % vocab
        mask[i, : len(t) + 2] = 1
    return ids, mask


def minilm_inputs(cfg: tbert.BertConfig):
    """``(rng, ids, mask)``: the 4 x 48 probe batch; the battery draws the
    PQ queries' noise from the same ``rng`` afterwards."""

    rng = np.random.default_rng(0)
    return (rng, *_probe_tokens(rng, 4, 48, cfg.vocab_size))


def reranker_inputs(cfg: tbert.BertConfig):
    """``(ids, mask, token_types)`` of ``RERANK_DEPTH`` pairs at seq 64."""

    rng = np.random.default_rng(1)
    ids, mask = _probe_tokens(rng, RERANK_DEPTH, 64, cfg.vocab_size)
    tt = np.zeros_like(ids)
    tt[:, 20:] = 1
    tt[mask == 0] = 0
    return ids, mask, tt


def clip_inputs(cfg: tclip.CLIPConfig, bos: int, eos: int):
    """``(pixels (2, H, W, 3), ids (3, s), mask)``. The text tower pools at
    the EOT token as the largest id (the CLIP vocab layout), so a checkpoint
    whose ``eos_token_id`` is not above ``bos_token_id`` is refused."""

    if eos <= bos:
        raise ValueError(f"clip text pooling assumes eos_token_id ({eos}) > "
                         f"bos_token_id ({bos}) — the CLIP vocab layout")
    rng = np.random.default_rng(2)
    v, t = cfg.vision, cfg.text
    pixels = rng.standard_normal((2, v.image_size, v.image_size, 3)).astype(np.float32)
    b, s = 3, min(16, t.max_position)
    ids = rng.integers(1, bos, (b, s)).astype(np.int32)
    ids[:, 0] = bos
    mask = np.zeros((b, s), np.int32)
    for i, pos in enumerate([s - 1, max(2, s // 2), max(3, s - 3)]):
        ids[i, pos] = eos
        ids[i, pos + 1:] = 0
        mask[i, : pos + 1] = 1
    return pixels, ids, mask


def whisper_inputs(cfg: twhisper.WhisperConfig):
    """``(mel (2, 2 * max_source_positions, n_mels), token ids (2, 7))``."""

    rng = np.random.default_rng(3)
    mel = rng.standard_normal(
        (2, cfg.max_source_positions * 2, cfg.num_mel_bins)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    return mel, ids


# ---------------------------------------------------------------------------
# The batteries: the port's towers on ``device`` against reference outputs
# ---------------------------------------------------------------------------


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.inference_mode()
def minilm_battery(sd, cfg: tbert.BertConfig, want: np.ndarray, pq_corpus: int = 4096,
                   device: DeviceLike = None) -> Dict:
    """Convert + parity against ``want`` (the reference's (4, h) sentence
    embeddings of :func:`minilm_inputs`) + W8A8 cosine + PQ refined recall
    on this checkpoint's embeddings."""

    from ..ops import pq as pqops
    from ..ops.topk import l2_normalize

    dev = resolve_device(device)
    tree = convert.convert_bert(sd, cfg)
    params = convert.params_from_jax(tree, "minilm", cfg, device=dev)
    rng, ids, mask = minilm_inputs(cfg)
    ids_t, mask_t = _t(ids, dev), _t(mask, dev)
    got_t = tbert.minilm_embed(params, ids_t, mask_t, cfg)
    got = _np(got_t)
    drift = cosine_drift(got, want)

    q8 = convert.params_from_jax(tree, "minilm", cfg, device=dev, q8=True)
    p16 = convert.params_from_jax(tree, "minilm", cfg, device=dev, dtype=torch.bfloat16)
    got_q8 = _np(tbert.minilm_embed(p16, ids_t, mask_t, cfg, q8_layers=q8))
    w8a8_cos = _mean_cosine(got_q8, got)
    del q8, p16

    texts = _probe_texts(pq_corpus)
    embs_t = torch.cat([
        tbert.minilm_embed(params, *(_t(a, dev) for a in _hash_tokens(texts[i:i + 256],
                                                                      cfg.vocab_size)), cfg)
        for i in range(0, len(texts), 256)])
    embs = _np(embs_t)
    m_pq = 16 if cfg.hidden_size % 16 == 0 else 8
    books = pqops.train_pq(embs_t, m=m_pq)
    codes = pqops.pq_encode(embs_t, books)
    noise = rng.standard_normal((16, cfg.hidden_size)).astype(np.float32)
    q = l2_normalize(embs_t[:16] + 0.05 * _t(noise, dev))
    n = embs.shape[0]
    q_np = _np(q)
    exact = q_np @ embs.T
    thr = np.partition(exact, n - 10, axis=1)[:, n - 10] - 1e-3
    s, ix = pqops.pq_topk(q, books, codes, torch.ones((n,), dtype=torch.bool, device=dev),
                          PQ_CANDIDATES)
    rs, _ = pqops.refine_exact(q_np, embs, ix.cpu().numpy(), _np(s), 10)
    pq_recall = float(np.mean(rs >= thr[:, None]))

    return {
        "family": "minilm",
        "config": asdict(cfg),
        "cosine_drift_vs_torch": drift,
        "parity_ok": drift <= COSINE_GATE,
        "w8a8_cosine_vs_f32": w8a8_cos,
        "w8a8_ok": w8a8_cos >= W8A8_COSINE_GATE,
        "pq_refined_recall_at_10": pq_recall,
        "pq_m": m_pq,
        "pq_ok": pq_recall >= PQ_RECALL_GATE,
        "_params": tree,
        "_cfg": cfg,
    }


@torch.inference_mode()
def reranker_battery(sd, cfg: tbert.BertConfig, want: np.ndarray,
                     device: DeviceLike = None) -> Dict:
    """Convert + score parity against ``want`` (the reference's logits of
    :func:`reranker_inputs`) + W8A8 rerank-order preservation at depth 8."""

    dev = resolve_device(device)
    tree = convert.convert_cross_encoder(sd, cfg)
    params = convert.params_from_jax(tree, "cross", cfg, device=dev)
    ids, mask, tt = (_t(a, dev) for a in reranker_inputs(cfg))
    got = _np(tbert.cross_encoder_score(params, ids, mask, tt, cfg))
    max_abs = float(np.max(np.abs(got - want)))
    order_ok = bool((np.argsort(-got) == np.argsort(-want)).all())

    q8 = convert.params_from_jax(tree, "cross", cfg, device=dev, q8=True)
    p16 = convert.params_from_jax(tree, "cross", cfg, device=dev, dtype=torch.bfloat16)
    got_q8 = _np(tbert.cross_encoder_score(p16, ids, mask, tt, cfg, q8_layers=q8))
    w8a8_order_ok = bool((np.argsort(-got_q8) == np.argsort(-got)).all())

    return {
        "family": "reranker",
        "config": asdict(cfg),
        "score_max_abs_err_vs_torch": max_abs,
        "parity_ok": max_abs <= 2e-3 and order_ok,
        "order_preserved_vs_torch": order_ok,
        "w8a8_order_preserved": w8a8_order_ok,
        "w8a8_ok": w8a8_order_ok,
        "_params": tree,
        "_cfg": cfg,
    }


@torch.inference_mode()
def clip_battery(sd, cfg: tclip.CLIPConfig, want: Tuple[np.ndarray, np.ndarray],
                 bos: int, eos: int, device: DeviceLike = None) -> Dict:
    """Convert + image / text feature parity against ``want`` (the
    reference's features of :func:`clip_inputs`) + W8A8 vision cosine."""

    dev = resolve_device(device)
    tree = convert.convert_clip(sd, cfg)
    params = convert.params_from_jax(tree, "clip", cfg, device=dev)
    pixels, ids, mask = clip_inputs(cfg, bos, eos)
    pixels_t = _t(pixels, dev)
    got_im = _np(tclip.clip_image_features(params, pixels_t, cfg))
    drift_im = cosine_drift(got_im, want[0])
    got_tx = _np(tclip.clip_text_features(params, _t(ids, dev), _t(mask, dev), cfg))
    drift_tx = cosine_drift(got_tx, want[1])

    q8 = convert.params_from_jax(tree, "clip", cfg, device=dev, q8=True)
    p16 = convert.params_from_jax(tree, "clip", cfg, device=dev, dtype=torch.bfloat16)
    got_q8 = _np(tclip.clip_image_features(p16, pixels_t, cfg, q8_layers=q8))
    w8a8_cos = _mean_cosine(got_q8, got_im)

    return {
        "family": "clip",
        "config": {"vision": asdict(cfg.vision), "text": asdict(cfg.text),
                   "projection_dim": cfg.projection_dim},
        "image_cosine_drift_vs_torch": drift_im,
        "text_cosine_drift_vs_torch": drift_tx,
        "parity_ok": drift_im <= COSINE_GATE and drift_tx <= COSINE_GATE,
        "w8a8_cosine_vs_f32": w8a8_cos,
        "w8a8_ok": w8a8_cos >= W8A8_COSINE_GATE,
        "_params": tree,
        "_cfg": cfg,
    }


@torch.inference_mode()
def whisper_battery(sd, cfg: twhisper.WhisperConfig, want: Tuple[np.ndarray, np.ndarray],
                    device: DeviceLike = None) -> Dict:
    """Convert + encoder-state drift and decoder-logit token agreement
    against ``want`` (the reference's encoder states and teacher-forced
    logits of :func:`whisper_inputs`)."""

    dev = resolve_device(device)
    tree = convert.convert_whisper(sd, cfg)
    params = convert.params_from_jax(tree, "whisper", cfg, device=dev)
    mel, ids = whisper_inputs(cfg)
    enc = twhisper.whisper_encode(params, _t(mel, dev), cfg)
    drift_enc = cosine_drift(_np(enc), want[0])
    logits = _np(twhisper.whisper_decode_logits(params, _t(ids, dev), enc, cfg))
    token_agree = float(np.mean(logits.argmax(-1) == want[1].argmax(-1)))

    return {
        "family": "whisper",
        "config": asdict(cfg),
        "encoder_cosine_drift_vs_torch": drift_enc,
        "decoder_token_agreement": token_agree,
        "parity_ok": drift_enc <= COSINE_GATE and token_agree == 1.0,
        "_params": tree,
        "_cfg": cfg,
    }


# ---------------------------------------------------------------------------
# The validators: load on the CPU, reference in f32, then the battery
# ---------------------------------------------------------------------------


def validate_minilm(source: str, pq_corpus: int = 4096, device: DeviceLike = None) -> Dict:
    """Convert + parity + W8A8 cosine + PQ refined recall on real embeddings.

    Returns a report dict with measured numbers, per-check ``*_ok`` flags,
    the converted params (JAX layout, for the CLI to persist) and the
    derived config."""

    import transformers

    model = transformers.BertModel.from_pretrained(source).eval()
    cfg = bert_config_from_hf(model.config)
    _, ids, mask = minilm_inputs(cfg)
    with torch.no_grad():
        hidden = model(input_ids=torch.from_numpy(ids.astype(np.int64)),
                       attention_mask=torch.from_numpy(mask.astype(np.int64))).last_hidden_state
        m = torch.from_numpy(mask).float().unsqueeze(-1)
        pooled = (hidden * m).sum(1) / m.sum(1).clamp(min=1e-9)
        want = torch.nn.functional.normalize(pooled, dim=-1).numpy()
    return minilm_battery(state_dict_numpy(model), cfg, want, pq_corpus, device)


def validate_reranker(source: str, device: DeviceLike = None) -> Dict:
    """Convert + score parity + W8A8 rerank-order preservation at depth 8."""

    import transformers

    model = transformers.BertForSequenceClassification.from_pretrained(source).eval()
    cfg = bert_config_from_hf(model.config)
    ids, mask, tt = reranker_inputs(cfg)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids.astype(np.int64)),
                     attention_mask=torch.from_numpy(mask.astype(np.int64)),
                     token_type_ids=torch.from_numpy(tt.astype(np.int64))).logits.numpy()[:, 0]
    return reranker_battery(state_dict_numpy(model), cfg, want, device)


def validate_clip(source: str, device: DeviceLike = None) -> Dict:
    """Convert + image/text embedding parity + W8A8 vision-tower cosine."""

    import transformers

    model = transformers.CLIPModel.from_pretrained(source).eval()
    cfg = clip_config_from_hf(model.config)
    t_hf = model.config.text_config
    bos, eos = t_hf.bos_token_id, t_hf.eos_token_id
    pixels, ids, mask = clip_inputs(cfg, bos, eos)
    with torch.no_grad():
        want_im = model.get_image_features(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy())).numpy()
        want_tx = model.get_text_features(
            input_ids=torch.from_numpy(ids.astype(np.int64)),
            attention_mask=torch.from_numpy(mask.astype(np.int64))).numpy()
    return clip_battery(state_dict_numpy(model), cfg, (want_im, want_tx), bos, eos, device)


def validate_whisper(source: str, device: DeviceLike = None) -> Dict:
    """Convert + encoder-state and decoder-logit parity (token agreement)."""

    import transformers

    model = transformers.WhisperForConditionalGeneration.from_pretrained(source).eval().model
    cfg = whisper_config_from_hf(model.config)
    mel, ids = whisper_inputs(cfg)
    with torch.no_grad():
        enc = model.encoder(
            input_features=torch.from_numpy(mel.transpose(0, 2, 1).copy())).last_hidden_state
        hidden = model.decoder(input_ids=torch.from_numpy(ids.astype(np.int64)),
                               encoder_hidden_states=enc).last_hidden_state
        logits = (hidden @ model.decoder.embed_tokens.weight.T).numpy()
    return whisper_battery(state_dict_numpy(model), cfg, (enc.numpy(), logits), device)


VALIDATORS = {
    "minilm": validate_minilm,
    "clip": validate_clip,
    "reranker": validate_reranker,
    "whisper": validate_whisper,
}


def public_report(report: Dict) -> Dict:
    """Strip the non-serializable params/cfg carriers for printing."""

    return {k: v for k, v in report.items() if not k.startswith("_")}


def report_passed(report: Dict) -> bool:
    return all(v for k, v in report.items() if k.endswith("_ok"))


def reference_outputs(family: str, sd, cfg, device: DeviceLike = "cpu",
                      bos_eos: Optional[Tuple[int, int]] = None):
    """The port's own f32 outputs of ``family`` on its probe inputs, in the
    form the battery's ``want`` takes: the reference where no HF model can be
    loaded (seeded weights on a machine without ``transformers``).
    ``bos_eos`` is CLIP's ``(bos, eos)`` token pair."""

    dev = resolve_device(device)
    with torch.inference_mode():
        if family == "minilm":
            params = convert.params_from_jax(convert.convert_bert(sd, cfg), "minilm", cfg,
                                             device=dev)
            _, ids, mask = minilm_inputs(cfg)
            return _np(tbert.minilm_embed(params, _t(ids, dev), _t(mask, dev), cfg))
        if family == "reranker":
            params = convert.params_from_jax(convert.convert_cross_encoder(sd, cfg), "cross",
                                             cfg, device=dev)
            ids, mask, tt = (_t(a, dev) for a in reranker_inputs(cfg))
            return _np(tbert.cross_encoder_score(params, ids, mask, tt, cfg))
        if family == "clip":
            params = convert.params_from_jax(convert.convert_clip(sd, cfg), "clip", cfg,
                                             device=dev)
            pixels, ids, mask = clip_inputs(cfg, *bos_eos)
            return (_np(tclip.clip_image_features(params, _t(pixels, dev), cfg)),
                    _np(tclip.clip_text_features(params, _t(ids, dev), _t(mask, dev), cfg)))
        if family == "whisper":
            params = convert.params_from_jax(convert.convert_whisper(sd, cfg), "whisper", cfg,
                                             device=dev)
            mel, ids = whisper_inputs(cfg)
            enc = twhisper.whisper_encode(params, _t(mel, dev), cfg)
            return _np(enc), _np(twhisper.whisper_decode_logits(params, _t(ids, dev), enc, cfg))
    raise ValueError(f"unknown family {family!r}")
