"""Whisper (encoder-decoder ASR) in PyTorch, HF-numerics-exact.

Port of ``mmrag_tpu/models/whisper.py``. The whole pipeline after the wav
read runs on the device as plain torch (the JAX package leaves all of it to
XLA; no Pallas kernel lies on this path):

  * the log-mel spectrogram (X4): reflect padding, 400-sample frames at hop
    160, the Hann-windowed real DFT as two f32 products, the mel filterbank
    product, ``log10`` dynamic-range compression, numerically matching HF's
    ``WhisperFeatureExtractor``;
  * the encoder, both stem convolutions as unfold + dense;
  * the greedy decode (X5): a loop of exactly ``max_len`` one-token steps
    over preallocated self-attention K/V caches and cross-attention K/V
    computed once, with no host sync inside the loop (JAX's ``lax.scan``
    runs every step, and so does this loop).

Products take compute-dtype operands and give f32 results (JAX's
``preferred_element_type=float32``): :func:`mmrag_tpu_torch.models.bert.matmul_f32`
for dense layers, :func:`bmm_f32` for the attention products. The vocabulary
projection is f32 x f32 (TF32 is off on the card, ``device.py``).

Parameters are the JAX package's tree (``encoder/{conv1,conv2,positions,
layers,final_ln}``, ``decoder/{token_embedding,positions,layers,final_ln}``)
as tensors: matrices in the working dtype, biases, LayerNorms, positions
and the token embedding f32 (:func:`mmrag_tpu_torch.models.convert.params_from_jax`
with ``kind="whisper"``). :func:`init_whisper_params` returns the JAX-layout
tree as numpy arrays, as :func:`mmrag_tpu_torch.models.bert.init_bert_params`
does.

Architecture facts mirrored from HF ``openai/whisper-*``: pre-LN blocks,
erf gelu, LayerNorm eps 1e-5, no bias on k_proj, q scaled by head_dim**-0.5,
sinusoidal (stored) encoder positions, learned decoder positions, logits =
tied token-embedding transpose. Decoding forces
``<|startoftranscript|>[lang][task]<|notimestamps|>`` and stops at
``<|endoftext|>``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .bert import _dense, _layer_norm, _normal

Params = Dict[str, Any]

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
CHUNK_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480_000
NUM_FRAMES = CHUNK_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30 s chunk


@dataclass(frozen=True)
class WhisperConfig:
    num_mel_bins: int = 80
    d_model: int = 512
    encoder_layers: int = 6
    encoder_heads: int = 8
    decoder_layers: int = 6
    decoder_heads: int = 8
    ffn_dim: int = 2048
    vocab_size: int = 51_865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    # ---- special token ids -------------------------------------------------
    # OpenAI's vocab layout: ``base`` text tokens (ids 0..base-1), then
    # <|endoftext|>, <|startoftranscript|>, L language tokens, <|translate|>,
    # <|transcribe|>, <|startoflm|>, <|startofprev|>, <|nospeech|>,
    # <|notimestamps|>, and 1501 timestamp tokens — so
    # ``vocab = base + L + 1509``. Multilingual models: base 50257, L=99
    # (vocab 51865); large-v3 adds one language (51866); .en models: base
    # 50256, same specials (51864). Reduced-vocab test models (vocab < 51864)
    # use the last three ids as eot/sot/notimestamps so the decode loop and
    # detokenizer stay well-defined.
    @property
    def _standard_vocab(self) -> bool:
        return self.vocab_size >= 51_864

    @property
    def multilingual(self) -> bool:
        return self.vocab_size >= 51_865

    @property
    def eot_id(self) -> int:  # == number of base text tokens
        if not self._standard_vocab:
            return self.vocab_size - 1
        return 50_257 if self.multilingual else 50_256

    @property
    def sot_id(self) -> int:
        return self.eot_id + 1 if self._standard_vocab else self.vocab_size - 2

    @property
    def num_languages(self) -> int:
        return self.vocab_size - self.eot_id - 1509 if self._standard_vocab else 0

    @property
    def lang_base_id(self) -> int:  # <|en|> is the first language token
        return self.sot_id + 1

    @property
    def translate_id(self) -> int:
        return self.lang_base_id + self.num_languages

    @property
    def transcribe_id(self) -> int:
        return self.translate_id + 1

    @property
    def no_timestamps_id(self) -> int:
        return self.transcribe_id + 4 if self._standard_vocab else self.vocab_size - 3

    @property
    def timestamp_begin_id(self) -> int:
        return self.no_timestamps_id + 1

    def language_id(self, code: str) -> int:
        """Token id for a language code (OpenAI's canonical ordering)."""

        idx = LANGUAGES.index(code)  # raises ValueError for unknown codes
        if idx >= self.num_languages:
            raise ValueError(f"language {code!r} not in this model's vocab")
        return self.lang_base_id + idx

    def forced_prefix(self, language: str = "en", task: str = "transcribe") -> Tuple[int, ...]:
        """``<|startoftranscript|>[<|lang|><|task|>]<|notimestamps|>``."""

        if not self.multilingual:
            return (self.sot_id, self.no_timestamps_id)
        task_id = self.transcribe_id if task == "transcribe" else self.translate_id
        return (self.sot_id, self.language_id(language), task_id, self.no_timestamps_id)


# OpenAI Whisper's language ordering — token id = lang_base_id + index.
# The 100th (yue) exists only in large-v3's vocab (num_languages gates it).
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


WHISPER_TINY = WhisperConfig(d_model=384, encoder_layers=4, encoder_heads=6,
                             decoder_layers=4, decoder_heads=6, ffn_dim=1536)
WHISPER_BASE = WhisperConfig()
WHISPER_SMALL = WhisperConfig(d_model=768, encoder_layers=12, encoder_heads=12,
                              decoder_layers=12, decoder_heads=12, ffn_dim=3072)

_PRESETS = {"tiny": WHISPER_TINY, "base": WHISPER_BASE, "small": WHISPER_SMALL}


def preset(name: str) -> WhisperConfig:
    for key, cfg in _PRESETS.items():
        if key in name:
            return cfg
    raise KeyError(f"unknown whisper preset in {name!r}; expected one of {list(_PRESETS)}")


# ---------------------------------------------------------------------------
# Log-mel frontend (HF WhisperFeatureExtractor numerics)
# ---------------------------------------------------------------------------


def mel_filterbank(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = 80,
    sample_rate: int = SAMPLE_RATE,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank
    ``(n_freqs, n_mels)`` — matches HF ``mel_filter_bank(..., norm="slaney",
    mel_scale="slaney")`` / librosa defaults."""

    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        hz = 200.0 * m / 3.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.T.astype(np.float32)  # (n_freqs, n_mels)


@functools.lru_cache(maxsize=4)
def _mel_constants(n_mels: int):
    n = np.arange(N_FFT)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * n / N_FFT)).astype(np.float64)  # periodic hann
    k = np.arange(N_FFT // 2 + 1)
    ang = -2 * np.pi * np.outer(n, k) / N_FFT
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)  # window folded into DFT
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b, mel_filterbank(n_mels=n_mels)


@functools.lru_cache(maxsize=8)
def _mel_constants_on(n_mels: int, device: torch.device):
    """:func:`_mel_constants` as f32 tensors on ``device``, copied once."""

    return tuple(torch.from_numpy(a).to(device) for a in _mel_constants(n_mels))


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(b, 480000) f32 waveform -> (b, 3000, n_mels) HF-Whisper log-mel (X4).

    Reflect-pad + frame + windowed real DFT as two f32 products + mel
    product + log10 dynamic-range compression. The peak is taken per batch
    row, so a zero-padded window of a bucket has its own.
    """

    cos_b, sin_b, fb = _mel_constants_on(n_mels, audio.device)
    pad = N_FFT // 2
    # torch's reflect padding takes a (b, channels, T) view
    x = F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = audio.shape[1] // HOP_LENGTH  # HF computes then drops the last frame
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # (b, frames, 400)
    real = frames @ cos_b
    imag = frames @ sin_b
    power = real * real + imag * imag  # (b, frames, 201)
    mel = power @ fb
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Init (seeded, offline-friendly; the JAX-layout tree as numpy)
# ---------------------------------------------------------------------------


def _dense_init(gen, fan_in: int, fan_out: int, bias: bool = True) -> Params:
    p = {"kernel": _normal(gen, (fan_in, fan_out))}
    if bias:
        p["bias"] = np.zeros(fan_out, np.float32)
    return p


def _ln_init(dim: int) -> Params:
    return {"scale": np.ones(dim, np.float32), "bias": np.zeros(dim, np.float32)}


def _attn_init(gen, d: int) -> Params:
    return {
        "q": _dense_init(gen, d, d),
        "k": _dense_init(gen, d, d, bias=False),  # whisper k_proj has no bias
        "v": _dense_init(gen, d, d),
        "out": _dense_init(gen, d, d),
    }


def _sinusoid_positions(length: int, dim: int) -> np.ndarray:
    """OpenAI Whisper's encoder sinusoids (what HF stores in
    ``encoder.embed_positions.weight``)."""

    log_timescale = np.log(10_000) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper_params(seed: int = 0, cfg: WhisperConfig = WHISPER_BASE) -> Params:
    """Deterministic seeded init with the JAX package's tree and stds
    (normal 0.02, zero biases, unit LN, sinusoid encoder positions), as numpy
    arrays. The numbers come from a ``torch.Generator`` and differ from
    ``jax.random``'s."""

    gen = torch.Generator().manual_seed(seed)
    d, f = cfg.d_model, cfg.ffn_dim
    enc_layers = [
        {"ln1": _ln_init(d), "attn": _attn_init(gen, d), "ln2": _ln_init(d),
         "fc1": _dense_init(gen, d, f), "fc2": _dense_init(gen, f, d)}
        for _ in range(cfg.encoder_layers)
    ]
    dec_layers = [
        {"ln1": _ln_init(d), "self_attn": _attn_init(gen, d),
         "ln_cross": _ln_init(d), "cross_attn": _attn_init(gen, d), "ln2": _ln_init(d),
         "fc1": _dense_init(gen, d, f), "fc2": _dense_init(gen, f, d)}
        for _ in range(cfg.decoder_layers)
    ]
    return {
        "encoder": {
            "conv1": _dense_init(gen, 3 * cfg.num_mel_bins, d),
            "conv2": _dense_init(gen, 3 * d, d),
            "positions": _sinusoid_positions(cfg.max_source_positions, d),
            "layers": enc_layers,
            "final_ln": _ln_init(d),
        },
        "decoder": {
            "token_embedding": _normal(gen, (cfg.vocab_size, d)),
            "positions": _normal(gen, (cfg.max_target_positions, d)),
            "layers": dec_layers,
            "final_ln": _ln_init(d),
        },
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` of (B, M, K) x (B, K, N) operands in one dtype with
    an f32 result, never rounded to the operands' dtype (JAX's einsum with
    ``preferred_element_type=float32``): on the card
    ``torch.bmm(..., out_dtype=float32)``; on the CPU, f32 products of the
    operands (exact for bf16 values)."""

    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")  # HF whisper uses erf gelu


def _heads(x: torch.Tensor, heads: int, dtype) -> torch.Tensor:
    """(b, s, d) -> (b*heads, s, hd) in ``dtype``."""

    b, s, d = x.shape
    return x.to(dtype).reshape(b, s, heads, d // heads).transpose(1, 2).reshape(
        b * heads, s, d // heads)


def _merge_heads(ctx: torch.Tensor, b: int) -> torch.Tensor:
    """(b*heads, s, hd) -> (b, s, d)."""

    bh, s, hd = ctx.shape
    return ctx.reshape(b, bh // b, s, hd).transpose(1, 2).reshape(b, s, bh // b * hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias, dtype) -> torch.Tensor:
    """softmax(q k^T + bias) v over (b*heads, s, hd) operands; f32 scores,
    probabilities cast to ``dtype`` for the second product."""

    scores = bmm_f32(q, k.transpose(1, 2))
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return bmm_f32(probs.to(dtype), v), probs


def _mha(attn: Params, x_q: torch.Tensor, x_kv: torch.Tensor, heads: int,
         bias, dtype, probs_out: list | None = None) -> torch.Tensor:
    """(b, sq, d) x (b, sk, d) -> (b, sq, d); q pre-scaled like HF whisper.
    ``probs_out`` receives the (b, heads, sq, sk) f32 probabilities."""

    b, sq, d = x_q.shape
    hd = d // heads
    q = _heads(_dense(attn["q"], x_q, dtype) * (hd ** -0.5), heads, dtype)
    k = _heads(_dense(attn["k"], x_kv, dtype), heads, dtype)
    v = _heads(_dense(attn["v"], x_kv, dtype), heads, dtype)
    ctx, probs = _attend(q, k, v, bias, dtype)
    if probs_out is not None:
        probs_out.append(probs.reshape(b, heads, sq, -1))
    return _dense(attn["out"], _merge_heads(ctx, b), dtype)


def _unfold3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """kernel-3, pad-1 conv1d unfold: (b, T, c) -> (b, T_out, 3c), (k, c)
    flattening order matching torch ``Conv1d.weight`` (out, in, k) transposed
    to (k, in, out) in :func:`mmrag_tpu_torch.models.convert.convert_whisper`."""

    t = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    t_out = (t + 2 - 3) // stride + 1
    last = stride * (t_out - 1) + 1
    return torch.cat([xp[:, k: k + last: stride] for k in range(3)], dim=-1)


def _ffn(layer: Params, x: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    h = _layer_norm(layer["ln2"], x, eps)
    return _dense(layer["fc2"], _gelu(_dense(layer["fc1"], h, dtype)), dtype)


def whisper_encode(
    params: Params,
    mel: torch.Tensor,  # (b, 3000, n_mels) from log_mel_spectrogram
    cfg: WhisperConfig = WHISPER_BASE,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Encoder states (b, 1500, d_model) in f32."""

    enc = params["encoder"]
    eps = cfg.layer_norm_eps
    x = _gelu(_dense(enc["conv1"], _unfold3(mel, stride=1), compute_dtype))
    x = _gelu(_dense(enc["conv2"], _unfold3(x.to(compute_dtype), stride=2), compute_dtype))
    x = x + enc["positions"][None, : x.shape[1]]
    for layer in enc["layers"]:
        h = _layer_norm(layer["ln1"], x, eps)
        x = x + _mha(layer["attn"], h, h, cfg.encoder_heads, None, compute_dtype)
        x = x + _ffn(layer, x, eps, compute_dtype)
    return _layer_norm(enc["final_ln"], x, eps)


def _vocab_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 hidden states x the tied f32 token embedding's transpose: the
    vocabulary projection, f32 x f32 (not rounded to the compute dtype)."""

    return x @ params["decoder"]["token_embedding"].T


def whisper_decode_logits(
    params: Params,
    token_ids: torch.Tensor,  # (b, s) int
    enc_states: torch.Tensor,  # (b, 1500, d)
    cfg: WhisperConfig = WHISPER_BASE,
    compute_dtype: torch.dtype = torch.float32,
    cross_out: list | None = None,
) -> torch.Tensor:
    """Teacher-forced decoder logits (b, s, vocab) — the parity/test path;
    generation uses the KV-cached :func:`whisper_greedy_decode`.
    ``cross_out`` receives each layer's (b, heads, s, frames) cross-attention
    probabilities (:func:`mmrag_tpu_torch.models.align.decoder_cross_attention`)."""

    dec = params["decoder"]
    s = token_ids.shape[1]
    eps = cfg.layer_norm_eps
    x = dec["token_embedding"][token_ids.long()] + dec["positions"][None, :s]
    causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32, device=x.device),
                        diagonal=1)[None]
    for layer in dec["layers"]:
        h = _layer_norm(layer["ln1"], x, eps)
        x = x + _mha(layer["self_attn"], h, h, cfg.decoder_heads, causal, compute_dtype)
        h = _layer_norm(layer["ln_cross"], x, eps)
        x = x + _mha(layer["cross_attn"], h, enc_states, cfg.decoder_heads, None,
                     compute_dtype, cross_out)
        x = x + _ffn(layer, x, eps, compute_dtype)
    return _vocab_logits(params, _layer_norm(dec["final_ln"], x, eps))


def parse_timestamp_segments(
    tokens: Sequence[int],
    cfg: WhisperConfig,
    time_offset: float = 0.0,
    window_seconds: float = float(CHUNK_SECONDS),
) -> list:
    """Split a decoded token sequence on Whisper timestamp tokens.

    Input is one window's consumed-token sequence (prefix included) decoded
    with a timestamp-enabled prefix (no ``<|notimestamps|>``). Timestamp
    tokens encode ``(id - timestamp_begin) * 0.02`` seconds. Returns
    ``[(start_sec, end_sec, [text_token_ids])]`` with ``time_offset`` added;
    parsing is tolerant of the malformed patterns unconstrained greedy can
    emit (missing closing stamp -> segment ends at the last seen time;
    consecutive stamps -> no empty segment). An empty result means the
    window produced no usable timestamps; callers fall back to
    window-granularity segments.
    """

    ts_begin, eot = cfg.timestamp_begin_id, cfg.eot_id
    segments = []
    start: float | None = None
    text: list = []
    for tok in tokens:
        tok = int(tok)
        if tok == eot:
            break
        if tok >= ts_begin:
            t = (tok - ts_begin) * 0.02
            if start is not None and text:
                segments.append((time_offset + start, time_offset + t, text))
            start, text = t, []
        elif tok < eot and start is not None:  # text token inside a segment
            text.append(tok)
    if start is not None and text:  # unterminated tail: close at window end
        segments.append((time_offset + start, time_offset + max(start, window_seconds), text))
    return segments


def detect_language(
    params: Params,
    enc_states: torch.Tensor,  # (b, 1500, d)
    cfg: WhisperConfig = WHISPER_BASE,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Language-token ids (b,) int32 — one decoder step on
    ``<|startoftranscript|>`` with the logits restricted to the
    language-token slice."""

    if not cfg.multilingual:
        raise ValueError("language detection needs a multilingual checkpoint")
    b = enc_states.shape[0]
    sot = torch.full((b, 1), cfg.sot_id, dtype=torch.long, device=enc_states.device)
    logits = whisper_decode_logits(params, sot, enc_states, cfg, compute_dtype)
    lang = logits[:, 0, cfg.lang_base_id: cfg.lang_base_id + cfg.num_languages]
    return (lang.argmax(dim=-1) + cfg.lang_base_id).to(torch.int32)


# ---------------------------------------------------------------------------
# KV-cached greedy decode (X5: max_len steps, no host sync)
# ---------------------------------------------------------------------------


def whisper_greedy_decode(
    params: Params,
    enc_states: torch.Tensor,  # (b, 1500, d)
    cfg: WhisperConfig = WHISPER_BASE,
    forced_prefix: Sequence[int] | None = None,
    max_len: int = 224,
    compute_dtype: torch.dtype = torch.float32,
    eot_id: int | None = None,  # override for reduced-vocab test models
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode with per-layer KV caches.

    Returns ``(tokens, lengths)``: tokens (b, max_len) int32 — the consumed
    sequence starting at ``<|startoftranscript|>``, padded with
    ``<|endoftext|>`` after stopping — and lengths (b,) int32 counting tokens
    before the first eot. Cross-attention K/V are computed once; each of the
    ``max_len`` steps runs (b, 1, d) products against the caches, written in
    place at step ``t``. Nothing in the loop reads the device, so the host
    queues every step without waiting.
    """

    dec = params["decoder"]
    b, s_enc = enc_states.shape[:2]
    d, heads = cfg.d_model, cfg.decoder_heads
    hd = d // heads
    eps = cfg.layer_norm_eps
    dtype = compute_dtype
    dev = enc_states.device
    eot = cfg.eot_id if eot_id is None else eot_id
    prefix = tuple(forced_prefix) if forced_prefix is not None else cfg.forced_prefix()
    assert 0 < len(prefix) <= max_len
    # past the position table the decode would read no position: refuse it
    assert max_len <= cfg.max_target_positions, (
        f"max_len {max_len} exceeds max_target_positions {cfg.max_target_positions}"
    )

    # cross K/V once, as (b*heads, S, hd) in the compute dtype
    cross_kv = [
        (_heads(_dense(layer["cross_attn"]["k"], enc_states, dtype), heads, dtype),
         _heads(_dense(layer["cross_attn"]["v"], enc_states, dtype), heads, dtype))
        for layer in dec["layers"]
    ]
    caches = [
        (torch.zeros((b, max_len, heads, hd), dtype=dtype, device=dev),
         torch.zeros((b, max_len, heads, hd), dtype=dtype, device=dev))
        for _ in dec["layers"]
    ]
    # row t: the additive position mask of step t (positions <= t open)
    pos = torch.arange(max_len, device=dev)
    pos_masks = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e9).to(torch.float32)
    forced = torch.tensor(prefix, dtype=torch.long, device=dev)
    tokens = torch.empty((b, max_len), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    nxt = forced[0].expand(b)
    emb, positions = dec["token_embedding"], dec["positions"]
    scale = hd ** -0.5

    for t in range(max_len):
        tok = forced[t].expand(b) if t < len(prefix) else nxt
        x = (emb[tok] + positions[t])[:, None, :]  # (b, 1, d)
        mask = pos_masks[t]
        for layer, (kc, vc), (ck, cv) in zip(dec["layers"], caches, cross_kv):
            sa = layer["self_attn"]
            h = _layer_norm(layer["ln1"], x, eps)
            q = (_dense(sa["q"], h, dtype) * scale).reshape(b * heads, 1, hd).to(dtype)
            kc[:, t] = _dense(sa["k"], h, dtype).reshape(b, heads, hd)
            vc[:, t] = _dense(sa["v"], h, dtype).reshape(b, heads, hd)
            keys = kc.permute(0, 2, 1, 3).reshape(b * heads, max_len, hd)
            vals = vc.permute(0, 2, 1, 3).reshape(b * heads, max_len, hd)
            ctx, _ = _attend(q, keys, vals, mask, dtype)
            x = x + _dense(sa["out"], ctx.reshape(b, 1, d), dtype)

            ca = layer["cross_attn"]
            h = _layer_norm(layer["ln_cross"], x, eps)
            q = (_dense(ca["q"], h, dtype) * scale).reshape(b * heads, 1, hd).to(dtype)
            ctx, _ = _attend(q, ck, cv, None, dtype)
            x = x + _dense(ca["out"], ctx.reshape(b, 1, d), dtype)

            x = x + _ffn(layer, x, eps, dtype)
        logits = _vocab_logits(params, _layer_norm(dec["final_ln"], x, eps)[:, 0])
        done = done | (tok == eot)
        nxt = torch.where(done, eot, logits.argmax(dim=-1))
        tokens[:, t] = torch.where(done, eot, tok)
    lengths = (tokens != eot).sum(dim=1, dtype=torch.int32)
    return tokens, lengths
