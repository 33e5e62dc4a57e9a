"""Whisper ASR runtime on one device: wav -> TranscriptSegments.

Port of ``mmrag_tpu/ingest/asr.py``, the top rung of the ASR ladder.
Everything after the wav read runs on the runtime's device: log-mel,
encoder and the KV-cached greedy decode
(:mod:`mmrag_tpu_torch.models.whisper`). Audio is split into Whisper's 30 s
windows, and windows are batched into power-of-two buckets (1, 2, 4, 8), so
the device sees a few fixed shapes; one dispatch transcribes a bucket and
is read back once. JAX's per-(bucket, prefix) ``jax.jit`` programs become
one cached callable per (bucket, prefix).

The runtime runs on ``cuda`` unless it is given ``device="cpu"``; without
CUDA and without ``"cpu"`` it raises, as ``EncoderRuntime`` does. Products
run in bf16 on the card under ``TPU_COMPUTE_DTYPE=bfloat16`` (the default),
f32 on the CPU (``device.working_dtype``).

Activation requires converted weights + ``vocab.json`` under
``WEIGHTS_DIR/<MODEL_ASR>/`` (either package's ``save_params`` of a
``convert_whisper`` tree); otherwise :func:`get_asr_runtime` returns None
and the ladder tries its other rungs.

Segment granularity: with ``MODEL_ASR_TIMESTAMPS`` (the default) each window
decodes with a timestamp-enabled prefix and is split on Whisper timestamp
tokens into sub-window segments; disabled — or when a window's decode emits
no usable stamps — segments fall back to one per 30 s window (start =
window offset, duration = audio covered).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import wave
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, working_dtype
from ..settings import Settings, settings as _default_settings

logger = logging.getLogger(__name__)

_CHUNK_BUCKETS = (1, 2, 4, 8)


def read_wav_mono16k(path: str) -> np.ndarray:
    """16 kHz mono PCM wav -> float32 waveform in [-1, 1].

    The ffmpeg extraction step (:func:`mmrag_tpu_torch.ingest.youtube.extract_audio`)
    always produces this format; anything else is a caller bug, reported
    loudly rather than resampled silently.
    """

    with wave.open(path, "rb") as fh:
        if fh.getframerate() != 16_000 or fh.getnchannels() != 1:
            raise ValueError(
                f"{path}: expected 16kHz mono wav, got "
                f"{fh.getframerate()}Hz x{fh.getnchannels()}"
            )
        width = fh.getsampwidth()
        raw = fh.readframes(fh.getnframes())
    if width == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    return audio


def _bucket(n: int, buckets=_CHUNK_BUCKETS) -> int:
    from ..models.runtime import _bucket as _impl  # single shared definition

    return _impl(n, buckets)


def _weights_dir(cfg: Settings) -> str:
    return os.path.join(cfg.paths.weights_dir, cfg.models.asr.replace("/", "__"))


def weights_available(cfg: Settings) -> bool:
    """Converted weights and ``vocab.json`` under ``WEIGHTS_DIR/<MODEL_ASR>/``."""

    from ..models import convert

    wdir = _weights_dir(cfg)
    return convert.params_available(wdir, "model") and os.path.exists(
        os.path.join(wdir, "vocab.json"))


class WhisperRuntime:
    """Lazy-loading, bucketed Whisper transcription engine on one device.

    ``language`` is a code from :data:`mmrag_tpu_torch.models.whisper.LANGUAGES`
    or ``"auto"`` (default): detect once per file from the first window.
    """

    def __init__(
        self,
        cfg: Optional[Settings] = None,
        max_tokens: int = 224,
        language: Optional[str] = None,
        timestamps: Optional[bool] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg or _default_settings
        self.device = resolve_device(device)
        self.compute_dtype = working_dtype(self.cfg.tpu.compute_dtype, self.device)
        self.max_tokens = max_tokens
        self.language = language or self.cfg.models.asr_language
        self.timestamps = (
            self.cfg.models.asr_timestamps if timestamps is None else timestamps
        )
        self._lock = threading.RLock()
        self._params = None
        self._model_cfg = None
        self._decoder = None
        self._fns: Dict[tuple, Callable] = {}
        self._detect_fn = None

    # -- loading ------------------------------------------------------------

    def available(self) -> bool:
        return weights_available(self.cfg)

    def _ensure(self) -> None:
        with self._lock:
            if self._params is not None:
                return
            from ..models import convert, tokenizer as tok, whisper

            wdir = _weights_dir(self.cfg)
            if not self.available():
                raise FileNotFoundError(
                    f"no converted whisper weights + vocab.json under {wdir}; "
                    "write convert.convert_whisper(<HF state dict>) there with "
                    "convert.save_params(..., 'model') and add the tokenizer's vocab.json"
                )
            meta_path = os.path.join(wdir, "model.json")
            meta = {}
            if os.path.exists(meta_path):
                with open(meta_path, encoding="utf-8") as fh:
                    meta = json.load(fh)
            if "config" in meta:
                model_cfg = whisper.WhisperConfig(**meta["config"])
            else:
                model_cfg = whisper.preset(self.cfg.models.asr)
            tree = convert.load_params(wdir, "model")
            vocab = int(tree["decoder"]["token_embedding"].shape[0])
            if vocab != model_cfg.vocab_size:  # .en checkpoints
                model_cfg = dataclasses.replace(model_cfg, vocab_size=vocab)
            self._params = convert.params_from_jax(
                tree, "whisper", model_cfg, device=self.device, dtype=self.compute_dtype)
            self._model_cfg = model_cfg
            # the decode loop cannot run past the learned position table
            self.max_tokens = min(self.max_tokens, model_cfg.max_target_positions)
            self._decoder = tok.load_whisper_decoder(wdir, model_cfg.eot_id)
            logger.info("whisper ASR loaded from %s (%s) on %s", wdir, self.cfg.models.asr,
                        self.device)

    def _window_samples(self) -> int:
        from ..models.whisper import HOP_LENGTH

        # Whisper's window is max_source_positions encoder states x conv
        # stride 2 x hop 160 samples = 30 s for real checkpoints; deriving it
        # from the config keeps reduced test models consistent end to end
        return self._model_cfg.max_source_positions * 2 * HOP_LENGTH

    def _encode(self, audio: np.ndarray) -> torch.Tensor:
        """(b, samples) host waveform -> encoder states on the device."""

        from ..models import whisper

        mcfg = self._model_cfg
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        mel = whisper.log_mel_spectrogram(x, mcfg.num_mel_bins)
        return whisper.whisper_encode(self._params, mel, mcfg, self.compute_dtype)

    def _transcribe_fn(self, batch: int, prefix: tuple) -> Callable:
        """One mel -> encode -> greedy-decode callable per (batch bucket,
        decode prefix)."""

        key = (batch, prefix)
        with self._lock:
            if key not in self._fns:
                from ..models import whisper

                def fn(audio: np.ndarray):
                    with torch.inference_mode():
                        enc = self._encode(audio)
                        return whisper.whisper_greedy_decode(
                            self._params, enc, self._model_cfg, forced_prefix=prefix,
                            max_len=self.max_tokens, compute_dtype=self.compute_dtype)

                self._fns[key] = fn
            return self._fns[key]

    def _resolve_prefix(self, first_window: np.ndarray) -> tuple:
        """Decode prefix for this file: fixed language, or one detection
        dispatch on the first window when ``language == "auto"``."""

        mcfg = self._model_cfg

        def finish(prefix: tuple) -> tuple:
            # timestamp mode drops the trailing <|notimestamps|>
            return prefix[:-1] if self.timestamps else prefix

        if not mcfg.multilingual:
            return finish(mcfg.forced_prefix())
        if self.language != "auto":
            return finish(mcfg.forced_prefix(language=self.language))
        from ..models import whisper

        with self._lock:
            if self._detect_fn is None:

                def detect(audio: np.ndarray):
                    with torch.inference_mode():
                        return whisper.detect_language(
                            self._params, self._encode(audio), mcfg, self.compute_dtype)

                self._detect_fn = detect
        lang_id = int(self._detect_fn(first_window[None])[0])
        return finish((mcfg.sot_id, lang_id, mcfg.transcribe_id, mcfg.no_timestamps_id))

    def _first_window(self, audio: np.ndarray) -> np.ndarray:
        chunk = self._window_samples()
        first = np.zeros(chunk, np.float32)
        first[: min(len(audio), chunk)] = audio[:chunk]
        return first

    # -- transcription --------------------------------------------------------

    def transcribe_array(self, audio: np.ndarray) -> List[Tuple[float, float, str]]:
        """float32 16 kHz waveform -> [(start_sec, duration_sec, text)]."""

        from ..models.whisper import SAMPLE_RATE

        self._ensure()
        chunk_samples = self._window_samples()
        audio = np.asarray(audio, np.float32)
        total = len(audio)
        if total == 0:
            return []
        n_chunks = max(1, -(-total // chunk_samples))
        prefix = self._resolve_prefix(self._first_window(audio))

        results: List[Tuple[float, float, str]] = []
        done = 0
        while done < n_chunks:
            take = min(n_chunks - done, _CHUNK_BUCKETS[-1])
            bsz = _bucket(take)
            # slice+pad per batch: peak host memory is one bucket of windows,
            # not a zero-padded copy of the whole file
            batch = np.zeros((bsz, chunk_samples), np.float32)
            for j in range(take):
                part = audio[(done + j) * chunk_samples : (done + j + 1) * chunk_samples]
                batch[j, : len(part)] = part
            tokens, lengths = self._transcribe_fn(bsz, prefix)(batch)
            # the dispatch's one readback: tokens with their lengths
            host = torch.cat([tokens, lengths[:, None]], dim=1).cpu().numpy()
            for j in range(take):
                idx = done + j
                start = idx * chunk_samples / SAMPLE_RATE
                covered = min(total - idx * chunk_samples, chunk_samples) / SAMPLE_RATE
                toks = host[j, : int(host[j, -1])]
                results.extend(self._window_segments(toks, start, covered))
            done += take
        return results

    def _window_segments(
        self, toks: np.ndarray, start: float, covered: float
    ) -> List[Tuple[float, float, str]]:
        """One window's tokens -> segments: timestamp-token split when
        enabled (falling back to the whole window if the decode produced no
        usable stamps), else one segment per window."""

        if self.timestamps:
            from ..models.whisper import parse_timestamp_segments

            parsed = parse_timestamp_segments(
                toks, self._model_cfg, time_offset=start, window_seconds=covered
            )
            out = []
            for seg_start, seg_end, ids in parsed:
                text = self._decoder.decode(ids).strip()
                if text:
                    end = min(seg_end, start + covered)
                    out.append((seg_start, max(end - seg_start, 0.0), text))
            if out:
                return out
        text = self._decoder.decode(toks).strip()
        return [(start, covered, text)] if text else []

    def transcribe_wav(self, wav_path: str):
        """wav file -> List[TranscriptSegment] (the ladder contract).

        With ``MODEL_ASR_WORD_ALIGN`` on (and the detokenizer present), each
        segment also carries word-level spans from the cross-attention DTW
        aligner."""

        from .youtube import TranscriptSegment

        audio = read_wav_mono16k(wav_path)
        if self.cfg.models.asr_word_align and self._resolve_decoder():
            return [
                TranscriptSegment(
                    text=seg["text"], start=seg["start"],
                    duration=seg["duration"],
                    words=tuple(
                        (w.word, round(w.start, 3), round(w.end, 3))
                        for w in seg["words"]),
                )
                for seg in self.transcribe_array_aligned(audio)
            ]
        return [
            TranscriptSegment(text=text, start=start, duration=dur)
            for start, dur, text in self.transcribe_array(audio)
        ]

    def _resolve_decoder(self) -> bool:
        """True when the vocab.json detokenizer loaded (alignment needs
        per-token vocab strings; without it fall back to plain segments)."""

        self._ensure()
        return self._decoder is not None

    # -- word-level alignment (the WhisperX-align equivalent) ----------------

    def _aligned_transcribe_fn(self, prefix: tuple) -> Callable:
        """One callable per decode prefix for the aligned path, batch 1:
        mel -> encode ONCE -> KV-cached greedy decode -> teacher-forced
        cross-attention capture over the same encoder states -> the
        (s_tokens, frames) alignment matrix, reduced on the device."""

        key = ("aligned", prefix)
        with self._lock:
            if key not in self._fns:
                from ..models import align as talign, whisper

                def fn(audio: np.ndarray):
                    with torch.inference_mode():
                        mcfg, dtype = self._model_cfg, self.compute_dtype
                        enc = self._encode(audio)
                        tokens, lengths = whisper.whisper_greedy_decode(
                            self._params, enc, mcfg, forced_prefix=prefix,
                            max_len=self.max_tokens, compute_dtype=dtype)
                        _, cross = talign.decoder_cross_attention(
                            self._params, tokens, enc, mcfg, compute_dtype=dtype)
                        return tokens, lengths, talign.alignment_matrix_device(cross[:, 0])

                self._fns[key] = fn
            return self._fns[key]

    def transcribe_array_aligned(self, audio: np.ndarray) -> List[Dict]:
        """Waveform -> segments WITH word-level timestamps.

        Instead of a second wav2vec model, a teacher-forced decoder pass
        captures cross-attention on the device and a host DTW recovers word
        spans (:mod:`mmrag_tpu_torch.models.align`). Returns
        ``[{"start", "duration", "text", "words": [WordSpan, ...]}, ...]``.
        """

        from ..models import align as talign
        from ..models.whisper import SAMPLE_RATE

        self._ensure()
        if self._decoder is None:
            raise FileNotFoundError(
                "word alignment needs the vocab.json detokenizer")
        mcfg = self._model_cfg
        chunk_samples = self._window_samples()
        audio = np.asarray(audio, np.float32)
        total = len(audio)
        if total == 0:
            return []
        n_chunks = max(1, -(-total // chunk_samples))
        prefix = self._resolve_prefix(self._first_window(audio))

        out: List[Dict] = []
        fn = self._aligned_transcribe_fn(prefix)
        for idx in range(n_chunks):
            window = np.zeros(chunk_samples, np.float32)
            part = audio[idx * chunk_samples: (idx + 1) * chunk_samples]
            window[: len(part)] = part
            start = idx * chunk_samples / SAMPLE_RATE
            covered = min(total - idx * chunk_samples, chunk_samples) / SAMPLE_RATE
            tokens, lengths, matrix = fn(window[None])
            host = torch.cat([tokens, lengths[:, None]], dim=1).cpu().numpy()
            n_tok = int(host[0, -1])
            toks = host[0, :n_tok]
            segs = self._window_segments(toks, start, covered)
            if not segs:
                continue
            words = talign.words_from_matrix(
                matrix[:n_tok].cpu().numpy(), toks, self._decoder, mcfg, time_offset=start)
            # the aligner sees all encoder frames including the zero-padded
            # tail, so a word span can land past the window's covered audio:
            # clamp to [start, start + covered] as _window_segments clamps
            # segment ends. A word whose whole span fell into the padding
            # keeps a minimal sliver at the window end (it is real decoded
            # text; only its alignment overflowed).
            hi = start + covered
            clamped = []
            for w in words:
                lo_w = min(max(w.start, start), hi)
                hi_w = min(max(w.end, start), hi)
                if hi_w <= lo_w:
                    lo_w = max(start, hi - 0.02)
                    hi_w = hi
                clamped.append(dataclasses.replace(w, start=lo_w, end=hi_w))
            # assign each word to the segment containing its midpoint
            # (fallback: the nearest segment start)
            segments = [
                {"start": s, "duration": d, "text": t, "words": []}
                for s, d, t in segs
            ]
            for w in clamped:
                mid = (w.start + w.end) / 2.0
                target = next(
                    (seg for seg in segments
                     if seg["start"] <= mid < seg["start"] + seg["duration"]),
                    min(segments, key=lambda seg: abs(seg["start"] - w.start)),
                )
                target["words"].append(w)
            out.extend(segments)
        return out

    def transcribe_wav_aligned(self, wav_path: str) -> List[Dict]:
        """wav file -> word-aligned segments (see
        :meth:`transcribe_array_aligned`)."""

        return self.transcribe_array_aligned(read_wav_mono16k(wav_path))


_runtime: Optional[WhisperRuntime] = None
_runtime_lock = threading.Lock()


def _same_settings(a: Settings, b: Settings) -> bool:
    ma, mb = a.models, b.models
    return (ma.asr == mb.asr and a.paths.weights_dir == b.paths.weights_dir
            and ma.asr_language == mb.asr_language
            and ma.asr_timestamps == mb.asr_timestamps
            and ma.asr_word_align == mb.asr_word_align
            and a.tpu.compute_dtype == b.tpu.compute_dtype)


def get_asr_runtime(cfg: Optional[Settings] = None,
                    device: DeviceLike = None) -> Optional[WhisperRuntime]:
    """Singleton WhisperRuntime, or None when no converted weights exist
    (callers then try the ladder's other rungs). A call with *different*
    settings (weights dir / model id / language / timestamps / word align /
    compute dtype) or another device type rebuilds the singleton rather than
    serving the old configuration. With weights present, a missing card
    raises (``device="cpu"`` asks for the CPU)."""

    global _runtime
    with _runtime_lock:
        wanted = cfg or _default_settings
        dev_type = torch.device("cuda" if device is None else device).type
        if _runtime is not None and (
            not _same_settings(_runtime.cfg, wanted) or _runtime.device.type != dev_type
        ):
            _runtime = None
        if _runtime is None:
            if not weights_available(wanted):
                return None
            _runtime = WhisperRuntime(wanted, device=device)
        return _runtime


def reset_asr_runtime() -> None:
    global _runtime
    with _runtime_lock:
        _runtime = None
