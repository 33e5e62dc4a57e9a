"""YouTube ingestion: id resolution, transcript-first ladder, download/ASR.

Mirrors the reference ladder (``app/ingest/youtube.py``):

  1. resolve the 11-char video id from any URL form (``youtube.py:22,36-43``);
  2. try the transcript API (``:86-119``);
  3. else download (yt-dlp with retry/linear backoff, ``:46-83``), extract
     16 kHz mono audio (``:122-147``), and transcribe (``:150-209``): the
     port's Whisper (:mod:`mmrag_tpu_torch.ingest.asr`) when converted
     weights exist, else WhisperX, else Whisper (:func:`transcribe_audio`);
  4. surface per-stage timeout guards and clean errors.

Every network/binary dependency (youtube-transcript-api, yt-dlp, ffmpeg)
is import-gated: absent deps raise :class:`YouTubeIngestError` with
an actionable message instead of crashing at import, and each stage is
injectable for tests — the reference's monkeypatch seam, kept deliberately.
This module is host-side control flow only; the dense work (frames, CLIP)
lives in :mod:`mmrag_tpu_torch.ingest.frames`.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..settings import Settings, settings as _default_settings

logger = logging.getLogger(__name__)

_VIDEO_ID_RE = re.compile(
    r"(?:v=|/v/|youtu\.be/|/embed/|/shorts/|/live/)([A-Za-z0-9_-]{11})"
)
_BARE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{11}$")


class YouTubeIngestError(RuntimeError):
    pass


@dataclass(frozen=True)
class TranscriptSegment:
    text: str
    start: float
    duration: float
    # optional word-level spans ((word, start_s, end_s), ...) — populated
    # when MODEL_ASR_WORD_ALIGN is on and the port's Whisper rung ran (the
    # reference's WhisperX-align capability, models/align.py); None on the
    # caption-API rung and by default
    words: Optional[tuple] = None

    @property
    def end(self) -> float:
        return self.start + self.duration


def resolve_video_id(url_or_id: str) -> str:
    """Extract the 11-char video id from any common URL shape or a bare id."""

    candidate = url_or_id.strip()
    if _BARE_ID_RE.match(candidate):
        return candidate
    m = _VIDEO_ID_RE.search(candidate)
    if m:
        return m.group(1)
    raise YouTubeIngestError(f"cannot extract a video id from {url_or_id!r}")


def fetch_video_info(url: str, cfg: Optional[Settings] = None) -> Dict:
    """yt-dlp metadata fetch without download (reference ``tasks.py:36-42``)."""

    cfg = cfg or _default_settings
    try:
        import yt_dlp  # type: ignore
    except ImportError as exc:
        raise YouTubeIngestError(
            "yt-dlp is not installed; cannot fetch video metadata"
        ) from exc
    opts = {"quiet": True, "skip_download": True, "socket_timeout": cfg.youtube.timeout_sec}
    with yt_dlp.YoutubeDL(opts) as ydl:
        info = ydl.extract_info(url, download=False)
    duration_min = (info.get("duration") or 0) / 60.0
    if duration_min > cfg.youtube.max_duration_min:
        raise YouTubeIngestError(
            f"video is {duration_min:.0f} min, over the "
            f"{cfg.youtube.max_duration_min} min limit"
        )
    return {
        "video_id": info.get("id"),
        "title": info.get("title", ""),
        "duration": info.get("duration"),
        "uploader": info.get("uploader", ""),
    }


def get_transcript(
    video_id: str, languages: Optional[List[str]] = None
) -> List[TranscriptSegment]:
    """Transcript API fetch with language preference (reference ``:86-119``)."""

    try:
        from youtube_transcript_api import YouTubeTranscriptApi  # type: ignore
    except ImportError as exc:
        raise YouTubeIngestError(
            "youtube-transcript-api is not installed; transcript path unavailable"
        ) from exc
    langs = languages or ["en", "en-US", "en-GB"]
    if hasattr(YouTubeTranscriptApi, "get_transcript"):
        raw = YouTubeTranscriptApi.get_transcript(video_id, languages=langs)
    else:  # v1.0+ removed the static API in favor of instance .fetch()
        raw = [
            {"text": sn.text, "start": sn.start, "duration": sn.duration}
            for sn in YouTubeTranscriptApi().fetch(video_id, languages=langs)
        ]
    return [
        TranscriptSegment(
            text=seg.get("text", ""), start=float(seg.get("start", 0.0)),
            duration=float(seg.get("duration", 0.0)),
        )
        for seg in raw
        if seg.get("text", "").strip()
    ]


def download_video(
    url: str, out_dir: str, cfg: Optional[Settings] = None
) -> str:
    """Resilient yt-dlp download with linear-backoff retries
    (reference ``:46-83``). Returns the downloaded file path."""

    cfg = cfg or _default_settings
    try:
        import yt_dlp  # type: ignore
    except ImportError as exc:
        raise YouTubeIngestError("yt-dlp is not installed; cannot download") from exc
    os.makedirs(out_dir, exist_ok=True)
    template = os.path.join(out_dir, "%(id)s.%(ext)s")
    opts = {
        "quiet": True,
        "format": cfg.youtube.download_format,
        "outtmpl": template,
        # yt-dlp's internal retries AND the outer backoff loop both get
        # cfg.retries — deliberately mirroring the reference's double-retry
        # structure (app/ingest/youtube.py:69-70 inside its own outer loop)
        "retries": cfg.youtube.retries,
        "socket_timeout": cfg.youtube.timeout_sec,
    }
    last_exc: Optional[Exception] = None
    for attempt in range(cfg.youtube.retries + 1):
        try:
            with yt_dlp.YoutubeDL(opts) as ydl:
                info = ydl.extract_info(url, download=True)
            # prepare_filename ignores the merge step (video+audio streams
            # can merge into .mkv); yt-dlp records the real path here
            reqs = (info or {}).get("requested_downloads") or []
            if reqs and reqs[0].get("filepath"):
                return reqs[0]["filepath"]
            return ydl.prepare_filename(info)
        except Exception as exc:  # yt-dlp raises many error types
            last_exc = exc
            if attempt < cfg.youtube.retries:  # no pointless terminal sleep
                wait = (attempt + 1) * 2.0
                logger.warning("download attempt %d failed (%s); retrying in %.0fs",
                               attempt + 1, exc, wait)
                time.sleep(wait)
    raise YouTubeIngestError(f"download failed after retries: {last_exc}")


def extract_audio(
    video_path: str, cfg: Optional[Settings] = None
) -> str:
    """ffmpeg 16 kHz mono wav extraction (reference ``:122-147``)."""

    cfg = cfg or _default_settings
    import shutil

    if shutil.which("ffmpeg") is None:
        raise YouTubeIngestError("ffmpeg binary not available; cannot extract audio")
    wav_path = os.path.splitext(video_path)[0] + ".wav"
    cmd = [
        "ffmpeg", "-hide_banner", "-loglevel", "error", "-y", "-i", video_path,
        "-ac", "1", "-ar", "16000", wav_path,
    ]
    try:
        subprocess.run(cmd, check=True, timeout=cfg.youtube.timeout_sec,
                       capture_output=True)
    except (subprocess.SubprocessError, OSError) as exc:
        raise YouTubeIngestError(f"audio extraction failed: {exc}") from exc
    return wav_path


def transcribe_audio(wav_path: str, cfg: Optional[Settings] = None,
                     device=None) -> List[TranscriptSegment]:
    """ASR ladder: the port's Whisper -> WhisperX -> Whisper (reference
    ``:150-209`` has only the last two). The port's rung runs when converted
    weights and ``vocab.json`` exist (:func:`mmrag_tpu_torch.ingest.asr.get_asr_runtime`,
    on ``device``: the card unless ``"cpu"`` is asked for); the other two
    stay import-gated like the reference's.

    One deliberate difference from the JAX package, which catches any error
    of its own rung and moves on: here an error that the port's runtime
    raises while it is available propagates, as :class:`YouTubeIngestError`
    with its cause. The other rungs are tried only when there are no
    weights, so a failure on the card never turns quietly into a CPU
    ``whisperx`` run."""

    cfg = cfg or _default_settings
    from .asr import get_asr_runtime

    try:
        runtime = get_asr_runtime(cfg, device)
        if runtime is not None:
            return runtime.transcribe_wav(wav_path)
    except Exception as exc:
        raise YouTubeIngestError(f"Whisper ASR failed on {wav_path}: {exc}") from exc
    # the reference loads whisper "base" on both torch rungs
    # (app/ingest/youtube.py:156,163); follow MODEL_ASR so the ladder and
    # the port's runtime agree on the model size
    size = cfg.models.asr.rsplit("-", 1)[-1] or "base"
    segments = None
    try:
        import whisperx  # type: ignore

        model = whisperx.load_model(size, device="cpu")
        result = model.transcribe(wav_path)
        segments = result.get("segments", [])
    except ImportError:
        pass
    except Exception as exc:
        # whisperx runtime failures (e.g. ctranslate2 rejecting its default
        # float16 compute type on CPU) degrade to the plain-whisper rung
        logger.warning("whisperx failed (%s); trying plain whisper", exc)
    if segments is None:
        try:
            import whisper  # type: ignore
        except ImportError as exc:
            raise YouTubeIngestError(
                "neither whisperx nor whisper is installed; ASR unavailable"
            ) from exc
        model = whisper.load_model(size)
        segments = model.transcribe(wav_path).get("segments", [])
    return [
        TranscriptSegment(
            text=s.get("text", "").strip(),
            start=float(s.get("start", 0.0)),
            duration=float(s.get("end", 0.0)) - float(s.get("start", 0.0)),
        )
        for s in segments
        if s.get("text", "").strip()
    ]


def transcript_or_fallback(
    url: str,
    work_dir: str,
    cfg: Optional[Settings] = None,
    *,
    transcript_fn: Callable[[str], List[TranscriptSegment]] = get_transcript,
    download_fn: Callable[..., str] = download_video,
    audio_fn: Callable[..., str] = extract_audio,
    asr_fn: Optional[Callable[[str], List[TranscriptSegment]]] = None,
    device=None,
) -> Dict:
    """Transcript-first orchestrator (reference ``:212-241``).

    Returns ``{"video_id", "segments", "source", "video_path"?}`` where
    ``source`` is ``transcript`` or ``asr``. Stage functions are injectable
    (the reference's monkeypatch seam) so tests run without network. The
    default ASR stage is :func:`transcribe_audio` under ``cfg`` on
    ``device`` (the ingest task passes its engine's).
    """

    cfg = cfg or _default_settings
    if asr_fn is None:
        def asr_fn(path: str) -> List[TranscriptSegment]:
            return transcribe_audio(path, cfg, device)
    video_id = resolve_video_id(url)
    if cfg.youtube.prefer_transcript:
        try:
            segments = transcript_fn(video_id)
            if segments:
                return {"video_id": video_id, "segments": segments,
                        "source": "transcript"}
        except Exception as exc:
            # EVERY transcript failure — including a missing
            # youtube-transcript-api package — falls through to the
            # download+ASR rung; only the ASR rung's errors are terminal
            logger.warning("transcript fetch failed (%s); falling back to ASR", exc)
    video_path = download_fn(url, work_dir, cfg)
    wav_path = audio_fn(video_path, cfg)
    segments = asr_fn(wav_path)
    if not segments:
        raise YouTubeIngestError(f"ASR produced no segments for {video_id}")
    return {"video_id": video_id, "segments": segments, "source": "asr",
            "video_path": video_path}


def segments_to_nodes(
    document_id: str, segments: List[TranscriptSegment]
) -> List[Dict]:
    """Per-segment text nodes with timestamp metadata (reference
    ``app/tasks.py:87-106``)."""

    nodes = []
    for i, seg in enumerate(segments):
        if not seg.text.strip():
            continue
        meta = {
            "document_id": document_id,
            "ts_start": seg.start,
            "ts_end": seg.end,
        }
        if seg.words:
            # word-level spans ride the node metadata so retrieval hits
            # can cite sub-segment positions (MODEL_ASR_WORD_ALIGN)
            meta["words"] = [list(w) for w in seg.words]
        nodes.append(
            {
                "id": f"{document_id}-s{i}",
                "text": seg.text.strip(),
                "metadata": meta,
            }
        )
    return nodes
