"""Ingestion tasks: the YouTube pipeline driven by the job queue.

Mirrors the reference Celery task (``app/tasks.py:49-208``)
stage for stage: 24h already-indexed dedup key (``:45-62,196-197``), metadata
fetch (``:36-42``), transcript-or-fallback, per-segment text nodes with
timestamps (``:87-106``), text indexing, conditional frame extraction
honoring ``lazy_frames`` (``:131-144``), image indexing, notes+quiz build and
persist (``:193-194``), progress via the stage callback (``:52,66,83,147``),
FAILURE on exception (``:206-208``).

The frame->CLIP path streams decoded arrays straight into the encoder
(decode -> embed -> index in one pipeline, no file re-read between stages).
Port of ``mmrag_tpu/serving/tasks.py``: ``frames_fn`` is called with the
engine's device, so scene scores and pHash dedup run where the encoders do.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..ingest import youtube as yt
from ..ingest.frames import FrameExtractionError, extract_scene_frames
from ..rag import index_build
from ..rag.engine import RagEngine, get_engine
from ..storage.kv import KVStore
from ..storage.records import Document
from ..utils.note_builder import build_notes_payload

logger = logging.getLogger(__name__)


def ingest_youtube_task(
    progress: Callable[..., None],
    user_id: str,
    url: str,
    engine: Optional[RagEngine] = None,
    kv: Optional[KVStore] = None,
    info_fn: Optional[Callable] = None,
    ladder_fn: Optional[Callable] = None,
    frames_fn: Optional[Callable] = None,
) -> Dict:
    """Full video pipeline; returns the Celery-result-shaped summary dict."""

    # late-bound so monkeypatching the yt module (the reference's test seam)
    # still takes effect
    info_fn = info_fn or yt.fetch_video_info
    ladder_fn = ladder_fn or yt.transcript_or_fallback
    frames_fn = frames_fn or extract_scene_frames
    engine = engine or get_engine()
    cfg = engine.cfg
    video_id = yt.resolve_video_id(url)
    document_id = video_id

    dedup_key = f"yt:indexed:{user_id}:{video_id}"
    if kv is not None and kv.get(dedup_key):
        return {"status": "already_indexed", "video_id": video_id,
                "text_nodes": 0, "image_nodes": 0}

    progress("metadata")
    try:
        info = info_fn(url, cfg)
    except yt.YouTubeIngestError as exc:
        logger.warning("metadata fetch unavailable (%s); continuing with id only", exc)
        info = {"video_id": video_id, "title": "", "duration": None}
    title = info.get("title") or video_id

    engine.metadata.upsert_document(
        Document(
            document_id=document_id, user_id=user_id, doc_type="youtube",
            title=title, source=url, status="processing",
            meta={"duration": info.get("duration")},
        )
    )

    try:
        return _run_pipeline(
            user_id, url, video_id, document_id, title, engine, cfg, kv,
            dedup_key, progress, ladder_fn, frames_fn,
        )
    except Exception:
        # the job records FAILURE (jobs.py), but the catalog row must not
        # stay "processing" forever
        engine.metadata.set_document_status(document_id, "failed")
        raise


def _run_pipeline(user_id, url, video_id, document_id, title, engine, cfg, kv,
                  dedup_key, progress, ladder_fn, frames_fn):
    progress("transcript")
    work_dir = f"{cfg.paths.ingest_cache_dir}/videos/{user_id}/{video_id}"
    # the ASR rung runs where the encoders do
    ladder = ladder_fn(url, work_dir, cfg, device=engine.device)
    segments: List[yt.TranscriptSegment] = ladder["segments"]

    progress("index_text")
    text_nodes = yt.segments_to_nodes(document_id, segments)
    n_text = index_build.index_text_nodes(user_id, text_nodes, engine)

    n_images = 0
    video_path = ladder.get("video_path")
    if not cfg.youtube.lazy_frames and video_path:
        progress("frames")
        try:
            frames, arrays = frames_fn(
                user_id, document_id, video_path, cfg, return_arrays=True,
                device=engine.device,
            )
        except FrameExtractionError as exc:
            logger.warning("frame extraction failed (%s); continuing without frames", exc)
            frames, arrays = [], []
        if frames:
            progress("index_images")
            # streaming pipeline: decoded arrays -> CLIP -> index with
            # host-prep/device-compute overlap (rag/stream.py)
            from ..rag.stream import stream_index_video_frames

            n_images = stream_index_video_frames(
                user_id, document_id, frames, arrays, engine
            )

    progress("notes")
    notes = build_notes_payload(title, segments, cfg)
    engine.notes.upsert(user_id, video_id, notes, title=title)

    engine.metadata.set_document_status(document_id, "ready")
    engine.persist_indexes()
    if kv is not None:
        kv.setex(dedup_key, cfg.cache.dedup_ttl_sec, "1")

    return {
        "status": "ok",
        "video_id": video_id,
        "title": title,
        "source": ladder["source"],
        "text_nodes": n_text,
        "image_nodes": n_images,
        "notes": {"summary": notes.get("summary", ""),
                  "quiz_count": len(notes.get("quiz", []))},
    }
