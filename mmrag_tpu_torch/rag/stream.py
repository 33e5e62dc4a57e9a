"""Streaming decode -> embed -> index pipeline.

Port of ``mmrag_tpu/rag/stream.py``.

The reference ingests video frames in three serialized stages: ffmpeg writes
JPEGs, PIL re-reads them, CLIP embeds batch-by-batch with a blocking
``.cpu().numpy()`` each time (``app/ingest/frames.py:58-95``,
``app/ml/embeddings.py:73-91``). Here the stages overlap:

  * decode produces uint8 RGB arrays directly (no JPEG round-trip on the
    embed path; files are still written for the media server);
  * the card's forward for bucket N is launched asynchronously (CUDA
    launches return at once) and only synchronized AFTER bucket N+1's
    host-side crop/pad work is queued — host prep and the card's compute
    run concurrently;
  * index upserts for bucket N happen while bucket N+1 is in flight.

One public entry point per modality keeps the reference's node/metadata
contract (``index_image_nodes`` result shape).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..storage.records import Chunk, VectorRow
from .engine import RagEngine, get_engine

logger = logging.getLogger(__name__)


def stream_index_images(
    user_id: str,
    items: Sequence[Tuple[Dict, np.ndarray]],  # (node-meta, uint8 RGB array)
    engine: Optional[RagEngine] = None,
) -> int:
    """Embed + index image arrays with device/host overlap.

    ``items`` pairs each node dict (same schema as ``index_image_nodes``:
    ``id``, ``metadata`` with ``document_id``/``media_path``/``ts``) with its
    decoded pixel array. Returns rows written. Buckets follow the runtime's
    static batch shapes; while bucket N computes on device, bucket N+1's
    host prep runs, and bucket N-1's rows are upserted.
    """

    engine = engine or get_engine()
    if not items:
        return 0
    metas: List[Dict] = [node for node, _ in items]
    arrays: List[np.ndarray] = [arr for _, arr in items]

    written = 0
    pending: Optional[Tuple[int, object, int]] = None  # (meta_start, dev, n)
    meta_cursor = 0

    def flush(meta_start: int, dev, n: int) -> int:
        emb = dev[:n].float().cpu().numpy()  # sync point for bucket N
        rows, chunks = [], []
        doc_ids = set()
        for offset in range(n):
            node = metas[meta_start + offset]
            meta = dict(node.get("metadata") or {})
            doc_id = meta.get("document_id") or node.get("document_id") or "unknown"
            doc_ids.add(doc_id)
            chunk_id = node.get("id") or f"{doc_id}-img{meta_start + offset}"
            rows.append(
                VectorRow(
                    chunk_id=chunk_id,
                    user_id=user_id,
                    document_id=doc_id,
                    modality="image",
                    embedding=emb[offset],
                    meta=meta,
                )
            )
            chunks.append(
                Chunk(
                    chunk_id=chunk_id,
                    document_id=doc_id,
                    user_id=user_id,
                    modality="image",
                    text="",
                    media_path=meta.get("media_path") or meta.get("image_path") or "",
                    page=meta.get("page"),
                    ts_start=meta.get("ts_start"),
                    ts_end=meta.get("ts_end"),
                    meta=meta,
                )
            )
        # catalog first (FK target + the validating step), vectors second —
        # a chunk-side failure must not leave orphaned vector rows that
        # hydrate to nothing and silently eat top-k slots
        for doc_id in doc_ids:
            engine.metadata.ensure_document(doc_id, user_id)
        engine.metadata.upsert_chunks(chunks)
        engine.image_index.upsert(rows)
        return len(rows)

    # embed_images_async yields per-bucket device tensors without readback;
    # pulling the NEXT bucket queues its host prep + dispatch before we
    # synchronize on the previous one.
    for dev, n in engine.runtime.embed_images_async(arrays):
        if pending is not None:
            written += flush(*pending)
        pending = (meta_cursor, dev, n)
        meta_cursor += n
    if pending is not None:
        written += flush(*pending)

    if written:
        engine.versions.bump(user_id)
    logger.info("stream-indexed %d image rows for %s", written, user_id)
    return written


def stream_index_video_frames(
    user_id: str,
    document_id: str,
    frames: Iterable,  # ExtractedFrame list
    arrays: Sequence[np.ndarray],
    engine: Optional[RagEngine] = None,
) -> int:
    """Adapter: ``extract_scene_frames(..., return_arrays=True)`` output ->
    streaming embed+index, preserving the reference's frame-node metadata
    (``app/tasks.py:150-165``)."""

    items = []
    for i, (frame, arr) in enumerate(zip(frames, arrays)):
        node = {
            "id": f"{document_id}-frame-{i:04d}",
            "metadata": {
                "document_id": document_id,
                "media_path": frame.path,
                "ts_start": frame.ts,
                "ts_end": frame.ts,
                "modality": "image",
            },
        }
        items.append((node, arr))
    return stream_index_images(user_id, items, engine)
