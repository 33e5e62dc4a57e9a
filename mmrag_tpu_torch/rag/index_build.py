"""Index builders: node dicts -> re-split -> embed -> vector rows -> slabs.

Contract mirrors the reference (``app/ml/index_build.py``):

  * ``index_text_nodes(user_id, nodes, engine)`` — re-splits each node's text
    with the sentence splitter (512/64, ``index_build.py:14,64``), embeds
    *metadata-inclusive* text (``:65-69``), upserts rows, bumps the per-user
    index version (``:33-43``), and records sub-chunks in the metadata
    catalog.
  * ``index_image_nodes(user_id, nodes, engine)`` — CLIP-embeds image files
    (``:106-155``).
  * ``get_index_version(user_id)`` — the cache-invalidation version read.

Node shape (same as reference ingest emits): ``{"id": str, "text": str,
"metadata": dict}`` for text; ``{"id": str, "image_path": str,
"metadata": dict}`` for images. Returns the number of vector rows written.

Unlike the reference, embedding happens in bucketed device batches (not
bs=32 loops), and the version bump is atomic cross-process.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..ingest.chunk import sentence_split
from ..storage.records import Chunk, VectorRow
from ..utils.profiling import stage
from .engine import RagEngine, get_engine


def _metadata_text(text: str, metadata: Dict) -> str:
    """Prefix embed-relevant metadata, as the reference embeds
    metadata-inclusive node text (``index_build.py:65-69``)."""

    parts = []
    title = metadata.get("title") or metadata.get("source_title")
    if title:
        parts.append(str(title))
    page = metadata.get("page")
    if page is not None:
        parts.append(f"page {page}")
    parts.append(text)
    return "\n".join(parts)


def index_text_nodes(
    user_id: str,
    nodes: Sequence[Dict],
    engine: Optional[RagEngine] = None,
) -> int:
    engine = engine or get_engine()
    with stage("ingest.text") as span:  # items: the chunks, once split
        cfg = engine.cfg.chunks
        rows: List[VectorRow] = []
        chunks: List[Chunk] = []
        texts: List[str] = []
        pending: List[Dict] = []

        with stage("ingest.split", items=len(nodes)):
            for node in nodes:
                text = (node.get("text") or "").strip()
                if not text:
                    continue
                meta = dict(node.get("metadata") or {})
                doc_id = meta.get("document_id") or node.get("document_id") or "unknown"
                pieces = sentence_split(text, cfg.split_tokens, cfg.split_overlap_tokens) or [text]
                for j, piece in enumerate(pieces):
                    # len(pending) (not the result list, which is still empty
                    # here): id-less nodes must not collide on one chunk_id
                    chunk_id = node.get("id") or f"{doc_id}-t{len(pending)}"
                    if len(pieces) > 1:
                        chunk_id = f"{chunk_id}#{j}"
                    texts.append(_metadata_text(piece, meta))
                    pending.append(
                        {"chunk_id": chunk_id, "doc_id": doc_id, "meta": meta, "text": piece}
                    )

        span.items = len(pending)
        if not pending:
            return 0
        embeddings = engine.runtime.embed_text_batch(texts)
        for info, emb in zip(pending, embeddings):
            meta = info["meta"]
            rows.append(
                VectorRow(
                    chunk_id=info["chunk_id"],
                    user_id=user_id,
                    document_id=info["doc_id"],
                    modality="text",
                    embedding=emb,
                    meta=meta,
                )
            )
            chunks.append(
                Chunk(
                    chunk_id=info["chunk_id"],
                    document_id=info["doc_id"],
                    user_id=user_id,
                    modality="text",
                    text=info["text"],
                    page=meta.get("page"),
                    ts_start=meta.get("ts_start"),
                    ts_end=meta.get("ts_end"),
                    meta=meta,
                )
            )
        with stage("ingest.upsert", items=len(rows)):
            written = engine.text_index.upsert(rows)
        with stage("ingest.catalogue", items=len(chunks)):
            for doc_id in {c.document_id for c in chunks}:
                engine.metadata.ensure_document(doc_id, user_id)
            engine.metadata.upsert_chunks(chunks)
        engine.versions.bump(user_id)
        return written


def index_image_nodes(
    user_id: str,
    nodes: Sequence[Dict],
    engine: Optional[RagEngine] = None,
) -> int:
    engine = engine or get_engine()
    pending = []
    paths = []
    for node in nodes:
        path = node.get("image_path") or node.get("media_path")
        if not path:
            continue
        meta = dict(node.get("metadata") or {})
        doc_id = meta.get("document_id") or node.get("document_id") or "unknown"
        chunk_id = node.get("id") or f"{doc_id}-img{len(pending)}"
        pending.append({"chunk_id": chunk_id, "doc_id": doc_id, "meta": meta, "path": path})
        paths.append(path)
    if not pending:
        return 0
    embeddings = engine.runtime.embed_image_files(paths)
    rows, chunks = [], []
    for info, emb in zip(pending, embeddings):
        meta = info["meta"]
        rows.append(
            VectorRow(
                chunk_id=info["chunk_id"],
                user_id=user_id,
                document_id=info["doc_id"],
                modality="image",
                embedding=emb,
                meta=meta,
            )
        )
        chunks.append(
            Chunk(
                chunk_id=info["chunk_id"],
                document_id=info["doc_id"],
                user_id=user_id,
                modality="image",
                media_path=info["path"],
                page=meta.get("page"),
                ts_start=meta.get("ts_start"),
                ts_end=meta.get("ts_end"),
                meta=meta,
            )
        )
    written = engine.image_index.upsert(rows)
    for doc_id in {c.document_id for c in chunks}:
        engine.metadata.ensure_document(doc_id, user_id)
    engine.metadata.upsert_chunks(chunks)
    engine.versions.bump(user_id)
    return written


def index_image_rows(
    user_id: str,
    rows: Sequence[VectorRow],
    chunks: Sequence[Chunk],
    engine: Optional[RagEngine] = None,
) -> int:
    """Pre-embedded image rows (streaming frames pipeline fast path)."""

    engine = engine or get_engine()
    if not rows:
        return 0
    written = engine.image_index.upsert(list(rows))
    for doc_id in {c.document_id for c in chunks}:
        engine.metadata.ensure_document(doc_id, user_id)
    engine.metadata.upsert_chunks(list(chunks))
    engine.versions.bump(user_id)
    return written


def get_index_version(user_id: str, engine: Optional[RagEngine] = None) -> int:
    engine = engine or get_engine()
    return engine.versions.get(user_id)
