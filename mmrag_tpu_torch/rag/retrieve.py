"""Retrieval pipeline: dual query embed -> masked top-k -> rerank -> fusion.

Port of ``mmrag_tpu/rag/retrieve.py``. Contract mirrors the reference
retriever (``app/ml/retrieve.py``): per-modality retrieval with TTL caching
keyed by the per-user index version (``:41-101``), dual query embeddings
(MiniLM + CLIP-text) with an embed cache (``:120-129``), cross-encoder rerank
of the top ``rerank_topk`` text hits followed by a full resort on
``rerank_score or score`` (``:132-155``), z-score fusion to ``final_n``
(``:158-195``), and batched metadata hydration (one SQL query).

The tenant (and optional ``document_id``) predicate is applied *inside* the
device top-k mask, not post-fusion (fixes ``api/routes.py:272-279``). A
rerank failure raises: the JAX package's degrade-to-no-rerank ladder is not
carried over, so a fault in the cross-encoder cannot hide behind unranked
results.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import cache
from ..ops.fusion import fuse_results
from ..storage.records import RetrievedHit
from ..utils.profiling import stage
from .embeddings import get_query_embeddings
from .engine import RagEngine, get_engine


def _hydrate(raw_hits: List[tuple], modality: str, engine: RagEngine) -> List[RetrievedHit]:
    chunk_map = engine.metadata.get_chunks_batch([cid for cid, _ in raw_hits])
    hits: List[RetrievedHit] = []
    for cid, score in raw_hits:
        chunk = chunk_map.get(cid)
        if chunk is None:
            continue  # catalog lost the row; skip like the reference
        hits.append(
            RetrievedHit(
                chunk_id=cid,
                document_id=chunk.document_id,
                user_id=chunk.user_id,
                modality=modality,
                score=score,
                text=chunk.text,
                media_path=chunk.media_path,
                meta={
                    **chunk.meta,
                    "page": chunk.page,
                    "ts_start": chunk.ts_start,
                    "ts_end": chunk.ts_end,
                },
            )
        )
    return hits


def retrieve_text(
    user_id: str, query: str, engine: Optional[RagEngine] = None,
    document_id: Optional[str] = None,
) -> List[RetrievedHit]:
    engine = engine or get_engine()
    qvec = get_query_embeddings(query, engine)["text"]
    raw = engine.text_index.search(
        qvec, user_id, engine.cfg.retrieval.index_topk_text, document_id
    )
    return _hydrate(raw, "text", engine)


def retrieve_images(
    user_id: str, query: str, engine: Optional[RagEngine] = None,
    document_id: Optional[str] = None,
) -> List[RetrievedHit]:
    engine = engine or get_engine()
    qvec = get_query_embeddings(query, engine)["image"]
    raw = engine.image_index.search(
        qvec, user_id, engine.cfg.retrieval.index_topk_image, document_id
    )
    return _hydrate(raw, "image", engine)


def _rerank_text(query: str, hits: List[RetrievedHit], engine: RagEngine) -> List[RetrievedHit]:
    """Score top ``rerank_topk`` (query, text) pairs, then resort the whole
    list by ``rerank_score or score`` (reference ``retrieve.py:132-155``)."""

    cfg = engine.cfg.retrieval
    if not cfg.use_rerank or not hits:
        return hits
    head = hits[: cfg.rerank_topk]
    scores = engine.runtime.rerank_scores(query, [h.text for h in head])
    return _with_rerank_scores(hits, scores, cfg.rerank_topk)


def _with_rerank_scores(hits: List[RetrievedHit], scores, rerank_topk: int) -> List[RetrievedHit]:
    """Attach rerank scores to the head and resort the whole list by
    ``rerank_score or score`` (reference ``retrieve.py:132-155``)."""

    head = hits[:rerank_topk]
    rescored = [
        RetrievedHit(
            chunk_id=h.chunk_id, document_id=h.document_id, user_id=h.user_id,
            modality=h.modality, score=h.score, rerank_score=float(s),
            text=h.text, media_path=h.media_path, meta=h.meta,
        )
        for h, s in zip(head, scores)
    ]
    merged = rescored + hits[rerank_topk:]
    merged.sort(key=lambda h: h.rerank_score if h.rerank_score is not None else h.score,
                reverse=True)
    return merged


def retrieve_batch(
    items: List[Tuple[str, str, Optional[str]]],  # (user_id, query, document_id)
    engine: Optional[RagEngine] = None,
) -> List[Dict[str, List[Dict]]]:
    """Batched full retrieval: N coalesced requests cost one dual query
    embed, one masked top-k per modality (per-query tenant predicates via
    :meth:`VectorIndex.search_batch_multi_async`), and one cross-encoder call
    over every request's rerank pairs. Semantics per item are those of
    :func:`retrieve` (same fusion, same resort, same result shape)."""

    engine = engine or get_engine()
    if not items:
        return []
    cfgr = engine.cfg.retrieval
    users = [u for u, _, _ in items]
    queries = [q for _, q, _ in items]
    docs = [d for _, _, d in items]

    # embed -> search stays on the device: both towers and both masked top-k
    # searches are enqueued back to back, then the collectors read back
    with stage("retrieve.embed"):
        tdev, idev = engine.runtime.embed_queries_device(queries)
    with stage("retrieve.search"):
        t_pending = engine.text_index.search_batch_multi_async(
            tdev, users, cfgr.index_topk_text, docs
        )
        i_pending = engine.image_index.search_batch_multi_async(
            idev, users, cfgr.index_topk_image, docs
        )
        traw = t_pending()
        iraw = i_pending()
    tvecs = tdev.cpu().numpy()
    ivecs = idev.cpu().numpy()
    for q, tv, iv in zip(queries, tvecs, ivecs):
        cache.set_query_embeddings(q, {"text": tv, "image": iv})
    with stage("retrieve.hydrate"):
        text_hits = [_hydrate(r, "text", engine) for r in traw]
        image_hits = [_hydrate(r, "image", engine) for r in iraw]

    if cfgr.use_rerank:
        pair_q: List[str] = []
        pair_p: List[str] = []
        counts = []
        for i, hits in enumerate(text_hits):
            head = hits[: cfgr.rerank_topk]
            pair_q.extend(queries[i] for _ in head)
            pair_p.extend(h.text for h in head)
            counts.append(len(head))
        with stage("retrieve.rerank"):
            scores = (
                engine.runtime.rerank_pairs(pair_q, pair_p)
                if pair_p
                else np.zeros(0, np.float32)
            )
        offset = 0
        for i, n in enumerate(counts):
            if n:
                text_hits[i] = _with_rerank_scores(
                    text_hits[i], scores[offset : offset + n], cfgr.rerank_topk
                )
            offset += n

    payloads = []
    with stage("retrieve.fuse", items=len(items)):
        for i in range(len(items)):
            fused = fuse_results(text_hits[i], image_hits[i], cfgr.final_n)
            payloads.append(
                {
                    "results": [h.to_dict() for h in fused],
                    "text": [h.to_dict() for h in text_hits[i]],
                    "images": [h.to_dict() for h in image_hits[i]],
                    "index_version": engine.versions.get(users[i]),
                }
            )
    return payloads


def retrieve(
    user_id: str, query: str, engine: Optional[RagEngine] = None,
    document_id: Optional[str] = None,
) -> Dict[str, List[Dict]]:
    """Full retrieval: returns ``{"results": fused, "text": ..., "images": ...,
    "index_version": v}`` with hits as dicts (reference result shape)."""

    engine = engine or get_engine()
    version = engine.versions.get(user_id)
    # normalize before appending the doc-filter suffix so whitespace/case
    # variants of the query share one cache entry; the doc id is hex-encoded
    # because the cache layer lowercases keys and video ids are case-sensitive
    doc_tag = document_id.encode().hex() if document_id else "None"
    cache_key_query = f"{cache.normalize_query(query)}\x00doc={doc_tag}"
    cached = cache.get_retrieval_results(user_id, cache_key_query, version)
    if cached is not None:
        return cached

    batcher = engine.retrieval_batcher
    if batcher is not None:
        # whole-request coalescing: one embed/search/rerank set for every
        # concurrent request in the window
        payload = batcher.submit((user_id, query, document_id))
    else:
        text_hits = _rerank_text(
            query, retrieve_text(user_id, query, engine, document_id), engine)
        image_hits = retrieve_images(user_id, query, engine, document_id)
        fused = fuse_results(text_hits, image_hits, engine.cfg.retrieval.final_n)
        payload = {
            "results": [h.to_dict() for h in fused],
            "text": [h.to_dict() for h in text_hits],
            "images": [h.to_dict() for h in image_hits],
            "index_version": version,
        }
    cache.set_retrieval_results(user_id, cache_key_query, version, payload)
    return payload
