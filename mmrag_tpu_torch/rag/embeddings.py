"""Public embedding API — reference-compatible signatures + the query
embed-cache layer.

Port of ``mmrag_tpu/rag/embeddings.py``, mirroring reference
``app/ml/embeddings.py:52-105``: ``embed_text_batch(texts) -> (n, 384)``,
``embed_images_batch(paths) -> (n, 512)``, ``embed_query_for_images(query)
-> (512,)`` — all L2-normalized f32 numpy. ``batch_size`` kwargs are
accepted for drop-in compatibility but superseded by the static batch
buckets.

:func:`get_query_embeddings` is the serving-side query embedding policy (the
reference's ``_get_embeddings``, ``app/ml/retrieve.py:120-129``): probe the
TTL embed cache, else produce both query towers (MiniLM 384-d + CLIP text
512-d), through the engine's cross-request
:class:`~mmrag_tpu_torch.serving.batcher.QueryEmbedBatcher` when it has one,
so concurrent requests share one padded dual-tower forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .. import cache
from ..models.runtime import get_runtime


def embed_text_batch(texts: Sequence[str], batch_size: Optional[int] = None) -> np.ndarray:
    return get_runtime().embed_text_batch(texts)


def embed_images_batch(paths: Sequence[str], batch_size: Optional[int] = None) -> np.ndarray:
    return get_runtime().embed_image_files(paths)


def embed_image_arrays(images: Sequence[np.ndarray]) -> np.ndarray:
    """Array-input variant (decoded frames)."""

    return get_runtime().embed_images_batch(images)


def embed_query_for_images(query: str) -> np.ndarray:
    return get_runtime().embed_query_for_images(query)


def get_query_embeddings(query: str, engine=None) -> Dict[str, np.ndarray]:
    """Dual query embedding with TTL cache + cross-request coalescing
    (reference ``_get_embeddings``, ``retrieve.py:120-129``). Returns
    ``{"text": (384,), "image": (512,)}``; cache keys are normalized
    (lowercase, collapsed whitespace). Misses go through the engine's
    :class:`QueryEmbedBatcher` when enabled, else two direct bucketed
    forwards."""

    cached = cache.get_query_embeddings(query)
    if cached is not None:
        return cached
    if engine is None:
        from .engine import get_engine

        engine = get_engine()
    batcher = engine.query_batcher
    if batcher is not None:
        embeds = batcher.embed(query)
    else:
        embeds = {
            "text": engine.runtime.embed_text_batch([query])[0],
            "image": engine.runtime.embed_query_for_images(query),
        }
    cache.set_query_embeddings(query, embeds)
    return embeds
