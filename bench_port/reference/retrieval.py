"""Plain retrieval: exact masked top-k, rerank resort and z-score fusion.

The published behaviour of the reference retriever
(``app/ml/retrieve.py``): per-modality cosine top-k over the rows of the
asking tenant (and of one document where the request names one), the
cross-encoder on the first ``rerank_topk`` text hits, the text list resorted
by ``rerank_score or score``, then each list's scores z-normalised (a list
of fewer than two, or of no spread, gives zeros); a text hit's combined
score is the mean of its cosine z and, by list position, the rerank z; an
image hit's is its cosine z; the merged list sorted by combined score and
cut to ``final_n``. Also the text an ingest embeds: the title and page
lines, then the chunk (``app/ml/index_build.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def metadata_text(text: str, meta: Dict) -> str:
    parts = []
    title = meta.get("title") or meta.get("source_title")
    if title:
        parts.append(str(title))
    if meta.get("page") is not None:
        parts.append(f"page {meta['page']}")
    parts.append(text)
    return "\n".join(parts)


def masked_scores(query: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Cosine scores of unit ``rows`` (n, d) against one unit query (d,),
    ``-inf`` where ``keep`` is false."""

    scores = rows @ query
    return torch.where(keep, scores, torch.full_like(scores, float("-inf")))


def z_scores(values: Sequence[float]) -> np.ndarray:
    arr = np.asarray(values, dtype=np.float64)
    if arr.size < 2 or arr.std() < 1e-12:
        return np.zeros_like(arr)
    return (arr - arr.mean()) / arr.std()


def resort(hits: List[Dict]) -> List[Dict]:
    """The text list resorted by ``rerank_score or score``, stable."""

    return sorted(hits, key=lambda h: h["rerank_score"] if h.get("rerank_score") is not None
                  else h["score"], reverse=True)


def fuse(text_hits: List[Dict], image_hits: List[Dict], final_n: int) -> List[Dict]:
    """Hits are dicts with ``score`` and, for reranked text, ``rerank_score``;
    returns copies with ``combined_score``, best first."""

    cos_z = z_scores([h["score"] for h in text_hits])
    rr = [h["rerank_score"] for h in text_hits if h.get("rerank_score") is not None]
    rr_z = z_scores(rr) if rr else np.zeros(0)
    img_z = z_scores([h["score"] for h in image_hits])
    out = []
    for i, (h, cz) in enumerate(zip(text_hits, cos_z)):
        parts = [cz] + ([float(rr_z[i])] if i < len(rr_z) else [])
        out.append({**h, "combined_score": float(np.mean(parts))})
    for h, cz in zip(image_hits, img_z):
        out.append({**h, "combined_score": float(cz)})
    out.sort(key=lambda h: h["combined_score"], reverse=True)
    return out[: max(final_n, 0)]
