"""Grounded answer generation with citations and an abstention gate.

Contract mirrors the reference generator (``app/ml/
generate.py``):

  * citation tokens ``[doc:<id> p:<page>]`` for PDF text, ``[ts:<a>-<b>]``
    for transcript spans (``generate.py:21-30``);
  * a grounded prompt separating text evidence from image paths (``:33-53``);
  * **confidence gate**: if ``max(combined_score) < CONFIDENCE_TAU`` the
    system abstains and returns the top snippets instead of an LLM answer
    (``:56-81``) — fully offline-capable;
  * a Gemini multimodal call with raw image bytes capped at ``final_n``
    (``:83-97``), gated on the SDK + ``GEMINI_API_KEY`` being present
    (``generate.py:13-18``). Absent either, the abstention/snippet path is
    the answer path (reference behaves identically with no key).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from ..settings import Settings, settings as _default_settings

logger = logging.getLogger(__name__)


def citation_token(hit: Dict) -> str:
    meta = hit.get("meta") or {}
    ts_start, ts_end = meta.get("ts_start"), meta.get("ts_end")
    if ts_start is not None and ts_end is not None:
        return f"[ts:{ts_start:.0f}-{ts_end:.0f}]"
    page = meta.get("page")
    doc = hit.get("document_id", "?")
    if page is not None:
        return f"[doc:{doc} p:{page}]"
    return f"[doc:{doc}]"


def build_prompt(query: str, results: Sequence[Dict]) -> str:
    """Grounded prompt: enumerated text evidence with citation tokens, image
    paths listed separately, instructions to cite and refuse unsupported
    claims (reference ``generate.py:33-53``)."""

    text_lines, image_lines = [], []
    for hit in results:
        token = citation_token(hit)
        if hit.get("modality") == "image":
            image_lines.append(f"- {hit.get('media_path', '')} {token}")
        else:
            snippet = (hit.get("text") or "").strip()
            text_lines.append(f"{token} {snippet}")
    parts = [
        "Answer the user's question using ONLY the evidence below.",
        "Cite evidence inline with its bracketed token. If the evidence is "
        "insufficient, say you don't know.",
        "",
        "Text evidence:",
        *(text_lines or ["(none)"]),
        "",
        "Image evidence (attached):",
        *(image_lines or ["(none)"]),
        "",
        f"Question: {query}",
    ]
    return "\n".join(parts)


def _gemini_answer(
    prompt: str, image_paths: List[str], cfg: Settings
) -> Optional[str]:
    from ..utils.gemini import get_model

    model = get_model(cfg)
    if model is None:
        return None
    try:
        content: List = [prompt]
        for path in image_paths:
            with open(path, "rb") as fh:
                data = fh.read()
            mime = "image/png" if data[:8].startswith(b"\x89PNG") else "image/jpeg"
            content.append({"mime_type": mime, "data": data})
        response = model.generate_content(content)
        return getattr(response, "text", None)
    except Exception:
        logger.exception("Gemini call failed; falling back to snippets")
        return None


def generate_response(
    query: str,
    results: Sequence[Dict],
    cfg: Optional[Settings] = None,
) -> Dict:
    """Returns the reference's ``/chat_pro`` payload shape plus extras:
    ``response`` and ``citations`` ``{"text": [...], "images": [...]}`` match
    the reference contract (``generate.py:63-97``); ``answer`` (alias),
    ``citation_tokens``, ``snippets``, and ``abstained`` are additive."""

    cfg = cfg or _default_settings
    results = list(results)
    citation_tokens = [
        {
            "token": citation_token(h),
            "chunk_id": h.get("chunk_id"),
            "document_id": h.get("document_id"),
            "modality": h.get("modality"),
            # combined_score is PRESENT but None on unfused per-modality
            # hits, so a dict-default never fires — coalesce explicitly
            # (the confidence gate below already did)
            "score": (
                h.get("combined_score")
                if h.get("combined_score") is not None
                else h.get("score")
            ),
            "media_path": h.get("media_path") or None,
        }
        for h in results
    ]

    def _meta(h: Dict) -> Dict:
        return {
            **(h.get("meta") or {}),
            "document_id": h.get("document_id"),
            "chunk_id": h.get("chunk_id"),
            "media_path": h.get("media_path") or None,
        }

    citations = {  # reference shape: metadata dicts per modality
        "text": [_meta(h) for h in results if h.get("modality") == "text"],
        "images": [_meta(h) for h in results if h.get("modality") == "image"],
    }
    snippets = [
        {"token": citation_token(h), "text": (h.get("text") or "")[:400]}
        for h in results
        if h.get("modality") == "text"
    ]

    best = max(
        (h.get("combined_score") if h.get("combined_score") is not None else h.get("score", 0.0))
        for h in results
    ) if results else float("-inf")

    def _payload(answer: str, abstained: bool) -> Dict:
        return {
            "response": answer,  # reference key (generate.py:81,97)
            "answer": answer,
            "citations": citations,
            "citation_tokens": citation_tokens,
            "snippets": snippets,
            "abstained": abstained,
        }

    # Confidence gate (reference generate.py:56-81)
    if not results or best < cfg.retrieval.confidence_tau:
        return _payload(
            "I couldn't find confident enough evidence to answer that. "
            "Here are the closest passages I found."
            if results
            else "I couldn't find anything relevant in your indexed documents.",
            abstained=True,
        )

    prompt = build_prompt(query, results)
    image_paths = [
        h["media_path"]
        for h in results[: cfg.retrieval.final_n]
        if h.get("modality") == "image" and h.get("media_path")
    ]
    answer = _gemini_answer(prompt, image_paths, cfg)
    if answer is None:
        # Offline grounded fallback: extractive answer from top evidence.
        lead = next((s for s in snippets if s["text"]), None)
        answer = (
            f"Based on the indexed evidence {lead['token']}: {lead['text']}"
            if lead
            else "Relevant visual evidence found; see citations."
        )
    return _payload(answer, abstained=False)
