"""Shared Gemini client construction (grounded answers + study notes).

One definition of the api-key gate, import gate, and model construction for
:mod:`mmrag_tpu_torch.rag.generate` and :mod:`mmrag_tpu_torch.utils.note_builder`
(one copy instead of two near-identical blocks). Returns ``None`` whenever
Gemini is unavailable — callers own their offline fallbacks (abstention
snippets / heuristic notes), the reference's degrade ladder
(``app/utils/note_builder.py:73-82``).
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


def get_model(cfg) -> Optional[object]:
    """Configured ``genai.GenerativeModel`` or None (no key / no sdk)."""

    if not cfg.gemini.api_key:
        return None
    try:
        import google.generativeai as genai
    except ImportError:
        logger.warning("google-generativeai not installed; offline fallback")
        return None
    try:
        genai.configure(api_key=cfg.gemini.api_key)
        return genai.GenerativeModel(cfg.gemini.model)
    except Exception:
        logger.exception("Gemini model construction failed")
        return None
