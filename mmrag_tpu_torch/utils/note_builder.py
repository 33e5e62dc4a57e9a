"""Study notes + quiz builder for ingested videos.

Mirrors the reference (``app/utils/note_builder.py``):
transcript context truncated to ``NOTE_CONTEXT_CHARS`` (``:10-22``), a
Gemini JSON-notes prompt with schema validation and *silent* fallback
(``:64-82``), and a heuristic fallback building summary / key points /
timeline / quiz from the first segments (``:25-51``) — the always-available
offline path.

Payload schema (stored by :class:`~mmrag_tpu_torch.storage.notes.NoteStore`):
``{"summary": str, "key_points": [str], "timeline": [{"ts", "label"}],
"quiz": [{"question", "options", "answer"}]}``.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Sequence

from ..ingest.youtube import TranscriptSegment
from ..settings import Settings, settings as _default_settings

logger = logging.getLogger(__name__)

REQUIRED_KEYS = ("summary", "key_points", "timeline", "quiz")


def truncate_context(
    segments: Sequence[TranscriptSegment], max_chars: int
) -> str:
    parts: List[str] = []
    used = 0
    for seg in segments:
        text = seg.text.strip()
        if not text:
            continue
        if used + len(text) + 1 > max_chars:
            if not parts:
                # a single giant segment: truncate like the reference's
                # char-cap (note_builder.py:10-22) instead of returning an
                # EMPTY context that invites ungrounded generation
                parts.append(text[:max_chars])
            break
        parts.append(text)
        used += len(text) + 1
    return " ".join(parts)


def heuristic_notes(
    title: str,
    segments: Sequence[TranscriptSegment],
    quiz_questions: int,
) -> Dict:
    """Offline notes: lead summary, evenly-spaced timeline, cloze-ish quiz."""

    texts = [s.text.strip() for s in segments if s.text.strip()]
    summary = " ".join(texts[:3])[:600] or f"Notes for {title or 'video'}."
    key_points = [t[:200] for t in texts[:5]]

    timeline = []
    if segments:
        step = max(len(segments) // 6, 1)
        for seg in list(segments)[::step][:6]:
            timeline.append({"ts": round(seg.start, 1), "label": seg.text.strip()[:80]})

    quiz = []
    for i, text in enumerate(texts[: quiz_questions * 2]):
        words = [w for w in text.split() if len(w) > 4]
        answer = max(words, key=len) if words else ""
        distractors = [w for w in words if w != answer][:3]
        if not distractors:  # a one-option quiz gives the answer away
            continue
        question = text.replace(answer, "_____", 1)
        # truncate around the blank, not blindly from the front — the blank
        # must survive into the rendered question
        blank_at = question.find("_____")
        start = max(0, min(blank_at - 60, len(question) - 160))
        question = question[start : start + 160]
        # deterministic per-question rotation: correct answer is not always
        # listed first
        options = [answer, *distractors]
        rot = (i + 1) % len(options)
        options = options[rot:] + options[:rot]
        quiz.append(
            {"question": f"Fill in the blank: {question}",
             "options": options, "answer": answer}
        )
        if len(quiz) >= quiz_questions:
            break
    return {
        "summary": summary,
        "key_points": key_points,
        "timeline": timeline,
        "quiz": quiz,
    }


def _gemini_notes(
    title: str, context: str, quiz_questions: int, cfg: Settings
) -> Optional[Dict]:
    from .gemini import get_model

    model = get_model(cfg)
    if model is None:
        return None
    prompt = (
        "You are a study assistant. From the transcript below produce STRICT "
        "JSON with keys summary (string), key_points (list of strings), "
        "timeline (list of {ts: seconds, label}), quiz (list of "
        f"{{question, options, answer}}, exactly {quiz_questions} items). "
        f"Video title: {title}\n\nTranscript:\n{context}"
    )
    try:
        response = model.generate_content(prompt)
        text = getattr(response, "text", "") or ""
        start, end = text.find("{"), text.rfind("}")
        payload = json.loads(text[start : end + 1])
        if not all(k in payload for k in REQUIRED_KEYS):
            raise ValueError(f"missing keys in {sorted(payload)}")
        return payload
    except Exception:
        logger.exception("Gemini notes failed; using heuristic fallback")
        return None


def build_notes_payload(
    title: str,
    segments: Sequence[TranscriptSegment],
    cfg: Optional[Settings] = None,
) -> Dict:
    """Gemini JSON notes when available, heuristic otherwise (silent
    fallback, reference ``note_builder.py:73-82``)."""

    cfg = cfg or _default_settings
    context = truncate_context(segments, cfg.notes.context_chars)
    payload = _gemini_notes(title, context, cfg.notes.quiz_questions, cfg)
    if payload is None:
        payload = heuristic_notes(title, segments, cfg.notes.quiz_questions)
    payload["title"] = title
    return payload
