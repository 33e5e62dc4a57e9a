"""The arithmetic of the per-layer readers in ``metrics/``.

Each reader takes the traced run's records: ``window`` (the traced
sub-window, on the monotonic clock), ``recorder`` (the harness's spans,
observations and kernel-wrapper calls), ``trace`` (the device operations,
or None where no device was traced), ``config`` and ``reference`` (the
plain tokenizers, for real token counts). A reader that finds nothing to
read returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import flops
from .trace import kernel_name, union_length


def _overlap(s: float, e: float, lo: float, hi: float) -> float:
    return max(0.0, min(e, hi) - max(s, lo))


def stage_median_ms(rec: Dict, name: str) -> Optional[float]:
    lo, hi = rec["window"]
    vals = [d for n, t, d in rec["recorder"].observed if n == name and lo <= t < hi]
    return float(np.median(vals)) * 1e3 if vals else None


def batch_occupancy(rec: Dict) -> Optional[float]:
    lo, hi = rec["window"]
    sizes = [len(b["items"]) for b in rec["recorder"].batches
             if "items" in b and lo <= b["start"] < hi]
    return float(np.mean(sizes)) if sizes else None


def _device(rec: Dict) -> List[Tuple[str, float, float]]:
    return rec["trace"].events if rec["trace"] is not None else []


def idle_pct(rec: Dict) -> Optional[float]:
    if rec["trace"] is None:
        return None
    lo, hi = rec["window"]
    busy = union_length([(s, e) for _, s, e in _device(rec)], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def roofline_pct(rec: Dict, kname: str) -> Optional[float]:
    """Sum of the launches' least times over the sum of their device
    times, in the sub-window. The wrapper calls carry the shapes; where a
    launch at an edge of the window lost its partner, the bound is scaled by
    the device launch count."""

    lo, hi = rec["window"]
    times = [e - s for n, s, e in _device(rec) if kernel_name(n) == kname and lo <= s < hi]
    calls = [info for k, t, info in rec["recorder"].calls if k == kname and lo <= t < hi]
    if not times or not calls:
        return None
    if kname == "K-bmax":
        bounds = [flops.kbmax_bound(*info) for info in calls]
    else:
        bounds = [flops.gemm_bound(*info) for info in calls]
    total = sum(bounds) * len(times) / len(calls)
    return 100.0 * total / sum(times)


def _tokens(rec: Dict):
    ref = rec["reference"]
    return ref.wp, ref.bpe


def chat_step_time(rec: Dict, batch: Dict) -> float:
    """The least time of one coalesced ``retrieve_batch`` at its real
    tokens: both query towers, the two masked searches and the rerank."""

    cfg = rec["config"]
    m_text, m_clip, m_cross = (cfg["models"][r] for r in ("text", "clip", "reranker"))
    wp, bpe = _tokens(rec)
    queries = [q for _, q, _ in batch["items"]]
    q_len = [min(len(wp.ids(q)) + 2, m_text["max_seq_length"]) for q in queries]
    c_len = [min(len(bpe.ids(q)) + 2, m_clip["text_config"]["max_position_embeddings"])
             for q in queries]
    pair_len = []
    for q, payload in zip(queries, batch["payloads"]):
        for h in payload["text"]:
            if h.get("rerank_score") is not None:
                n = len(wp.ids(q)) + len(wp.ids(h["text"])) + 3
                pair_len.append(min(n, m_cross["max_length"]))
    text = flops.bert_step(q_len, m_text)
    cross = flops.bert_step(pair_len, m_cross)
    int8 = cfg["env"].get("TPU_ENCODER_QUANT") == "int8"
    linear = text["linear"] + cross["linear"]
    floating = (text["attention"] + cross["attention"] + flops.clip_text_step(c_len, m_clip)
                + flops.search_flops(len(queries), cfg["index"]["text_rows"], m_text["hidden_size"])
                + flops.search_flops(len(queries), cfg["index"]["image_rows"],
                                     m_clip["projection_dim"]))
    return flops.least_time(floating, linear) if int8 else flops.least_time(floating + linear, 0)


def mfu_chat(rec: Dict) -> Optional[float]:
    """Least time of the steps in the sub-window over the time at least one
    step ran; a step at an edge counts by its share inside."""

    lo, hi = rec["window"]
    steps = [b for b in rec["recorder"].batches
             if "items" in b and _overlap(b["start"], b["end"], lo, hi) > 0]
    if not steps:
        return None
    need = sum(chat_step_time(rec, b) * _overlap(b["start"], b["end"], lo, hi)
               / (b["end"] - b["start"]) for b in steps)
    busy = union_length([(b["start"], b["end"]) for b in steps], lo, hi)
    return 100.0 * need / busy


def mfu_ingest(rec: Dict) -> Optional[float]:
    """MiniLM's least time at the real tokens of the chunks embedded in the
    sub-window, over the sub-window."""

    lo, hi = rec["window"]
    cfg = rec["config"]
    m = cfg["models"]["text"]
    wp, _ = _tokens(rec)
    need = 0.0
    for b in rec["recorder"].batches:
        if "texts" not in b:
            continue
        share = _overlap(b["start"], b["end"], lo, hi) / max(b["end"] - b["start"], 1e-9)
        if share <= 0:
            continue
        lens = [min(len(wp.ids(t)) + 2, m["max_seq_length"]) for t in b["texts"]]
        step = flops.bert_step(lens, m)
        if cfg["env"].get("TPU_ENCODER_QUANT") == "int8":
            need += share * flops.least_time(step["attention"], step["linear"])
        else:
            need += share * flops.least_time(step["attention"] + step["linear"], 0)
    return 100.0 * need / (hi - lo) if need else None


def ms_per_kchunk(rec: Dict, names: Tuple[str, ...]) -> Optional[float]:
    """Seconds inside the named spans per thousand chunks they handled, for
    the spans that ended in the sub-window (the catalogue's span is
    counted with the upsert's chunks)."""

    lo, hi = rec["window"]
    spans = [(n, s, e, k) for n, s, e, k in rec["recorder"].spans if n in names and lo <= e < hi]
    chunks = sum(k for n, _, _, k in spans if n == names[0])
    if not chunks:
        return None
    return sum(e - s for _, s, e, _ in spans) * 1e3 / (chunks / 1e3)
