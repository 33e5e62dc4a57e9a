"""The arithmetic of the readers of the program's own spans.

The program keeps its last spans and garbage collections in a ring
(``mmrag_tpu_torch.utils.profiling.records()``): flat tuples of span id,
parent id, request id, name, thread id, start, end, items and attrs, on the
monotonic clock that ``records["window"]`` is on. A reader keeps what ended
in the window: the records themselves, or for a per-batch number the
batches, with their descendants found through the parent ids. Where the
program keeps no ring, or the ring holds no record that ended in the
window, a reader returns None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from .trace import union_length

SID, PARENT, RID, NAME, TID, START, END, ITEMS, ATTRS = range(9)


def ring() -> List[tuple]:
    """Every record the program's ring holds, or none where it has no ring."""

    from mmrag_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return read() if read is not None else []


def _ended_in(records: Iterable[tuple], window) -> List[tuple]:
    lo, hi = window
    return [r for r in records if lo <= r[END] < hi]


def _attr(record: tuple, key: str):
    return dict(record[ATTRS] or ()).get(key)


class Spans:
    """The ring, read once, with its records that ended in the window."""

    def __init__(self, rec: Dict) -> None:
        self.all = ring()
        self.window = rec["window"]
        self.ended = _ended_in(self.all, self.window)
        self._by_sid = None

    def named(self, name: str) -> List[tuple]:
        return [r for r in self.ended if r[NAME] == name]

    def _ancestor(self, record: tuple, names) -> Optional[tuple]:
        if self._by_sid is None:
            self._by_sid = {r[SID]: r for r in self.all if r[SID]}
        parent = self._by_sid.get(record[PARENT])
        while parent is not None and parent[NAME] not in names:
            parent = self._by_sid.get(parent[PARENT])
        return parent

    def per_root(self, roots: List[tuple], names) -> List[float]:
        """For each root, the seconds of its descendants named in ``names``."""

        sums = {r[SID]: 0.0 for r in roots}
        root_names = {r[NAME] for r in roots}
        for r in self.all:
            if r[NAME] in names:
                top = self._ancestor(r, root_names)
                if top is not None and top[SID] in sums:
                    sums[top[SID]] += r[END] - r[START]
        return list(sums.values())


def retrieval_batch_ms(rec: Dict, names) -> Optional[float]:
    """Median, over the retrieval batcher's ``serving.batch`` spans that
    ended in the window, of the milliseconds of their descendants named in
    ``names``."""

    spans = Spans(rec)
    batches = [r for r in spans.named("serving.batch") if _attr(r, "batcher") == "retrieval"]
    if not batches:
        return None
    return float(np.median(spans.per_root(batches, set(names)))) * 1e3


def handler_self_ms(rec: Dict) -> Optional[float]:
    """Median self time of ``POST /chat_pro`` requests: each ``http.request``
    span's duration less the time its child spans cover."""

    spans = Spans(rec)
    roots = [r for r in spans.named("http.request")
             if _attr(r, "method") == "POST" and _attr(r, "path") == "/chat_pro"]
    if not roots:
        return None
    children: Dict[int, list] = {r[SID]: [] for r in roots}
    for r in spans.all:
        if r[PARENT] in children:
            children[r[PARENT]].append((r[START], r[END]))
    own = [(r[END] - r[START]) - union_length(children[r[SID]], r[START], r[END])
           for r in roots]
    return float(np.median(own)) * 1e3


def gc_ms_per_s(rec: Dict) -> Optional[float]:
    """Milliseconds of collection pause (every generation) that ended in
    the window, a second of it."""

    spans = Spans(rec)
    if not spans.ended:
        return None
    lo, hi = spans.window
    return sum(r[END] - r[START] for r in spans.named("gc")) * 1e3 / (hi - lo)


def ms_per_kchunk(rec: Dict, name: str, ancestor: str) -> Optional[float]:
    """Milliseconds of the ``name`` spans under the ``ancestor`` spans that
    ended in the window, per thousand of the ancestors' items (chunks)."""

    spans = Spans(rec)
    roots = spans.named(ancestor)
    chunks = sum(r[ITEMS] or 0 for r in roots)
    if not chunks:
        return None
    return sum(spans.per_root(roots, {name})) * 1e3 / (chunks / 1e3)
