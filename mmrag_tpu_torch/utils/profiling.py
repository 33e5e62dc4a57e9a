"""Tracing + stage timing: request ids, spans and stage events.

Extends the reference's observability (request-id logging middleware
``app/main.py:30-41`` + Celery ``update_state`` stage events,
SURVEY §5 "per-stage timing in the same stage-event shape"):

  * :func:`stage` — context manager logging ``rid=<id> stage=<name>
    ms=<t>``, feeding the metrics registry, and appending one flat record
    to the span ring;
  * :class:`Metrics` — counters + latency reservoirs with p50/p95
    summaries (exposed by the HTTP layer);
  * the span ring — the process's flight recorder: the last
    :data:`RING_SIZE` spans and garbage collections, each a flat tuple
    (:data:`FIELDS`) stamped with ``time.monotonic()``. It has no off
    state. Parent span and request id travel in a context variable, so a
    span opened inside another is its child, and a request's id reaches
    every span it opens; :class:`~mmrag_tpu_torch.serving.batcher.MicroBatcher`
    carries both across its threads. :func:`records` reads the ring,
    :func:`write_chrome_trace` writes it for ``chrome://tracing``.

Records are tuples of atomic values (and tuples of them), so the cyclic
collector untracks them: a full collection does not traverse the ring.
"""

from __future__ import annotations

import contextvars
import gc
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("mmrag_tpu_torch.stage")

RING_SIZE = 65536
# one span record: (span id, parent span id (0: a root), request id (a str,
# a batch's tuple of them, or None), name, thread id, start, end (monotonic
# seconds), items (or None), attrs (a tuple of (key, value) pairs, or None))
FIELDS = ("sid", "parent", "rid", "name", "tid", "start", "end", "items", "attrs")

_ring: deque = deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
# the innermost open span (its id and request id are its children's)
_current: contextvars.ContextVar = contextvars.ContextVar("span", default=None)
_monotonic = time.monotonic
_get_ident = threading.get_ident
_new = object.__new__
_info_enabled = logger.isEnabledFor
_INFO = logging.INFO


class Metrics:
    def __init__(self, reservoir: int = 512) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, float] = {}
        self._reservoir = reservoir
        # name -> [the last ``reservoir`` seconds, the count of every observation]
        self._series: Dict[str, list] = {}
        # collections by generation and their pause (ms), written by the gc
        # hook without a lock (collections never overlap)
        self._gc = [0, 0, 0, 0.0]

    def incr(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] += amount

    def observe(self, name: str, seconds: float) -> None:
        lock = self._lock
        lock.acquire()  # not ``with``, which costs twice as much: this runs on every span
        try:
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = [deque(maxlen=self._reservoir), 0]
            series[0].append(seconds)
            series[1] += 1
        finally:
            lock.release()

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins statistic in its OWN unit (quality scores,
        sizes) — ``observe`` is for durations only: its reservoir exports
        as a ``*_latency_ms`` summary multiplied by 1e3, which renders a
        0.83 reconstruction cosine as "830 ms"."""

        with self._lock:
            self._gauges[name] = float(value)

    def note_gc(self, generation: int, seconds: float) -> None:
        self._gc[generation] += 1
        self._gc[3] += seconds * 1e3

    def summary(self) -> Dict:
        """Counters (the collector's, and each stage's: the count of its
        observations, among them), gauges, and each reservoir's p50/p95/max
        with ``count``: every observation made, not the reservoir's length."""

        with self._lock:
            counters = dict(self._counters)
            counters.update((name, n) for name, (_, n) in self._series.items()
                            if name.startswith("stage."))
            for g in range(3):
                counters[f"gc.collections.gen{g}"] = self._gc[g]
            counters["gc.pause_ms"] = self._gc[3]
            out: Dict = {"counters": counters, "gauges": dict(self._gauges), "latency_ms": {}}
            for name, (values, count) in self._series.items():
                ordered = sorted(values)
                out["latency_ms"][name] = {
                    "count": count,
                    "p50": round(ordered[len(ordered) // 2] * 1e3, 3),
                    "p95": round(ordered[int(len(ordered) * 0.95)] * 1e3, 3),
                    "max": round(ordered[-1] * 1e3, 3),
                }
            return out

    def prometheus_text(self) -> str:
        """The summary in Prometheus text exposition format (v0.0.4).

        Counter names map to ``mmrag_<name>_total`` and each latency
        reservoir to a ``mmrag_<name>_latency_ms`` summary (p50/p95
        quantiles over the reservoir, ``_count`` every observation, which
        for a stage is its counter, + max), so a stock Prometheus scrape of
        ``/metrics?format=prometheus`` works without an exporter sidecar.
        Dots and other non-metric characters in registry names become
        underscores per the exposition grammar.
        """

        def _name(raw: str) -> str:
            cleaned = [
                ch if (ch.isalnum() or ch == "_") else "_" for ch in raw
            ]
            if cleaned and cleaned[0].isdigit():
                cleaned.insert(0, "_")
            return "".join(cleaned)

        summary = self.summary()
        lines = []
        for raw, value in sorted(summary["counters"].items()):
            metric = f"mmrag_{_name(raw)}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {value}")
        for raw, value in sorted(summary["gauges"].items()):
            metric = f"mmrag_{_name(raw)}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")
        for raw, stats in sorted(summary["latency_ms"].items()):
            metric = f"mmrag_{_name(raw)}_latency_ms"
            lines.append(f"# TYPE {metric} summary")
            lines.append(f'{metric}{{quantile="0.5"}} {stats["p50"]}')
            lines.append(f'{metric}{{quantile="0.95"}} {stats["p95"]}')
            lines.append(f"{metric}_count {stats['count']}")
            lines.append(f"# TYPE {metric}_max gauge")
            lines.append(f"{metric}_max {stats['max']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()
            self._gc[:] = [0, 0, 0, 0.0]


metrics = Metrics()


def stage(name: str, request_id=None, items: Optional[int] = None, **attrs) -> "_Span":
    """Time a pipeline stage as a span (``with stage(...) as span``); logs in
    the reference's stage-event shape.

    ``request_id`` (a string, or a batch's tuple of them) defaults to the
    enclosing span's; ``items`` (settable on the span inside the block) is
    the count of what the span handled; ``attrs`` are kept with the record.
    On exit it observes its seconds as ``stage.<name>`` (which counts it)
    through ``profiling.metrics`` as found at that moment, and appends its
    record to the ring. No device synchronisation: a span that waits on
    the card wraps a wait the code makes anyway."""

    span = _new(_Span)  # no __init__: this runs for every span
    span.name = name
    span.rid = request_id
    span.items = items
    span.attrs = tuple(attrs.items()) if attrs else None
    return span


class _Span:
    __slots__ = ("name", "rid", "items", "attrs", "sid", "parent", "start", "_token")

    def __enter__(self) -> "_Span":
        up = _current.get()
        if up is None:
            self.parent = 0
        else:
            self.parent = up.sid
            if self.rid is None:
                self.rid = up.rid
        self.sid = next(_ids)
        self._token = _current.set(self)
        self.start = _monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = _monotonic()
        _current.reset(self._token)
        name, start = self.name, self.start
        _ring.append((self.sid, self.parent, self.rid, name, _get_ident(), start, end,
                      self.items, self.attrs))
        metrics.observe("stage." + name, end - start)
        if _gc_full:
            _observe_gc_full()
        if _info_enabled(_INFO):
            logger.info("rid=%s stage=%s ms=%.1f", self.rid or "-", name, (end - start) * 1e3)


def current() -> Tuple[int, object]:
    """(the innermost open span's id, its request id) in this context;
    (0, None) outside every span."""

    up = _current.get()
    return (0, None) if up is None else (up.sid, up.rid)


def record(name: str, start: float, end: float, request_id=None, parent: int = 0,
           items: Optional[int] = None, **attrs) -> None:
    """A span that ended already, timed by its caller (a queue wait, seen
    from the thread that ends it): observed as :func:`stage` does."""

    _ring.append((next(_ids), parent, request_id, name, _get_ident(), start, end, items,
                  tuple(attrs.items()) if attrs else None))
    metrics.observe("stage." + name, end - start)
    if _gc_full:
        _observe_gc_full()


def records() -> List[tuple]:
    """A copy of the ring, oldest first."""

    return list(_ring)  # one C call under the interpreter lock: no append lands inside


# -- garbage collection ------------------------------------------------------

_GC_ATTRS = tuple((("generation", g),) for g in range(3))
_gc_start = [0.0]
# full collections' pauses, not observed yet
_gc_full: deque = deque()


def _gc_hook(phase: str, info: Dict) -> None:
    """Each collection as a ``gc`` record, counted by generation. It runs
    inside whatever the collecting thread was doing, which may hold any
    lock, so it calls nothing that takes one: a full collection's pause
    is queued, and the next span's exit observes it as ``stage.gc.full``."""

    if phase == "start":
        _gc_start[0] = _monotonic()
        return
    end = _monotonic()
    start = _gc_start[0]
    generation = info["generation"]
    _ring.append((0, 0, None, "gc", _get_ident(), start, end, None, _GC_ATTRS[generation]))
    metrics.note_gc(generation, end - start)
    if generation == 2:
        _gc_full.append(end - start)


def _observe_gc_full() -> None:
    while True:
        try:
            seconds = _gc_full.popleft()
        except IndexError:  # another thread's span took the last
            return
        metrics.observe("stage.gc.full", seconds)


if _gc_hook not in gc.callbacks:
    gc.callbacks.append(_gc_hook)


# -- export ------------------------------------------------------------------

def write_chrome_trace(path: str) -> int:
    """The ring as a Chrome trace (``chrome://tracing``, Perfetto): one
    complete event a record, microseconds on the monotonic clock. Returns
    the number of events written."""

    pid = os.getpid()
    events = []
    for sid, parent, rid, name, tid, start, end, items, attrs in records():
        args = {"sid": sid, "parent": parent}
        if rid is not None:
            args["rid"] = list(rid) if isinstance(rid, tuple) else rid
        if items is not None:
            args["items"] = items
        args.update(attrs or ())
        events.append({"name": name, "ph": "X", "ts": start * 1e6,
                       "dur": (end - start) * 1e6, "pid": pid, "tid": tid, "args": args})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)
