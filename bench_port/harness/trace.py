"""What a traced run records: the harness's own spans, and a device trace.

Only a ``--trace 1`` run installs these. Every record is taken from the
benchmark's side of a call into the system, on the host's monotonic clock:

* every ``metrics.observe`` of the system (its ``stage()`` spans, the
  batcher's queue waits and batch runs), each with the time it was made,
  so a reader sees every event of the sub-window and not a reservoir;
* each coalesced ``retrieve_batch`` call, with its items and its payloads;
* each call of the kernel wrappers that launch K-gemm and K-bmax,
  with its tensors' shapes (the profiler does not link a kernel launched
  from the system's own libraries to its op; the roofline readers pair the
  two by sums over the sub-window instead);
* the ingest cell's spans around the embed, the index upsert and the
  catalogue write.

:class:`DeviceTrace` runs ``torch.profiler`` with CUDA activity over a
steady sub-window and keeps each device operation's name and interval,
moved onto the monotonic clock by a marker range opened at a known time.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Tuple

# a fragment of each hand-written kernel's symbol and its name
SYMBOLS = (("gemm_i8_kernel", "K-gemm-i8"), ("gemm_bf16_kernel", "K-gemm"),
           ("gemm_f32_kernel", "K-gemm"), ("bucket_max_tc_kernel", "K-bmax"),
           ("bucket_max_f32_kernel", "K-bmax"), ("attention_mma_kernel", "K-attn"),
           ("attention_f32_kernel", "K-attn"), ("row_kernel", "K-ln"))
WRAPPERS = {"gemm": "K-gemm", "bucket_max": "K-bmax"}
MARKER = "bench.clock_marker"


def kernel_name(symbol: str) -> str:
    return next((name for frag, name in SYMBOLS if frag in symbol), symbol)


class Recorder:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.observed: List[Tuple[str, float, float]] = []  # (name, end, seconds)
        self.calls: List[Tuple[str, float, Tuple]] = []  # (kernel, time, shape info)
        self.batches: List[Dict] = []
        self.spans: List[Tuple[str, float, float, int]] = []  # (name, start, end, items)
        self._undo: List[Tuple[object, str, object]] = []

    def _patch(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)

    def install_serving(self) -> None:
        """The observe hook, the kernel wrappers and the batch span."""

        from mmrag_tpu_torch.ops import kernels
        from mmrag_tpu_torch.rag import retrieve
        from mmrag_tpu_torch.utils import profiling

        metrics = profiling.metrics
        observe = metrics.observe

        def observed(name, seconds):
            t = time.monotonic()
            with self.lock:
                self.observed.append((name, t, seconds))
            return observe(name, seconds)

        self._patch(metrics, "observe", observed)
        for attr, kname in WRAPPERS.items():
            for owner in (kernels, kernels.DISPATCH):
                fn = getattr(owner, attr)
                self._patch(owner, attr, self._labelled(fn, kname))
        batch_fn = retrieve.retrieve_batch

        @functools.wraps(batch_fn)
        def batch(items, engine=None):
            t0 = time.monotonic()
            out = batch_fn(items, engine)
            with self.lock:
                self.batches.append({"start": t0, "end": time.monotonic(),
                                     "items": list(items), "payloads": out})
            return out

        self._patch(retrieve, "retrieve_batch", batch)

    def install_ingest(self, engine) -> None:
        self.install_serving()
        self._span(engine.runtime, "embed_text_batch", "ingest.embed")
        self._span(engine.text_index, "upsert", "ingest.upsert")
        self._span(engine.metadata, "upsert_chunks", "ingest.catalogue")

    def _span(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def call(items, *args, **kwargs):
            t0 = time.monotonic()
            out = fn(items, *args, **kwargs)
            with self.lock:
                self.spans.append((name, t0, time.monotonic(), len(items)))
                if name == "ingest.embed":
                    self.batches.append({"start": t0, "end": time.monotonic(),
                                         "texts": list(items)})
            return out

        self._patch(owner, attr, call)

    def _labelled(self, fn, kname: str):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = time.monotonic()
            info = _shape_info(kname, args, kwargs)
            with self.lock:
                self.calls.append((kname, t, info))
            return fn(*args, **kwargs)
        return call


def _shape_info(kname: str, args, kwargs) -> Tuple:
    """What the roofline of one launch needs, from the wrapper's arguments."""

    if kname == "K-bmax":
        queries, corpus, mask = args[:3]
        return (int(queries.shape[0]), int(corpus.shape[0]), int(corpus.shape[1]),
                corpus.element_size(), mask.numel() * mask.element_size(),
                int(queries.shape[0]) * -(-int(corpus.shape[0]) // 128) * 4)
    if kname == "K-gemm":
        a, w = args[0], args[1]
        residual = args[3] if len(args) > 3 else kwargs.get("residual")
        out_dtype = kwargs.get("out_dtype") or (args[5] if len(args) > 5 else None) or a.dtype
        import torch

        out_elem = torch.empty((), dtype=out_dtype).element_size()
        return (int(a.shape[0]), int(a.shape[1]), int(w.shape[1]), a.element_size(),
                out_elem, residual is not None)
    raise ValueError(kname)


class DeviceTrace:
    """``torch.profiler`` with CUDA activity, started and stopped by the
    harness around a steady sub-window of the measured one."""

    def __init__(self) -> None:
        self.prof = None
        self.start_mono = 0.0
        self.stop_mono = 0.0
        self.events: List[Tuple[str, float, float]] = []  # (name, start, end), monotonic

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start loads
        CUPTI, which holds the interpreter for seconds."""

        import torch

        self.start()
        torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.start_mono = time.monotonic()
        with record_function(MARKER):
            pass

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.stop_mono = time.monotonic()
        self.prof.stop()

    def collect(self) -> None:
        """The device operations, read from the stopped profiler (after the
        window: reading them takes the interpreter for a while)."""

        from torch.autograd import DeviceType

        events = self.prof.events()
        marker = next((e for e in events if e.name == MARKER), None)
        if marker is None:
            raise RuntimeError("the profiler lost the clock marker range")
        shift = self.start_mono - marker.time_range.start / 1e6
        self.events = sorted(
            (e.name, e.time_range.start / 1e6 + shift, e.time_range.end / 1e6 + shift)
            for e in events if e.device_type == DeviceType.CUDA)
        self.prof = None

    @property
    def window(self) -> Tuple[float, float]:
        return self.start_mono, self.stop_mono


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] between the intervals."""

    out, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def breakdown(trace: DeviceTrace, recorder: Recorder) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps by the innermost span the host was in at their middle."""

    lo, hi = trace.window
    by_name: Dict[str, float] = {}
    for name, s, e in trace.events:
        key = kernel_name(name)[:96]
        by_name[key] = by_name.get(key, 0.0) + (min(e, hi) - max(s, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = [(n, t - d, t) for n, t, d in recorder.observed]
    spans += [(n, s, e) for n, s, e, _ in recorder.spans]
    spans += [("retrieve_batch", b["start"], b["end"]) for b in recorder.batches
              if "items" in b]
    named = []
    for s, e in gaps([(a, b) for _, a, b in trace.events], lo, hi):
        mid = (s + e) / 2
        inside = [(b - a, n) for n, a, b in spans if a <= mid <= b]
        named.append((min(inside)[1] if inside else "no span open", e - s))
    named.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, float(v)] for n, v in ops],
            "idle_gaps": [[n, float(v)] for n, v in named[:10]]}
