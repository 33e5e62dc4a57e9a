"""Cross-request micro-batching: coalesce concurrent queries into one dispatch.

The reference serves each HTTP request with its own encoder forward
(``app/ml/retrieve.py:120-129`` under FastAPI concurrency,
SURVEY §2c "FastAPI async + uvicorn" row). On the card that wastes the
tensor cores and the host's launch time: a batch-1 MiniLM forward costs
nearly the same wall time as batch-16, so N concurrent chat requests should
ride ONE padded device step. Port of ``mmrag_tpu/serving/batcher.py``.

:class:`MicroBatcher` sits between serving threads and an ``EncoderRuntime``
method: ``submit()`` blocks the calling thread, a single collector thread
drains the queue — waiting at most ``window_ms`` after the first item, or
until ``max_batch`` items arrive — runs the batch function once, and fans
results back out. Items never reorder within a batch, errors propagate to
every waiter of the failed batch, and an idle batcher holds no thread wakeups
(the collector parks on the queue).

``QueryEmbedBatcher`` packages the common case: the dual query embedding
(MiniLM + CLIP-text) used by ``/chat_pro``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Generic, List, Optional, Sequence, TypeVar

from ..utils import profiling

T = TypeVar("T")


class _Slot(Generic[T]):
    __slots__ = ("item", "event", "result", "error", "t_enqueue", "parent", "request_id")

    def __init__(self, item: T) -> None:
        self.item = item
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # the submitting thread's open span and request id, for the spans
        # the runner records on the request's behalf
        self.parent, self.request_id = profiling.current()
        self.t_enqueue = time.monotonic()


class MicroBatcher(Generic[T]):
    """Batch a ``fn(list[T]) -> Sequence[results]`` across calling threads."""

    def __init__(
        self,
        fn: Callable[[List[T]], Sequence[Any]],
        max_batch: int = 16,
        window_ms: float = 4.0,
        name: str = "microbatch",
        default_timeout: Optional[float] = 300.0,
        workers: int = 1,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fn = fn
        self._name = name
        self._max_batch = max_batch
        self._window_s = max(window_ms, 0.0) / 1e3
        # generous default: the FIRST batch may load the weights and build
        # the kernels with nvcc, which takes minutes — a short timeout would
        # spuriously fail every early waiter
        self._default_timeout = default_timeout
        self._queue: "queue.Queue[_Slot[T]]" = queue.Queue()
        self._closed = threading.Event()
        self._stats_lock = threading.Lock()
        self.batches_run = 0
        self.items_seen = 0
        self._running = 0  # batches inside the batch function now
        # achieved-coalescing histogram {batch_size: count} — the number the
        # batcher exists to move (surfaced by the serving-load bench)
        self.batch_sizes: dict = {}
        # workers > 1 pipelines batches: while batch N blocks on its device
        # readback (GIL released), batch N+1 tokenizes and dispatches — the
        # collector only FORMS batches, a small pool RUNS them. Results stay
        # per-slot, so cross-batch completion order is free to vary. The
        # semaphore implements continuous batching: when every runner is
        # busy, the collector keeps folding new arrivals into the pending
        # batch instead of queueing tiny batches behind the pool.
        self._pool = None
        self._free = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"{name}-runner"
            )
            self._free = threading.Semaphore(workers)
        self._thread = threading.Thread(
            target=self._collector, name=f"{name}-collector", daemon=True
        )
        self._thread.start()

    # -- worker ---------------------------------------------------------------

    def _collector(self) -> None:
        while not self._closed.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            # window_ms bounds TOTAL wait after the first item (a per-get
            # timeout would let a slow trickle of arrivals extend the window
            # up to (max_batch-1) * window_ms of tail latency)
            deadline = time.monotonic() + self._window_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            if self._pool is not None:
                # continuous batching: while no runner is free, fold new
                # arrivals into this batch (bounded by max_batch) instead of
                # forming tiny follow-on batches behind a saturated pool
                permit = False
                while not self._closed.is_set():
                    if self._free.acquire(timeout=0.002):
                        permit = True
                        break
                    while len(batch) < self._max_batch:
                        try:
                            batch.append(self._queue.get_nowait())
                        except queue.Empty:
                            break
                if permit:
                    self._pool.submit(self._run_released, batch)
                else:
                    self._run(batch)  # drain synchronously on shutdown
            else:
                self._run(batch)
        # drain: fail any slots enqueued after the collector stopped looking
        while True:
            try:
                slot = self._queue.get_nowait()
            except queue.Empty:
                break
            slot.error = RuntimeError("batcher closed before running this item")
            slot.event.set()

    def _run_released(self, batch: List[_Slot[T]]) -> None:
        try:
            self._run(batch)
        finally:
            self._free.release()

    def _run(self, batch: List[_Slot[T]]) -> None:
        with self._stats_lock:
            self.batches_run += 1
            self.items_seen += len(batch)
            self.batch_sizes[len(batch)] = self.batch_sizes.get(len(batch), 0) + 1
            self._running += 1
            running = self._running
        # queue-wait vs work-time split: a request's
        # latency = time-to-dispatch (window + runner availability — these
        # spans, each with its request's id) + its batch's run time
        # (serving.batch and its retrieve.* children). /metrics carries
        # both, so a tail is attributable to queueing vs device work without
        # guesswork.
        t_start = time.monotonic()
        wait = f"queue_wait.{self._name}"
        for slot in batch:
            profiling.record(wait, slot.t_enqueue, t_start, slot.request_id, slot.parent)
        try:
            with profiling.stage("serving.batch", tuple(s.request_id for s in batch),
                                 items=len(batch), batcher=self._name, running=running):
                results = self._fn([s.item for s in batch])
            dt = time.monotonic() - t_start
            profiling.metrics.observe(f"stage.batch_run.{self._name}", dt)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch fn returned {len(results)} results for {len(batch)} items"
                )
            for slot, res in zip(batch, results):
                slot.result = res
        except BaseException as exc:  # propagate to every waiter
            for slot in batch:
                slot.error = exc
        finally:
            with self._stats_lock:
                self._running -= 1
            for slot in batch:
                slot.event.set()

    # -- public ----------------------------------------------------------------

    def submit(self, item: T, timeout: Optional[float] = None) -> Any:
        """Block until the item's batch completes; returns its result.

        ``timeout=None`` uses the batcher's ``default_timeout``."""

        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        slot: _Slot[T] = _Slot(item)
        self._queue.put(slot)
        if not slot.event.wait(timeout if timeout is not None else self._default_timeout):
            raise TimeoutError("micro-batch did not complete in time")
        if slot.error is not None:
            raise slot.error
        return slot.result

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        # the collector drains on exit; cover the case where it never got to
        while True:
            try:
                slot = self._queue.get_nowait()
            except queue.Empty:
                break
            slot.error = RuntimeError("batcher closed before running this item")
            slot.event.set()


class QueryEmbedBatcher:
    """Dual query embedding (MiniLM 384-d + CLIP-text 512-d) with coalescing.

    One batcher per runtime; both towers run over the same coalesced query
    list, so N concurrent ``/chat_pro`` requests cost two padded forwards
    total instead of 2N batch-1 forwards.
    """

    def __init__(self, runtime, max_batch: int = 16, window_ms: float = 4.0) -> None:
        self._runtime = runtime

        def embed_all(qs: List[str]):
            text = self._runtime.embed_text_batch(qs)
            image = self._runtime.embed_queries_for_images(qs)
            return [
                {"text": text[i], "image": image[i]} for i in range(len(qs))
            ]

        self._batcher: MicroBatcher[str] = MicroBatcher(
            embed_all, max_batch=max_batch, window_ms=window_ms, name="query-embed"
        )

    def embed(self, query: str) -> dict:
        return self._batcher.submit(query)

    @property
    def stats(self) -> dict:
        return {
            "batches_run": self._batcher.batches_run,
            "items_seen": self._batcher.items_seen,
        }

    def close(self) -> None:
        self._batcher.close()
