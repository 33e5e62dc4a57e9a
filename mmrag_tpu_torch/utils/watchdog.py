"""Device-health watchdog: detects a wedged accelerator runtime.

Port of ``mmrag_tpu/utils/watchdog.py``. A runtime can wedge such that
*every launch or readback blocks forever* — no exception, no timeout. A
server in that state accepts connections (`/healthz` is pure host code)
while every `/chat_pro` hangs, which defeats both compose healthchecks and
load-balancer liveness probes. The reference never hits this because
torch-on-CPU can't lose its device; a serving stack on a card must surface
it (SURVEY §5 failure-detection role).

Design: a daemon thread periodically runs a trivial device op + readback
in a helper thread and waits ``timeout_sec``. Three states:

* ``ok``      — the probe round-tripped within the timeout
* ``wedged``  — a probe is stuck (the helper thread never returned); no
  new probes pile up behind it, and recovery is detected when the stuck
  probe finally completes
* ``unknown`` — watchdog disabled or no probe has completed yet

State is exposed through :data:`mmrag_tpu_torch.utils.profiling.metrics`
(``device.watchdog.wedged`` counter) and :func:`status` (consumed by
``/healthz``). Python threads can't be killed, so a wedged probe thread
parks until the runtime recovers — there is at most one in flight.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .profiling import metrics

_logger = logging.getLogger("mmrag_tpu_torch.watchdog")


_probe = None  # (stream, buffer) of the card probe, made at its first run


def _default_probe() -> None:
    """One trivial op on the card, on a stream of its own, and a wait for
    it to finish.

    ``torch.cuda.synchronize()`` (or a readback on the default stream) would
    wait for every launch queued before it, so a long coalesced batch would
    read as ``wedged``; the probe waits on its own stream's event only.
    Without CUDA (a server asked to run on the CPU) there is no card to
    probe."""

    global _probe
    import torch

    if not torch.cuda.is_available():
        return
    if _probe is None:
        stream = torch.cuda.Stream()  # non-blocking: never waits on the default stream
        with torch.cuda.stream(stream):
            _probe = (stream, torch.zeros(8, device="cuda"))
    stream, buf = _probe
    with torch.cuda.stream(stream):
        buf.add_(1.0)
        done = stream.record_event()
    done.synchronize()


class DeviceWatchdog:
    def __init__(
        self,
        period_sec: float = 60.0,
        timeout_sec: float = 30.0,
        probe: Optional[Callable[[], None]] = None,
    ) -> None:
        self.period_sec = period_sec
        self.timeout_sec = timeout_sec
        self._probe = probe or _default_probe
        self._state = "unknown"
        self._last_ok: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_done = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="device-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_sec + 1)
            self._thread = None
        if self._probe_thread is not None:
            # a probe mid-dispatch at interpreter teardown aborts the
            # process; bounded join (a truly wedged probe can't be waited
            # out — that shutdown is already degraded)
            self._probe_thread.join(timeout=self.timeout_sec)
            self._probe_thread = None

    # -- state ---------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "device": self._state,
                "last_ok_age_sec": (
                    round(time.monotonic() - self._last_ok, 1)
                    if self._last_ok is not None
                    else None
                ),
            }

    # -- internals -----------------------------------------------------------

    def _run_probe(self) -> None:
        try:
            self._probe()
        except Exception as exc:  # a *failing* device is still a live one
            _logger.warning("device probe raised: %s", exc)
        finally:
            self._probe_done.set()

    def _tick(self) -> None:
        if self._probe_thread is not None and self._probe_thread.is_alive():
            # previous probe still stuck: stay wedged, don't stack threads
            return
        self._probe_done.clear()
        self._probe_thread = threading.Thread(
            target=self._run_probe, name="device-probe", daemon=True
        )
        self._probe_thread.start()
        completed = self._probe_done.wait(self.timeout_sec)
        with self._lock:
            if completed:
                if self._state == "wedged":
                    _logger.warning("device runtime recovered")
                    metrics.incr("device.watchdog.recovered")
                self._state = "ok"
                self._last_ok = time.monotonic()
            else:
                if self._state != "wedged":
                    _logger.error(
                        "device probe did not return within %.0fs — runtime "
                        "wedged (dispatches will hang)", self.timeout_sec,
                    )
                self._state = "wedged"
                metrics.incr("device.watchdog.wedged")

    def _run(self) -> None:
        while not self._stop.is_set():
            self._tick()
            # a stuck probe already consumed timeout_sec of the period
            self._stop.wait(max(self.period_sec - self.timeout_sec, 1.0)
                            if self._state == "wedged" else self.period_sec)


_watchdog: Optional[DeviceWatchdog] = None
_watchdog_lock = threading.Lock()


def start_watchdog(
    period_sec: float, timeout_sec: Optional[float] = None
) -> Optional[DeviceWatchdog]:
    """Start (once per process) the device watchdog; period <= 0 disables."""

    global _watchdog
    if period_sec <= 0:
        return None
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = DeviceWatchdog(
                period_sec=period_sec,
                timeout_sec=timeout_sec or min(30.0, period_sec / 2),
            )
            _watchdog.start()
        return _watchdog


def stop_watchdog() -> None:
    """Stop and clear the process watchdog (server shutdown): its probe
    thread launches on the card, and a daemon thread inside a device call
    at interpreter teardown can abort the process."""

    global _watchdog
    with _watchdog_lock:
        wd, _watchdog = _watchdog, None
    if wd is not None:
        wd.stop()


def status() -> dict:
    """Current device-health view for ``/healthz`` (``unknown`` when off)."""

    with _watchdog_lock:
        if _watchdog is None:
            return {"device": "unknown", "last_ok_age_sec": None}
        return _watchdog.status()
