"""Telemetry streaming (copy of ``deppy_tpu/obs/stream.py:1-221``):
replica -> aggregator event push.

A :class:`TelemetryStreamer` registers as an event forwarder on the
process telemetry registry (:meth:`Registry.add_forwarder`), so every
JSONL sink event — profile, race, fault, speculate, route, spans — is
also enqueued for the fleet aggregator, sink file or not.

Backpressure contract (the load-bearing part): ``enqueue`` NEVER
blocks and NEVER raises.  The queue is a bounded list under a lock;
when a slow (or dead) aggregator lets it fill, further events are
dropped and counted (``deppy_obs_stream_dropped_total``) — serving
latency is unperturbed by observability.  A daemon thread drains the
queue in batches of ``DEPPY_GPU_OBS_BATCH`` (256) at most every
``DEPPY_GPU_OBS_FLUSH_MS`` (200.0) milliseconds, POSTing
``{"replica": ..., "events": [...]}`` to ``/fleet/telemetry`` on the
aggregator; a failed POST drops that batch (counted) rather than
requeueing it, so the queue bound (``DEPPY_GPU_OBS_QUEUE``, 4096) is
real.

After a failed POST the streamer additionally holds off for a bounded,
exponentially growing interval (doubling from the flush period up to
``DEPPY_GPU_OBS_BACKOFF_MAX_S``, 5.0) instead of re-hammering a
restarting aggregator at full flush cadence; the first successful POST
after a down streak resets the hold-off and is counted on
``deppy_obs_stream_reconnects_total``.  A knob's malformed value reads
its default (``config.env_int`` / ``config.env_float`` with
``strict=False``, as the reference reads its ``DEPPY_TPU_OBS_*``).  The lock is a plain ``threading`` lock where the
reference takes a lockdep-named one.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import List, Optional, Tuple

from .. import config

# The streamer's own families (registered on the process registry only
# while a streamer is armed; `obs.render_metric_lines` mirrors them
# onto the service /metrics).
STREAM_FAMILIES = (
    "deppy_obs_stream_events_total",
    "deppy_obs_stream_dropped_total",
    "deppy_obs_stream_batches_total",
    "deppy_obs_stream_errors_total",
    "deppy_obs_stream_reconnects_total",
)

POST_TIMEOUT_S = 5.0


def _parse_target(target: str) -> Tuple[str, int]:
    host, _, port = target.rpartition(":")
    return (host or "127.0.0.1"), int(port)


class TelemetryStreamer:
    """Bounded, non-blocking event pusher to the fleet aggregator."""

    def __init__(self, target: str, replica: Optional[str] = None,
                 queue_cap: Optional[int] = None,
                 batch: Optional[int] = None,
                 flush_ms: Optional[float] = None,
                 registry=None):
        from .. import telemetry
        from ..profile import sanitize_replica

        self.target = target
        self._host, self._port = _parse_target(target)
        self.replica = sanitize_replica(replica) or "unknown"
        if queue_cap is None:
            queue_cap = config.env_int("DEPPY_GPU_OBS_QUEUE", 4096,
                                       strict=False)
        if batch is None:
            batch = config.env_int("DEPPY_GPU_OBS_BATCH", 256,
                                   strict=False)
        if flush_ms is None:
            flush_ms = config.env_float("DEPPY_GPU_OBS_FLUSH_MS", 200.0,
                                        strict=False)
        self._cap = max(int(queue_cap), 1)
        self._batch = max(int(batch), 1)
        self._flush_s = max(float(flush_ms), 1.0) / 1000.0
        backoff_max = config.env_float("DEPPY_GPU_OBS_BACKOFF_MAX_S",
                                       5.0, strict=False)
        self._backoff_max_s = max(float(backoff_max), 0.0)
        self._backoff_s = 0.0     # current hold-off (0 = healthy)
        self._retry_at = 0.0      # monotonic deadline of the hold-off
        self._down = False        # last POST failed
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registry = (registry if registry is not None
                          else telemetry.default_registry())
        reg = self._registry
        self._c_events = reg.counter(
            "deppy_obs_stream_events_total",
            "Telemetry events enqueued for fleet streaming.")
        self._c_dropped = reg.counter(
            "deppy_obs_stream_dropped_total",
            "Telemetry events dropped on a full streamer queue (slow "
            "or dead aggregator) — the backpressure valve; serving "
            "never blocks on observability.")
        self._c_batches = reg.counter(
            "deppy_obs_stream_batches_total",
            "Telemetry batches delivered to the fleet aggregator.")
        self._c_errors = reg.counter(
            "deppy_obs_stream_errors_total",
            "Telemetry batch POSTs that failed (batch dropped, not "
            "requeued).")
        self._c_reconnects = reg.counter(
            "deppy_obs_stream_reconnects_total",
            "Successful POSTs that ended a failed-POST streak: the "
            "streamer resumed after its bounded exponential hold-off.")

    # --------------------------------------------------------- event side

    def __call__(self, event: dict) -> None:
        """The registry-forwarder entry point."""
        self.enqueue(event)

    def enqueue(self, event: dict) -> None:
        with self._lock:
            if len(self._queue) >= self._cap:
                dropped = True
                depth = len(self._queue)
            else:
                self._queue.append(event)
                dropped = False
                depth = len(self._queue)
        if dropped:
            self._c_dropped.inc()
            return
        self._c_events.inc()
        if depth >= self._batch:
            self._wake.set()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # --------------------------------------------------------- drain side

    def start(self) -> None:
        if self._thread is not None:
            return
        self._registry.add_forwarder(self)
        self._thread = threading.Thread(
            target=self._run, name="obs-stream", daemon=True)
        self._thread.start()

    def close(self, drain_s: float = 2.0) -> None:
        """Detach from the registry, flush what's queued, stop."""
        self._registry.remove_forwarder(self)
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=drain_s)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._flush_s)
            self._wake.clear()
            self.flush()
        self.flush()

    def flush(self) -> None:
        """Drain the queue in batches; called from the drain thread and
        from tests.  While a failed-POST hold-off is pending, flush is
        a no-op (events keep queueing, bounded as ever) — except the
        final ``close()`` flush, which bypasses the hold-off for one
        last delivery attempt."""
        while True:
            if self._down and not self._stop.is_set() \
                    and time.monotonic() < self._retry_at:
                return
            with self._lock:
                batch = self._queue[: self._batch]
                del self._queue[: len(batch)]
            if not batch:
                return
            if self._post(batch):
                self._c_batches.inc()
                if self._down:
                    self._down = False
                    self._backoff_s = 0.0
                    self._c_reconnects.inc()
            else:
                self._c_errors.inc()
                base = max(self._flush_s, 0.05)
                grown = self._backoff_s * 2.0 if self._backoff_s \
                    else base
                self._backoff_s = min(grown, self._backoff_max_s) \
                    if self._backoff_max_s else base
                self._retry_at = time.monotonic() + self._backoff_s
                self._down = True
                # This batch is dropped (the queue bound stays real);
                # the REST of the queue waits out the hold-off rather
                # than feeding a dead aggregator batch after batch.
                return
            if len(batch) < self._batch:
                return

    def _post(self, batch: List[dict]) -> bool:
        body = json.dumps({"replica": self.replica,
                           "events": batch}).encode("utf-8")
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=POST_TIMEOUT_S)
        try:
            conn.request("POST", "/fleet/telemetry", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            return 200 <= resp.status < 300
        except (OSError, http.client.HTTPException):
            return False
        finally:
            conn.close()
