"""The fleet-wide observability plane (copy of
``deppy_tpu/obs/__init__.py:1-129``).

A fleet of replicas is made observable as one process.  Four layers:

  * **stream** — :class:`~deppy_tpu_torch.obs.stream.TelemetryStreamer`:
    a registry event forwarder that batch-pushes every sink event
    (profile, race, fault, speculate, route, spans) to an aggregator
    endpoint (``POST /fleet/telemetry`` on the router).  Bounded queue
    with counted drops — a slow aggregator can never stall serving.
    Disarmed is byte-identical to the local-sink-only pipeline.
  * **aggregate** — :class:`~deppy_tpu_torch.obs.aggregate.Aggregator`:
    the router-side ingest that stamps each event with its source
    replica and appends to ONE merged JSONL sink.
  * **federate** — router ``GET /fleet/metrics``: scrape every live
    replica concurrently, merge families under a ``replica`` label, and
    compute the fleet rollups (warm-hit ratio, per-tenant burn rate,
    queue depth, race win share, route health).
  * **drift** — :class:`~deppy_tpu_torch.obs.drift.CostModelWatchdog`:
    fits the effective µs/trip per size class from live ``profile``
    ledger samples and compares it against a baseline artifact; drift
    past the band emits a ``costmodel_drift`` event and pushes the
    ``deppy_costmodel_drift_ratio`` gauge past it.

Capped by :mod:`deppy_tpu_torch.obs.top`: a terminal fleet dashboard
over ``/fleet/metrics`` + ``/fleet/status``.

Armed from Python with :func:`start_streamer` (an aggregator's
``host:port``) and :func:`start_watchdog` (a baseline file), or by the
port's service (``DEPPY_GPU_OBS_STREAM``, ``_BASELINE``) and router
(``DEPPY_GPU_OBS_SINK``: the router's :class:`Aggregator` behind its
``POST /fleet/telemetry``); their CLI flags are ROADMAP A7.2.  The lock is a plain ``threading`` lock
where the reference takes a lockdep-named one.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .aggregate import Aggregator
from .drift import CostModelWatchdog, load_baseline
from .federate import fleet_rollups, merge_scrapes
from .stream import STREAM_FAMILIES, TelemetryStreamer

# Process-wide active components (one serving process = one replica):
# the service's /metrics injects their exposition lines the same way
# the profiler and SLO accountant inject theirs.
_LOCK = threading.Lock()
_STREAMER: Optional[TelemetryStreamer] = None
_WATCHDOG: Optional[CostModelWatchdog] = None


def start_streamer(target: str, replica: Optional[str] = None,
                   flush_ms: Optional[float] = None) -> TelemetryStreamer:
    """Build, register (as a default-registry event forwarder), and
    start the process streamer.  Replaces any previous one."""
    global _STREAMER
    streamer = TelemetryStreamer(target, replica=replica,
                                 flush_ms=flush_ms)
    with _LOCK:
        prev, _STREAMER = _STREAMER, streamer
    if prev is not None:
        prev.close()
    streamer.start()
    return streamer


def start_watchdog(baseline: str,
                   replica: Optional[str] = None
                   ) -> Optional[CostModelWatchdog]:
    """Build and register the process cost-model drift watchdog.
    Returns None (disarmed) when the baseline artifact is unreadable —
    observability must never fail serving."""
    global _WATCHDOG
    watchdog = CostModelWatchdog.from_baseline(baseline, replica=replica)
    if watchdog is None:
        return None
    with _LOCK:
        prev, _WATCHDOG = _WATCHDOG, watchdog
    if prev is not None:
        prev.close()
    watchdog.install()
    return watchdog


def stop_all() -> None:
    """Detach and stop the process streamer + watchdog (server drain)."""
    global _STREAMER, _WATCHDOG
    with _LOCK:
        streamer, _STREAMER = _STREAMER, None
        watchdog, _WATCHDOG = _WATCHDOG, None
    if streamer is not None:
        streamer.close()
    if watchdog is not None:
        watchdog.close()


def render_metric_lines() -> List[str]:
    """Exposition lines for the armed obs components — appended to the
    service ``/metrics`` like the profiler/SLO injections.  Disarmed
    (no streamer, no watchdog) this is exactly []."""
    from .. import telemetry

    with _LOCK:
        streamer, watchdog = _STREAMER, _WATCHDOG
    lines: List[str] = []
    if streamer is not None:
        lines += telemetry.default_registry().render_families(
            STREAM_FAMILIES)
    if watchdog is not None:
        lines += watchdog.render_metric_lines()
    return lines


__all__ = [
    "Aggregator",
    "CostModelWatchdog",
    "STREAM_FAMILIES",
    "TelemetryStreamer",
    "fleet_rollups",
    "load_baseline",
    "merge_scrapes",
    "render_metric_lines",
    "start_streamer",
    "start_watchdog",
    "stop_all",
]
