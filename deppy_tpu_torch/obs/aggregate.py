"""Router-side telemetry aggregation (copy of
``deppy_tpu/obs/aggregate.py:1-118``): one merged, replica-stamped sink.

The :class:`Aggregator` is the receiving end of the streaming layer
(:mod:`deppy_tpu_torch.obs.stream`): the router's ``POST /fleet/telemetry``
hands it each ``{"replica": ..., "events": [...]}`` batch, and it
appends every event — stamped ``"replica": <source>`` — to ONE merged
JSONL sink.  The merged sink uses the exact per-event schema of the
per-process sink, plus the ``replica`` stamp, so every existing sink
consumer (:func:`deppy_tpu_torch.telemetry.iter_merged_sink_events`,
:func:`deppy_tpu_torch.profile.report.summarize`) reads it unchanged.

The router's OWN events (its ``router.forward`` hop spans) are
ingested locally via :meth:`ingest_event` stamped ``replica="router"``.
The lock is a plain ``threading`` lock where the reference takes a
lockdep-named one.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional, Tuple

ROUTER_REPLICA = "router"


class Aggregator:
    """Append replica-stamped telemetry events to the merged sink."""

    def __init__(self, sink_path: str, registry=None):
        self.sink_path = sink_path
        self._lock = threading.Lock()
        self._file = None
        self._counts: Dict[str, int] = {}
        self._c_events = self._c_batches = self._c_rejects = None
        if registry is not None:
            self._c_events = registry.counter(
                "deppy_obs_ingest_events_total",
                "Telemetry events ingested into the merged fleet sink, "
                "by source replica.", labelname="replica")
            self._c_batches = registry.counter(
                "deppy_obs_ingest_batches_total",
                "Telemetry batches accepted by POST /fleet/telemetry.")
            self._c_rejects = registry.counter(
                "deppy_obs_ingest_rejects_total",
                "Malformed telemetry batches rejected (bad JSON shape).")

    def ingest(self, doc) -> Tuple[int, Optional[str]]:
        """One ``POST /fleet/telemetry`` body.  Returns
        ``(accepted_count, error)`` — error is a client-facing reason
        string for a 400, None on success."""
        from ..profile import sanitize_replica

        if not isinstance(doc, dict):
            return self._reject("body must be a JSON object")
        events = doc.get("events")
        if not isinstance(events, list):
            return self._reject("'events' must be a list")
        replica = sanitize_replica(doc.get("replica")) or "unknown"
        accepted = 0
        for ev in events:
            if isinstance(ev, dict):
                self.ingest_event(replica, ev, flush=False)
                accepted += 1
        # One flush per accepted batch, not per event: the sink stays
        # tail-readable at the streamers' flush cadence while the
        # aggregator's syscall rate is bounded by batches, not events.
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                except OSError:
                    self._file = None
        if self._c_batches is not None:
            self._c_batches.inc()
        return accepted, None

    def _reject(self, reason: str) -> Tuple[int, str]:
        if self._c_rejects is not None:
            self._c_rejects.inc()
        return 0, reason

    def ingest_event(self, replica: str, event: dict,
                     flush: bool = True) -> None:
        """Stamp + append one event.  The aggregator is authoritative
        for the ``replica`` field: a forged in-event stamp is
        overwritten by the transport-level source."""
        stamped = dict(event)
        stamped["replica"] = replica
        line = json.dumps(stamped) + "\n"
        with self._lock:
            self._counts[replica] = self._counts.get(replica, 0) + 1
            try:
                if self._file is None:
                    self._file = open(self.sink_path, "a",
                                      encoding="utf-8")
                self._file.write(line)
                if flush:
                    self._file.flush()
            except OSError:
                self._file = None
        if self._c_events is not None:
            self._c_events.inc(label=replica)

    def counts(self) -> Dict[str, int]:
        """Events ingested per source replica (for /fleet/status)."""
        with self._lock:
            return dict(self._counts)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
