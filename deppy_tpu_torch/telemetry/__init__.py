"""Pipeline-wide observability (copy of ``deppy_tpu/telemetry/__init__.py:1-65``).

A dependency-free span/counter/histogram registry plus the structured
per-batch :class:`SolveReport`, threaded through pad/pack → device
transfer → solve → decode by :mod:`deppy_tpu_torch.engine.driver`, and
read back by ``Solver.report`` and ``BatchResolver.last_report``.  The
JSONL event sink is ``DEPPY_GPU_TELEMETRY_FILE`` (or
:func:`configure_sink`).  :mod:`.trace` adds per-request trace contexts
(W3C ``traceparent`` interop), span trees with links across coalesced
dispatches, and the :class:`trace.FlightRecorder`.
"""

from . import trace  # noqa: F401 — re-exported subsystem
from .registry import (
    LANE_BUCKETS,
    RATIO_BUCKETS,
    SECONDS_BUCKETS,
    STAGE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    Span,
    configure_sink,
    default_registry,
    iter_merged_sink_events,
    iter_sink_events,
    percentile,
    set_default_registry,
)
from .report import (
    SolveReport,
    begin_report,
    current_report,
    detach_report,
    end_report,
    last_report,
)

__all__ = [
    "trace",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "SolveReport",
    "LANE_BUCKETS",
    "RATIO_BUCKETS",
    "SECONDS_BUCKETS",
    "STAGE_BUCKETS",
    "begin_report",
    "configure_sink",
    "current_report",
    "default_registry",
    "detach_report",
    "end_report",
    "iter_merged_sink_events",
    "iter_sink_events",
    "last_report",
    "percentile",
    "set_default_registry",
]
