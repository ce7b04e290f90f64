"""Lightweight span/counter/histogram registry (copy of ``deppy_tpu/telemetry/registry.py:1-606``).

The observability backbone of the solve pipeline: the engine driver and
the SAT facades record into a :class:`Registry`, which renders the
Prometheus text exposition format (the surface upstream deppy's
controller-runtime metrics registry serves, ``main.go:63-64``) and can
mirror every span to a JSONL event sink for offline analysis.

Design constraints, in order:

  * **Cheap when idle.**  Counters are one lock + one add; spans are two
    ``perf_counter`` calls and a dict.  With no sink configured nothing
    is formatted or written — the pipeline's telemetry overhead must
    stay within noise.  No span synchronizes the device: each times
    the host wall, and the driver's existing fetches are where the
    card's work lands.
  * **Thread-safe.**  Callers may observe from several threads while
    another renders.
  * **Deterministic exposition.**  Families render in registration
    order, labeled samples in sorted label order, so scrapes diff
    cleanly and tests can pin exact lines.

The JSONL sink (``DEPPY_GPU_TELEMETRY_FILE``, or :func:`configure_sink`)
receives one object per event::

    {"ts": 1722700000.123, "kind": "span", "name": "driver.pad_pack",
     "dur_s": 0.0123, "attrs": {"problems": 64, "lanes": 64}}
    {"ts": ..., "kind": "report", "report": {...SolveReport...}}

Left out until the analysis tooling is ported: the lock-order proxy of
``deppy_tpu.analysis.lockdep`` (plain ``threading`` locks here).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram buckets for wall-clock seconds: sub-ms dispatch
# overheads through minutes-long giant-catalog solves.
SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# Ratio buckets (fill / waste ratios live in [0, 1]).
RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# Escalation stages: 0 = single-stage, 1 = stage-1 sufficed, 2 = stage-2.
STAGE_BUCKETS = (0.0, 1.0, 2.0, 3.0)
# Lane-count buckets (coalesced batch sizes, queue drains): powers of two
# up to the widest probed dispatch width (scripts/lane_probe.py).
LANE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                512.0, 1024.0, 2048.0, 4096.0)


def iter_sink_events(path: str):
    """Yield one item per non-empty line of a JSONL sink file: the
    parsed event dict, or None for a malformed line (callers count
    those).  The read-side twin of :meth:`Registry.emit`, shared by
    every sink consumer (`deppy stats`/`trace`/`compiles`/`profile`
    and the profiler's report)."""
    # errors="replace": a torn write can leave invalid UTF-8 on the
    # final line of a live sink file — it must count as one malformed
    # line, not raise UnicodeDecodeError mid-summary.
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                yield None
                continue
            yield ev if isinstance(ev, dict) else None


def iter_merged_sink_events(paths):
    """Yield events from several sink files as ONE deduplicated stream
    (`deppy stats/trace/profile --file a.jsonl --file
    b.jsonl` merges replica sinks and the fleet aggregator's merged
    sink without hand-concatenation).  Dedupe keys, in order:

      * stamped events — ``(replica, trace_id, seq)``: ``seq`` is the
        per-process event sequence (telemetry.trace), unique within a
        replica; the ``replica`` stamp (added by the fleet aggregator)
        disambiguates seq collisions across replicas;
      * span events — ``(replica, trace_id, span_id)``;
      * everything else — the event's canonical JSON.

    Malformed lines yield None, like :func:`iter_sink_events`."""
    seen = set()
    for path in paths:
        for ev in iter_sink_events(path):
            if ev is None:
                yield None
                continue
            replica, tid = ev.get("replica"), ev.get("trace_id")
            if ev.get("seq") is not None:
                key = (replica, tid, "e", ev["seq"])
            elif ev.get("kind") == "span" and ev.get("span_id"):
                key = (replica, tid, "s", ev["span_id"])
            else:
                key = json.dumps(ev, sort_keys=True, default=str)
            if key in seen:
                continue
            seen.add(key)
            yield ev


def percentile(sorted_vals, q):
    """Nearest-rank percentile over pre-sorted values (0 on empty) —
    THE percentile statistic, shared by `deppy stats`, the trip
    ledger's lane-work distribution, and the SLO window's p99 so the
    three can never silently diverge."""
    import math

    n = len(sorted_vals)
    if n == 0:
        return 0
    idx = min(max(int(math.ceil(q / 100.0 * n)) - 1, 0), n - 1)
    return sorted_vals[idx]


def _fmt(v) -> str:
    """Sample-value formatting: ints stay ints, floats render via str()
    (matching the service's historical f-string rendering, so pinned
    scrape lines like ``deppy_solve_seconds_total 0.5`` are preserved)."""
    return str(v)


def _fmt_le(bound: float) -> str:
    """Bucket bound label: Prometheus convention ('%g': 0.005, 1, +Inf)."""
    if bound == float("inf"):
        return "+Inf"
    return "%g" % bound


class Counter:
    """Monotonic counter, optionally labeled by one label name.

    Unlabeled: ``inc(n)``.  Labeled: ``inc(n, label_value)``.  Values
    keep their Python numeric type (int stays int) so exposition matches
    the historical hand-rendered lines byte for byte.
    """

    kind = "counter"

    def __init__(self, name: str, help: str, lock,
                 labelname: Optional[str] = None, initial=0):
        self.name = name
        self.help = help
        self._lock = lock
        self.labelname = labelname
        self._value = initial
        self._labeled: Dict[str, int] = {}

    def inc(self, n=1, label: Optional[str] = None) -> None:
        with self._lock:
            if label is None:
                self._value = self._value + n
            else:
                self._labeled[label] = self._labeled.get(label, 0) + n

    def preset(self, *labels: str) -> "Counter":
        """Pre-register label values at 0 so they render before first
        increment (the service's outcome counters always expose all
        three outcomes)."""
        with self._lock:
            for lab in labels:
                self._labeled.setdefault(lab, 0)
        return self

    @property
    def value(self):
        with self._lock:
            if self.labelname is None:
                return self._value
            return dict(self._labeled)

    def _render(self) -> List[str]:
        # The shared registry RLock: re-entrant under render_lines'
        # snapshot, real protection for a standalone render (a
        # concurrent first-time label is a
        # dict-changed-during-iteration away).
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} counter"]
            if self.labelname is None:
                lines.append(f"{self.name} {_fmt(self._value)}")
            else:
                for lab, n in sorted(self._labeled.items()):
                    lines.append(
                        f'{self.name}{{{self.labelname}="{lab}"}} {_fmt(n)}'
                    )
            return lines


class Gauge:
    """Last-write-wins gauge.  Renders only once set (the service's
    verdict gauges are absent until a verdict exists)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._value = None

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value

    def _render(self) -> List[str]:
        with self._lock:
            if self._value is None:
                return []
            return [f"# HELP {self.name} {self.help}",
                    f"# TYPE {self.name} gauge",
                    f"{self.name} {_fmt(self._value)}"]


class Histogram:
    """Fixed-bucket histogram with cumulative (monotonic) bucket counts,
    rendered as the standard ``_bucket``/``_sum``/``_count`` series."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock,
                 buckets: Sequence[float] = SECONDS_BUCKETS):
        self.name = name
        self.help = help
        self._lock = lock
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[str, int]]:
        """(le_label, cumulative_count) per bucket, +Inf last."""
        out = []
        with self._lock:
            running = 0
            for b, c in zip(self.buckets, self._counts):
                running += c
                out.append((_fmt_le(b), running))
            out.append((_fmt_le(float("inf")), running + self._counts[-1]))
        return out

    def _render(self) -> List[str]:
        with self._lock:  # re-entrant: cumulative() re-takes it
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} histogram"]
            for le, n in self.cumulative():
                lines.append(f'{self.name}_bucket{{le="{le}"}} {n}')
            lines.append(f"{self.name}_sum {_fmt(self._sum)}")
            lines.append(f"{self.name}_count {self._count}")
            return lines


class Span:
    """One timed pipeline stage, used as a context manager.

    Attributes set during the span (``sp[\"stage\"] = 2`` or
    ``sp.set(lanes=64)``) ride along into the JSONL event.  Duration is
    available as ``sp.dur_s`` after exit.

    When a trace context is active on the thread
    (:mod:`deppy_tpu_torch.telemetry.trace`), the span is stamped with
    ``trace_id``/``span_id``/``parent_id`` on entry (nesting via the
    thread's span stack) and its completed event joins the request's
    trace; without one, behavior — and the emitted event — is
    byte-identical to the pre-trace schema.
    """

    __slots__ = ("name", "attrs", "_registry", "_t0", "dur_s",
                 "trace_id", "span_id", "parent_id", "links")

    def __init__(self, registry: "Registry", name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._registry = registry
        self._t0 = 0.0
        self.dur_s = 0.0
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None
        self.links: Optional[List[dict]] = None

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def link(self, trace_id: str, span_id: Optional[str] = None) -> None:
        """Record a span link (a causal reference to a span in another
        trace — W3C/OTel links): how a coalesced dispatch points back at
        every request it serves."""
        if self.links is None:
            self.links = []
        link = {"trace_id": trace_id}
        if span_id:
            link["span_id"] = span_id
        self.links.append(link)

    def __enter__(self) -> "Span":
        from . import trace as _trace

        self._t0 = time.perf_counter()
        _trace.enter_span(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from . import trace as _trace

        self.dur_s = time.perf_counter() - self._t0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _trace.exit_span(self)
        self._registry._record_span(self)


class Registry:
    """Metric families + span stream, with optional JSONL sink.

    One lock guards every family (contention is negligible at the
    pipeline's per-batch observation rate, and a single lock keeps
    render atomic).
    """

    def __init__(self, sink_path: Optional[str] = None):
        # RLock: render_lines holds it across every family's _render so a
        # scrape is one consistent snapshot (no torn histograms, no
        # dict-changed-during-iteration from a concurrent first-time
        # label), while the family accessors re-enter it freely.
        self._lock = threading.RLock()
        self._families: Dict[str, object] = {}
        self._order: List[str] = []
        self._sink_lock = threading.Lock()
        self._sink_path = sink_path
        self._sink_file = None
        # Event forwarders: callables handed every emitted
        # event alongside (or instead of) the sink file — the fleet
        # telemetry streamer registers here.  Stored as an immutable
        # tuple swapped atomically under _sink_lock so emit() can read
        # it without taking the lock (empty tuple = pre-obs fast path).
        self._forwarders: Tuple = ()
        # Bounded in-memory span tail for `deppy stats` on a live
        # process and for tests; not a durable record (the sink is).
        self._recent_spans: List[dict] = []
        self._recent_cap = 256

    # ------------------------------------------------------------ families

    def _family(self, cls, name: str, help: str, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, self._lock, **kw)
                self._families[name] = fam
                self._order.append(name)
            elif not isinstance(fam, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            return fam

    def counter(self, name: str, help: str = "",
                labelname: Optional[str] = None, initial=0) -> Counter:
        return self._family(Counter, name, help, labelname=labelname,
                            initial=initial)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = SECONDS_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    # -------------------------------------------------------------- spans

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _record_span(self, span: Span) -> None:
        from . import trace as _trace

        event = {"ts": round(time.time(), 3), "kind": "span",
                 "name": span.name, "dur_s": round(span.dur_s, 6),
                 "attrs": span.attrs}
        _trace.note_span_event(span, event)
        with self._sink_lock:
            self._recent_spans.append(event)
            if len(self._recent_spans) > self._recent_cap:
                del self._recent_spans[: -self._recent_cap]
        self.emit(event)

    def record_span(self, name: str, dur_s: float, **attrs) -> None:
        """Record a span whose duration was measured elsewhere (the
        scheduler's queue-wait: the wait happens on the dispatch loop's
        clock, the span belongs to the submitting request's trace).
        Same stamping/sink path as a context-managed span."""
        sp = Span(self, name, attrs)
        sp.dur_s = dur_s
        from . import trace as _trace

        _trace.enter_span(sp)
        _trace.exit_span(sp)
        self._record_span(sp)

    def recent_spans(self) -> List[dict]:
        with self._sink_lock:
            return list(self._recent_spans)

    def event(self, kind: str, **fields) -> None:
        """Emit one ad-hoc event to the JSONL sink, and — when a trace
        context is active on this thread — stamp it with the trace's ids
        and attach it to the request's trace, sink or not.  The
        reference's fault-domain layer uses this for ``fault`` and
        ``breaker`` events; ``kind`` becomes the event's ``kind`` field
        alongside the usual ``ts``.  With neither a sink nor an active
        trace this stays a two-branch no-op."""
        from . import trace as _trace

        traced = _trace.current_context() is not None
        # deppy: lint-ok[concurrency-discipline] deliberate unlocked fast-path read; emit() re-checks under the lock
        if self._sink_path is None and not traced and not self._forwarders:
            return
        event = {"ts": round(time.time(), 3), "kind": kind, **fields}
        if traced:
            _trace.stamp_event(event, kind)
        self.emit(event)

    # --------------------------------------------------------------- sink

    def configure_sink(self, path: Optional[str]) -> None:
        """Point the JSONL sink at ``path`` (None disables).  The file is
        opened lazily on first event and appended to, one JSON object
        per line."""
        with self._sink_lock:
            if self._sink_file is not None:
                try:
                    self._sink_file.close()
                except OSError:
                    pass
                self._sink_file = None
            self._sink_path = path

    @property
    def sink_path(self) -> Optional[str]:
        with self._sink_lock:
            return self._sink_path

    @property
    def forwarding(self) -> bool:
        """True when at least one event forwarder is registered —
        emitted events have somewhere to go even without a sink file
        (the flight recorder's dump gate checks both)."""
        # deppy: lint-ok[concurrency-discipline] atomic tuple swap; a one-swap-stale verdict only gates a dump
        return bool(self._forwarders)

    def add_forwarder(self, fn) -> None:
        """Register a callable handed every emitted event (the
        reference's fleet telemetry streamer).  Forwarders run before the sink
        write and must never block or raise into the pipeline — emit()
        swallows their exceptions."""
        with self._sink_lock:
            if fn not in self._forwarders:
                self._forwarders = self._forwarders + (fn,)

    def remove_forwarder(self, fn) -> None:
        with self._sink_lock:
            self._forwarders = tuple(
                f for f in self._forwarders if f is not fn)

    def emit(self, event: dict) -> None:
        """Append one event object to the sink, if configured, and hand
        it to every registered forwarder.  Sink I/O failures disable
        the sink rather than failing the solve — the pipeline must
        never die to observability."""
        # Forwarders first: streaming works without a local sink.  The
        # tuple is swapped atomically, so the unlocked read sees a
        # consistent (possibly one-swap-stale) set.
        # deppy: lint-ok[concurrency-discipline] atomic tuple swap; emit must not serialize on the sink lock
        for fn in self._forwarders:
            try:
                fn(event)
            # deppy: lint-ok[exception-hygiene] a broken forwarder must never fail the solve; the streamer counts its own errors
            except Exception:
                pass
        # deppy: lint-ok[concurrency-discipline] double-checked: the unlocked read only skips work, the locked one decides
        if self._sink_path is None:
            return
        with self._sink_lock:
            if self._sink_path is None:
                return
            try:
                if self._sink_file is None:
                    self._sink_file = open(self._sink_path, "a",
                                           encoding="utf-8")
                self._sink_file.write(json.dumps(event) + "\n")
                self._sink_file.flush()
            except OSError:
                self._sink_path = None
                self._sink_file = None

    # ------------------------------------------------------------- render

    def render_lines(self) -> List[str]:
        with self._lock:
            lines: List[str] = []
            for name in self._order:
                lines.extend(self._families[name]._render())
            return lines

    def render_families(self, names: Sequence[str]) -> List[str]:
        """Exposition lines for just the named families, in the given
        order (absent names skipped) — one consistent snapshot, like
        :meth:`render_lines`.  Lets another surface (the service's
        ``/metrics``) mirror a subset of this registry without reaching
        into family internals."""
        with self._lock:
            lines: List[str] = []
            for name in names:
                fam = self._families.get(name)
                if fam is not None:
                    lines.extend(fam._render())
            return lines

    def render(self) -> str:
        return "\n".join(self.render_lines()) + "\n"

    def snapshot(self) -> dict:
        """Plain-dict view of every family (for JSON output / tests)."""
        out: Dict[str, object] = {}
        with self._lock:
            families = [(n, self._families[n]) for n in self._order]
        for name, fam in families:
            if isinstance(fam, Histogram):
                out[name] = {"count": fam.count, "sum": fam.sum}
            else:
                out[name] = fam.value
        return out


_DEFAULT: Optional[Registry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry the pipeline instruments against.  Its
    sink is configured from ``DEPPY_GPU_TELEMETRY_FILE`` at creation;
    :func:`configure_sink` can override later."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Registry(
                    sink_path=os.environ.get("DEPPY_GPU_TELEMETRY_FILE")
                    or None
                )
    return _DEFAULT


def set_default_registry(registry: Optional[Registry]) -> Optional[Registry]:
    """Swap the process-default registry (tests); returns the previous."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, registry
    return prev


def configure_sink(path: Optional[str]) -> None:
    """Point the default registry's JSONL sink at ``path``."""
    default_registry().configure_sink(path)
