"""Per-request distributed tracing + flight recorder (copy of ``deppy_tpu/telemetry/trace.py:1-510``).

The port's :class:`registry.Span` enters and leaves every span through
this module, so it comes along with the registry.  The port has no
service or scheduler yet, so nothing activates a context, and every hook
below is one thread-local ``getattr``.  What the module gives once a
caller does:

  * **Trace context.**  One :class:`TraceContext` per request (from an
    inbound W3C ``traceparent`` or ``X-Deppy-Request-Id`` header,
    :func:`context_from_headers`), activated on the handler thread.
    While a context is active, every :class:`registry.Span` opened on
    that thread is stamped with ``trace_id`` / ``span_id`` /
    ``parent_id`` (spans nest via a thread-local span stack), and every
    ``Registry.event`` is stamped and attached to the request's trace —
    the JSONL sink schema stays append-only, untraced callers emit
    byte-identical events.
  * **Cross-thread propagation.**  :func:`capture_parent` snapshots a
    submit's context and :func:`dispatch_scope` re-installs it around a
    coalesced dispatch, whose root span records **span links** to every
    parent request; every span/event it produces is mirrored into each
    parent's trace.
  * **Flight recorder.**  A bounded in-memory ring of the last-N
    completed request traces plus a separate (larger) ring that retains
    *every* errored trace, dumped to the JSONL sink as ``trace`` events
    (:meth:`FlightRecorder.dump`).  The ring sizes are
    ``DEPPY_GPU_TRACE_RING`` and ``DEPPY_GPU_TRACE_ERROR_RING``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# ID formats follow the W3C trace-context wire format: 16-byte trace ids
# and 8-byte span ids, lowercase hex.
_HEX = frozenset("0123456789abcdef")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """Parse a W3C ``traceparent`` header (``00-<trace>-<span>-<flags>``)
    into ``(trace_id, parent_span_id)``; None on anything malformed —
    a bad header must degrade to a minted id, never to a 500."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if not (set(version) <= _HEX and set(trace_id) <= _HEX
            and set(span_id) <= _HEX):
        return None
    # All-zero ids and the reserved version 0xff are invalid per spec.
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


class TraceContext:
    """One trace: a request's (or a coalesced dispatch's) span tree.

    Completed span events and stamped fault/breaker events accumulate on
    the context (thread-safe — the dispatch loop appends while the
    handler thread may be finishing); ``parents`` makes a dispatch
    context mirror everything it records into each request it serves."""

    __slots__ = ("trace_id", "request_id", "parent_span_id",
                 "root_span_id", "spans", "events", "links", "error",
                 "ts", "parents", "_lock")

    def __init__(self, trace_id: Optional[str] = None,
                 request_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 parents: Sequence["ParentRef"] = ()):
        self.trace_id = trace_id or new_trace_id()
        self.request_id = request_id or self.trace_id
        self.parent_span_id = parent_span_id
        self.root_span_id: Optional[str] = None
        self.spans: List[dict] = []
        self.events: List[dict] = []
        self.links: List[dict] = []
        self.error = False
        self.ts = round(time.time(), 3)
        self.parents: Tuple["ParentRef", ...] = tuple(parents)
        self._lock = threading.Lock()

    def note(self, event: dict, kind: str,
             errored: Optional[bool] = None) -> None:
        """Attach one completed span event (or stamped fault/breaker
        event) to this trace, and mirror it into every parent trace.

        Error marking is deliberately narrow: fault events, a breaker
        tripping OPEN, and spans that raised.  Benign breaker recovery
        transitions (``closed`` / ``half_open``) ride the tree without
        flagging healthy requests into the error ring.  A
        ``deadline_exceeded`` fault is lane-scoped: raised under a
        coalesced dispatch (this context has parents) it must NOT flag
        the dispatch's healthy batchmates — the scheduler marks the one
        request whose lane actually expired (:func:`mark_error`);
        raised directly under a request's own trace it flags it."""
        if errored is None:
            if kind == "fault" and event.get("fault") == "deadline_exceeded":
                errored = not self.parents
            else:
                # lockdep violations are incidents like faults: the
                # trace lands in the error ring.
                errored = (kind in ("fault", "lockdep")
                           or (kind == "breaker"
                               and event.get("state") == "open")
                           or "error" in event.get("attrs", {}))
        with self._lock:
            (self.spans if kind == "span" else self.events).append(event)
            if errored:
                self.error = True
        for parent, _span_id in self.parents:
            parent.note(event, kind, errored=errored)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "trace_id": self.trace_id,
                "request_id": self.request_id,
                "ts": self.ts,
                "error": self.error,
                "root_span_id": self.root_span_id,
                "links": list(self.links),
                "spans": list(self.spans),
                "events": list(self.events),
            }


# (context, span_id-to-link-under) — what capture_parent hands across
# the submit → dispatch-loop thread hop.
ParentRef = Tuple[TraceContext, Optional[str]]

_TLS = threading.local()


def current_context() -> Optional[TraceContext]:
    """The trace context active on this thread, if any."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def activate(ctx: TraceContext) -> Iterator[TraceContext]:
    """Make ``ctx`` the active trace on this thread; spans opened inside
    nest under it (the stack starts at the inbound parent span, so a
    proxy-propagated ``traceparent`` parents our root correctly)."""
    prev_ctx = getattr(_TLS, "ctx", None)
    prev_stack = getattr(_TLS, "stack", None)
    _TLS.ctx = ctx
    _TLS.stack = [ctx.parent_span_id] if ctx.parent_span_id else []
    try:
        yield ctx
    finally:
        _TLS.ctx = prev_ctx
        _TLS.stack = prev_stack


def mark_error() -> None:
    """Flag the active trace errored — precise attribution for
    conditions only the caller can see (the scheduler marks the one
    request whose lane was deadline-degraded, not its batchmates)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is not None:
        ctx.error = True


def capture_parent() -> Optional[ParentRef]:
    """Snapshot (active context, current span id) for a thread hop —
    the scheduler stores this on each queued group so the dispatch loop
    can link back to the submitting request."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return None
    stack = getattr(_TLS, "stack", None)
    span_id = stack[-1] if stack else ctx.root_span_id
    return (ctx, span_id)


@contextmanager
def dispatch_scope(
    parents: Sequence[Optional[ParentRef]],
) -> Iterator[Optional[TraceContext]]:
    """Trace scope for one coalesced dispatch.  With no traced parents
    this is a no-op (library callers pay nothing).  An inline dispatch
    on the submitting request's own thread keeps that request's context
    (spans nest naturally, no link indirection).  Otherwise — the
    dispatch-loop thread — a fresh dispatch trace is created whose
    spans/events mirror into every parent request's trace; the caller
    records span links on its root span (see ``TraceContext.links``)."""
    refs = [p for p in parents if p is not None]
    if not refs:
        yield None
        return
    cur = current_context()
    if cur is not None and len(refs) == 1 and refs[0][0] is cur:
        yield None  # inline on the request's own thread
        return
    ctx = TraceContext(parents=refs)
    ctx.links = [{"trace_id": p.trace_id, "span_id": sid}
                 for p, sid in refs]
    with activate(ctx):
        yield ctx


# ------------------------------------------------------------ span hooks
#
# Called by registry.Span.__enter__/__exit__ and Registry._record_span /
# Registry.event.  All no-ops (one getattr) without an active context.


def enter_span(span) -> None:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    span.trace_id = ctx.trace_id
    span.span_id = new_span_id()
    span.parent_id = stack[-1] if stack else None
    if ctx.root_span_id is None:
        ctx.root_span_id = span.span_id
    stack.append(span.span_id)


def exit_span(span) -> None:
    if getattr(span, "span_id", None) is None:
        return
    stack = getattr(_TLS, "stack", None)
    if stack and stack[-1] == span.span_id:
        stack.pop()


def note_span_event(span, event: dict) -> None:
    """Stamp a completed span's ids onto its JSONL event and attach it
    to the active trace.  Untraced spans leave the event untouched
    (schema append-only: the new keys are simply absent)."""
    if span.trace_id is None:
        return
    event["trace_id"] = span.trace_id
    event["span_id"] = span.span_id
    if span.parent_id:
        event["parent_id"] = span.parent_id
    if span.links:
        event["links"] = list(span.links)
    ctx = getattr(_TLS, "ctx", None)
    if ctx is not None and ctx.trace_id == span.trace_id:
        ctx.note(event, "span")


# Per-process sequence for stamped events: two genuinely distinct fault
# events can be field-identical (two lanes expiring in the same ms), so
# consumers deduplicating live sink lines against flight-recorder dumps
# need an identity that distinguishes them.  itertools.count's __next__
# is atomic under CPython.
_EVENT_SEQ = itertools.count(1)


def stamp_event(event: dict, kind: str) -> None:
    """Stamp an ad-hoc registry event (fault / breaker / deadline) with
    the active trace's ids, a per-process ``seq``, and attach it to the
    trace — this is how the fault layer's retries, group splits, host
    routing, and breaker transitions land on the request's span tree."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return
    stack = getattr(_TLS, "stack", None)
    event["trace_id"] = ctx.trace_id
    event["seq"] = next(_EVENT_SEQ)
    if stack and stack[-1]:
        event["parent_id"] = stack[-1]
    ctx.note(event, kind)


# --------------------------------------------------------- request entry


def context_from_headers(traceparent: Optional[str] = None,
                         request_id: Optional[str] = None) -> TraceContext:
    """Build a request's context from its inbound headers: a valid W3C
    ``traceparent`` wins (its trace id is adopted and our root span
    parents under the caller's span); else ``X-Deppy-Request-Id`` (used
    verbatim as the request id, and as the trace id when it already is
    one); else both ids are minted."""
    rid = request_id.strip() if request_id else None
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        trace_id, parent_span_id = parsed
        return TraceContext(trace_id=trace_id, request_id=rid or trace_id,
                            parent_span_id=parent_span_id)
    if rid:
        low = rid.lower()
        trace_id = low if len(low) == 32 and set(low) <= _HEX else None
        return TraceContext(trace_id=trace_id, request_id=rid)
    return TraceContext()


def traceparent_of(ctx: TraceContext) -> str:
    """The ``traceparent`` a response echoes: our trace, our root span."""
    return f"00-{ctx.trace_id}-{ctx.root_span_id or new_span_id()}-01"


# -------------------------------------------------------- flight recorder

DEFAULT_RING = 64
DEFAULT_ERROR_RING = 256


def _env_cap(name: str, default: int) -> int:
    try:
        return max(int(os.environ.get(name, "") or default), 1)
    except ValueError:
        return default


class FlightRecorder:
    """Bounded in-memory ring of completed request traces.

    Two rings: ``capacity`` recent traces of any outcome, and a separate
    ``error_capacity`` ring holding only errored traces (HTTP >= 400
    other than deliberate 503 load sheds, fault/breaker events, deadline
    expiries) so a burst of healthy traffic — or of sheds — can never
    evict the one trace that explains an incident.
    """

    def __init__(self, capacity: Optional[int] = None,
                 error_capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None \
            else _env_cap("DEPPY_GPU_TRACE_RING", DEFAULT_RING)
        self.error_capacity = error_capacity if error_capacity is not None \
            else _env_cap("DEPPY_GPU_TRACE_ERROR_RING", DEFAULT_ERROR_RING)
        self._lock = threading.Lock()
        # Rings keyed by a per-record sequence number, NOT the trace id:
        # several requests legitimately share one inbound W3C trace id
        # (a proxy fanning out under one distributed trace), and keying
        # by it would let a later request — or a successful retry —
        # silently overwrite an earlier (possibly errored) record.
        self._seq = 0
        self._ring: "Dict[int, dict]" = {}     # insertion-ordered
        self._errors: "Dict[int, dict]" = {}

    def record(self, ctx: TraceContext, status: Optional[int] = None,
               timings: Optional[dict] = None) -> dict:
        """File one completed request's trace; returns the stored dict."""
        trace = ctx.to_dict()
        trace["status"] = status
        if timings:
            trace["timings"] = {k: round(float(v), 6)
                                for k, v in timings.items()}
        # 503 is deliberate load shedding (queue depth / open breaker /
        # unmeetable deadline), not a request failure: a shed burst must
        # not flood the error ring (evicting real incident traces) or
        # pay a sink write per rejection on the shedding path.  Sheds
        # whose trace carries a fault event (e.g. the unmeetable-
        # deadline counter) still arrive with ctx.error already set.
        errored = bool(trace["error"]
                       or (status is not None and status >= 400
                           and status != 503))
        trace["error"] = errored
        with self._lock:
            self._seq += 1
            key = self._seq
            self._ring[key] = trace
            while len(self._ring) > self.capacity:
                del self._ring[next(iter(self._ring))]
            if errored:
                self._errors[key] = trace
                while len(self._errors) > self.error_capacity:
                    del self._errors[next(iter(self._errors))]
        if errored:
            # Errored traces go to the JSONL sink the moment they
            # complete (no-op without a sink): the requests that rode a
            # breaker-tripping dispatch finish recording only AFTER the
            # trip, so a dump-at-open alone could never contain them —
            # this is what actually puts incident traces on disk before
            # any operator restart.
            self._emit(trace, reason="error")
        return trace

    def _emit(self, trace: dict, reason: str) -> None:
        from .registry import default_registry

        reg = default_registry()
        # Forwarders count as an output: a fleet replica streaming to
        # the aggregator dumps into the merged sink even
        # with no local sink file configured.
        if reg.sink_path is None and not reg.forwarding:
            return
        reg.emit({"ts": round(time.time(), 3), "kind": "trace",
                  "reason": reason, "trace": trace})

    def get(self, trace_or_request_id: str) -> Optional[dict]:
        """Lookup by trace id or request id (the ``?id=`` parameter);
        with several records under one shared trace id, the most recent
        wins (the index at ``/debug/traces`` lists each separately)."""
        wanted = trace_or_request_id
        best_key = -1
        best = None
        with self._lock:
            for ring in (self._ring, self._errors):
                for key, trace in ring.items():
                    if key > best_key and (
                            trace["trace_id"] == wanted
                            or trace.get("request_id") == wanted):
                        best_key, best = key, trace
        return best

    def traces(self) -> List[dict]:
        """Every retained trace, most recent first (error-ring entries
        evicted from the main ring included, deduplicated)."""
        with self._lock:
            merged = dict(self._errors)
            merged.update(self._ring)
            return [merged[k] for k in sorted(merged, reverse=True)]

    def summaries(self) -> List[dict]:
        """Index view for the ``/debug/traces`` listing."""
        return [{
            "trace_id": t["trace_id"],
            "request_id": t["request_id"],
            "ts": t["ts"],
            "status": t.get("status"),
            "error": t["error"],
            "spans": len(t["spans"]),
        } for t in self.traces()]

    def dump(self, reason: str = "") -> int:
        """Write every retained trace to the default registry's JSONL
        sink as ``trace`` events (no-op without a sink); returns the
        number written.  Triggered by SIGUSR2 and by breaker-open —
        the breaker-open dump preserves the *healthy* context leading
        up to a trip; the incident requests themselves (still in
        flight at trip time) land via the errored-trace write in
        :meth:`record`."""
        from .registry import default_registry

        reg = default_registry()
        if reg.sink_path is None and not reg.forwarding:
            return 0
        traces = self.traces()
        for trace in traces:
            self._emit(trace, reason=reason)
        return len(traces)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._errors.clear()


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> FlightRecorder:
    """The process-wide flight recorder (one service, one black box)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
    return _DEFAULT


def set_default_recorder(
        recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Swap the process recorder (tests); returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, recorder
    return prev


def notify_breaker_open() -> None:
    """Breaker-open hook: dump the flight recorder to the JSONL sink so
    the traces that *led up to* the trip are on disk before the host-only
    window (and any operator restart) discards them.  Never raises — the
    breaker's own transition must not die to observability."""
    try:
        default_recorder().dump(reason="breaker_open")
    # deppy: lint-ok[exception-hygiene] the breaker transition must never die to observability
    except Exception:
        pass
