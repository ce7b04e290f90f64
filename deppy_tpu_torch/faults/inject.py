"""Deterministic fault injection at named pipeline points (copy of ``deppy_tpu/faults/inject.py:1-301``).

Every recovery path must be exercisable on the CPU, where the card never
actually fails.  This harness scripts the failures: a **fault plan** —
JSON from ``DEPPY_GPU_FAULT_PLAN`` or :func:`configure_plan` — lists
rules matched against named **fault points** the pipeline calls
:func:`inject` at.  The port calls these so far:

  ==========================  ================================================
  point                       where
  ==========================  ================================================
  ``sched.dispatch``          entry of one coalesced scheduler dispatch
                              (an error here fails every coalesced request,
                              and latency stalls the whole flush)
  ``sched.race.<backend>``    entry of one portfolio race entrant (an error
                              loses that entrant the race; every entrant
                              failing falls back to the canonical path)
  ``sched.shadow.<backend>``  entry of one shadow route probe (an error is
                              the probe's ``ok: false`` route event; no
                              answer depends on it).  Like the reference,
                              :data:`KNOWN_POINTS` does not list it, so an
                              env plan naming it warns "unmatched" and
                              still injects
  ``hostpool.dispatch``       entry of one host-pool dispatch (an error
                              degrades the batch to the inline engine)
  ``hostpool.worker_crash``   each chunk sent to a pool worker (an error
                              makes that worker exit mid-task; its lanes
                              retry on a fresh worker)
  ``driver.dispatch``         each device dispatch attempt of one group
                              (an error is retried, split, host-routed and
                              charged to the breaker)
  ``driver.device_put``       the upload of one bucket's tensors to the
                              device (inside an attempt: same recovery)
  ``driver.host_fallback``    entry of a group's host-engine fallback (an
                              error here is the caller's)
  ``checkpoint.save_group``   before one checkpoint group is written (an
                              error models the process dying between
                              completed groups)
  ``sessions.op``             entry of one session operation
  ``service.resolve``         entry of one ``/v1/resolve`` request's
                              resolve (an error is the request's counted
                              500)
  ``fleet.forward``           each router-to-replica HTTP exchange (an
                              error fails that forward before the
                              transport; a drain or join answers 502)
  ``fleet.join_stream``       each warm-state chunk streamed to a joining
                              replica (an error resends the chunk, up to
                              the join's retries)
  ``fleet.arc_flip``          the atomic ring swap of a join, after the
                              stream (an error leaves membership as it
                              was)
  ``router.peer_sync``        each gossip exchange with a peer router (an
                              error is counted, never raised)
  ``driver.shard_dispatch.N`` each dispatch attempt of mesh slot ``N``'s
                              shard (an error charges only that slot's
                              breaker)
  ==========================  ================================================

Every point of the reference's vocabulary (:data:`KNOWN_POINTS`) is
called.  :data:`NOT_YET_CALLED` would name the ROADMAP item that brings a
call site still missing, and the env path warns on a rule that can match
only those; it is empty.

Plan format — an object ``{"faults": [...]}`` or a bare list of rules::

    [{"point": "sched.dispatch", "kind": "error", "times": 1},
     {"point": "sched.dispatch", "kind": "latency", "latency_s": 0.02,
      "times": -1},
     {"point": "sched.*", "kind": "error", "period": 2, "times": 1}]

Rule fields: ``point`` (exact name or fnmatch glob), ``kind``
(``error`` | ``latency``, default ``error``), ``times`` (total firings,
-1 = unlimited, default 1), ``after`` (skip the first K hits),
``period`` (when > 0, fire on the first ``times`` hits of every
``period``-hit cycle), and ``latency_s`` / ``message``.  Hit counting is
per rule, under one lock — deterministic for a given call sequence.

Errors raise :class:`InjectedFault` (a ``RuntimeError``).  Injections
count ``deppy_faults_injected_total{point=}`` and emit ``fault`` events
to the telemetry sink.
"""

from __future__ import annotations

import json
import threading
import time
from fnmatch import fnmatch
from typing import List, Optional, Tuple, Union

from .. import config


# The registered fault-point vocabulary, the reference's whole list, so
# that a plan written for the reference reads the same here: the
# operator plan path (env) warns on rules that match none of them — a
# chaos plan written against a renamed point would otherwise inject
# nothing and report green.  Entries ending ``.*`` are prefixes for
# dynamically-suffixed points (one per mesh device).
KNOWN_POINTS = (
    "driver.dispatch",
    "driver.device_put",
    "driver.host_fallback",
    "driver.shard_dispatch.*",
    "checkpoint.save_group",
    "service.resolve",
    "sched.dispatch",
    "sched.race.*",
    "hostpool.dispatch",
    "hostpool.worker_crash",
    "fleet.forward",
    "fleet.join_stream",
    "fleet.arc_flip",
    "router.peer_sync",
    "sessions.op",
)

# The points of KNOWN_POINTS the port does not call yet, each with the
# ROADMAP item that brings its call site (none since the mesh).  A rule
# that can match only these is named on the env path too: it would
# inject nothing here.
NOT_YET_CALLED: dict = {}


def _matches(rule_point: str, known: str) -> bool:
    return (rule_point == known or fnmatch(known, rule_point)
            or fnmatch(rule_point, known))


def unmatched_points(plan: "FaultPlan") -> List[str]:
    """Rule points that match no registered fault point (exact, or
    either side globbing).  The operator plan paths warn on these; the
    unit-test path (``FaultPlan.from_doc`` with synthetic points) stays
    silent."""
    return [rule.point for rule in plan.rules
            if not any(_matches(rule.point, k) for k in KNOWN_POINTS)]


def uncalled_points(plan: "FaultPlan") -> List[Tuple[str, List[str]]]:
    """Rule points that match registered points but none the port
    calls yet: ``(point, [ROADMAP items])`` per such rule."""
    out = []
    for rule in plan.rules:
        hit = [k for k in KNOWN_POINTS if _matches(rule.point, k)]
        if hit and all(k in NOT_YET_CALLED for k in hit):
            out.append((rule.point,
                        sorted({NOT_YET_CALLED[k] for k in hit})))
    return out


class InjectedFault(RuntimeError):
    """The scripted failure raised at an ``error`` fault point."""


class FaultRule:
    """One scripted fault: where, what, and on which hits."""

    __slots__ = ("point", "kind", "times", "after", "period", "latency_s",
                 "message", "hits", "fired")

    def __init__(self, point: str, kind: str = "error", times: int = 1,
                 after: int = 0, period: int = 0, latency_s: float = 0.0,
                 message: str = ""):
        if kind not in ("error", "latency"):
            raise ValueError(f"fault rule kind must be 'error' or "
                             f"'latency', got {kind!r}")
        self.point = str(point)
        self.kind = kind
        self.times = int(times)
        self.after = max(int(after), 0)
        self.period = max(int(period), 0)
        self.latency_s = float(latency_s)
        self.message = message or f"injected fault at {point}"
        self.hits = 0       # matching inject() calls seen
        self.fired = 0      # times this rule actually fired

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        if not isinstance(d, dict) or "point" not in d:
            raise ValueError(f"fault rule must be an object with a "
                             f"'point' key, got {d!r}")
        unknown = set(d) - {"point", "kind", "times", "after", "period",
                            "latency_s", "message"}
        if unknown:
            raise ValueError(
                f"unknown fault rule keys {sorted(unknown)} in {d!r}")
        return cls(
            point=d["point"], kind=d.get("kind", "error"),
            times=d.get("times", 1), after=d.get("after", 0),
            period=d.get("period", 0), latency_s=d.get("latency_s", 0.0),
            message=d.get("message", ""),
        )

    def should_fire(self, consume: bool = True) -> bool:
        """Advance this rule's hit counter and decide; caller holds the
        plan lock.  ``consume=False`` still advances the schedule but
        leaves the ``times`` budget untouched — used for an error rule
        shadowed by an earlier one on the same hit, so its scripted
        firing isn't silently spent without ever raising."""
        self.hits += 1
        idx = self.hits - 1  # 0-based hit index
        if idx < self.after:
            return False
        idx -= self.after
        if self.period > 0:
            fire = (idx % self.period) < max(self.times, 0) or self.times < 0
        else:
            fire = self.times < 0 or self.fired < self.times
        if fire and consume:
            self.fired += 1
        return fire and consume


class FaultPlan:
    """A parsed, hit-counting set of fault rules."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = rules
        self._lock = threading.Lock()

    @classmethod
    def from_doc(cls, doc: Union[dict, list]) -> "FaultPlan":
        if isinstance(doc, dict):
            doc = doc.get("faults", [])
        if not isinstance(doc, list):
            raise ValueError(
                "fault plan must be a list of rules or "
                '{"faults": [...]}')
        return cls([FaultRule.from_dict(r) for r in doc])

    def check(self, point: str) -> None:
        """Match ``point`` against every rule; sleep for latency rules,
        raise :class:`InjectedFault` for the first error rule that
        fires.  Latency rules evaluated before the error raise, so a
        slow-then-dead fault composes in one plan."""
        sleep_s = 0.0
        error: Optional[FaultRule] = None
        with self._lock:
            for rule in self.rules:
                if rule.point != point and not fnmatch(point, rule.point):
                    continue
                consume = rule.kind == "latency" or error is None
                if not rule.should_fire(consume=consume):
                    continue
                if rule.kind == "latency":
                    sleep_s += rule.latency_s
                else:
                    error = rule
        if sleep_s > 0.0:
            _record(point, "latency", sleep_s=sleep_s)
            time.sleep(sleep_s)
        if error is not None:
            _record(point, "error")
            raise InjectedFault(error.message)


def _record(point: str, kind: str, **attrs) -> None:
    from .. import telemetry
    from .metrics import fault_counter

    fault_counter("deppy_faults_injected_total").inc(1, label=point)
    telemetry.default_registry().event(
        "fault", fault="injected", point=point, fault_kind=kind, **attrs)


# ------------------------------------------------------------ plan plumbing

_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()
_ENV_LOADED = False


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse a plan from inline JSON, ``@file``, or a plain file path
    (anything not starting with ``[`` / ``{`` is treated as a path)."""
    spec = spec.strip()
    if spec.startswith("@"):
        spec = spec[1:]
    if spec and spec[0] not in "[{":
        with open(spec, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    else:
        doc = json.loads(spec)
    return FaultPlan.from_doc(doc)


def plan_from_env() -> Optional[FaultPlan]:
    """Parse ``DEPPY_GPU_FAULT_PLAN`` (inline JSON or a file path);
    unset/empty → None.  A malformed plan raises — a chaos run that
    silently injects nothing would report green without testing
    anything."""
    raw = config.env_raw("DEPPY_GPU_FAULT_PLAN", "").strip()
    if not raw:
        return None
    plan = plan_from_spec(raw)
    _warn_unmatched(plan)
    return plan


def _warn_unmatched(plan: FaultPlan) -> None:
    import sys

    for point in unmatched_points(plan):
        print(f"[deppy] fault-plan rule point {point!r} matches no "
              f"registered fault point ({', '.join(KNOWN_POINTS)}); "
              f"it will never fire", file=sys.stderr, flush=True)
    for point, items in uncalled_points(plan):
        print(f"[deppy] fault-plan rule point {point!r} matches only "
              f"points this package does not call yet (ROADMAP "
              f"{', '.join(items)}); it will never fire",
              file=sys.stderr, flush=True)


def configure_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install the active plan (None disarms); returns the previous."""
    global _PLAN, _ENV_LOADED
    with _PLAN_LOCK:
        prev, _PLAN = _PLAN, plan
        _ENV_LOADED = True  # explicit configuration overrides the env
        return prev


def current_plan() -> Optional[FaultPlan]:
    """The active plan, loading ``DEPPY_GPU_FAULT_PLAN`` on first call."""
    global _PLAN, _ENV_LOADED
    if not _ENV_LOADED:
        with _PLAN_LOCK:
            if not _ENV_LOADED:
                _PLAN = plan_from_env()
                _ENV_LOADED = True
    return _PLAN


def inject(point: str) -> None:
    """The pipeline's fault hook.  No active plan → one global read and
    return; the hot paths never pay more than that."""
    plan = current_plan()
    if plan is not None:
        plan.check(point)
