"""Cross-request continuous-batching scheduler (port of ``deppy_tpu/sched/scheduler.py:1-2144``, its cold serving path).

One :class:`Scheduler` sits between request producers (``BatchResolver``
callers, one thread each) and the engine driver.  Producers call
:meth:`Scheduler.submit` and block; a single dispatch-loop thread drains
the queue into coalesced dispatches, so concurrent traffic shares one
pad/pack, upload and set of kernel launches instead of paying one each.

  * **Size-class-aware micro-batch queue.**  Each submit becomes one
    *group* (its problems never split across dispatches).  Groups carry
    a size class — the power-of-two bucket of their largest
    ``driver._cost_proxy`` value, the cost proxy ``partition_buckets``
    splits on — and a flush coalesces only same-class, same-budget
    groups, so one giant catalog never inflates every lane of a burst
    of tiny ones.
  * **Max-wait / max-fill flush.**  A flush fires when the head group
    has waited ``max_wait_ms`` (a lone request keeps low latency) or the
    head's class has ``max_fill`` lanes queued (a burst fills lanes).
  * **Deadlines.**  Each lane carries its request's
    :class:`faults.Deadline` object (captured on the submitting thread,
    ambient env deadline included).  Expired lanes degrade to
    ``Incomplete`` at triage — their coalesced batchmates dispatch
    unharmed — and the dispatch runs under the *loosest* live lane's
    deadline scope, so no batchmate is cut short by a stranger's tighter
    budget.
  * **Result cache.**  Misses queue; hits (:mod:`.cache`) bypass the
    queue entirely and cost zero engine steps.
  * **Admission.**  :meth:`admission_retry_after` turns queue depth
    beyond ``max_depth`` into a Retry-After estimate, per tenant under
    the weighted-fair gate (:mod:`.fair`), with priority lanes at the
    flush head.

``backend="device"`` (the default) runs each flush through
``driver.solve_problems(..., device=self.device)`` — the CUDA kernels on
``"cuda"``, their plain versions on ``"cpu"``; a failed build or launch
raises inside the dispatch and reaches every coalesced submitter.
``backend="host"`` drains through the host engine
(:func:`deppy_tpu_torch.hostpool.solve_inline`; the worker pool is
ROADMAP A5.3).

Left out, each with the ROADMAP item that brings it (the parameters keep
the reference's names and raise ``NotImplementedError`` when set; each
tier stays off until then): the incremental tier and warm class (A5.4),
portfolio racing (A5.2), speculation, optimize probes and route shadows
(A5.6), sessions and the ``immediate`` head (A5.5), the serving mesh
(A6), and the ``auto`` backend, its probe and the breaker (A7).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

from .. import faults, hostpool, telemetry
from ..sat.constraints import Variable
from ..sat.encode import Problem, encode
from ..sat.errors import Incomplete, InternalSolverError, NotSatisfiable
from ..sat.solver import check_backend
from .cache import MISS, ResultCache, fingerprint
from .fair import TenantPolicy

# Knob defaults; the env mirrors are DEPPY_GPU_SCHED_MAX_WAIT_MS,
# DEPPY_GPU_SCHED_MAX_FILL, DEPPY_GPU_SCHED_MAX_DEPTH and
# DEPPY_GPU_CACHE_SIZE.
DEFAULT_MAX_WAIT_MS = 5.0
DEFAULT_MAX_FILL = 256
DEFAULT_CACHE_SIZE = 1024
DEFAULT_MAX_DEPTH = 4096

_OFF = ("off", "0", "false", "no")

# Parameters of tiers not ported yet, with the ROADMAP item of each: any
# value but None raises.  incremental, portfolio and speculate also take
# their "off" spellings.
_LEFT_OUT = {
    "incremental": "A5.4 (the incremental tier)",
    "incremental_max_delta": "A5.4 (the incremental tier)",
    "incremental_index_size": "A5.4 (the incremental tier)",
    "portfolio": "A5.2 (engine registry and portfolio racing)",
    "portfolio_k": "A5.2 (engine registry and portfolio racing)",
    "portfolio_sample_check": "A5.2 (engine registry and portfolio racing)",
    "speculate": "A5.6 (speculative pre-resolution)",
    "speculate_max_backlog": "A5.6 (speculative pre-resolution)",
    "mesh": "A6 (mesh serving)",
    "mesh_devices": "A6 (mesh serving)",
    "lanes_per_device": "A6 (mesh serving)",
}


def _env_int(name: str, default: int) -> int:
    v = faults.env_float(name, float(default), warn=True)
    return int(v if v is not None else default)


class _Lane:
    """One problem awaiting dispatch, plus its result slot.

    ``degraded`` marks a lane the deadline triage actually expired —
    distinct from a budget-exhaustion ``Incomplete``.  ``tenant`` is the
    submitting request's, carried per lane so a deadline expiry at
    triage attributes to the tenant whose lane expired."""

    __slots__ = ("problem", "key", "max_steps", "budget", "deadline",
                 "result", "steps", "degraded", "backtracks", "tenant")

    def __init__(self, problem: Problem, key: str,
                 max_steps: Optional[int], budget: int, deadline,
                 tenant: str = "default"):
        self.problem = problem
        self.key = key
        self.max_steps = max_steps
        self.budget = budget
        self.deadline = deadline  # faults.Deadline or None
        self.result = None
        self.steps = 0
        self.degraded = False
        # The solve's search-backtrack count, None until a path that
        # measures it reports in.
        self.backtracks = None
        self.tenant = tenant


class _Group:
    """All queued lanes of one submit() call — flushed atomically.

    ``parent`` carries the submitting request's trace context across the
    thread hop to the dispatch loop, so a coalesced dispatch can link
    back to every request it serves; ``timing`` receives the request's
    queue-wait/dispatch/solve/decode breakdown.  Groups are
    single-tenant (one submit = one request = one tenant)."""

    __slots__ = ("lanes", "enq_t", "size_class", "budget", "event",
                 "error", "report", "parent", "timing", "tenant",
                 "priority")

    def __init__(self, lanes: List[_Lane], size_class: int, budget: int,
                 priority: int = 1):
        self.lanes = lanes
        self.enq_t = time.monotonic()
        self.size_class = size_class
        self.budget = budget
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.report = None
        self.parent = telemetry.trace.capture_parent()
        self.timing: dict = {}
        self.tenant = lanes[0].tenant if lanes else "default"
        self.priority = priority


def _apply_lane_result(lane: _Lane, r, point: str) -> None:
    """Decode one HostLaneResult onto its lane — the host drain's decode
    convention (:func:`deppy_tpu_torch.hostpool.lane_answer`)."""
    if r.degraded:
        faults.note_deadline_exceeded(point, tenant=lane.tenant)
        lane.result = Incomplete()
        lane.degraded = True
        return
    lane.result = hostpool.lane_answer(lane.problem, r)
    lane.steps = r.steps
    lane.backtracks = r.backtracks


class Scheduler:
    """Coalesce concurrent resolve requests into shared dispatches."""

    def __init__(
        self,
        backend: str = "device",
        device="cuda",
        max_steps: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        max_fill: Optional[int] = None,
        cache_size: Optional[int] = None,
        max_depth: Optional[int] = None,
        registry: Optional[telemetry.Registry] = None,
        mesh=None,
        mesh_devices: Optional[int] = None,
        lanes_per_device: Optional[int] = None,
        incremental: Optional[str] = None,
        incremental_max_delta: Optional[float] = None,
        incremental_index_size: Optional[int] = None,
        portfolio: Optional[str] = None,
        portfolio_k: Optional[int] = None,
        portfolio_sample_check: Optional[float] = None,
        speculate: Optional[str] = None,
        speculate_max_backlog: Optional[int] = None,
        fair: Optional[str] = None,
        tenant_weights: Optional[str] = None,
    ):
        given = dict(
            incremental=incremental,
            incremental_max_delta=incremental_max_delta,
            incremental_index_size=incremental_index_size,
            portfolio=portfolio, portfolio_k=portfolio_k,
            portfolio_sample_check=portfolio_sample_check,
            speculate=speculate,
            speculate_max_backlog=speculate_max_backlog,
            mesh=mesh, mesh_devices=mesh_devices,
            lanes_per_device=lanes_per_device)
        for name, value in given.items():
            if value is None or (
                    name in ("incremental", "portfolio", "speculate")
                    and str(value).strip().lower() in _OFF):
                continue
            raise NotImplementedError(
                f"Scheduler({name}=...) is not ported yet: ROADMAP "
                f"{_LEFT_OUT[name]}")
        self.backend = check_backend(backend)
        self.device = device
        self.max_steps = max_steps
        if max_wait_ms is None:
            max_wait_ms = faults.env_float(
                "DEPPY_GPU_SCHED_MAX_WAIT_MS", DEFAULT_MAX_WAIT_MS,
                warn=True)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        if max_fill is None:
            max_fill = _env_int("DEPPY_GPU_SCHED_MAX_FILL",
                                DEFAULT_MAX_FILL)
        self.max_fill = max(int(max_fill), 1)
        if max_depth is None:
            max_depth = _env_int("DEPPY_GPU_SCHED_MAX_DEPTH",
                                 DEFAULT_MAX_DEPTH)
        self.max_depth = int(max_depth)
        if cache_size is None:
            cache_size = _env_int("DEPPY_GPU_CACHE_SIZE",
                                  DEFAULT_CACHE_SIZE)
        self._registry = registry if registry is not None \
            else telemetry.default_registry()
        self.cache = ResultCache(cache_size, registry=self._registry)
        # Weighted-fair per-tenant admission + priority lanes.  "off"
        # restores the global-depth-only gate and strict FIFO flush
        # head; "on" (the default) is identical while one tenant is
        # queued — the fairness math only bites under contention.
        if fair is None:
            fair = os.environ.get("DEPPY_GPU_SCHED_FAIR", "on")
        self.fair = str(fair).strip().lower() not in _OFF
        if tenant_weights is None:
            tenant_weights = os.environ.get(
                "DEPPY_GPU_SCHED_TENANT_WEIGHTS")
        self.tenant_policy = TenantPolicy.from_spec(tenant_weights)
        # Queued lanes per tenant (CV-guarded).
        self._tenant_depth: dict = {}
        reg = self._registry
        self._c_tenant_sheds = reg.counter(
            "deppy_sched_tenant_sheds_total",
            "Admissions shed by the weighted-fair per-tenant gate, by "
            "tenant (the offender's 503s; victims under their share "
            "keep admitting).", labelname="tenant")
        self._g_depth = reg.gauge(
            "deppy_sched_queue_depth",
            "Problems queued for a coalesced dispatch right now.")
        self._g_depth.set(0)
        self._h_coalesced = reg.histogram(
            "deppy_sched_coalesced_batch_size",
            "Problems per coalesced scheduler dispatch.",
            buckets=telemetry.LANE_BUCKETS)
        self._c_dispatches = reg.counter(
            "deppy_sched_dispatches_total",
            "Coalesced dispatch groups drained from the queue.")
        self._c_requests = reg.counter(
            "deppy_sched_coalesced_requests_total",
            "Requests (submit calls) served per drained dispatch.")
        self._c_flushes = reg.counter(
            "deppy_sched_flushes_total",
            "Queue flushes by trigger (wait = max-wait elapsed, fill = "
            "lane target reached, drain = shutdown, inline = loop not "
            "running).", labelname="reason")
        # Condition over an RLock: ``running`` re-enters it from
        # ``_enqueue``.
        self._cv = threading.Condition()
        self._queue: List[_Group] = []
        self._depth = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # EWMA of dispatch wall clock, seeding the Retry-After estimate.
        self._dispatch_ewma_s = 0.05

    # -------------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Start the dispatch-loop thread (idempotent)."""
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="deppy-sched", daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop; queued groups drain (dispatch) first so no
        submitter is left hanging.  Submits after stop dispatch
        inline."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        with self._cv:
            self._thread = None

    @property
    def running(self) -> bool:
        # Under the CV: _thread/_stop are written by start()/stop() on
        # other threads, and a torn pair here could route a submit
        # inline while the loop drains the same group.
        with self._cv:
            t = self._thread
            return t is not None and t.is_alive() and not self._stop

    # ------------------------------------------------------------- admission

    def queue_depth(self) -> int:
        with self._cv:
            return self._depth

    def admission_retry_after(
            self, tenant: str = "default") -> Optional[float]:
        """Seconds a client should back off, or None to admit.

        With the fair gate off this is a GLOBAL check: shed everyone
        once total depth reaches ``max_depth``.  With it on the shed is
        PER TENANT: a tenant sheds once its own queued lanes reach its
        weighted share of ``max_depth`` among the tenants queued right
        now, with a hard GLOBAL backstop at 2x ``max_depth`` (tenant
        labels are client-controlled).  The estimate is the number of
        flushes needed to drain the relevant backlog times the recent
        dispatch wall clock (EWMA), floored at 1s."""
        if self.max_depth <= 0:
            return None
        with self._cv:
            depth = self._depth
            ewma = self._dispatch_ewma_s
            if self.fair:
                t_depth = self._tenant_depth.get(tenant, 0)
                active = [t for t, n in self._tenant_depth.items()
                          if n > 0]
            else:
                t_depth, active = depth, []
        if not self.fair:
            if depth < self.max_depth:
                return None
        elif depth >= 2 * self.max_depth:
            self._c_tenant_sheds.inc(label=tenant)
            t_depth = max(t_depth, depth)
        else:
            cap = self.tenant_policy.cap(tenant, self.max_depth, active)
            if t_depth < cap:
                return None
            self._c_tenant_sheds.inc(label=tenant)
        flushes = max(t_depth / float(self.max_fill), 1.0)
        return max(flushes * ewma, 1.0)

    # ---------------------------------------------------------------- submit

    def submit(
        self,
        problem_vars: Sequence[Sequence[Variable]],
        deadline_s: Optional[float] = None,
        max_steps: Optional[int] = None,
        stats: Optional[dict] = None,
        tenant: str = "default",
    ) -> List[object]:
        """Resolve ``problem_vars`` through the shared queue; blocks
        until every problem has an answer and returns them in input
        order (Solution dict / NotSatisfiable / Incomplete — the
        BatchResolver contract).  ``stats`` receives ``{"steps": N,
        "report": SolveReport-or-None, "timings": {...},
        "deadline_misses": M}``: ``deadline_misses`` counts THIS
        submit's lanes the deadline triage degraded.

        Raises what the unscheduled path raises: DuplicateIdentifier
        from encoding, InternalSolverError for unresolvable references
        (screened here, per lane, BEFORE anything queues — a malformed
        request must never abort a coalesced batchmate's dispatch), and
        whatever its dispatch raised."""
        from ..engine.driver import _budget

        if max_steps is None:
            max_steps = self.max_steps
        budget = int(_budget(max_steps))
        problems = [encode(vs) for vs in problem_vars]
        for p in problems:
            if p.errors:
                raise InternalSolverError(p.errors)
        # Capture the request's effective deadline (explicit scope,
        # enclosing scope, or ambient env) as an OBJECT: its clock keeps
        # ticking across the thread hop to the dispatch loop.
        with faults.deadline_scope(deadline_s), faults.ambient_deadline():
            dl = faults.current_deadline()
        results: List[object] = [None] * len(problems)
        pending: List[tuple] = []
        for i, p in enumerate(problems):
            key = fingerprint(p)
            hit = self.cache.lookup(key, budget)
            if hit is not MISS:
                results[i] = hit  # bypasses the queue entirely
            else:
                pending.append((i, _Lane(p, key, max_steps, budget, dl,
                                         tenant=tenant)))
        steps = 0
        deadline_misses = 0
        report = None
        timing: dict = {}
        if pending:
            prio = (self.tenant_policy.priority(tenant) if self.fair
                    else 1)
            group = self._make_group([lane for _, lane in pending],
                                     budget, priority=prio)
            self._enqueue(group)
            group.event.wait()
            if group.error is not None:
                raise group.error
            # The dispatch's report, shared with every request coalesced
            # into it (the reference's, with one group per submit).
            report = group.report
            timing.update(group.timing)
            for i, lane in pending:
                results[i] = lane.result
                steps += lane.steps
                if lane.degraded:
                    deadline_misses += 1
                    # Only THIS request's lane was triaged expired: flag
                    # this trace, not the batchmates'.
                    telemetry.trace.mark_error()
            qw = group.timing.get("queue_wait_s")
            if qw is not None:
                # Recorded on the submitting thread so the span joins
                # THIS request's trace (the wait was measured on the
                # dispatch loop's clock).
                telemetry.default_registry().record_span(
                    "sched.queue_wait", qw, lanes=len(group.lanes))
        if stats is not None:
            stats["steps"] = steps
            stats["report"] = report
            stats["timings"] = dict(timing)
            stats["deadline_misses"] = deadline_misses
        return results

    def _make_group(self, lanes: List[_Lane], budget: int,
                    priority: int = 1) -> _Group:
        from ..engine.driver import _bucket, _cost_proxy

        size_class = _bucket(max(_cost_proxy(l.problem) for l in lanes))
        return _Group(lanes, size_class, budget, priority=priority)

    def _enqueue(self, group: _Group) -> None:
        with self._cv:
            if self.running:
                self._queue.append(group)
                self._depth += len(group.lanes)
                self._tenant_depth[group.tenant] = (
                    self._tenant_depth.get(group.tenant, 0)
                    + len(group.lanes))
                self._g_depth.set(self._depth)
                self._cv.notify_all()
                return
        # No loop thread (library use, or post-shutdown stragglers):
        # dispatch on the caller's thread — same code path, no queue.
        self._dispatch([group], reason="inline")

    # --------------------------------------------------------- dispatch loop

    def _loop(self) -> None:
        try:
            self._loop_inner()
        finally:
            # A normal stop drains the queue through dispatches; this
            # only fires on an unexpected loop crash — fail any still-
            # queued groups loudly so no submitter waits forever.
            with self._cv:
                orphans, self._queue = self._queue, []
                self._depth = 0
                self._tenant_depth.clear()
                self._g_depth.set(0)
            for g in orphans:
                if not g.event.is_set():
                    g.error = RuntimeError(
                        "scheduler dispatch loop exited unexpectedly")
                    g.event.set()

    def _loop_inner(self) -> None:
        while True:
            groups: List[_Group] = []
            reason = None
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._queue:
                    groups, reason = self._drain_locked(force=self._stop)
                    if not groups:
                        head_due = (self._head_locked().enq_t
                                    + self.max_wait_s)
                        delay = head_due - time.monotonic()
                        self._cv.wait(timeout=max(delay, 0.001))
                        continue
            if not groups:
                return  # stopped and drained
            self._dispatch(groups, reason)

    # A queued group older than this many coalescing windows becomes
    # the flush head regardless of priority class: a sustained urgent
    # stream must not starve bulk lanes forever.
    PRIORITY_AGING_WINDOWS = 100

    def _head_locked(self) -> _Group:
        """The next flush head (caller holds the lock): the oldest
        group of the most urgent priority class queued (with every
        group at the default priority this is the FIFO head), unless
        the globally oldest group has aged past PRIORITY_AGING_WINDOWS
        coalescing windows — starvation beats priority."""
        oldest = min(self._queue, key=lambda g: g.enq_t)
        aging_s = max(self.max_wait_s * self.PRIORITY_AGING_WINDOWS,
                      0.5)
        if time.monotonic() - oldest.enq_t >= aging_s:
            return oldest
        return min(self._queue, key=lambda g: (g.priority, g.enq_t))

    def _drain_locked(self, force: bool = False):
        """Pick the flushable group set (caller holds the lock): the
        priority head plus every queued group in its size class and
        budget, up to ``max_fill`` lanes.  Returns ([], None) when no
        flush is due yet."""
        head = self._head_locked()
        take = [head]
        lanes = len(head.lanes)
        for g in self._queue:
            if lanes >= self.max_fill:
                break
            if (g is not head and g.size_class == head.size_class
                    and g.budget == head.budget
                    and lanes + len(g.lanes) <= self.max_fill):
                take.append(g)
                lanes += len(g.lanes)
        if force:
            reason = "drain"
        elif lanes >= self.max_fill:
            reason = "fill"
        elif time.monotonic() - head.enq_t >= self.max_wait_s:
            reason = "wait"
        else:
            return [], None
        taken = set(map(id, take))
        self._queue = [g for g in self._queue if id(g) not in taken]
        self._depth -= lanes
        for g in take:
            left = self._tenant_depth.get(g.tenant, 0) - len(g.lanes)
            if left > 0:
                self._tenant_depth[g.tenant] = left
            else:
                self._tenant_depth.pop(g.tenant, None)
        self._g_depth.set(self._depth)
        return take, reason

    def _dispatch(self, groups: List[_Group], reason: str) -> None:
        lanes = [lane for g in groups for lane in g.lanes]
        t0 = time.monotonic()
        report = None
        timing: dict = {}
        # Everything — telemetry included — runs inside the try: the
        # finally below is the only thing standing between a failure
        # here and submitters parked forever on their group events.
        try:
            for g in groups:
                g.timing["queue_wait_s"] = max(t0 - g.enq_t, 0.0)
            self._c_flushes.inc(label=reason)
            self._c_dispatches.inc()
            self._c_requests.inc(len(groups))
            self._h_coalesced.observe(len(lanes))
            # Trace scope: on the loop thread this is a fresh dispatch
            # trace whose root span LINKS to every parent request;
            # inline (caller-thread) dispatches nest under the request's
            # own trace instead.
            reg = telemetry.default_registry()
            with telemetry.trace.dispatch_scope(
                    [g.parent for g in groups]) as dctx:
                with reg.span("sched.dispatch", lanes=len(lanes),
                              requests=len(groups), reason=reason) as sp:
                    if dctx is not None:
                        for link in dctx.links:
                            sp.link(link["trace_id"],
                                    link.get("span_id"))
                    faults.inject("sched.dispatch")
                    report = self._solve_lanes(lanes, timing)
            for lane in lanes:
                self._maybe_cache(lane)
        except BaseException as e:  # noqa: BLE001 — re-raised per request
            for g in groups:
                g.error = e
        finally:
            dur = time.monotonic() - t0
            # Read-modify-write under the CV: admission_retry_after
            # reads the EWMA from other threads.
            with self._cv:
                self._dispatch_ewma_s = (0.8 * self._dispatch_ewma_s
                                         + 0.2 * dur)
            timing["dispatch_s"] = dur
            for g in groups:
                g.timing.update(timing)
                g.report = report
                g.event.set()

    def _maybe_cache(self, lane: _Lane) -> None:
        r = lane.result
        if isinstance(r, (dict, NotSatisfiable)):
            self.cache.store(lane.key, lane.budget, r)
        elif isinstance(r, Incomplete) and lane.deadline is None:
            # Budget exhaustion is reproducible; deadline degradation
            # is not — only the former may be cached.
            self.cache.store(lane.key, lane.budget, r)

    # -------------------------------------------------------------- solving

    def _solve_lanes(self, lanes: List[_Lane], timing: Optional[dict] = None):
        """Solve one coalesced lane set; fills each lane's result/steps
        and returns the dispatch's SolveReport.  ``timing``, when given,
        receives the solve/decode wall-clock split."""
        if timing is None:
            timing = {}
        live: List[_Lane] = []
        for lane in lanes:
            if lane.deadline is not None and lane.deadline.expired():
                # Expired at triage: degrade THIS lane only — its
                # batchmates dispatch unharmed.
                faults.note_deadline_exceeded("sched.dispatch",
                                              tenant=lane.tenant)
                lane.result = Incomplete()
                lane.steps = 0
                lane.degraded = True
            else:
                live.append(lane)
        if not live:
            return None
        # The dispatch runs under the LOOSEST live deadline (a
        # stranger's tighter budget must not cut a batchmate short).
        # Any unbounded lane means an unbounded dispatch.  The port's
        # driver does not read this scope yet: the reference's recovery
        # wrapper, which decodes a group past its expiry Incomplete,
        # comes with ROADMAP A7, so until then a lane that passed
        # triage is solved to its answer.
        scope = None
        deadlines = [lane.deadline for lane in live]
        if all(d is not None for d in deadlines):
            scope = max(deadlines, key=lambda d: d.remaining())
        rep, owns = telemetry.begin_report(backend=self.backend,
                                           n_problems=len(live))
        try:
            with faults.deadline_scope(scope):
                if self.backend == "host":
                    t1 = time.perf_counter()
                    self._solve_host(live, rep)
                    timing["solve_s"] = time.perf_counter() - t1
                else:
                    self._solve_device(live, timing)
        finally:
            telemetry.end_report(rep, owns)
        return rep

    def _solve_device(self, live: List[_Lane], timing: dict) -> None:
        from ..engine import driver

        problems = [lane.problem for lane in live]
        # All live lanes share one normalized budget (the flush policy
        # only coalesces equal-budget groups); solve_problems merges its
        # telemetry into the report begun above.
        t1 = time.perf_counter()
        results = driver.solve_problems(problems,
                                        max_steps=live[0].max_steps,
                                        device=self.device)
        timing["solve_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        decoded = driver.decode_results(problems, results)
        timing["decode_s"] = time.perf_counter() - t1
        for lane, res, dec in zip(live, results, decoded):
            lane.steps = int(res.steps)
            lane.backtracks = int(res.trace_n)
            lane.result = dec

    def _solve_host(self, live: List[_Lane], rep) -> None:
        """Host-engine drain for ``backend="host"``.  Each LANE's own
        deadline rides along: completed lanes keep their answers,
        expired ones degrade individually."""
        reg = telemetry.default_registry()
        with reg.span("sched.host_solve", problems=len(live)):
            results = hostpool.solve_inline(
                [lane.problem for lane in live],
                max_steps=[lane.max_steps for lane in live],
                deadlines=[lane.deadline for lane in live])
            for lane, r in zip(live, results):
                hostpool.count_lane(rep, r)
                _apply_lane_result(lane, r, "sched.host_solve")
