"""Cross-request continuous-batching scheduler (port of ``deppy_tpu/sched/scheduler.py:1-2144``, its cold and warm serving paths).

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

  * **Portfolio racing.**  A cold flush can race the top-K engine
    backends of its size class (:class:`PortfolioRacer`, ranked by
    :mod:`deppy_tpu_torch.engine.registry`): the first definitive
    finisher wins, a sampled share of non-canonical wins is
    cross-checked against the canonical backend, and lanes whose
    deadline cannot survive the device estimate go to the host pool
    (:meth:`Scheduler._triage_stragglers`).  ``portfolio="auto"`` (the
    default) races only classes with a measured ``portfolio`` row for
    the device's platform; ``"on"`` races wherever two candidates serve
    the class; ``"off"`` constructs no racer.
  * **Incremental tier.**  An exact-cache miss consults a
    :class:`deppy_tpu_torch.incremental.ClauseSetIndex` of solved
    problems (``incremental``, default ``"on"``): a problem within one
    small delta of an indexed one queues in its own size class,
    :data:`INCREMENTAL_CLASS`, and its flush screens the warm prefixes
    on the scheduler's device (more than one lane), runs the survivors'
    warm attempts on the host engine and cold-solves every fallback
    through the normal path.  A warm flush never races.
  * **Sessions.**  :meth:`Scheduler.submit_session` serves one stateful
    session's scoped solve (:class:`deppy_tpu_torch.sessions.SessionStore`):
    the lane skips the shared result cache and clause-set index in both
    directions, plans its warm start against the session's private
    index (the O(delta) ``plan_for_scope`` first, then the generic
    ``plan``), queues in :data:`INCREMENTAL_CLASS` when planned and in
    :data:`SESSION_CLASS` otherwise, and flushes as soon as it reaches
    the head (the ``immediate`` flush reason).
  * **Idle-priority queue.**  :meth:`Scheduler.submit_optimize` queues
    the optimization tier's solves (:class:`deppy_tpu_torch.optimize.Planner`:
    feasibility solves, native bound probes, explains) on a queue of
    their own, which the loop drains only when no live lane is queued
    and no live flush is pending (the ``spec`` flush reason): live
    traffic preempts every probe at a flush boundary.  The submitter
    blocks, and a dispatch error re-raises into it.
  * **Speculative pre-resolution.**  With ``speculate`` on (the
    default), every submitted problem's family is retained by a
    :class:`deppy_tpu_torch.speculate.SpeculationManager`; a catalog
    publish (:meth:`SpeculationManager.publish`) queues the affected
    families' post-publish states through
    :meth:`Scheduler.submit_speculative` on the same idle queue —
    fire-and-forget pre-solves capped at ``speculate_max_backlog``
    lanes, discarded (and counted) at shutdown — whose answers land in
    the result cache and the clause-set index like any other lane's.
  * **Trip profiler.**  The host drain and the warm flush record their
    cost at the profiler's ``host`` and ``warm`` sites
    (:mod:`deppy_tpu_torch.profile`), stamped with the flush's tenant
    when it serves one only.

``backend="device"`` (the default) runs each flush through
``driver.solve_problems(..., device=self.device)`` — the CUDA kernels on
``"cuda"``, their plain versions on ``"cpu"`` — whose fault envelope
retries, splits and host-routes a failed launch and charges the card's
circuit breaker.  A defect of the tree (``driver.TREE_DEFECTS``: a
kernel that does not build, a launch it cannot take, a shape a wrapper
refuses, ``"cuda"`` on a machine without a card) passes through
the envelope and reaches every coalesced submitter, raced or not (a
raced device entrant's defect is re-raised into its flush, or into the
next dispatch when another entrant had already won).
``backend="host"`` drains through the host path's entry
(:func:`deppy_tpu_torch.hostpool.solve_host_problems`: the worker pool,
or inline).  ``backend="auto"`` resolves each flush without blocking
(:func:`deppy_tpu_torch.sat.solver.resolve_backend`): host until the
engine probe's verdict lands (:meth:`Scheduler.start` kicks one in the
background), and while the breaker is open, when a host drain kicks the
deferred re-probe (:meth:`Scheduler._kick_reprobe`,
``DEPPY_GPU_REPROBE`` seconds between failed probes, default 600).
While the breaker blocks the device, the racer offers no device entrant
and the warm screen is skipped.

Left out, each with the ROADMAP item that brings it (the parameters keep
the reference's names and raise ``NotImplementedError`` when set; each
tier stays off until then): route shadows (A5.6.4: ``set_route_plane``,
``submit_shadow``) and the serving mesh (A6: ``mesh``, ``mesh_devices``,
``lanes_per_device``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import faults, hostpool, telemetry
from .. import profile as _profile
from ..sat.constraints import Variable
from ..sat.encode import Problem, encode
from ..sat.errors import Incomplete, InternalSolverError, NotSatisfiable
from ..sat.solver import check_backend, resolve_backend
from .cache import MISS, ResultCache, fingerprint
from .fair import TenantPolicy

# Knob defaults; the env mirrors are DEPPY_GPU_SCHED_MAX_WAIT_MS,
# DEPPY_GPU_SCHED_MAX_FILL, DEPPY_GPU_SCHED_MAX_DEPTH and
# DEPPY_GPU_CACHE_SIZE.
DEFAULT_MAX_WAIT_MS = 5.0
DEFAULT_MAX_FILL = 256
DEFAULT_CACHE_SIZE = 1024
DEFAULT_MAX_DEPTH = 4096
# Portfolio racing: top-K backends raced per cold flush, and the
# deterministic 1-in-N fraction of non-canonical race wins that are
# cross-checked against the canonical backend (the canonical entrant is
# exempted from cancellation on sampled races so its answer exists to
# compare).  Env mirrors: DEPPY_GPU_PORTFOLIO, DEPPY_GPU_PORTFOLIO_K and
# DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK.
DEFAULT_PORTFOLIO_K = 2
DEFAULT_PORTFOLIO_SAMPLE_CHECK = 0.0625
# The incremental tier: clause-set index capacity and the largest cone,
# as a fraction of the problem's variables, a warm start may re-solve.
# Env mirror: DEPPY_GPU_INCREMENTAL (on/off).  The reference's size and
# cutoff knobs come with the CLI that sets them (ROADMAP A7.2).
DEFAULT_INCREMENTAL_INDEX = 512
DEFAULT_INCREMENTAL_MAX_DELTA = 0.25
# Speculative pre-solve lanes queued at idle priority, at most
# (scheduler.py:84).  Env mirrors: DEPPY_GPU_SPECULATE (on/off) and
# DEPPY_GPU_SPECULATE_MAX_BACKLOG.
DEFAULT_SPECULATE_MAX_BACKLOG = 2048

# The "incremental" size class (scheduler.py:91): warm-started lanes
# coalesce with each other — their cost is a handful of host propagation
# passes, not a device dispatch, so padding them into a cold batch's
# lanes would waste device width AND serialize near-lookups behind a
# solve.  Cold classes are power-of-two cost buckets (>= 1), so -1 can
# never collide.
INCREMENTAL_CLASS = -1

# The "session" size class (scheduler.py:93-100): a stateful session's
# cold solves dispatch in their own bucket — they carry assumption-
# conditioned answers that must never coalesce into (or pad out) a
# stateless cold batch, and their results bypass the shared result
# cache entirely (see ``_maybe_cache``).  Warm session lanes ride
# INCREMENTAL_CLASS like any other warm-started lane: the warm flush
# machinery is per-lane and scoped-ness travels on the lane itself.
SESSION_CLASS = -2

_OFF = ("off", "0", "false", "no")

# Parameters of tiers not ported yet, with the ROADMAP item of each: any
# value but None raises.
_LEFT_OUT = {
    "mesh": "A6 (mesh serving)",
    "mesh_devices": "A6 (mesh serving)",
    "lanes_per_device": "A6 (mesh serving)",
}


def _env_int(name: str, default: int) -> int:
    v = faults.env_float(name, float(default), warn=True)
    return int(v if v is not None else default)


def _single_tenant(lanes: List["_Lane"]) -> Optional[str]:
    """The one tenant a flush serves, or None when mixed — profile
    events are tenant-stamped only when attribution is unambiguous."""
    tenants = {lane.tenant for lane in lanes}
    return tenants.pop() if len(tenants) == 1 else None


class _Lane:
    """One problem awaiting dispatch, plus its result slot.

    ``degraded`` marks a lane the deadline triage actually expired —
    distinct from a budget-exhaustion ``Incomplete``.  ``tenant`` is the
    submitting request's, carried per lane so a deadline expiry at
    triage attributes to the tenant whose lane expired."""

    __slots__ = ("problem", "key", "max_steps", "budget", "deadline",
                 "result", "steps", "degraded", "warm", "backtracks",
                 "index_steps", "tenant", "scoped", "session_index")

    def __init__(self, problem: Problem, key: str,
                 max_steps: Optional[int], budget: int, deadline,
                 warm=None, tenant: str = "default"):
        self.problem = problem
        self.key = key
        self.max_steps = max_steps
        self.budget = budget
        self.deadline = deadline  # faults.Deadline or None
        self.result = None
        self.steps = 0
        self.degraded = False
        # The lane's WarmPlan (incremental size class), and the solve's
        # search-backtrack count — None until a path that measures it
        # reports in (the clause-set index seeds warm starts only from
        # zero-backtrack solves, so an unmeasured lane must never be
        # indexed as zero).  ``index_steps`` is the COLD-equivalent step
        # cost to index under when it differs from ``steps``: a
        # warm-served lane's own step count is a fraction of what a cold
        # solve would spend, and indexing it verbatim would erode the
        # budget gate that keeps a warm SAT from shadowing a cold
        # Incomplete at tight budgets.
        self.warm = warm
        self.backtracks = None
        self.index_steps = None
        self.tenant = tenant
        # A scoped lane answers under a session's open assumption stack
        # — its result is assumption-conditioned and must never be
        # admitted to the shared exact LRU or clause-set index (it would
        # poison stateless traffic); instead the model lands in the
        # session's OWN index so the next op warm-starts from the
        # session's last model.
        self.scoped = False
        self.session_index = None


class _Group:
    """All queued lanes of one submit() call — flushed atomically.

    ``parent`` carries the submitting request's trace context across the
    thread hop to the dispatch loop, so a coalesced dispatch can link
    back to every request it serves; ``timing`` receives the request's
    queue-wait/dispatch/solve/decode breakdown.  Groups are
    single-tenant (one submit = one request = one tenant)."""

    __slots__ = ("lanes", "enq_t", "size_class", "budget", "event",
                 "error", "report", "parent", "timing", "speculative",
                 "tenant", "priority", "immediate")

    def __init__(self, lanes: List[_Lane], size_class: int, budget: int,
                 speculative: bool = False, priority: int = 1,
                 immediate: bool = False):
        self.lanes = lanes
        self.enq_t = time.monotonic()
        self.size_class = size_class
        self.budget = budget
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.report = None
        self.parent = telemetry.trace.capture_parent()
        self.timing: dict = {}
        # An idle-priority group (an optimize probe or a pre-solve):
        # queued on the idle queue, drained only when no live lane waits.
        self.speculative = speculative
        self.tenant = lanes[0].tenant if lanes else "default"
        self.priority = priority
        # A blocking interactive lane (a session op) flushes as soon as
        # it reaches the head — a caller is synchronously waiting on ONE
        # lane, so holding it the coalescing window's max-wait buys
        # nothing and costs the whole window.  Batchmates that are
        # already queued still coalesce into the flush.
        self.immediate = immediate


def _apply_lane_result(lane: _Lane, r, point: str,
                       canonical: bool = True) -> None:
    """Decode one HostLaneResult onto its lane — the host drain's decode
    convention (:func:`deppy_tpu_torch.hostpool.lane_answer`), shared by
    the racer's winner and the straggler resubmission so the paths
    cannot drift.  ``canonical=False`` (a race won by a non-canonical
    backend) clears the lane's backtrack observation: the winner's
    count is not the canonical engine's."""
    if r.degraded:
        faults.note_deadline_exceeded(point, tenant=lane.tenant)
        lane.result = Incomplete()
        lane.degraded = True
        return
    lane.result = hostpool.lane_answer(lane.problem, r)
    lane.steps = r.steps
    lane.backtracks = r.backtracks if canonical else None


class _RacePlan:
    """One flush's race decision: the candidate backends and the class
    they were ranked for."""

    __slots__ = ("names", "class_name", "canonical")

    def __init__(self, names: List[str], class_name: str,
                 canonical: str):
        self.names = names
        self.class_name = class_name
        self.canonical = canonical


# Abandoned race losers (a device solve mid-launch, a descent
# mid-certification) must not be killed as daemon threads at interpreter
# teardown while they hold the CUDA runtime.  Every race thread
# registers here and an atexit hook joins the stragglers (bounded:
# losers see the stop flag at their next step boundary; a device solve
# runs out its dispatch).
_RACE_THREADS: List[threading.Thread] = []
_RACE_THREADS_LOCK = threading.Lock()
_RACE_ATEXIT = [False]


def _note_race_thread(t: threading.Thread) -> None:
    with _RACE_THREADS_LOCK:
        _RACE_THREADS[:] = [x for x in _RACE_THREADS if x.is_alive()]
        _RACE_THREADS.append(t)
        if not _RACE_ATEXIT[0]:
            import atexit

            atexit.register(_join_race_threads)
            _RACE_ATEXIT[0] = True


def _join_race_threads(timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    with _RACE_THREADS_LOCK:
        threads = list(_RACE_THREADS)
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))


class PortfolioRacer:
    """First-finisher-wins racing across registered engine backends
    (``scheduler.py:304-599``).

    One coalesced cold flush is dispatched to the top-K candidate
    backends of its size class concurrently, one thread each
    (``deppy-race-<backend>``; :mod:`deppy_tpu_torch.engine.registry`
    ranks them — measured ``portfolio`` rows first, the static
    canonical-first order otherwise); the first DEFINITIVE finisher
    (every lane answered) wins, and the losers are cancelled: host lanes
    check a cooperative stop flag at step boundaries, device solves run
    to completion with their fetch dropped, hostpool dispatches are
    abandoned.  A deterministic 1-in-N sample of non-canonical wins is
    cross-checked against the canonical backend's answer — a mismatch is
    a loud ``race_mismatch`` fault event and the canonical answer is
    served.

    Entrant errors are counted (``deppy_race_entrant_errors_total``,
    by backend) and evented (a ``race_entrant_error`` fault naming the
    error), and an entrant that raises loses the race, as in the
    reference — a device fault seldom gets here, since the driver's
    envelope retries, splits and host-routes it.  The one exception is a
    device entrant whose solve raised a defect of the tree
    (``driver.TREE_DEFECTS``): that error is re-raised into the dispatch
    as racing off would raise it — into this flush when no winner was
    served yet, else into the next flush this racer plans.

    Modes: ``on`` races wherever ≥2 candidates serve the class;
    ``auto`` races only classes with a measured ``portfolio`` row.
    ``off`` never constructs a racer.  Lanes are accounted with
    :func:`deppy_tpu_torch.hostpool.count_lane` (the reference's
    ``_count_lane_outcome``)."""

    def __init__(self, mode: str, k: int, sample_check: float,
                 registry: "telemetry.Registry", device="cuda"):
        self.mode = mode
        self.k = max(int(k), 2)
        self.device = device
        rate = max(float(sample_check), 0.0)
        self._check_interval = (int(round(1.0 / min(rate, 1.0)))
                                if rate > 0 else 0)
        # Non-canonical wins since the last cross-check.  The sampling
        # contract is 1-in-N NON-CANONICAL WINS (not 1-in-N races —
        # counting races would let deterministic aliasing against the
        # flush pattern starve the check forever); seeded so the very
        # FIRST non-canonical win is checked.  The cancel exemption
        # must be decided before racing, so the check arms whenever
        # the next non-canonical win would be the Nth.
        self._check_lock = threading.Lock()
        self._since_check = max(self._check_interval - 1, 0)
        self._registry = registry
        # A device entrant's error that arrived after its race was
        # decided; raised by the next plan() (under _check_lock).
        self._device_error: Optional[BaseException] = None

    # ------------------------------------------------------------- plan

    def plan(self, live: List[_Lane], backend: str) -> Optional[_RacePlan]:
        """Decide whether THIS flush races: candidate backends for its
        ladder class, capability- and availability-filtered.  None
        means the canonical single-backend path runs untouched.  Raises
        a device entrant's error that landed after its race was decided
        (the flush fails as a canonical dispatch on that device would)."""
        from ..engine import registry as engine_registry
        from ..engine.driver import padded_class

        with self._check_lock:
            err, self._device_error = self._device_error, None
        if err is not None:
            raise err
        class_name = padded_class([lane.problem for lane in live])
        device_ok = (backend != "host"
                     and not faults.default_breaker().blocks_device())
        need_card = any(lane.problem.card_act.shape[0] > 0
                        and (lane.problem.card_act >= 0).any()
                        for lane in live)
        names, measured = engine_registry.candidates(
            class_name, self.k, device_ok=device_ok,
            cardinality=need_card, device=self.device)
        if self.mode == "auto" and not measured:
            return None
        if len(names) < 2:
            return None
        canonical = "host" if backend == "host" else "device"
        if canonical == "device" and not device_ok:
            canonical = "host"
        return _RacePlan(names, class_name, canonical)

    # ------------------------------------------------------------- race

    def race(self, plan: _RacePlan, live: List[_Lane], rep,
             timing: dict) -> bool:
        """Run one race.  Returns True when a winner's results were
        applied to the lanes (and merged into ``rep``); False when no
        entrant finished definitively — the caller falls back to the
        canonical path exactly as if racing were off."""
        from ..engine import registry as engine_registry
        from ..engine.driver import TREE_DEFECTS
        from ..sat.host import SolveCancelled

        reg = self._registry
        problems = [lane.problem for lane in live]
        deadlines = [lane.deadline for lane in live]
        dl = faults.current_deadline()
        stop = threading.Event()
        with self._check_lock:
            check = (self._check_interval > 0
                     and plan.canonical in plan.names
                     and self._since_check + 1 >= self._check_interval)
        cv = threading.Condition()
        finished: List[tuple] = []  # (name, dt, out, err, srep) in
        #                             completion order
        failed: List[BaseException] = []  # device solve errors
        decided = [False]  # under cv: the race has returned

        def run(name: str, t0: float) -> None:
            srep, owns = telemetry.begin_report(backend=name)
            out = None
            err = None
            solving = False
            try:
                if stop.is_set() and not (check
                                          and name == plan.canonical):
                    raise SolveCancelled()
                with faults.deadline_scope(dl):
                    faults.inject(f"sched.race.{name}")
                    solving = True
                    out = engine_registry.solve_via(
                        name, problems, max_steps=live[0].max_steps,
                        deadlines=deadlines,
                        cancel=(None if (check and name == plan.canonical)
                                else stop),
                        device=self.device)
                if name != "device" and out is not None:
                    # Non-device backends don't flow through the
                    # driver's report plumbing: account their lanes
                    # here, on the entrant's own report (merged only
                    # if this entrant wins).
                    for r in out:
                        if r is not None:
                            hostpool.count_lane(srep, r)
            except SolveCancelled:
                err = "cancelled"
            except BaseException as e:  # noqa: BLE001 — entrant-local
                err = e
                reg.counter(
                    "deppy_race_entrant_errors_total",
                    "Race entrants that raised (cancellation aside), "
                    "by backend.",
                    labelname="backend").inc(label=name)
                telemetry.default_registry().event(
                    "fault", fault="race_entrant_error", backend=name,
                    error=f"{type(e).__name__}: {e}"[:200],
                    size_class_name=plan.class_name, lanes=len(live))
            finally:
                telemetry.detach_report(srep, owns)
            fatal = (name == "device" and solving
                     and isinstance(err, TREE_DEFECTS))
            with cv:
                finished.append((name, time.perf_counter() - t0, out,
                                 err, srep))
                if fatal:
                    if decided[0]:
                        with self._check_lock:
                            if self._device_error is None:
                                self._device_error = err
                    else:
                        failed.append(err)
                cv.notify_all()

        t0 = time.perf_counter()
        with reg.span("race", lanes=len(live), entrants=len(plan.names),
                      size_class=plan.class_name) as sp:
            for name in plan.names:
                reg.counter(
                    "deppy_race_starts_total",
                    "Portfolio race entrant launches, by backend.",
                    labelname="backend").inc(label=name)
                t = threading.Thread(target=run, args=(name, t0),
                                     name=f"deppy-race-{name}",
                                     daemon=True)
                _note_race_thread(t)
                t.start()

            def _definitive(name, out):
                """A non-canonical entrant's budget-exhaustion
                'incomplete' is that ENGINE's verdict, not the
                canonical one (step accounting is engine-relative) —
                letting it win would serve (and cache) Incomplete
                where racing-off decides.  Only the canonical entrant
                may call Incomplete; deadline-degraded lanes pass."""
                if out is None:
                    return False
                for r in out:
                    if r is None:
                        return False
                    if (r.outcome == "incomplete" and not r.degraded
                            and name != plan.canonical):
                        return False
                return True

            def _winner_locked():
                for entry in finished:
                    name, _, out, err, _ = entry
                    if err is None and _definitive(name, out):
                        return entry
                return None

            with cv:
                winner = _winner_locked()
                while (winner is None and not failed
                       and len(finished) < len(plan.names)):
                    cv.wait()
                    winner = _winner_locked()
                decided[0] = True
            stop.set()
            if failed:
                # A defect of the tree: raise into the dispatch exactly
                # as racing off would, never serve around it.
                sp.set(winner="error")
                raise failed[0]
            if winner is None:
                sp.set(winner="none")
                telemetry.default_registry().event(
                    "race", size_class_name=plan.class_name,
                    entrants=list(plan.names), lanes=len(live),
                    default=plan.names[0], winner=None)
                return False

            noncanonical_win = winner[0] != plan.canonical
            checked = None
            if check and noncanonical_win:
                # Sampled differential cross-check: the canonical
                # entrant was exempt from cancellation — wait for its
                # answer and compare outcome/model/core per lane.
                # Deadline-degraded lanes are excluded on either side:
                # degradation is pure timing, not disagreement.
                with cv:
                    while not any(e[0] == plan.canonical
                                  for e in finished):
                        cv.wait()
                    canon = next(e for e in finished
                                 if e[0] == plan.canonical)
                with self._check_lock:
                    err, self._device_error = self._device_error, None
                if err is not None:
                    # The canonical device entrant raised while the
                    # check waited for it: this flush's error.
                    sp.set(winner="error")
                    raise err
                if canon[3] is None and canon[2] is not None and all(
                        r is not None for r in canon[2]):
                    mismatch = any(
                        (w.outcome, tuple(w.installed_idx),
                         tuple(w.core_idx))
                        != (c.outcome, tuple(c.installed_idx),
                            tuple(c.core_idx))
                        for w, c in zip(winner[2], canon[2])
                        if not w.degraded and not c.degraded)
                    checked = "mismatch" if mismatch else "ok"
                    if mismatch:
                        reg.counter(
                            "deppy_race_check_mismatch_total",
                            "Sampled race cross-checks that disagreed "
                            "with the canonical backend (served "
                            "canonical; investigate).").inc()
                        telemetry.default_registry().event(
                            "fault", fault="race_mismatch",
                            winner=winner[0],
                            canonical=plan.canonical,
                            lanes=len(live))
                        winner = canon  # serve the canonical answer
            if noncanonical_win:
                with self._check_lock:
                    if check:
                        self._since_check = 0
                    else:
                        self._since_check += 1

            wname, wdt, wout, _, wsrep = winner
            with cv:
                # A cancelled loser can surface as a PARTIAL completion
                # — err None but a None lane (a descent cancelled
                # mid-certification) — whose wall clock measures when
                # the cancel landed, not how fast the backend solves.
                # Such entrants are CENSORED: recorded as losers but
                # excluded from win-margin stats.
                losers = []
                for e in finished:
                    if e[0] == wname:
                        continue
                    censored = (e[3] is not None or e[2] is None
                                or any(r is None for r in e[2]))
                    losers.append({"backend": e[0],
                                   "wall_s": round(e[1], 6),
                                   "censored": bool(censored)})
                done = {e[0] for e in finished}
                margins = [e[1] - wdt for e in finished
                           if e[0] != wname and e[3] is None
                           and e[2] is not None
                           and all(r is not None for r in e[2])]
                clean_done = {e[0] for e in finished if e[3] is None}
            for name in plan.names:
                if name != wname and name not in done:
                    # Still running at event time (abandoned in the
                    # background): censored, no usable wall clock.
                    losers.append({"backend": name, "wall_s": None,
                                   "censored": True})
            for name in plan.names:
                if name != wname and name not in clean_done:
                    reg.counter(
                        "deppy_race_cancels_total",
                        "Race entrants cancelled or abandoned after "
                        "losing, by backend.",
                        labelname="backend").inc(label=name)
            reg.counter(
                "deppy_race_wins_total",
                "Races won (first definitive finisher), by backend.",
                labelname="backend").inc(label=wname)
            margin = min(margins) if margins else None
            if margin is not None:
                reg.histogram(
                    "deppy_race_win_margin_seconds",
                    "Winner-vs-best-finished-loser wall-clock margin "
                    "per race.").observe(max(margin, 0.0))
            sp.set(winner=wname)
            telemetry.default_registry().event(
                "race", size_class_name=plan.class_name, winner=wname,
                canonical=plan.canonical, default=plan.names[0],
                entrants=list(plan.names),
                lanes=len(live),
                cancelled=[n for n in plan.names
                           if n != wname and n not in clean_done],
                losers=losers,
                win_margin_s=(round(margin, 6)
                              if margin is not None else None),
                checked=checked, wall_s=round(wdt, 6))
        rep.merge(wsrep)
        canonical_won = wname == plan.canonical
        for lane, r in zip(live, wout):
            _apply_lane_result(lane, r, "sched.race",
                               canonical=canonical_won)
        timing["solve_s"] = timing.get("solve_s", 0.0) + wdt
        return True


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
        given = dict(mesh=mesh, mesh_devices=mesh_devices,
                     lanes_per_device=lanes_per_device)
        for name, value in given.items():
            if value is None:
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
        # Incremental tier (scheduler.py:664-689): a delta-aware
        # clause-set index in front of the exact-fingerprint LRU.
        # Default on; "off" removes the tier entirely.
        if incremental is None:
            incremental = os.environ.get("DEPPY_GPU_INCREMENTAL", "on")
        index = None
        if str(incremental).strip().lower() not in _OFF:
            if incremental_max_delta is None:
                incremental_max_delta = DEFAULT_INCREMENTAL_MAX_DELTA
            if incremental_index_size is None:
                incremental_index_size = DEFAULT_INCREMENTAL_INDEX
            from ..incremental import ClauseSetIndex

            index = ClauseSetIndex(
                capacity=incremental_index_size,
                max_delta_ratio=incremental_max_delta,
                registry=self._registry)
        self.incremental = index
        self.cache = ResultCache(cache_size, registry=self._registry,
                                 incremental=index)
        # Portfolio engine racing.  "off" constructs no racer at all;
        # "auto" (the default) races only size classes holding a
        # measured `portfolio` row; "on" races wherever ≥2 candidate
        # backends serve the class.
        if portfolio is None:
            portfolio = os.environ.get("DEPPY_GPU_PORTFOLIO", "auto")
        mode = str(portfolio).strip().lower()
        self._racer: Optional[PortfolioRacer] = None
        if mode not in _OFF:
            if portfolio_k is None:
                portfolio_k = _env_int("DEPPY_GPU_PORTFOLIO_K",
                                       DEFAULT_PORTFOLIO_K)
            if portfolio_sample_check is None:
                portfolio_sample_check = faults.env_float(
                    "DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK",
                    DEFAULT_PORTFOLIO_SAMPLE_CHECK, warn=True)
            self._racer = PortfolioRacer(
                "on" if mode in ("on", "1", "true", "yes") else "auto",
                portfolio_k, portfolio_sample_check, self._registry,
                device=device)
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
            "lane target reached, immediate = blocking interactive "
            "lane at the head, spec = idle-queue flush, drain = "
            "shutdown, inline = loop not running).", labelname="reason")
        # Condition over an RLock: ``running`` re-enters it from
        # ``_enqueue``.
        self._cv = threading.Condition()
        self._queue: List[_Group] = []
        self._depth = 0
        # The idle-priority queue (scheduler.py:770-800): optimize
        # probe groups and speculative pre-solves, drained only while
        # no live lane is queued.
        self._spec_queue: List[_Group] = []
        self._spec_depth = 0
        # Fingerprints queued or mid-dispatch on the idle queue (CV-
        # guarded): a duplicate publish burst arriving before the first
        # pre-solves have stored must not double-burn the backlog cap
        # solving the same families twice.  A dispatch releases its
        # lanes' keys.
        self._spec_keys: set = set()
        # Speculative pre-resolution.  "off" constructs no manager and
        # no gauge: the submit and dispatch paths are those of a
        # scheduler without the tier.
        if speculate is None:
            speculate = os.environ.get("DEPPY_GPU_SPECULATE", "on")
        self.speculate = None
        self._g_spec_depth = None
        if str(speculate).strip().lower() not in _OFF:
            if speculate_max_backlog is None:
                speculate_max_backlog = _env_int(
                    "DEPPY_GPU_SPECULATE_MAX_BACKLOG",
                    DEFAULT_SPECULATE_MAX_BACKLOG)
            self.spec_max_backlog = max(int(speculate_max_backlog), 0)
            from ..speculate import SpeculationManager

            self.speculate = SpeculationManager(self, registry=reg)
            self._g_spec_depth = reg.gauge(
                "deppy_speculate_backlog",
                "Speculative pre-solve lanes queued at idle priority "
                "right now.")
            self._g_spec_depth.set(0)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # EWMA of dispatch wall clock, seeding the Retry-After estimate.
        self._dispatch_ewma_s = 0.05
        # The deferred background engine re-probe (scheduler.py:804-810):
        # a breaker-open host drain under ``auto`` kicks ONE loop that
        # upgrades routing once the card recovers.
        self._reprobe_stop = threading.Event()
        self._reprobe_thread: Optional[threading.Thread] = None
        self._reprobe_s = faults.env_float("DEPPY_GPU_REPROBE", 600.0,
                                           warn=True) or 0.0

    # -------------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Start the dispatch-loop thread (idempotent)."""
        self._reprobe_stop.clear()
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="deppy-sched", daemon=True)
            self._thread.start()
        self._prewarm_backend()

    def _prewarm_backend(self) -> None:
        """The dispatch loop resolves the backend with ``block=False`` (it
        must never stall the queue behind the engine probe), so ``auto``
        answers "host" until something establishes the verdict; kick one
        background probe here so routing upgrades once it lands
        (scheduler.py:870-889).  On the CPU the verdict is instant."""
        if self.backend != "auto":
            return
        from ..sat import solver as sat_solver

        kind = sat_solver._device_type(self.device)
        if kind in sat_solver._ENGINE_USABLE or kind == "cpu":
            return
        threading.Thread(
            target=lambda: sat_solver.resolve_backend(
                "auto", device=self.device),
            name="deppy-sched-prewarm", daemon=True).start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop; queued LIVE groups drain (dispatch) first so
        no submitter is left hanging, queued optimize groups fail with
        "scheduler stopped before optimize dispatch", and queued
        pre-solves are discarded, counted on
        ``deppy_speculate_dropped_total`` (idle work never slows a
        drain).  Submits after stop dispatch inline."""
        self._reprobe_stop.set()
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
        warm_pending: List[tuple] = []
        for i, p in enumerate(problems):
            key = fingerprint(p)
            if self.speculate is not None:
                # Retain the served family so a later catalog publish
                # can be applied to it and pre-solved.
                self.speculate.observe(key, problem_vars[i])
            hit, plan = self.cache.lookup_or_plan(p, key, budget)
            if hit is not MISS:
                results[i] = hit  # bypasses the queue entirely
            elif plan is not None:
                # A certified warm plan queues in the incremental size
                # class — warm lanes coalesce with each other instead of
                # padding out a cold batch.
                warm_pending.append(
                    (i, _Lane(p, key, max_steps, budget, dl, warm=plan,
                              tenant=tenant)))
            else:
                pending.append((i, _Lane(p, key, max_steps, budget, dl,
                                         tenant=tenant)))
        steps = 0
        deadline_misses = 0
        report = None
        timing: dict = {}
        groups: List[tuple] = []
        prio = (self.tenant_policy.priority(tenant) if self.fair
                else 1)
        if pending:
            groups.append(
                (pending, self._make_group([lane for _, lane in pending],
                                           budget, priority=prio)))
        if warm_pending:
            groups.append(
                (warm_pending,
                 _Group([lane for _, lane in warm_pending],
                        INCREMENTAL_CLASS, budget, priority=prio)))
        for _, group in groups:
            self._enqueue(group)
        for grp_pending, group in groups:
            group.event.wait()
            if group.error is not None:
                raise group.error
            if group.report is not None:
                if report is None:
                    report = group.report
                else:
                    # Never merge IN PLACE: a group's report object is
                    # shared with every request coalesced into the same
                    # dispatch — fold both into a fresh one instead.
                    merged = telemetry.SolveReport(backend=report.backend)
                    merged.n_problems = 0
                    merged.merge(report)
                    merged.merge(group.report)
                    report = merged
            for k, v in group.timing.items():
                # A mixed submit spans two dispatches (cold + warm
                # groups): sequential stage durations ADD, but the
                # groups QUEUE concurrently, so overlapped waits take
                # the max, not the sum.
                if isinstance(v, (int, float)) and k in timing:
                    timing[k] = (max(timing[k], v)
                                 if k == "queue_wait_s"
                                 else timing[k] + v)
                else:
                    timing[k] = v
            for i, lane in grp_pending:
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
                    speculative: bool = False,
                    priority: int = 1) -> _Group:
        from ..engine.driver import _bucket, _cost_proxy

        size_class = _bucket(max(_cost_proxy(l.problem) for l in lanes))
        return _Group(lanes, size_class, budget, speculative=speculative,
                      priority=priority)

    # ------------------------------------------------------------ speculation

    def _set_spec_gauge_locked(self) -> None:
        """Caller holds the CV: the backlog gauge follows ``_spec_depth``
        (absent with the tier off)."""
        if self._g_spec_depth is not None:
            self._g_spec_depth.set(self._spec_depth)

    def speculative_depth(self) -> int:
        """Lanes queued at idle priority (pre-solves and optimize
        probes)."""
        with self._cv:
            return self._spec_depth

    def submit_speculative(
        self,
        problem_vars: Sequence[Sequence[Variable]],
        max_steps: Optional[int] = None,
    ) -> tuple:
        """Queue pre-solves at IDLE priority and return immediately with
        ``(queued, dropped)`` lane counts (``scheduler.py:1220-1312``) —
        fire-and-forget: results land in the result cache and the
        clause-set index exactly like ordinary solves, and nobody blocks
        on them.  The dispatch loop drains these groups only while no
        live group is queued, so live traffic preempts at every flush
        boundary.  Malformed families, already-cached fingerprints, and
        within-call duplicates are skipped; lanes past the backlog cap
        (or arriving while the loop is not running — a pre-solve must
        never dispatch inline on a publisher's thread) are dropped."""
        if self.speculate is None:
            return 0, len(problem_vars)
        from ..engine.driver import _budget

        if max_steps is None:
            max_steps = self.max_steps
        budget = int(_budget(max_steps))
        dropped = 0
        seen: set = set()
        cold: List[_Lane] = []
        warm: List[_Lane] = []
        for vs in problem_vars:
            try:
                p = encode(vs)
            except Exception as e:  # noqa: BLE001 — a malformed family
                # must never abort the rest of a publish burst; it is a
                # counted drop with a sink event, not a request error
                # (no requester exists to answer).
                telemetry.default_registry().event(
                    "fault", fault="speculate_encode_failed",
                    error=type(e).__name__)
                dropped += 1
                continue
            if p.errors:
                dropped += 1
                continue
            key = fingerprint(p)
            if key in seen:
                continue
            seen.add(key)
            if self.cache.peek(key, budget):
                continue  # the answer is already served from cache
            plan = (self.incremental.plan(p, key, budget)
                    if self.incremental is not None else None)
            lane = _Lane(p, key, max_steps, budget, None, warm=plan,
                         tenant="speculate")
            (warm if plan is not None else cold).append(lane)
            # Retain the POST-publish family under its new fingerprint:
            # a later publish must compose on this state, not the
            # superseded one the publish just retired.
            self.speculate.observe(key, vs)
        groups: List[_Group] = []
        # One group per cold family keeps size classes honest (the idle
        # drain coalesces same-class neighbours like the live drain);
        # warm lanes coalesce as the incremental class.
        for lane in cold:
            groups.append(self._make_group([lane], budget,
                                           speculative=True))
        if warm:
            groups.append(_Group(warm, INCREMENTAL_CLASS, budget,
                                 speculative=True))
        queued = 0
        with self._cv:
            admit = self.running
            for g in groups:
                # Drop lanes whose fingerprint is already queued or
                # mid-dispatch (a duplicate publish burst): neither
                # queued nor dropped — the answer is already on its
                # way.  The cache is re-peeked HERE because a pre-solve
                # can complete (store + key release) between the
                # pre-encode peek above and this enqueue; peek is a
                # leaf lock, safe under the CV.
                g.lanes = [lane for lane in g.lanes
                           if lane.key not in self._spec_keys
                           and not self.cache.peek(lane.key, budget)]
                if not g.lanes:
                    continue
                if (not admit or self._spec_depth + len(g.lanes)
                        > self.spec_max_backlog):
                    dropped += len(g.lanes)
                    continue
                self._spec_keys.update(lane.key for lane in g.lanes)
                self._spec_queue.append(g)
                self._spec_depth += len(g.lanes)
                queued += len(g.lanes)
            self._set_spec_gauge_locked()
            if queued:
                self._cv.notify_all()
        return queued, dropped

    # ----------------------------------------------------- optimize probes

    def submit_optimize(
        self,
        problem_vars: Sequence[Sequence[Variable]],
        deadline_s: Optional[float] = None,
        max_steps: Optional[int] = None,
        stats: Optional[dict] = None,
        tenant: str = "default",
    ) -> List[object]:
        """Blocking :meth:`submit` sibling for the optimization tier's
        solves (``scheduler.py:1316-1379``), queued at IDLE priority:
        probe groups ride the idle queue, so a long bound-tightening
        loop coalesces at flush boundaries and live resolution traffic
        preempts every iteration.  A submitter waits, so probes are
        never dropped (the blocked caller is the backpressure) and
        dispatch errors re-raise here.

        The lanes take no cache lookup, but their dispatch stores their
        answers in the result cache and their SAT models in the
        clause-set index like any other lane (``_dispatch`` runs every
        lane through ``_maybe_cache``, as the reference's does).  With
        the loop not running the probe dispatches inline."""
        from ..engine.driver import _budget

        if max_steps is None:
            max_steps = self.max_steps
        budget = int(_budget(max_steps))
        problems = [encode(vs) for vs in problem_vars]
        for p in problems:
            if p.errors:
                raise InternalSolverError(p.errors)
        with faults.deadline_scope(deadline_s), faults.ambient_deadline():
            dl = faults.current_deadline()
        lanes = [_Lane(p, fingerprint(p), max_steps, budget, dl,
                       tenant=tenant) for p in problems]
        group = self._make_group(lanes, budget, speculative=True)
        inline = False
        with self._cv:
            if self.running:
                self._spec_queue.append(group)
                self._spec_depth += len(group.lanes)
                self._set_spec_gauge_locked()
                self._cv.notify_all()
            else:
                inline = True
        if inline:
            # No loop thread (library use, or post-shutdown stragglers):
            # the probe dispatches on the caller's thread like _enqueue.
            self._dispatch([group], reason="inline")
        group.event.wait()
        if group.error is not None:
            raise group.error
        deadline_misses = 0
        for lane in lanes:
            if lane.degraded:
                deadline_misses += 1
                telemetry.trace.mark_error()
        qw = group.timing.get("queue_wait_s")
        if qw is not None:
            telemetry.default_registry().record_span(
                "sched.queue_wait", qw, lanes=len(group.lanes))
        if stats is not None:
            stats["steps"] = sum(lane.steps for lane in lanes)
            stats["report"] = group.report
            stats["timings"] = dict(group.timing)
            stats["deadline_misses"] = deadline_misses
        return [lane.result for lane in lanes]

    # -------------------------------------------------------------- sessions

    def submit_session(
        self,
        problem_vars: Sequence[Variable],
        deadline_s: Optional[float] = None,
        max_steps: Optional[int] = None,
        stats: Optional[dict] = None,
        tenant: str = "default",
        warm_index=None,
        session_key: Optional[str] = None,
        scope_entry_key: Optional[str] = None,
        scope_seed=None,
        problem: Optional[Problem] = None,
    ) -> object:
        """Blocking single-problem submit for a stateful session's (or an
        open test scope's) incremental solve (``scheduler.py:1117-1213``).
        The answer is exactly what ``submit`` would return for the same
        variables — same engines, same racing, same deadline and
        fair-admission semantics — but the lane is **scoped**: it skips
        the shared result cache entirely (no lookup, no store —
        assumption-conditioned answers must never serve or poison
        stateless traffic), its cold dispatch rides the dedicated
        :data:`SESSION_CLASS` bucket, and warm starts plan against
        ``warm_index`` — the session's private clause-set index holding
        the session's own last model — rather than the shared index.

        A per-step scoped solve must not re-pay O(problem) bookkeeping
        the caller already knows the answer to, so the session facade
        may hand over what it tracks: ``session_key`` replaces the
        canonical ``fingerprint(p)`` as the lane key — legitimate ONLY
        because scoped lanes never touch the shared result cache, the
        key's sole job is entry identity inside the session's private
        index — and ``scope_entry_key`` + ``scope_seed`` (the previous
        scoped solve's key and the assumption-stack delta's variable
        indices) let the index plan O(delta) via
        :meth:`ClauseSetIndex.plan_for_scope` instead of re-hashing and
        re-scanning the whole problem.  When the declared predecessor
        is missing (first solve, UNSAT last step, post-handoff import)
        the generic classifier answers, and when no plan survives the
        gates the lane cold-solves — identity holds on every path.
        ``problem`` is the already-lowered form of ``problem_vars``
        (the facade's ``encode_assumed`` splice).

        Returns the single result (Solution dict / NotSatisfiable /
        Incomplete); raises what ``submit`` raises for malformed input,
        and whatever its dispatch raised.  ``stats`` receives what
        ``submit`` gives it, plus ``warm`` (a warm start was planned)."""
        from ..engine.driver import _budget

        if max_steps is None:
            max_steps = self.max_steps
        budget = int(_budget(max_steps))
        p = problem if problem is not None else encode(problem_vars)
        if p.errors:
            raise InternalSolverError(p.errors)
        with faults.deadline_scope(deadline_s), faults.ambient_deadline():
            dl = faults.current_deadline()
        key = session_key if session_key is not None else fingerprint(p)
        plan = None
        if warm_index is not None:
            if scope_entry_key is not None:
                plan = warm_index.plan_for_scope(
                    p, key, budget, scope_entry_key, scope_seed or ())
            if plan is None:
                plan = warm_index.plan(p, key, budget)
        lane = _Lane(p, key, max_steps, budget, dl, warm=plan,
                     tenant=tenant)
        lane.scoped = True
        lane.session_index = warm_index
        prio = (self.tenant_policy.priority(tenant) if self.fair
                else 1)
        group = _Group([lane],
                       INCREMENTAL_CLASS if plan is not None
                       else SESSION_CLASS,
                       budget, priority=prio, immediate=True)
        self._enqueue(group)
        group.event.wait()
        if group.error is not None:
            raise group.error
        if lane.degraded:
            telemetry.trace.mark_error()
        qw = group.timing.get("queue_wait_s")
        if qw is not None:
            telemetry.default_registry().record_span(
                "sched.queue_wait", qw, lanes=1)
        if stats is not None:
            stats["steps"] = lane.steps
            stats["report"] = group.report
            stats["timings"] = dict(group.timing)
            stats["deadline_misses"] = 1 if lane.degraded else 0
            stats["warm"] = plan is not None
        return lane.result

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
                # Idle-queue orphans fail loudly too: an optimize
                # probe's submitter waits on its event.
                orphans += self._spec_queue
                self._spec_queue = []
                self._spec_depth = 0
                self._spec_keys.clear()
                self._set_spec_gauge_locked()
            for g in orphans:
                if not g.event.is_set():
                    g.error = RuntimeError(
                        "scheduler dispatch loop exited unexpectedly")
                    g.event.set()

    def _loop_inner(self) -> None:
        while True:
            discarded = 0
            spec_orphans: List[_Group] = []
            groups: List[_Group] = []
            reason = None
            with self._cv:
                while (not self._queue and not self._spec_queue
                       and not self._stop):
                    self._cv.wait()
                if self._stop and self._spec_queue:
                    # Shutdown discards the idle backlog: no submitter
                    # waits on a pre-solve, and idle work must never
                    # slow a drain.  Optimize probes have a waiter:
                    # their groups are failed below, outside the lock.
                    # The discarded lanes (scheduler.py:1527) are the
                    # backlog's, probes included, as the reference's.
                    discarded = self._spec_depth
                    spec_orphans = self._spec_queue
                    self._spec_queue = []
                    self._spec_depth = 0
                    self._spec_keys.clear()
                    self._set_spec_gauge_locked()
                if self._queue:
                    groups, reason = self._drain_locked(force=self._stop)
                    if not groups:
                        # A live flush is pending but not yet due.  The
                        # idle queue is NOT consulted in this window: a
                        # probe dispatch here could push the live flush
                        # past max_wait — idle priority means idle, not
                        # "between live flushes".
                        head_due = (self._head_locked().enq_t
                                    + self.max_wait_s)
                        delay = head_due - time.monotonic()
                        self._cv.wait(timeout=max(delay, 0.001))
                        continue
                elif self._spec_queue:
                    # No live lane is queued: drain ONE idle flush.  Live
                    # submits arriving during its dispatch preempt at the
                    # next loop iteration (the flush boundary).
                    groups, reason = self._drain_spec_locked()
            for g in spec_orphans:
                if not g.event.is_set():
                    g.error = RuntimeError(
                        "scheduler stopped before optimize dispatch")
                    g.event.set()
            if discarded and self.speculate is not None:
                self.speculate.note_discarded(discarded)
            if not groups:
                return  # stopped and drained
            self._dispatch(groups, reason)

    def _drain_spec_locked(self):
        """Pick one idle flush (caller holds the lock;
        scheduler.py:1564-1586): the oldest idle group plus its
        same-class, same-budget neighbours up to ``max_fill`` lanes —
        the live drain's coalescing rule applied to the idle queue."""
        head = self._spec_queue[0]
        take = [head]
        lanes = len(head.lanes)
        for g in self._spec_queue[1:]:
            if lanes >= self.max_fill:
                break
            if (g.size_class == head.size_class
                    and g.budget == head.budget
                    and lanes + len(g.lanes) <= self.max_fill):
                take.append(g)
                lanes += len(g.lanes)
        taken = set(map(id, take))
        self._spec_queue = [g for g in self._spec_queue
                            if id(g) not in taken]
        self._spec_depth -= lanes
        self._set_spec_gauge_locked()
        return take, "spec"

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
        elif head.immediate:
            reason = "immediate"
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
            if any(g.speculative for g in groups):
                # The sink's record of a failed idle flush
                # (scheduler.py:1691-1700); the optimize submitter gets
                # the error re-raised as well.
                telemetry.default_registry().event(
                    "fault", fault="speculate_dispatch_failed",
                    error=type(e).__name__,
                    lanes=sum(len(g.lanes) for g in groups
                              if g.speculative))
        finally:
            dur = time.monotonic() - t0
            # Read-modify-write under the CV: admission_retry_after
            # reads the EWMA from other threads.
            with self._cv:
                self._dispatch_ewma_s = (0.8 * self._dispatch_ewma_s
                                         + 0.2 * dur)
                for g in groups:
                    if g.speculative:
                        self._spec_keys.difference_update(
                            lane.key for lane in g.lanes)
            timing["dispatch_s"] = dur
            for g in groups:
                g.timing.update(timing)
                g.report = report
                g.event.set()

    def _maybe_cache(self, lane: _Lane) -> None:
        r = lane.result
        if lane.scoped:
            # Assumption-conditioned answers never reach the shared
            # exact LRU or clause-set index (scheduler.py:1726-1745) —
            # they would poison stateless traffic with results that
            # only hold under the session's assumption stack.  The
            # session's private index takes the model instead (same
            # eligibility gate as the shared index: measured,
            # zero-backtrack-certifiable, not degraded) so the
            # session's NEXT op warm-starts from it.
            if (lane.session_index is not None and isinstance(r, dict)
                    and not lane.degraded and lane.backtracks is not None):
                model = np.fromiter(
                    (bool(r[v.identifier])
                     for v in lane.problem.variables),
                    dtype=bool, count=lane.problem.n_vars)
                lane.session_index.store(
                    lane.key, lane.problem, model,
                    lane.index_steps if lane.index_steps is not None
                    else lane.steps,
                    lane.backtracks, lazy_rows=True)
            return
        if isinstance(r, (dict, NotSatisfiable)):
            self.cache.store(lane.key, lane.budget, r)
        elif isinstance(r, Incomplete) and lane.deadline is None:
            # Budget exhaustion is reproducible; deadline degradation
            # is not — only the former may be cached.
            self.cache.store(lane.key, lane.budget, r)
        # SAT models feed the clause-set index (scheduler.py:1753-1766)
        # so the NEXT delta against this problem warm-starts.  Only
        # lanes whose path measured the search-backtrack count are
        # eligible (the index keeps zero-backtrack seeds only — the warm
        # certification precondition); degraded lanes never are.
        if (self.incremental is not None and isinstance(r, dict)
                and not lane.degraded and lane.backtracks is not None):
            model = np.fromiter(
                (bool(r[v.identifier]) for v in lane.problem.variables),
                dtype=bool, count=lane.problem.n_vars)
            self.incremental.store(
                lane.key, lane.problem, model,
                lane.index_steps if lane.index_steps is not None
                else lane.steps,
                lane.backtracks)

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
        # The dispatch runs under the LOOSEST live deadline (the driver
        # degrades whole groups past the scope's expiry, and a
        # stranger's tighter budget must not cut a batchmate short).
        # Any unbounded lane means an unbounded dispatch.
        scope = None
        deadlines = [lane.deadline for lane in live]
        if all(d is not None for d in deadlines):
            scope = max(deadlines, key=lambda d: d.remaining())
        backend = resolve_backend(self.backend, block=False,
                                  device=self.device)
        if (self.backend == "auto" and backend == "host"
                and faults.default_breaker().blocks_device()):
            # A breaker-open host drain: kick the deferred background
            # re-probe so routing upgrades once the card recovers.
            self._kick_reprobe()
        rep, owns = telemetry.begin_report(backend=backend,
                                           n_problems=len(live))
        try:
            with faults.deadline_scope(scope):
                if all(lane.warm is not None for lane in live):
                    # An incremental-class flush (scheduler.py:1817-1823):
                    # warm attempts first, cold fallbacks drain through
                    # the normal backend path; it never races.
                    t1 = time.perf_counter()
                    self._solve_incremental(live, rep, timing, backend)
                    timing["solve_s"] = time.perf_counter() - t1
                    return rep
                # Portfolio racing (scheduler.py:1826-1853).  A None plan
                # (racing off, auto with no measured row, <2 candidates)
                # leaves the canonical single-backend path below as it
                # was.
                plan = (self._racer.plan(live, backend)
                        if self._racer is not None else None)
                finisher = None
                raced = False
                try:
                    if plan is not None:
                        live, finisher = self._triage_stragglers(
                            live, plan.class_name)
                        if live:
                            raced = self._racer.race(plan, live, rep,
                                                     timing)
                        else:
                            raced = True
                    if not raced:
                        if backend == "host":
                            t1 = time.perf_counter()
                            self._solve_host(live, rep)
                            timing["solve_s"] = time.perf_counter() - t1
                        else:
                            self._solve_device(live, timing)
                finally:
                    if finisher is not None:
                        finisher(rep)
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

    def _solve_incremental(self, live: List[_Lane], rep,
                           timing: dict, backend: str) -> None:
        """Drain one incremental-class flush (scheduler.py:1900-1971):
        screen the warm prefixes on the scheduler's device (device
        backend, more than one lane), run the surviving warm attempts on
        the host spec engine, and cold-solve every fallback through the
        NORMAL backend path.  Per-lane deadlines are admission checks
        before each warm attempt (the hostpool convention: a lane never
        preempts mid-solve), so a lapse during the flush degrades only
        the lanes not yet started.

        The screen is skipped while the card's breaker blocks the device
        (its contract is zero device attempts); a screen failure
        degrades to all-True (:func:`incremental.screen`).  A sampled
        flush records the screen and the warm attempts at the
        profiler's ``warm`` site; cold fallbacks account under their own
        backend."""
        from .. import incremental as inc

        prof_t0 = _profile.dispatch_t0("warm")
        warm_served = 0
        warm_steps = 0
        plans = [lane.warm for lane in live]
        screened = [True] * len(live)
        if (backend != "host" and len(live) > 1
                and not faults.default_breaker().blocks_device()):
            # The batched device lane variant: one pass over the whole
            # warm class instead of per-lane host prefix tests.
            screened = inc.screen(plans, device=self.device)
        cold: List[_Lane] = []
        for lane, plan, ok in zip(live, plans, screened):
            if lane.deadline is not None and lane.deadline.expired():
                faults.note_deadline_exceeded("sched.dispatch",
                                              tenant=lane.tenant)
                rep.count_outcome("incomplete")
                lane.result = Incomplete()
                lane.degraded = True
                continue
            res = inc.attempt(plan, lane.max_steps) if ok else None
            if res is None:
                if self.incremental is not None:
                    self.incremental.note_fallback()
                cold.append(lane)
                continue
            lane.result = hostpool.lane_answer(lane.problem, res)
            lane.steps = res.steps
            lane.backtracks = res.backtracks
            # Index under a cold-equivalent cost: the seeding entry's
            # cold steps plus this cone's work bounds what a cold solve
            # of THIS problem would spend far better than the warm
            # attempt's own count does.
            lane.index_steps = plan.entry_steps + res.steps
            warm_served += 1
            warm_steps += res.steps
            rep.count_outcome("sat")
            rep.steps += res.steps
            rep.decisions += res.decisions
            rep.propagation_rounds += res.propagation_rounds
            if self.incremental is not None:
                self.incremental.note_served()
        if prof_t0 is not None and warm_served:
            _profile.record_backend_flush(
                "warm", warm_served, warm_steps,
                time.perf_counter() - prof_t0,
                tenant=_single_tenant(live))
        if cold:
            if backend == "host":
                self._solve_host(cold, rep)
            else:
                self._solve_device(cold, timing)

    def _triage_stragglers(self, live: List[_Lane], class_name: str):
        """Per-lane deadline triage (scheduler.py:1973-2047): lanes whose
        remaining wall-clock budget cannot survive the expected device
        dispatch (the dispatch EWMA, floored by the engine registry's
        per-class device estimate) are resubmitted to the host pool on a
        side thread (``deppy-race-resubmit``), where they start at once
        instead of riding — or expiring inside — a device batch.  Returns
        (kept lanes, finisher|None); the finisher joins the resubmission
        and merges its report.  Racing path only: with the portfolio
        off, deadline semantics are untouched."""
        from ..engine import registry as engine_registry

        with self._cv:
            est = self._dispatch_ewma_s
        est = max(est,
                  engine_registry.estimate_us("device", class_name) / 1e6)
        resub = [lane for lane in live
                 if lane.deadline is not None
                 and 0.0 < lane.deadline.remaining() < est]
        if not resub:
            return live, None
        keep = [lane for lane in live
                if not any(lane is r for r in resub)]
        reg = self._registry
        reg.counter(
            "deppy_race_straggler_resubmits_total",
            "Deadline-straggler lanes resubmitted to the host pool "
            "instead of riding a device batch.").inc(len(resub))
        telemetry.default_registry().event(
            "race", resubmitted=len(resub),
            size_class_name=class_name)
        box: dict = {}

        def side() -> None:
            srep, owns = telemetry.begin_report(backend="hostpool")
            try:
                results = hostpool.solve_host_problems(
                    [lane.problem for lane in resub],
                    max_steps=[lane.max_steps for lane in resub],
                    deadlines=[lane.deadline for lane in resub])
                for lane, r in zip(resub, results):
                    hostpool.count_lane(srep, r)
                    _apply_lane_result(lane, r, "sched.race",
                                       canonical=False)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                box["error"] = e
            finally:
                telemetry.detach_report(srep, owns)
                box["rep"] = srep

        t = threading.Thread(target=side, name="deppy-race-resubmit",
                             daemon=True)
        t.start()

        def finisher(rep) -> None:
            t.join()
            rep.merge(box["rep"])
            if "error" in box:
                import sys

                if sys.exc_info()[1] is not None:
                    # A primary exception is already propagating out of
                    # the dispatch (the finisher runs in its finally):
                    # re-raising here would MASK it — surface the side
                    # failure on the sink instead.
                    telemetry.default_registry().event(
                        "fault", fault="race_resubmit_failed",
                        error=type(box["error"]).__name__,
                        lanes=len(resub))
                    return
                raise box["error"]

        return keep, finisher

    # ------------------------------------------------- deferred re-probe

    def _kick_reprobe(self) -> None:
        """Start the background re-probe loop (once) after a breaker-open
        host drain (scheduler.py:2051-2071).  The loop waits out the
        breaker's cooldown, then runs the killable subprocess engine
        probe off the serving path: a success resets the breaker and
        replaces the ``auto`` verdict
        (:func:`deppy_tpu_torch.sat.solver.reprobe_engine`), so routing
        upgrades without a live dispatch on the half-open probe; a
        failure retries every ``DEPPY_GPU_REPROBE`` seconds while the
        breaker stays open.  ``DEPPY_GPU_REPROBE`` <= 0 disables it."""
        if self._reprobe_s <= 0:
            return
        with self._cv:
            t = self._reprobe_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._reprobe_loop,
                                 name="deppy-sched-reprobe", daemon=True)
            self._reprobe_thread = t
        t.start()

    def _reprobe_loop(self) -> None:
        """The re-probe loop (scheduler.py:2073-2113)."""
        from ..sat import solver as sat_solver

        c_reprobes = self._registry.counter(
            "deppy_sched_reprobes_total",
            "Deferred background engine re-probes after a breaker-open "
            "host drain, by result.", labelname="result")
        # The first wake lands right after the cooldown; failed probes
        # retry on the full interval (a subprocess probe must not
        # hot-loop against a dead card).
        delay = max(faults.default_breaker().remaining_s(), 1.0)
        while True:
            if self._reprobe_stop.wait(delay):
                return
            state = faults.default_breaker().state()
            if state == "closed":
                # Recovered through the dispatch path while we slept.
                return
            if state == "open":
                # Re-opened (or still cooling): wait out the cooldown.
                delay = max(faults.default_breaker().remaining_s(), 1.0)
                continue
            try:
                ok = sat_solver.reprobe_engine(self.device)
            # A probe that raises means not recovered; retried next tick.
            except Exception:  # noqa: BLE001
                ok = False
            c_reprobes.inc(label="upgraded" if ok else "failed")
            if ok:
                telemetry.default_registry().event(
                    "fault", fault="sched_reprobe_upgraded")
                return
            delay = max(self._reprobe_s, 1.0)

    def _solve_host(self, live: List[_Lane], rep) -> None:
        """Host-engine drain for ``backend="host"`` and for ``auto``
        resolved to host (scheduler.py:2115-2144):
        the lanes run through the shared host entry — concurrent across
        the worker pool when one is available, inline (bit-identical)
        otherwise.  Each LANE's own deadline rides along: completed
        lanes keep their answers, expired ones degrade individually.  A
        sampled drain records its cost at the profiler's ``host`` site."""
        reg = telemetry.default_registry()
        prof_t0 = _profile.dispatch_t0("host")
        with reg.span("sched.host_solve", problems=len(live)):
            results = hostpool.solve_host_problems(
                [lane.problem for lane in live],
                max_steps=[lane.max_steps for lane in live],
                deadlines=[lane.deadline for lane in live])
            if prof_t0 is not None:
                _profile.record_backend_flush(
                    "host", len(live),
                    int(sum(r.steps for r in results)),
                    time.perf_counter() - prof_t0,
                    tenant=_single_tenant(live))
            for lane, r in zip(live, results):
                hostpool.count_lane(rep, r)
                _apply_lane_result(lane, r, "sched.host_solve")
