"""The session store (copy of ``deppy_tpu/sessions/store.py:1-451``).

One :class:`SessionStore` per scheduler, holding :class:`Session`
objects keyed by a random id:

  * each session retains its **encoded problem + decode vocabulary**
    (a :class:`deppy_tpu_torch.sat.Solver` with the request scheduler
    attached, on the scheduler's device) and a **private clause-set
    index** so consecutive solves warm-start from the session's own last
    model without ever touching the scheduler's shared index;
  * the session's **family key** (:func:`deppy_tpu_torch.fleet.ring.affinity_key`
    over its ordered variable ids) is returned at creation;
  * a **lease** (renewed by every op) bounds retention; a jittered
    sweeper expires lapsed sessions in the background and every
    map-touching path expires them lazily;
  * **caps** bound memory: a global hard cap and a per-tenant cap.
    At a cap, expired sessions are LRU-evicted first; if none remain
    the creation **sheds** (:class:`SessionShed`, counted) rather than
    evicting live state.

Ops answer byte-identically to the equivalent one-shot cold resolve:
an assumption is materialized as a real constraint (``Mandatory`` /
``Prohibited``) on its subject variable, so the solved problem IS the
problem a fresh resolve of the derived document would solve — same
fingerprints, same unsat-core strings, same minimization.  ``test``
is propagation on the host engine, as in the reference: host work by
design, not a fallback.  A ``resolve`` or ``explain`` whose dispatch
raises — on the card, a kernel that fails to build or launch, or a
failed warm screen — raises out of :meth:`SessionStore.op`.

Metric families (on ``metrics``, default the default registry):
``deppy_session_active``, ``deppy_session_ops_total{op}``,
``deppy_session_expired_total`` and
``deppy_session_evictions_total{reason}``; span ``session.op``; fault
point ``sessions.op``.  Locks are plain ``threading`` locks.  The limits
are arguments; left None they read ``DEPPY_GPU_SESSION_LEASE_S``,
``_MAX`` and ``_MAX_PER_TENANT`` (the reference's defaults; their CLI
flags are ``serve``'s ``--session-lease-s``, ``--session-max`` and
``--session-max-per-tenant``).  The service
(:mod:`deppy_tpu_torch.service`) switches the store on and off
(``DEPPY_GPU_SESSIONS``) and passes its replica name, which
``session.op`` spans carry as in the reference.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .. import config, faults, telemetry
from .. import io as problem_io
from ..fleet.ring import affinity_key
from ..fleet.snapshot import import_index_entry, index_entry_to_dict
from ..incremental import ClauseSetIndex
from ..sat.errors import InternalSolverError
from ..sat.solver import Solver

# A session's private warm index only ever needs the latest few models
# (the current assumption state and its immediate neighborhood); a tiny
# capacity keeps per-session memory bounded at catalog size, not
# history size.
SESSION_INDEX_CAPACITY = 4

# The store's limits, the reference's defaults (store.py:121-132); an
# argument left None reads DEPPY_GPU_SESSION_LEASE_S, _MAX and
# _MAX_PER_TENANT (a malformed value reads the default).
DEFAULT_LEASE_S = 300.0
DEFAULT_MAX_SESSIONS = 256
DEFAULT_MAX_PER_TENANT = 64

_OPS = ("assume", "test", "untest", "resolve", "explain")


class SessionError(ValueError):
    """Malformed session op (the reference's service renders a 400)."""


class SessionLost(KeyError):
    """Unknown or expired session id (the reference's service renders a
    404)."""


class SessionShed(RuntimeError):
    """Creation shed at a session cap (the reference's service renders a
    503)."""

    def __init__(self, scope: str):
        super().__init__(f"session cap reached ({scope})")
        self.scope = scope


class Session:
    """One retained interactive resolution session."""

    __slots__ = ("id", "tenant", "key", "solver", "index", "deadline",
                 "ops", "created", "lock")

    def __init__(self, sid: str, tenant: str, solver: Solver,
                 index: ClauseSetIndex, lease_s: float):
        self.id = sid
        self.tenant = tenant
        # The family key over the ORDERED variable identifiers — the
        # affinity key a fleet router routes ops by.
        self.key = affinity_key(
            v.identifier for v in solver.problem.variables)
        self.solver = solver
        self.index = index
        self.deadline = time.monotonic() + lease_s
        self.ops = 0
        self.created = time.time()
        # Ops on ONE session serialize (the scope stack is stateful);
        # distinct sessions run concurrently.  Never held across a
        # store-lock acquisition (store -> session is the only nesting
        # order, and only for bookkeeping, never across a solve).
        self.lock = threading.Lock()

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) \
            >= self.deadline

    def renew(self, lease_s: float) -> None:
        self.deadline = time.monotonic() + lease_s


class SessionStore:
    """Create/drive/expire sessions; export/import them for handoff."""

    def __init__(self, scheduler, metrics=None,
                 lease_s: Optional[float] = None,
                 max_sessions: Optional[int] = None,
                 max_per_tenant: Optional[int] = None,
                 sweep_interval_s: Optional[float] = None,
                 replica: Optional[str] = None):
        self.scheduler = scheduler
        self.replica = replica
        if lease_s is None:
            lease_s = config.env_float("DEPPY_GPU_SESSION_LEASE_S",
                                       DEFAULT_LEASE_S, strict=False)
        self.lease_s = max(float(lease_s), 0.05)
        if max_sessions is None:
            max_sessions = config.env_int("DEPPY_GPU_SESSION_MAX",
                                          DEFAULT_MAX_SESSIONS, strict=False)
        self.max_sessions = max(int(max_sessions), 1)
        if max_per_tenant is None:
            max_per_tenant = config.env_int(
                "DEPPY_GPU_SESSION_MAX_PER_TENANT", DEFAULT_MAX_PER_TENANT,
                strict=False)
        self.max_per_tenant = max(int(max_per_tenant), 1)
        self._registry = metrics if metrics is not None \
            else telemetry.default_registry()
        # Guards the id map and per-tenant counts only — never held
        # across a solve (a slow op must not serialize every other
        # session's bookkeeping).
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, Session]" = OrderedDict()
        self._tenants: Dict[str, int] = {}
        # The session metric families — registered here, so without a
        # store none of them exists.
        reg = self._registry
        self._g_active = reg.gauge(
            "deppy_session_active",
            "Live resolution sessions held by this replica.")
        self._g_active.set(0)
        self._c_ops = reg.counter(
            "deppy_session_ops_total",
            "Session ops served, by op.", labelname="op").preset(*_OPS)
        self._c_expired = reg.counter(
            "deppy_session_expired_total",
            "Sessions expired by lease (sweeper or lazy).")
        self._c_evictions = reg.counter(
            "deppy_session_evictions_total",
            "Sessions evicted or creations shed at a cap, by reason.",
            labelname="reason").preset("cap_expired", "shed")
        # Jittered sweeper (the lease renew-jitter idiom): replicas
        # started together must not sweep in lockstep forever.
        self._sweep_s = sweep_interval_s if sweep_interval_s is not None \
            else min(max(self.lease_s / 4.0, 0.05), 30.0)
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, daemon=True,
            name="deppy-session-sweeper")
        self._sweeper.start()

    # ------------------------------------------------------------ lifecycle

    def stop(self) -> None:
        self._stop.set()
        self._sweeper.join(timeout=5)

    def _sweep_loop(self) -> None:
        import random

        while not self._stop.is_set():
            self._stop.wait(self._sweep_s * (1.0 + 0.2 * random.random()))
            if self._stop.is_set():
                return
            self.sweep()

    def sweep(self) -> int:
        """Expire every lapsed session; returns the count (exposed for
        tests and called by the background sweeper)."""
        now = time.monotonic()
        with self._lock:
            lapsed = [sid for sid, s in self._sessions.items()
                      if s.expired(now)]
            for sid in lapsed:
                self._drop_locked(sid)
            if lapsed:
                self._c_expired.inc(len(lapsed))
        return len(lapsed)

    def _drop_locked(self, sid: str) -> Optional[Session]:
        s = self._sessions.pop(sid, None)
        if s is None:
            return None
        n = self._tenants.get(s.tenant, 0) - 1
        if n > 0:
            self._tenants[s.tenant] = n
        else:
            self._tenants.pop(s.tenant, None)
        self._g_active.set(len(self._sessions))
        return s

    # --------------------------------------------------------------- create

    def _evict_expired_locked(self, tenant: Optional[str] = None) -> bool:
        """LRU-evict ONE expired session (of ``tenant`` when given);
        True when a slot was freed.  Live sessions are never evicted —
        the cap sheds instead."""
        now = time.monotonic()
        for sid, s in self._sessions.items():  # OrderedDict = LRU order
            if s.expired(now) and (tenant is None or s.tenant == tenant):
                self._drop_locked(sid)
                self._c_expired.inc()
                self._c_evictions.inc(label="cap_expired")
                return True
        return False

    def _solver(self, variables, tenant: str) -> Solver:
        """A session's solver: scheduler-attached, on the scheduler's
        backend and device, so nothing in a session defaults to a
        device its scheduler does not use."""
        return Solver(variables, backend=self.scheduler.backend,
                      device=self.scheduler.device,
                      scheduler=self.scheduler, tenant=tenant)

    def create(self, doc, tenant: str = "default") -> dict:
        """Create a session from a single-problem document
        (``{"variables": [...]}``); returns the creation envelope
        (``id``, the family ``key``, and the lease).  Raises
        :class:`ProblemFormatError` / :class:`InternalSolverError` for
        malformed catalogs and :class:`SessionShed` at a cap."""
        variables = problem_io.problem_from_dict(doc)
        solver = self._solver(variables, tenant)
        if solver.problem.errors:
            raise InternalSolverError(solver.problem.errors)
        index = ClauseSetIndex(capacity=SESSION_INDEX_CAPACITY,
                               registry=self._registry)
        solver.warm_index = index
        sid = secrets.token_hex(12)
        with self._lock:
            if self._tenants.get(tenant, 0) >= self.max_per_tenant:
                if not self._evict_expired_locked(tenant):
                    self._c_evictions.inc(label="shed")
                    raise SessionShed("tenant")
            if len(self._sessions) >= self.max_sessions:
                if not self._evict_expired_locked():
                    self._c_evictions.inc(label="shed")
                    raise SessionShed("global")
            s = Session(sid, tenant, solver, index, self.lease_s)
            self._sessions[sid] = s
            self._tenants[tenant] = self._tenants.get(tenant, 0) + 1
            self._g_active.set(len(self._sessions))
        return {"id": sid, "key": s.key, "lease_s": self.lease_s,
                "n_vars": len(solver.problem.variables)}

    # ------------------------------------------------------------------ ops

    def _get(self, sid: str) -> Session:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None and s.expired():
                self._drop_locked(sid)
                self._c_expired.inc()
                s = None
            if s is None:
                raise SessionLost(sid)
            self._sessions.move_to_end(sid)  # LRU touch
            return s

    def op(self, sid: str, doc, deadline_s: Optional[float] = None) -> dict:
        """Drive one op against the retained state.  ``doc`` is
        ``{"op": "assume"|"test"|"untest"|"resolve"|"explain", ...}``;
        solve-carrying ops answer byte-identically to a one-shot cold
        resolve of the derived document.  Raises :class:`SessionLost`,
        :class:`SessionError`, and whatever the solve path raises — a
        kernel that fails to build or launch, or a failed warm screen on
        the card, reaches the caller; nothing answers around it, and the
        session's scope state is unchanged by the failed op."""
        faults.inject("sessions.op")
        if not isinstance(doc, dict) or doc.get("op") not in _OPS:
            raise SessionError(
                f'"op" must be one of {", ".join(_OPS)}')
        s = self._get(sid)
        op = doc["op"]
        attrs = {"op": op, "session": sid, "tenant": s.tenant}
        if self.replica is not None:
            attrs["replica"] = self.replica
        with telemetry.default_registry().span("session.op", **attrs):
            with s.lock:
                s.renew(self.lease_s)
                s.ops += 1
                out = self._op_inner(s, op, doc, deadline_s)
        self._c_ops.inc(label=op)
        return out

    def _op_inner(self, s: Session, op: str, doc: dict,
                  deadline_s: Optional[float]) -> dict:
        if op == "assume":
            idents = doc.get("identifiers")
            if not isinstance(idents, list) or not idents \
                    or not all(isinstance(i, str) for i in idents):
                raise SessionError(
                    '"identifiers" must be a non-empty list of strings')
            installed = doc.get("installed", True)
            if not isinstance(installed, bool):
                raise SessionError('"installed" must be a boolean')
            try:
                s.solver.assume(*idents, installed=installed)
            except InternalSolverError as e:
                raise SessionError("; ".join(e.errors)) from e
            return {"op": "assume",
                    "assumed": len(s.solver.assumptions())}
        if op == "test":
            # Propagation-only scope probe (gini Test): host-cheap by
            # design, so it stays on the inline spec engine like the
            # library facade — host work, not a fallback.
            verdict = s.solver.test()
            return {"op": "test", "result": verdict,
                    "depth": s.solver.scope_depth()}
        if op == "untest":
            try:
                depth = s.solver.untest()
            except InternalSolverError as e:
                raise SessionError("; ".join(e.errors)) from e
            return {"op": "untest", "depth": depth}
        # resolve / explain: the full solve, routed through the
        # scheduler's session lanes.  The rendered "result" object is
        # byte-identical to a one-shot cold resolve of the derived
        # document.
        stats: dict = {}
        r = s.solver.solve_scoped(deadline_s=deadline_s, stats=stats)
        out = {"op": op, "result": problem_io.result_to_dict(r)}
        if stats.get("warm"):
            out["warm"] = True
        return out

    # ------------------------------------------------------ handoff codec

    def export_entries(self) -> List[dict]:
        """Serialize every live session for the snapshot stream.  Lease deadlines export as REMAINING seconds (monotonic
        clocks do not travel between replicas); the private warm index
        rides along in the exact checksummed entry format the shared
        index uses."""
        with self._lock:
            sessions = list(self._sessions.values())
        now = time.monotonic()
        out = []
        for s in sessions:
            with s.lock:
                if s.expired(now):
                    continue
                assumptions, scopes, scope_base = s.solver.scope_state()
                out.append({
                    "id": s.id,
                    "tenant": s.tenant,
                    "affinity": s.key,
                    "variables": [problem_io.variable_to_dict(v)
                                  for v in s.solver.problem.variables],
                    "assumptions": [[i, bool(b)] for i, b in assumptions],
                    "scopes": list(scopes),
                    "scope_base": scope_base,
                    "lease_remaining_s": max(s.deadline - now, 0.0),
                    "ops": s.ops,
                    "index": [index_entry_to_dict(e)
                              for e in s.index.export_entries()],
                })
        return out

    def import_entry(self, raw) -> bool:
        """Rebuild one exported session (snapshot inheritance).
        Live-wins by id; a malformed entry is skipped (False), never
        fatal — exactly the index-entry import posture."""
        try:
            sid = str(raw["id"])
            tenant = str(raw["tenant"])
            variables = [problem_io.variable_from_dict(d)
                         for d in raw["variables"]]
            assumptions = [(str(i), bool(b))
                           for i, b in raw["assumptions"]]
            scopes = [int(x) for x in raw.get("scopes", [])]
            scope_base = int(raw.get("scope_base", 0))
            lease_remaining = float(raw.get("lease_remaining_s", 0.0))
        except (KeyError, TypeError, ValueError):
            return False
        if lease_remaining <= 0.0:
            return False
        solver = self._solver(variables, tenant)
        if solver.problem.errors:
            return False
        index = ClauseSetIndex(capacity=SESSION_INDEX_CAPACITY,
                               registry=self._registry)
        solver.warm_index = index
        try:
            self._replay_scope(solver, assumptions, scopes, scope_base)
        except (InternalSolverError, IndexError, ValueError):
            return False
        for entry in raw.get("index") or []:
            try:
                import_index_entry(index, entry)
            except Exception:  # noqa: BLE001 — a poisoned private-index entry only costs warmth, never the session
                continue
        s = Session(sid, tenant, solver, index,
                    min(lease_remaining, self.lease_s))
        s.ops = int(raw.get("ops", 0))
        with self._lock:
            if sid in self._sessions:
                return False  # live state wins
            if len(self._sessions) >= self.max_sessions \
                    or self._tenants.get(tenant, 0) >= self.max_per_tenant:
                if not self._evict_expired_locked():
                    self._c_evictions.inc(label="shed")
                    return False
            self._sessions[sid] = s
            self._tenants[tenant] = self._tenants.get(tenant, 0) + 1
            self._g_active.set(len(self._sessions))
        return True

    @staticmethod
    def _replay_scope(solver: Solver, assumptions: List[tuple],
                      scopes: List[int], scope_base: int) -> None:
        """Reconstruct the engine's scope stack through the public
        assume/test surface.  ``test()`` pushes the previous base and
        records the assumed-length at each push, so the lengths at
        historical test() calls are ``scopes[1:] + [scope_base]``."""
        lens = (scopes[1:] + [scope_base]) if scopes else []
        idx = 0
        for ln in lens:
            if ln < idx or ln > len(assumptions):
                raise ValueError("inconsistent scope stack")
            for ident, installed in assumptions[idx:ln]:
                solver.assume(ident, installed=installed)
            idx = ln
            solver.test()
        if scope_base > len(assumptions) and not scopes:
            raise ValueError("inconsistent scope stack")
        for ident, installed in assumptions[idx:]:
            solver.assume(ident, installed=installed)

    # ------------------------------------------------------------ accounting

    def active(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> dict:
        with self._lock:
            return {"active": len(self._sessions),
                    "tenants": dict(self._tenants),
                    "lease_s": self.lease_s,
                    "max_sessions": self.max_sessions,
                    "max_per_tenant": self.max_per_tenant}
