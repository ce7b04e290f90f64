"""Publish deltas and the speculation manager (copy of ``deppy_tpu/speculate/manager.py:1-336``).

A catalog publish names the bundles whose constraint sets changed (an
ABSOLUTE replacement per bundle, so applying the same publish to any
retained state of a family is idempotent) and the bundles withdrawn
outright.  :class:`SpeculationManager` glues the publish feed to the
serving stack:

  * ``observe`` retains the most recent problem families the scheduler
    served (the original variable lists, keyed by canonical
    fingerprint) — the raw material a delta is applied to;
  * ``publish`` enumerates the affected cached fingerprints through the
    :meth:`ClauseSetIndex.affected_keys` per-row scan, evicts the now
    pre-publish entries from the exact result cache (they can never be
    re-asked and must not linger), and queues one pre-solve per
    affected retained family through
    :meth:`deppy_tpu_torch.sched.Scheduler.submit_speculative`;
  * ``preview`` runs the same enumeration + application READ-ONLY: the
    proposed problems resolve on the host warm path (index plan → warm
    attempt → inline cold host solve) without storing into the cache or
    the index — the "what-if" scenario class.

The reference's ``lockdep`` lock is a plain :class:`threading.Lock`
here (ROADMAP A7.2 brings lockdep).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..sat.constraints import Prohibited, Variable
from ..sat.errors import Incomplete, NotSatisfiable

# Families retained for delta application.  Bounded LRU like every other
# serving-side store; sized above the result cache's default so a family
# whose exact entry is still live always has its variables on hand.
DEFAULT_FAMILY_CAPACITY = 2048
# Preview solves run inline on the caller's thread; bound the fan-out so
# one what-if request over a huge index cannot monopolize a handler.
# MAX is a server-side ceiling the client's `limit` cannot exceed.
DEFAULT_PREVIEW_LIMIT = 32
MAX_PREVIEW_LIMIT = 128


class PublishFormatError(ValueError):
    """Raised on a malformed publish/preview document."""


class PublishDelta:
    """One parsed catalog publish.

    ``updates`` maps bundle identifier → its NEW constraint tuple
    (absolute replacement, not a diff); ``removed`` lists withdrawn
    bundles — applied as :class:`Prohibited` so dependents re-resolve
    away from them without dangling references."""

    __slots__ = ("updates", "removed")

    def __init__(self, updates: Dict[str, tuple], removed: Sequence[str]):
        self.updates = dict(updates)
        self.removed = frozenset(removed)

    @classmethod
    def from_doc(cls, doc) -> "PublishDelta":
        from .. import io as problem_io

        if not isinstance(doc, dict):
            raise PublishFormatError(
                f"publish body must be an object, got {type(doc).__name__}")
        updates: Dict[str, tuple] = {}
        raw = doc.get("updates", [])
        if not isinstance(raw, list):
            raise PublishFormatError('"updates" must be a list')
        for entry in raw:
            if not isinstance(entry, dict) \
                    or not isinstance(entry.get("id"), str):
                raise PublishFormatError(
                    'each update requires a string "id"')
            cons = entry.get("constraints", [])
            if not isinstance(cons, list):
                raise PublishFormatError(
                    f'update {entry["id"]!r}: "constraints" must be a list')
            try:
                updates[entry["id"]] = tuple(
                    problem_io.constraint_from_dict(c) for c in cons)
            except problem_io.ProblemFormatError as e:
                raise PublishFormatError(
                    f"update {entry['id']!r}: {e}") from e
        removed = doc.get("removed", [])
        if not isinstance(removed, list) \
                or not all(isinstance(i, str) for i in removed):
            raise PublishFormatError('"removed" must be a list of ids')
        if not updates and not removed:
            raise PublishFormatError(
                'publish names no changes (empty "updates" and "removed")')
        return cls(updates, removed)

    def changed_identifiers(self) -> frozenset:
        return frozenset(self.updates) | self.removed

    def apply(self, variables: Sequence[Variable]) -> Optional[tuple]:
        """The post-publish variable list for one family, or None when
        the publish leaves it untouched (no named bundle present, or
        every named bundle already carries the published constraints)."""
        changed = False
        out: List[Variable] = []
        for v in variables:
            if v.identifier in self.removed:
                nc: tuple = (Prohibited(),)
            elif v.identifier in self.updates:
                nc = self.updates[v.identifier]
            else:
                out.append(v)
                continue
            if tuple(v.constraints) != nc:
                changed = True
            out.append(Variable(v.identifier, nc))
        return tuple(out) if changed else None


class _Family:
    __slots__ = ("variables", "ids")

    def __init__(self, variables: Tuple[Variable, ...]):
        self.variables = variables
        self.ids = frozenset(v.identifier for v in variables)


class SpeculationManager:
    """Publish subscription + speculative pre-solve orchestration.

    Owned by the :class:`deppy_tpu_torch.sched.Scheduler` (constructed
    only when ``speculate`` is on) so publishes reach the exact cache,
    the clause-set index, and the idle-priority queue the live traffic
    uses — pre-solved answers are indistinguishable from ordinary
    ones."""

    def __init__(self, scheduler,
                 registry: Optional[telemetry.Registry] = None,
                 family_capacity: int = DEFAULT_FAMILY_CAPACITY):
        self._sched = scheduler
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        self._family_capacity = max(int(family_capacity), 0)
        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._registry = reg
        self._c_publishes = reg.counter(
            "deppy_speculate_publishes_total",
            "Catalog publishes accepted on the watch endpoint/CLI.")
        self._c_affected = reg.counter(
            "deppy_speculate_affected_total",
            "Cached fingerprints enumerated as affected by a publish.")
        self._c_presolves = reg.counter(
            "deppy_speculate_presolves_total",
            "Speculative pre-solve lanes queued at idle priority.")
        self._c_dropped = reg.counter(
            "deppy_speculate_dropped_total",
            "Speculative pre-solves dropped (backlog cap, malformed "
            "family, or shutdown discard).")
        self._c_previews = reg.counter(
            "deppy_speculate_previews_total",
            "What-if preview resolutions served (read-only).")

    # ---------------------------------------------------------- observe

    def observe(self, key: str, variables: Sequence[Variable]) -> None:
        """Retain one served family (called per problem on the submit
        path — a dict store under the lock, nothing heavier).  The
        retained variable list is what a later publish is applied to."""
        if self._family_capacity == 0:
            return
        fam = _Family(tuple(variables))
        with self._lock:
            self._families[key] = fam
            self._families.move_to_end(key)
            while len(self._families) > self._family_capacity:
                self._families.popitem(last=False)

    def backlog(self) -> int:
        """Speculative lanes queued at idle priority right now."""
        return self._sched.speculative_depth()

    def note_discarded(self, n: int) -> None:
        """Speculative lanes the scheduler discarded (shutdown drain —
        no submitter waits on a pre-solve, so a drain drops them)."""
        if n:
            self._c_dropped.inc(n)

    # ---------------------------------------------------------- publish

    def _affected(self, delta: PublishDelta) -> List[Tuple[str, _Family]]:
        """Affected retained families, most recently served first: the
        union of the clause-set index's per-row enumeration (a key is
        affected when some structural row touches a changed bundle) and
        a membership check over retained families the index never
        admitted (non-SAT or backtracking solves still have cached exact
        results worth pre-replacing)."""
        changed = delta.changed_identifiers()
        index = getattr(self._sched, "incremental", None)
        index_keys = (set(index.affected_keys(changed))
                      if index is not None else set())
        with self._lock:
            items = list(reversed(self._families.items()))
        return [(key, fam) for key, fam in items
                if key in index_keys or fam.ids & changed]

    def publish(self, delta: PublishDelta,
                max_steps: Optional[int] = None) -> dict:
        """Handle one catalog publish: invalidate pre-publish cache
        entries, queue speculative pre-solves for every affected
        retained family, and return the accounting the endpoint/CLI
        renders."""
        reg = self._registry
        with reg.span("speculate.publish",
                      changed=len(delta.changed_identifiers())) as sp:
            self._c_publishes.inc()
            affected = self._affected(delta)
            self._c_affected.inc(len(affected))
            jobs: List[tuple] = []
            stale: List[str] = []
            unchanged = 0
            for key, fam in affected:
                new_vars = delta.apply(fam.variables)
                if new_vars is None:
                    # The family ALREADY carries the published
                    # constraints (an idempotent re-publish, or a
                    # post-publish re-ask already retained): its cached
                    # answer is the post-publish answer — evicting it
                    # would throw away exactly the hot entries the tier
                    # exists to keep.
                    unchanged += 1
                else:
                    stale.append(key)
                    jobs.append(new_vars)
            # Publish-driven invalidation: the entries the delta
            # actually changes describe PRE-publish catalog states and
            # must be evicted, not served stale — before the pre-solves
            # queue, so none is served between the publish and the
            # drain.
            invalidated = self._sched.cache.invalidate_keys(stale)
            # Retire the superseded retained states too: a later
            # publish applied to a pre-publish family would pre-solve
            # states no publish-tracking client will ever ask.  The
            # POST-publish states re-enter retention through
            # submit_speculative's observe (and through the clients'
            # own re-asks), so back-to-back publishes compose.
            with self._lock:
                for key in stale:
                    self._families.pop(key, None)
            queued, dropped = self._sched.submit_speculative(
                jobs, max_steps=max_steps)
            self._c_presolves.inc(queued)
            self._c_dropped.inc(dropped)
            out = {
                "changed": len(delta.changed_identifiers()),
                "affected": len(affected),
                "invalidated": invalidated,
                "queued": queued,
                "dropped": dropped,
                "unchanged": unchanged,
            }
            sp.set(**{k: v for k, v in out.items() if k != "changed"})
        return out

    # ---------------------------------------------------------- preview

    def preview(self, delta: PublishDelta,
                max_steps: Optional[int] = None,
                limit: Optional[int] = None) -> List[dict]:
        """Resolve a PROPOSED catalog change against the live index
        without serving or caching it: per affected family, the
        post-publish resolution (warm-started off the index when the
        plan certifies, inline cold host solve otherwise).  Nothing is
        stored anywhere — re-asking the same preview re-solves."""
        from ..incremental import attempt as warm_attempt
        from ..sat.encode import encode
        from ..sat.host import HostEngine
        from ..sched.cache import fingerprint

        if limit is None:
            limit = DEFAULT_PREVIEW_LIMIT
        limit = min(max(int(limit), 0), MAX_PREVIEW_LIMIT)
        index = getattr(self._sched, "incremental", None)
        out: List[dict] = []
        t0 = time.perf_counter()
        with self._registry.span("speculate.preview") as sp:
            for key, fam in self._affected(delta):
                if len(out) >= limit:
                    break
                new_vars = delta.apply(fam.variables)
                if new_vars is None:
                    continue
                problem = encode(new_vars)
                if problem.errors:
                    out.append({"fingerprint": key,
                                "error": "; ".join(problem.errors)})
                    continue
                new_key = fingerprint(problem)
                # account=False: a what-if consultation must not deflate
                # the serving tier's hit ratio or delta counters (the
                # same rule ResultCache.peek applies to the exact tier).
                plan = (index.plan(problem, new_key, 1 << 24,
                                   account=False)
                        if index is not None else None)
                klass = plan.klass if plan is not None else None
                result = None
                if plan is not None:
                    lane = warm_attempt(plan, max_steps)
                    if lane is not None:
                        result = {v.identifier: False
                                  for v in problem.variables}
                        for i in lane.installed_idx:
                            result[problem.variables[i].identifier] = True
                if result is None:
                    eng = HostEngine(problem, max_steps=max_steps)
                    try:
                        _, installed_idx = eng.solve()
                        result = {v.identifier: False
                                  for v in problem.variables}
                        for i in installed_idx:
                            result[problem.variables[i].identifier] = True
                    except NotSatisfiable as e:
                        result = e
                    except Incomplete as e:
                        result = e
                self._c_previews.inc()
                out.append({"fingerprint": key, "delta_class": klass,
                            "result": result})
            sp.set(families=len(out),
                   wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return out
