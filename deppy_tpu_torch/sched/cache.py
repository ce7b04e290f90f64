"""Canonical-form result cache (copy of ``deppy_tpu/sched/cache.py:1-331``, the exact LRU and its delta tier).

Catalog traffic is heavily repetitive — thousands of cluster states
re-resolving the same problem against the same catalog — so the
scheduler fingerprints every problem *after* encoding and serves repeats
straight from memory, bypassing the queue and the card entirely.

**Fingerprint.**  :func:`fingerprint` hashes the lowered
:class:`deppy_tpu_torch.sat.encode.Problem`: the clause tensor in
row-sorted (canonical) order with its per-clause constraint map permuted
alongside, every other dense tensor (cardinality rows, anchors, choice
tables) with shape and dtype, and the decode vocabulary (ordered entity
identifiers and applied-constraint strings).  The port encodes byte for
byte like the reference, so a problem's fingerprint here equals the
reference's.

**Budget semantics.**  Entries record the step budget they were solved
under; the solver is deterministic, so

  * a **definitive** result (sat / unsat) found within budget *B* is the
    answer for every request budget ≥ *B* — those hit;
  * an **incomplete** result at budget *B* (budget exhaustion only —
    deadline-degraded lanes are never cached) stays incomplete for every
    request budget ≤ *B* — those hit; a request with a *larger* budget
    is a **budget escalation**: the stale entry is invalidated
    (``deppy_cache_invalidations_total``) and the problem re-solves.

Eviction is LRU at ``capacity`` entries.  Hit/miss/evict counters and
the ``deppy_cache_hit_ratio`` gauge land on the registry the scheduler
was built with.  ``incremental=`` takes the delta-aware tier in front
of the LRU, a :class:`deppy_tpu_torch.incremental.ClauseSetIndex`:
:meth:`ResultCache.lookup_or_plan` (``cache.py:271-286``) consults it
on an exact miss.  :meth:`ResultCache.export_seeds` (``cache.py:256-269``)
is the warm-state snapshot's reader
(:func:`deppy_tpu_torch.fleet.snapshot.export_warm_state`).  The
speculation surfaces (``peek``, ``invalidate_keys``) come with ROADMAP
A5.6.3.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from .. import telemetry
from ..sat.encode import Problem
from ..sat.errors import Incomplete, NotSatisfiable

# Sentinel distinguishing "no cached answer" from a cached None.
MISS = object()


def fingerprint(problem: Problem) -> str:
    """Canonical content hash of one encoded problem (hex digest).

    Clause rows are sorted lexicographically (with ``clause_con``
    permuted alongside) so the hash is invariant to clause emission
    order; everything the decode path reads — identifiers, applied
    constraint strings, every dense tensor with its shape — is folded
    in, so key equality implies byte-identical rendered responses.

    Memoized on the problem object: a Problem's tensors never change
    after ``encode()``."""
    memo = problem.__dict__.get("_fp_digest")
    if memo is not None:
        return memo
    h = hashlib.sha256()

    def feed(tag: str, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr)
        h.update(tag.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())

    c = problem.clauses
    order = np.lexsort(c.T[::-1]) if c.size else np.arange(c.shape[0])
    feed("clauses", c[order])
    feed("clause_con", problem.clause_con[order])
    feed("card_ids", problem.card_ids)
    feed("card_n", problem.card_n)
    feed("card_act", problem.card_act)
    feed("card_con", problem.card_con)
    feed("anchors", problem.anchors)
    feed("choice_cand", problem.choice_cand)
    feed("var_choices", problem.var_choices)
    # Decode vocabulary: the response carries identifiers and applied
    # constraint strings, so they are part of the problem's identity.
    h.update(("\x1f".join(str(v.identifier) for v in problem.variables)
              ).encode())
    h.update(("\x1f".join(str(c) for c in problem.applied)).encode())
    digest = h.hexdigest()
    problem.__dict__["_fp_digest"] = digest
    return digest


def _result_nbytes(result) -> int:
    """Rough per-entry footprint estimate for the ``deppy_cache_bytes``
    gauge: identifier strings dominate a Solution dict, constraint
    strings an unsat core.  Documented as an estimate — it sizes
    capacity planning, not an allocator."""
    if isinstance(result, dict):
        return 96 + sum(len(str(k)) + 28 for k in result)
    cons = getattr(result, "constraints", None)
    if cons is not None:
        return 96 + sum(len(str(c)) + 28 for c in cons)
    return 96


class _Entry:
    __slots__ = ("budget", "result", "definitive", "nbytes")

    def __init__(self, budget: int, result, definitive: bool):
        self.budget = budget
        self.result = result  # Solution dict | NotSatisfiable | None
        self.definitive = definitive
        self.nbytes = _result_nbytes(result)


class ResultCache:
    """Thread-safe LRU keyed by :func:`fingerprint` digests."""

    def __init__(self, capacity: int = 1024,
                 registry: Optional[telemetry.Registry] = None,
                 incremental=None):
        from ..incremental import ClauseSetIndex

        if incremental is not None and not isinstance(incremental,
                                                      ClauseSetIndex):
            raise TypeError(
                f"incremental= takes a ClauseSetIndex or None, not "
                f"{type(incremental).__name__}")
        self.capacity = max(int(capacity), 0)
        # The delta-aware tier (or None): consulted on exact misses.
        self.incremental = incremental
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._hits = reg.counter(
            "deppy_cache_hits_total",
            "Scheduler result-cache hits (queue bypassed).")
        self._misses = reg.counter(
            "deppy_cache_misses_total",
            "Scheduler result-cache misses (problem queued).")
        self._evictions = reg.counter(
            "deppy_cache_evictions_total",
            "Result-cache entries evicted by LRU capacity pressure.")
        self._invalidations = reg.counter(
            "deppy_cache_invalidations_total",
            "Result-cache entries invalidated by budget escalation.")
        self._ratio = reg.gauge(
            "deppy_cache_hit_ratio",
            "Lifetime result-cache hit ratio (hits / lookups).")
        self._ratio.set(0.0)
        self._g_entries = reg.gauge(
            "deppy_cache_entries",
            "Result-cache entries resident right now.")
        self._g_entries.set(0)
        self._g_bytes = reg.gauge(
            "deppy_cache_bytes",
            "Estimated resident result-cache footprint in bytes "
            "(identifier/constraint string heuristic).")
        self._g_bytes.set(0)
        self._bytes = 0
        self._n_hits = 0
        self._n_lookups = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _size_changed_locked(self) -> None:
        self._g_entries.set(len(self._entries))
        self._g_bytes.set(self._bytes)

    def _account(self, hit: bool) -> None:
        """Caller holds the lock."""
        self._n_lookups += 1
        if hit:
            self._n_hits += 1
            self._hits.inc()
        else:
            self._misses.inc()
        self._ratio.set(round(self._n_hits / self._n_lookups, 4))

    def lookup(self, key: str, budget: int):
        """Cached result for ``key`` under ``budget``, or :data:`MISS`.

        Hits return a fresh Solution dict copy (callers may mutate), the
        shared :class:`NotSatisfiable` (immutable by convention), or a
        fresh :class:`Incomplete` marker."""
        if self.capacity == 0:
            return MISS
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._account(hit=False)
                return MISS
            if e.definitive:
                if e.budget > budget:
                    # Solved only with MORE steps than this request
                    # grants: the smaller budget might not have finished.
                    self._account(hit=False)
                    return MISS
                self._entries.move_to_end(key)
                self._account(hit=True)
                if isinstance(e.result, dict):
                    return dict(e.result)
                return e.result
            # Incomplete entry: still incomplete at any smaller budget;
            # a larger budget escalates — invalidate and re-solve.
            if budget <= e.budget:
                self._entries.move_to_end(key)
                self._account(hit=True)
                return Incomplete()
            self._bytes -= e.nbytes
            del self._entries[key]
            self._invalidations.inc()
            self._size_changed_locked()
            self._account(hit=False)
            return MISS

    def export_seeds(self) -> list:
        """``(key, budget, solution-dict)`` for every definitive SAT
        entry, least recently used first — the warm-state snapshot
        surface.  UNSAT and Incomplete entries are not exported: cores
        hold live constraint objects and incompletes are
        budget-relative; both re-solve cold once on the inheritor.
        Solution dicts are copied, so the snapshot cannot alias live
        entries."""
        out = []
        with self._lock:
            for key, e in self._entries.items():
                if e.definitive and isinstance(e.result, dict):
                    out.append((key, e.budget, dict(e.result)))
        return out

    def lookup_or_plan(self, problem: Problem, key: str, budget: int):
        """Exact lookup, then the delta tier: returns ``(hit, None)`` on
        an exact hit, ``(MISS, WarmPlan)`` when the incremental index
        can plan a certified warm start for this problem, and
        ``(MISS, None)`` otherwise (cold path)."""
        hit = self.lookup(key, budget)
        if hit is not MISS:
            if self.incremental is not None:
                # Exact hits never reach the solve/store path, so the
                # index's scan-window recency must be refreshed here or
                # a cycling catalog drifts it off the revisited states.
                self.incremental.touch(key)
            return hit, None
        if self.incremental is None:
            return MISS, None
        return MISS, self.incremental.plan(problem, key, budget)

    def store(self, key: str, budget: int, result) -> None:
        """Record one solved problem.  ``result`` is a Solution dict, a
        :class:`NotSatisfiable`, or an :class:`Incomplete` (cache it
        only for lanes that had NO deadline — deadline degradation says
        nothing about the step budget; the scheduler enforces that)."""
        if self.capacity == 0:
            return
        definitive = isinstance(result, (dict, NotSatisfiable))
        if not definitive and not isinstance(result, Incomplete):
            return  # unknown result shape: never cache defensively
        if isinstance(result, dict):
            # Private copy: the caller holds (and may mutate) the very
            # dict being stored — lookup() copies on the way out, store
            # must copy on the way in or mutation poisons future hits.
            result = dict(result)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if definitive and (not e.definitive or budget < e.budget):
                    # A definitive answer supersedes an incomplete one,
                    # and a smaller sufficient budget widens the entry's
                    # hit range (definitive-at-B serves every B' >= B).
                    self._bytes -= e.nbytes
                    e = _Entry(budget, result, True)
                    self._entries[key] = e
                    self._bytes += e.nbytes
                elif (not definitive and not e.definitive
                        and budget > e.budget):
                    # A deeper incomplete widens the incomplete range.
                    self._bytes -= e.nbytes
                    e = _Entry(budget, None, False)
                    self._entries[key] = e
                    self._bytes += e.nbytes
                self._entries.move_to_end(key)
                self._size_changed_locked()
                return
            e = _Entry(budget, result if definitive else None, definitive)
            self._entries[key] = e
            self._bytes += e.nbytes
            while len(self._entries) > self.capacity:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._evictions.inc()
            self._size_changed_locked()
