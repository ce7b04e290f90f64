"""Clause-set fingerprinting and delta classification (copy of ``deppy_tpu/incremental/clauseset.py:1-571``).

The exact fingerprint of :mod:`deppy_tpu_torch.sched.cache` is
all-or-nothing: one changed bundle in a catalog flips the digest and the
whole cache misses.  This module fingerprints each lowered problem at
CLAUSE granularity — a multiset of per-row keys over the
problem-variable literals (activation literals are dropped: they are
positional bookkeeping that shifts when the applied list shifts, while
the solve treats them as constant TRUE) plus the decode-vocabulary key —
so a delta request can be matched against the NEAREST cached solve and
classified instead of rejected:

  * ``identical``  — same clause/cardinality multiset (the exact digest
    may still differ: constraint strings are not solve-relevant);
  * ``additive``   — rows added only;
  * ``retractive`` — rows removed only;
  * ``mixed``      — both.

For a classified delta the **touched cone** is the variable set
reachable from the changed rows through shared literals, closed over
the union of both problems' structural rows — by construction no clause
or cardinality row spans the cone boundary, which is exactly the
decomposition :meth:`deppy_tpu_torch.sat.host.HostEngine.solve_warm`
certifies against.  The warm plan gates (cached solve was SAT with zero
search backtracks, cone fraction under the
``max_delta_ratio`` cutoff, generous step budget) keep
every served warm start inside the regime where warm output provably
equals cold output; anything outside falls back to a cold solve.

Brought across: :func:`problem_rows` (``:70``), :func:`vocab_key`
(``:110``), :func:`touched_cone` (``:133``), the lazy rows of
``_Entry`` (``:179-210``), :class:`WarmPlan` (``:213``) and
:class:`ClauseSetIndex` (``:232``: ``store`` with ``lazy_rows=``,
``export_entries`` / ``import_entry`` with ``_admit_locked``, ``touch``,
``plan``, the nearest-entry scan, the sessions' scoped planner
``plan_for_scope`` with the ``scoped`` delta class, and the
accounting, and the speculation tier's ``affected_keys`` (``:530``)
and read-only ``plan(account=False)`` (``:379``)), with a plain
``threading`` lock.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..sat.encode import Problem

DELTA_IDENTICAL = "identical"
DELTA_ADDITIVE = "additive"
DELTA_RETRACTIVE = "retractive"
DELTA_MIXED = "mixed"
# A stateful session's scoped solve, planned from the delta the session
# DECLARED (its assumption-stack diff) instead of from per-row
# classification — the O(delta) fast path of plan_for_scope().
DELTA_SCOPED = "scoped"

# Nearest-entry search is a multiset intersection per candidate; bound
# the scan to the most recent entries of the vocabulary bucket so a huge
# index cannot turn every lookup into a linear walk, and stop early at
# an entry within ACCEPT_DELTA changed rows — a single-row delta cannot
# meaningfully be beaten (a 0-row twin would classify identical, but
# both serve from the same cached model).  Anything looser picks a
# 2-row neighbor spanning TWO bundles over a 1-row neighbor spanning
# one, inflating the cone past the serve cutoff.
SCAN_CAP = 32
ACCEPT_DELTA = 1

# Warm serving is certified for models/cores, but a warm solve does less
# WORK than a cold solve — under a pathologically tight step budget the
# cold run could exhaust (Incomplete) where the warm run finishes.  The
# tier therefore engages only under budgets generously above the cached
# solve's measured cost; tighter budgets take the cold path unchanged.
MIN_WARM_BUDGET = 1 << 16
WARM_BUDGET_FACTOR = 16


def problem_rows(problem: Problem) -> "Counter[tuple]":
    """The problem's structural-row multiset: one key per clause and one
    per cardinality row.  Activation literals are dropped — see the
    module docstring.  Two deliberate asymmetries:

      * Clause literals keep their EMITTED order, and each clause key
        carries its ordinal among its subject variable's clauses.  Both
        are preference-relevant: a dependency's candidate order decides
        which candidate the search guesses first, and a variable's
        constraint order decides the order its choices spawn — sorting
        either away would serve a cached model for a problem whose cold
        solve prefers a different candidate.
      * Cardinality members ARE sorted: counting true members is
        order-invariant and spawns no choices.

    Memoized on the problem object: classification and store both need
    it, and rows never change after encode()."""
    memo = problem.__dict__.get("_inc_rows")
    if memo is not None:
        return memo
    n = problem.n_vars
    rows: "Counter[tuple]" = Counter()
    c = problem.clauses
    per_subject: Dict[int, int] = {}
    if c.size:
        kept = np.where(np.abs(c) <= n, c, 0)
        for row in kept:
            lits = tuple(row[row != 0].tolist())
            subj = abs(lits[0]) - 1 if lits else -1
            ordinal = per_subject.get(subj, 0)
            per_subject[subj] = ordinal + 1
            rows[("c", ordinal) + lits] += 1
    for ids_row, bound in zip(problem.card_ids, problem.card_n):
        members = ids_row[ids_row >= 0]
        rows[("k", int(bound)) + tuple(sorted(members.tolist()))] += 1
    problem.__dict__["_inc_rows"] = rows
    return rows


def vocab_key(problem: Problem) -> Tuple[int, tuple]:
    """Decode-vocabulary identity: variable identifiers in input order.
    Warm starts require index-aligned models, so only same-vocabulary
    problems are comparable.  (Applied-constraint strings are NOT part
    of this key — they are exactly what churn changes.)"""
    memo = problem.__dict__.get("_inc_vocab")
    if memo is not None:
        return memo
    key = (problem.n_vars,
           tuple(str(v.identifier) for v in problem.variables))
    problem.__dict__["_inc_vocab"] = key
    return key


def _row_vars(key: tuple) -> List[int]:
    """0-based problem-var indices of one row key (clause keys are
    ``("c", ordinal, *lits)``, cardinality keys ``("k", bound,
    *members)``)."""
    if key[0] == "c":
        return [abs(lit) - 1 for lit in key[2:]]
    return list(key[2:])


def touched_cone(problem: Problem, seed_vars, extra_rows) -> np.ndarray:
    """Close ``seed_vars`` over shared-literal adjacency: any structural
    row (of the NEW problem, plus ``extra_rows`` — the removed rows of
    the old one) sharing a variable with the cone pulls all its
    variables in.  At the fixpoint every row is wholly inside or wholly
    outside the cone, so the problem decomposes across the boundary."""
    n = problem.n_vars
    cone = np.zeros(n, dtype=bool)
    seed = [v for v in seed_vars if 0 <= v < n]
    if not seed:
        return cone
    cone[seed] = True
    # Vectorized edges: clause rows (act literals masked off) and
    # cardinality member rows, padded with sentinel index ``n``.
    edges = []
    c = problem.clauses
    if c.size:
        kept = np.where(np.abs(c) <= n, np.abs(c), 0)
        edges.append(np.where(kept > 0, kept - 1, n))
    if problem.card_ids.size:
        m = problem.card_ids
        edges.append(np.where(m >= 0, m, n).astype(np.int64))
    extra = [np.asarray(_row_vars(k), dtype=np.int64)
             for k in extra_rows if _row_vars(k)]
    ext = np.zeros(n + 1, dtype=bool)
    while True:
        ext[:n] = cone
        grew = False
        for vm in edges:
            touched = ext[vm].any(axis=1)
            if touched.any():
                hit = vm[touched]
                hit = hit[hit < n]
                if not cone[hit].all():
                    cone[hit] = True
                    grew = True
        for row in extra:
            if cone[row].any() and not cone[row].all():
                cone[row] = True
                grew = True
        if not grew:
            return cone


class _Entry:
    __slots__ = ("key", "_rows", "vocab", "model", "steps", "backtracks",
                 "_problem")

    def __init__(self, key: str, rows: "Optional[Counter[tuple]]", vocab,
                 model: np.ndarray, steps: int, backtracks: int,
                 problem: Optional[Problem] = None):
        self.key = key
        # ``rows=None`` defers the per-row multiset to first use: a
        # session's private-index store happens per interactive step,
        # and the scoped planner never reads rows — only the
        # generic-classifier fallback and the snapshot export do, so
        # eager O(problem) hashing there is latency for nothing.
        self._rows = rows
        self._problem = problem if rows is None else None
        self.vocab = vocab
        self.model = model            # bool[n_vars], the final installed set
        self.steps = int(steps)
        self.backtracks = int(backtracks)

    @property
    def rows(self) -> "Counter[tuple]":
        rows = self._rows
        if rows is None:
            prob = self._problem
            if prob is None:
                # Another thread materialized between our None check
                # and the problem read — its assignment is ordered
                # before the clear.
                return self._rows
            rows = problem_rows(prob)
            self._rows = rows
            self._problem = None
        return rows


class WarmPlan:
    """Everything one lane needs to attempt a warm-started solve."""

    __slots__ = ("problem", "key", "warm_assign", "cone", "klass",
                 "cone_fraction", "entry_key", "entry_steps")

    def __init__(self, problem: Problem, key: str, warm_assign: np.ndarray,
                 cone: np.ndarray, klass: str, cone_fraction: float,
                 entry_key: str, entry_steps: int):
        self.problem = problem
        self.key = key
        self.warm_assign = warm_assign  # int8[n_vars], cached model
        self.cone = cone                # bool[n_vars], to re-solve
        self.klass = klass
        self.cone_fraction = cone_fraction
        self.entry_key = entry_key
        self.entry_steps = entry_steps


class ClauseSetIndex:
    """Thread-safe LRU of solved clause-set fingerprints — the
    delta-aware tier in front of the exact-fingerprint result cache.

    ``plan()`` classifies an exact-miss problem against the nearest
    same-vocabulary entry and returns a :class:`WarmPlan` when every
    warm-identity gate passes; ``store()`` records SAT solves that are
    warm-start seeds (zero search backtracks).  Counters and the cone
    histogram land on the registry the scheduler was built with."""

    def __init__(self, capacity: int = 512,
                 max_delta_ratio: float = 0.25,
                 registry: Optional[telemetry.Registry] = None):
        self.capacity = max(int(capacity), 0)
        self.max_delta_ratio = float(max_delta_ratio)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._by_vocab: Dict[tuple, "OrderedDict[str, None]"] = {}
        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._registry = reg
        self._c_hits = reg.counter(
            "deppy_incremental_hits_total",
            "Warm-started solves served from the incremental tier.")
        self._c_fallbacks = reg.counter(
            "deppy_incremental_warm_fallbacks_total",
            "Warm-start attempts that fell back to a cold solve "
            "(prefix conflict, cone backtrack, budget).")
        self._c_delta = reg.counter(
            "deppy_incremental_delta_total",
            "Delta classifications against the clause-set index, by "
            "class (identical / additive / retractive / mixed / "
            "scoped / none).",
            labelname="class")
        self._h_cone = reg.histogram(
            "deppy_incremental_cone_fraction",
            "Touched-cone size as a fraction of problem variables, per "
            "planned warm start.",
            buckets=telemetry.RATIO_BUCKETS)
        self._n_lookups = 0
        self._n_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------ store

    def store(self, key: str, problem: Problem, model: np.ndarray,
              steps: int, backtracks: int,
              lazy_rows: bool = False) -> None:
        """Record one SAT solve.  Only zero-backtrack solves are
        warm-start seeds (the certification precondition), so anything
        else is dropped here rather than filtered on every lookup.
        ``lazy_rows=True`` (the scoped session store) defers the
        O(problem) per-row hashing to first use — the scoped planner
        never reads it."""
        if self.capacity == 0 or int(backtracks) != 0:
            return
        rows = None if lazy_rows else problem_rows(problem)
        vocab = vocab_key(problem)
        model = np.asarray(model, dtype=bool).copy()
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = _Entry(key, rows, vocab, model,
                                            steps, backtracks,
                                            problem=problem)
                # Refresh bucket recency too: the nearest-entry scan is
                # bounded to the most recent bucket keys, and a cycling
                # catalog re-stores old fingerprints — without the touch
                # the scan window drifts away from the live neighbors.
                bucket = self._by_vocab.get(vocab)
                if bucket is not None and key in bucket:
                    bucket.move_to_end(key)
                return
            self._admit_locked(_Entry(key, rows, vocab, model,
                                      steps, backtracks, problem=problem))

    def _admit_locked(self, entry: _Entry) -> None:
        """Insert a NEW entry (caller holds the lock; ``entry.key``
        not resident) and evict past capacity, keeping ``_entries``
        and ``_by_vocab`` in sync — the one copy of the eviction
        invariant, shared by ``store`` and ``import_entry``."""
        self._entries[entry.key] = entry
        bucket = self._by_vocab.setdefault(entry.vocab, OrderedDict())
        bucket[entry.key] = None
        while len(self._entries) > self.capacity:
            old_key, old = self._entries.popitem(last=False)
            ob = self._by_vocab.get(old.vocab)
            if ob is not None:
                ob.pop(old_key, None)
                if not ob:
                    del self._by_vocab[old.vocab]

    def export_entries(self) -> List[_Entry]:
        """Every resident entry, least recently used first (so an
        importer replaying the list reproduces this index's recency
        order) — the warm-state snapshot surface
        (:func:`deppy_tpu_torch.fleet.snapshot.export_warm_state`, and
        each session's private index in the session handoff)."""
        with self._lock:
            return list(self._entries.values())

    def import_entry(self, key: str, rows: "Counter[tuple]", vocab,
                     model: np.ndarray, steps: int,
                     backtracks: int) -> bool:
        """Admit one deserialized entry (the snapshot handoff path).
        Returns False without touching anything when ``key`` is already
        resident — the live entry is at least as fresh as the handed-off
        copy — or when the entry is not a certified warm seed (the
        store() gate: only zero-backtrack SAT models may seed warm
        starts, and a tampered snapshot must not widen that).  Raises
        ``ValueError`` when the model is not index-aligned with the
        entry's vocabulary: admitting a misaligned entry would plant a
        crash on the live warm path for that family's next delta."""
        if self.capacity == 0 or int(backtracks) != 0:
            return False
        model = np.asarray(model, dtype=bool).copy()
        if model.shape != (int(vocab[0]),):
            raise ValueError(
                f"model length {model.size} does not match the entry "
                f"vocabulary ({vocab[0]} variables)")
        with self._lock:
            if key in self._entries:
                return False
            self._admit_locked(_Entry(key, rows, vocab, model,
                                      steps, backtracks))
        return True

    def touch(self, key: str) -> None:
        """Refresh ``key``'s LRU and bucket recency without re-storing.
        Called on EXACT result-cache hits: those bypass the solve (and
        therefore the store-side recency refresh), and a cycling
        catalog would otherwise drift the bounded nearest-entry scan
        window away from the states traffic is actually revisiting."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            self._entries.move_to_end(key)
            bucket = self._by_vocab.get(entry.vocab)
            if bucket is not None and key in bucket:
                bucket.move_to_end(key)

    # ------------------------------------------------------------- plan

    def plan(self, problem: Problem, key: str, budget: int,
             account: bool = True) -> Optional[WarmPlan]:
        """Classify ``problem`` against the nearest cached entry and
        return a warm plan when certifiable, else None.  Spanned as
        ``incremental.delta`` with the class and cone size.

        ``account=False`` (the read-only preview tier) skips the
        lookup/delta/cone accounting AND the span: a what-if
        consultation that never serves must not deflate the serving
        tier's hit ratio or inflate its delta counters."""
        if self.capacity == 0:
            return None
        t0 = time.perf_counter()
        plan = self._plan_inner(problem, key, budget, account)
        if account:
            self._registry.record_span(
                "incremental.delta", time.perf_counter() - t0,
                klass=plan.klass if plan is not None else "none",
                cone=int(plan.cone.sum()) if plan is not None else 0)
        return plan

    def _plan_inner(self, problem: Problem, key: str, budget: int,
                    account: bool = True) -> Optional[WarmPlan]:
        vocab = vocab_key(problem)
        with self._lock:
            if account:
                self._n_lookups += 1
            empty = not self._by_vocab.get(vocab)
        if empty:
            # No comparable entry: skip the per-row hashing entirely —
            # a cold fleet's first pass must not pay the delta tier.
            if account:
                self._c_delta.inc(label="none")
            return None
        rows = problem_rows(problem)
        with self._lock:
            entry = self._nearest_locked(vocab, rows)
        if entry is None:
            if account:
                self._c_delta.inc(label="none")
            return None
        added = rows - entry.rows
        removed = entry.rows - rows
        if not added and not removed:
            klass = DELTA_IDENTICAL
        elif not removed:
            klass = DELTA_ADDITIVE
        elif not added:
            klass = DELTA_RETRACTIVE
        else:
            klass = DELTA_MIXED
        if account:
            self._c_delta.inc(label=klass)
        seed: List[int] = []
        for k in list(added) + list(removed):
            seed.extend(_row_vars(k))
        cone = touched_cone(problem, seed, removed.keys())
        fraction = float(cone.sum()) / max(problem.n_vars, 1)
        if fraction > self.max_delta_ratio:
            return None
        if int(budget) < max(MIN_WARM_BUDGET,
                             WARM_BUDGET_FACTOR * (entry.steps + 1)):
            return None
        warm_assign = np.where(entry.model, 1, -1).astype(np.int8)
        if account:
            self._h_cone.observe(fraction)
        return WarmPlan(problem, key, warm_assign, cone, klass, fraction,
                        entry.key, entry.steps)

    def _nearest_locked(self, vocab, rows) -> Optional[_Entry]:
        bucket = self._by_vocab.get(vocab)
        if not bucket:
            return None
        best = None
        best_delta = None
        n_rows = sum(rows.values())
        # Most recent entries first (churn clusters in time); nearest =
        # SMALLEST symmetric difference, not largest intersection — two
        # ancestors can share equally many rows while one carries extra
        # baggage that would all land in the cone.
        for k in list(reversed(bucket))[:SCAN_CAP]:
            entry = self._entries.get(k)
            if entry is None:
                continue
            shared = sum((rows & entry.rows).values())
            delta = (n_rows - shared) + (sum(entry.rows.values()) - shared)
            if best_delta is None or delta < best_delta:
                best, best_delta = entry, delta
            if best_delta <= ACCEPT_DELTA:
                break
        return best

    # ------------------------------------------------- scoped planning

    def plan_for_scope(self, problem: Problem, key: str, budget: int,
                       entry_key: str, seed_vars) -> Optional[WarmPlan]:
        """O(delta) warm planning for a stateful session's scoped solve.

        A session KNOWS its delta: successive scoped solves differ from
        each other only in the assumption-derived unit constraints on
        the variables whose assumptions changed — ``seed_vars``, the
        symmetric difference of the two assumption stacks.  That makes
        the generic :meth:`plan` pipeline's per-row multiset hashing and
        nearest-entry scan (both O(problem), paid per step) pure
        overhead here: this path looks the declared predecessor up by
        ``entry_key`` directly and closes the declared seed over
        shared-literal adjacency, so the per-step planning cost scales
        with the CHANGE, not the catalog.

        Identity is preserved by construction plus certification: every
        added/removed row is a unit constraint whose subject variable is
        in ``seed_vars`` (per-subject clause ordinals shift only for
        those same subjects), so the fixpoint cone contains every
        differing row and off-cone rows are byte-identical between the
        entry's problem and this one — the same decomposition invariant
        :meth:`plan` establishes, with
        :meth:`deppy_tpu_torch.sat.host.HostEngine.solve_warm` still the
        authoritative certifier (any imperfect plan falls back to a
        cold solve, answers unchanged).  The serve gates — entry is a
        zero-backtrack seed (enforced at :meth:`store`), cone fraction
        under ``max_delta_ratio``, generous budget — are the generic
        path's gates, unweakened."""
        if self.capacity == 0:
            return None
        t0 = time.perf_counter()
        with self._lock:
            self._n_lookups += 1
            entry = self._entries.get(entry_key)
        plan = None
        if entry is not None and entry.vocab == vocab_key(problem):
            cone = touched_cone(problem, seed_vars, ())
            fraction = float(cone.sum()) / max(problem.n_vars, 1)
            if (fraction <= self.max_delta_ratio
                    and int(budget) >= max(
                        MIN_WARM_BUDGET,
                        WARM_BUDGET_FACTOR * (entry.steps + 1))):
                warm_assign = np.where(entry.model, 1, -1).astype(np.int8)
                self._h_cone.observe(fraction)
                plan = WarmPlan(problem, key, warm_assign, cone,
                                DELTA_SCOPED, fraction, entry.key,
                                entry.steps)
        self._c_delta.inc(
            label=DELTA_SCOPED if plan is not None else "none")
        self._registry.record_span(
            "incremental.delta", time.perf_counter() - t0,
            klass=plan.klass if plan is not None else "none",
            cone=int(plan.cone.sum()) if plan is not None else 0)
        return plan

    # -------------------------------------------------------- accounting

    def note_served(self) -> None:
        with self._lock:
            self._n_hits += 1
        self._c_hits.inc()

    def note_fallback(self) -> None:
        self._c_fallbacks.inc()

    def hit_ratio(self) -> float:
        """Warm starts served / incremental lookups (exact-cache misses
        that consulted this tier)."""
        with self._lock:
            if self._n_lookups == 0:
                return 0.0
            return round(self._n_hits / self._n_lookups, 4)

    # ------------------------------------------------------------ affected

    def affected_keys(self, identifiers) -> List[str]:
        """Fingerprints of indexed solves a catalog publish touches,
        most recently stored first: an entry is affected when some
        structural row (clause or cardinality) mentions a changed
        identifier — the per-row keys store literals as vocab indices,
        so membership is a vocab-index lookup plus a row scan.  A
        changed identifier absent from an entry's vocabulary cannot
        affect it (no row can reference an unknown variable)."""
        wanted = frozenset(identifiers)
        if not wanted:
            return []
        out: List[str] = []
        with self._lock:
            entries = list(reversed(self._entries.values()))
        for entry in entries:
            idx = {i for i, ident in enumerate(entry.vocab[1])
                   if ident in wanted}
            if not idx:
                continue
            for row_key in entry.rows:
                if any(v in idx for v in _row_vars(row_key)):
                    out.append(entry.key)
                    break
        return out
