"""Host (CPU/NumPy) spec engine (copy of ``deppy_tpu/sat/host.py:1-1025``).

This is the executable semantic specification of the solve algorithm.
The tensor engine (:mod:`deppy_tpu_torch.engine`) implements the *same*
algorithm with dense fixed-shape state on the card; differential tests
assert the two agree bit-for-bit on outcomes, installed sets and unsat
cores.

Algorithm (mirroring upstream deppy's ``pkg/sat/solve.go:53-119`` and
``search.go:34-203``):

1. assume every constraint's activation + every anchor (solve.go:67-75) and
   run a baseline propagation "Test" (solve.go:79);
2. if undetermined, run the preference-ordered guess search: a deque of
   choices (anchor singletons, then Dependency candidate lists pushed when
   their subject is guessed), depth-first with chronological backtracking
   that retries the next candidate of a failed choice (search.go:34-98);
3. on SAT, cardinality-minimize only the "extras" — model-true variables
   that were never guessed — holding guesses true and model-false variables
   false (solve.go:86-113);
4. on UNSAT, report a minimal core of applied constraints
   (solve.go:114-115) computed by deletion-based minimization over
   activation assumptions (the engine-agnostic analog of gini's ``Why``).

Propagation ("Test", gini inter.S.Test) is a dense boolean-constraint
propagation to fixpoint over the clause matrix plus native cardinality rows;
full "Solve" (gini CDCL, search.go:168) is DPLL with false-first polarity on
the lowest-index unassigned variable, which doubles as a
minimal-model-biased completion.

The whole engine is here: the cold solve, the assumption scopes
(assume/test/untest), the bounded, warm and guided solves, cooperative
cancellation and the step budget, with the reference's step, decision,
propagation-round and backtrack counts.  The driver also routes the core
of a giant UNSAT problem here
(:data:`deppy_tpu_torch.engine.driver.HOST_CORE_NCONS`).

Left out: nothing of the engine.  The worker pool that runs it in other
processes is :mod:`deppy_tpu_torch.hostpool`.
"""

from __future__ import annotations

from collections import deque as _deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from .constraints import AppliedConstraint, Variable
from .encode import Problem
from .errors import Incomplete, InternalSolverError, NotSatisfiable
from .tracer import SearchPosition, StatsTracer, Tracer

SAT = 1
UNSAT = -1
UNKNOWN = 0

_UNASSIGNED = 0
_TRUE = 1
_FALSE = -1


class WarmStartConflict(Exception):
    """A warm-started solve could not certify byte-identity to a cold
    solve and must fall back.

    Raised by :meth:`HostEngine.solve_warm` whenever the cached
    assignment prefix conflicts with the delta problem, the cone search
    needs a backtrack (certification requires a conflict-free cone
    walk), or any other precondition of the warm/cold equivalence
    argument fails.  This is control flow, not an error: the caller
    answers with a cold solve and the result stays exact."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class GuidanceUnverified(Exception):
    """A gradient-guided solve could not certify byte-identity to
    :meth:`HostEngine.solve` and must fall back.

    Raised by :meth:`HostEngine.solve_guided` whenever the rounded
    relaxation fails its BCP verification pass, the problem's baseline
    is UNSAT (cores stay the discrete engines' business), or the
    zero-backtrack completion walk would need real backtracking.  Like
    :class:`WarmStartConflict` this is control flow, not an error: the
    portfolio racer answers with a discrete engine and the result
    stays exact."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class SolveCancelled(Exception):
    """A cooperatively-cancelled solve (portfolio racing).

    Raised from :meth:`HostEngine._count_step` when the engine's
    ``cancel`` event is set: a race's losing host lane stops at the
    next step boundary instead of running to completion.  Never a
    solve verdict — the racer discards the lane entirely."""


@dataclass
class _Guess:
    """One entry of the guess stack (reference search.go:16-21)."""

    choice: int                 # choice-table row
    index: int                  # candidate index guessed (or where search stopped)
    var: int                    # guessed var, or -1 if the choice was null/satisfied
    children: int               # choices spawned by this guess


class _Position(SearchPosition):
    def __init__(self, variables: List[Variable], conflicts: List[AppliedConstraint]):
        self._variables = variables
        self._conflicts = conflicts

    def variables(self) -> List[Variable]:
        return self._variables

    def conflicts(self) -> List[AppliedConstraint]:
        return self._conflicts


# Shared sentinel handed to stats-only tracers (wants_position = False):
# they count the call and never look inside.
_EMPTY_POSITION = _Position([], [])


class HostEngine:
    """Reference engine over a lowered :class:`Problem`."""

    def __init__(
        self,
        problem: Problem,
        tracer: Optional[Tracer] = None,
        max_steps: Optional[int] = None,
        cancel=None,
    ):
        self.p = problem
        # Cooperative cancellation: any object with
        # ``is_set()`` (a ``threading.Event``).  Checked at step
        # boundaries only — a race's losing lane stops at the next
        # step, never mid-propagation.  None (the default) keeps the
        # hot path free of the check's branch.
        self._cancel = cancel
        # StatsTracer is the default tracer (SURVEY.md §5): every host
        # solve — including the driver's host-routed cores — counts
        # decisions/propagation rounds/backtracks into the same channel
        # the tensor engine reports, at the cost of three int adds.
        self.tracer = tracer if tracer is not None else StatsTracer()
        self.max_steps = max_steps
        self._steps = 0
        # Engine-side counters, always maintained (a custom tracer may
        # not implement the optional count_* hooks).
        self.decisions = 0
        self.propagation_rounds = 0
        self.backtracks = 0
        self._hook_decision = getattr(self.tracer, "count_decision", None)
        self._hook_propagation = getattr(
            self.tracer, "count_propagation", None
        )
        # Stats-only tracers (wants_position = False) skip the
        # per-backtrack position snapshot entirely, so wiring StatsTracer
        # as the default adds only integer increments to the hot path.
        self._trace_wants_position = getattr(
            self.tracer, "wants_position", True
        )

        p = problem
        self.n = p.n_vars
        self.v = p.n_total
        # Precompute clause index/sign planes for vectorized propagation.
        cls = p.clauses
        self._cls_mask = cls != 0
        self._cls_var = np.where(self._cls_mask, np.abs(cls) - 1, 0)
        self._cls_sign = np.sign(cls).astype(np.int8)
        card = p.card_ids
        self._card_mask = card >= 0
        self._card_var = np.where(self._card_mask, card, 0)
        # Base assignment: all activation vars true (AssumeConstraints,
        # lit_mapping.go:136-140).
        self._base = np.zeros(self.v, dtype=np.int8)
        if p.n_cons:
            self._base[self.n :] = _TRUE
        self.last_conflicts: List[AppliedConstraint] = []
        # Incremental assumption scopes: the gini
        # Assume/Test/Untest surface (reference solve.go:79,99,104 —
        # inter.S).  ``_assumed_lits`` is the flat signed-literal
        # assumption set; each Test scope OWNS the assumptions added
        # since the previous Test, so ``_test_scopes`` records each
        # scope's START offset (``_scope_base`` = the offset the next
        # scope will start at) and Untest deletes from there.
        self._assumed_lits: List[int] = []
        self._test_scopes: List[int] = []
        self._scope_base = 0

    @property
    def steps(self) -> int:
        """Engine iterations consumed so far (tests, decisions, backtracks) —
        the host-side counterpart of the tensor engine's SolveResult.steps
        (SURVEY.md §5 observability)."""
        return self._steps

    # ------------------------------------------------------------------ BCP

    def _conflict_cons(self, idx) -> None:
        """Record a BCP conflict's applied-constraint indices as rendered
        conflicts for the tracer/`Why` path."""
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        self.last_conflicts = [self.p.applied[j] for j in idx]

    def _bcp(
        self,
        assign: np.ndarray,
        min_mask: Optional[np.ndarray] = None,
        min_w: int = 0,
        obj_w: Optional[np.ndarray] = None,
        obj_bound: int = 0,
    ) -> Tuple[bool, np.ndarray]:
        """Propagate to fixpoint.  Returns (conflict, assignment).

        One round evaluates every clause and cardinality row simultaneously —
        the dense analog of watched-literal BCP, and the op the tensor engine
        turns into a vmapped kernel.  ``min_mask``/``min_w`` is the dynamic
        "at most w of the extras" side-constraint used by the minimization
        loop (the native replacement for CardinalityConstrainer + Leq(w),
        solve.go:100-110).  ``obj_w``/``obj_bound`` is the
        signed generalization the optimize tier's bound-tightening
        probes use: sum(obj_w[v] for model-true v) <= obj_bound, where a
        negative weight models a cost-when-false term (keep-installed)
        folded to signed form — unit positive weights over a mask
        degenerate to exactly the ``min_mask`` rule.
        """
        self._bcp_rounds = 0
        try:
            return self._bcp_loop(assign, min_mask, min_w, obj_w,
                                  obj_bound)
        finally:
            # Telemetry (SURVEY.md §5): every fixpoint iteration counts,
            # whichever of the loop's return paths ended it.
            self.propagation_rounds += self._bcp_rounds
            if self._hook_propagation is not None:
                self._hook_propagation(self._bcp_rounds)

    def _bcp_loop(
        self,
        assign: np.ndarray,
        min_mask: Optional[np.ndarray],
        min_w: int,
        obj_w: Optional[np.ndarray] = None,
        obj_bound: int = 0,
    ) -> Tuple[bool, np.ndarray]:
        p = self.p
        self.last_conflicts = []
        while True:
            self._bcp_rounds += 1
            # Cooperative cancel, per propagation round: the
            # minimization sweep's conflict-probing BCP passes are the
            # engine's dominant cost on deep chains and never reach
            # _count_step — a losing race lane must stop here, not
            # minutes later.
            if self._cancel is not None and self._cancel.is_set():
                raise SolveCancelled()
            changed = False
            conflict = False
            want = np.zeros(self.v, dtype=np.int8)  # pending implications

            if p.clauses.shape[0]:
                vals = assign[self._cls_var] * self._cls_sign
                vals = np.where(self._cls_mask, vals, _FALSE)
                sat_c = (vals == _TRUE).any(axis=1)
                unass = (vals == _UNASSIGNED).sum(axis=1)
                dead = ~sat_c & (unass == 0)
                if dead.any():
                    self._conflict_cons(p.clause_con[np.nonzero(dead)[0]])
                    return True, assign
                units = ~sat_c & (unass == 1)
                if units.any():
                    rows = np.nonzero(units)[0]
                    cols = np.argmax(vals[rows] == _UNASSIGNED, axis=1)
                    uvars = self._cls_var[rows, cols]
                    usigns = self._cls_sign[rows, cols]
                    for uv, us in zip(uvars, usigns):
                        if want[uv] != 0 and want[uv] != us:
                            self._conflict_cons(p.clause_con[rows])
                            return True, assign
                        want[uv] = us

            if p.card_ids.shape[0]:
                mvals = assign[self._card_var]
                trues = ((mvals == _TRUE) & self._card_mask).sum(axis=1)
                unk = ((mvals == _UNASSIGNED) & self._card_mask).sum(axis=1)
                active = assign[p.card_act] == _TRUE
                over = active & (trues > p.card_n)
                if over.any():
                    self._conflict_cons(p.card_con[np.nonzero(over)[0]])
                    return True, assign
                full = active & (trues == p.card_n) & (unk > 0)
                for r in np.nonzero(full)[0]:
                    for m in p.card_ids[r]:
                        if m >= 0 and assign[m] == _UNASSIGNED:
                            if want[m] == _TRUE:
                                self._conflict_cons(p.card_con[r])
                                return True, assign
                            want[m] = _FALSE

            if min_mask is not None:
                mvals = assign[: self.n]
                trues = int(((mvals == _TRUE) & min_mask).sum())
                unk_sel = (mvals == _UNASSIGNED) & min_mask
                if trues > min_w:
                    return True, assign
                if trues == min_w and unk_sel.any():
                    for m in np.nonzero(unk_sel)[0]:
                        if want[m] == _TRUE:
                            return True, assign
                        want[m] = _FALSE

            if obj_w is not None:
                mvals = assign[: self.n]
                unk_m = mvals == _UNASSIGNED
                neg = obj_w < 0
                # Least achievable objective under this prefix:
                # decided-true weights are spent, and every still-open
                # negative weight is free to take.  Like the min_mask
                # rule, a violated bound is a conflict with no applied
                # constraint to blame (it is a side constraint).
                lb = int(obj_w[mvals == _TRUE].sum()
                         + obj_w[unk_m & neg].sum())
                if lb > obj_bound:
                    return True, assign
                if unk_m.any():
                    # Forcing: an open positive-weight var the bound
                    # cannot afford must be false; an open negative-
                    # weight var whose refusal would break the bound
                    # must be true (lb already banks its weight).
                    for m in np.nonzero(unk_m & (obj_w > 0)
                                        & (obj_w + lb > obj_bound))[0]:
                        if want[m] == _TRUE:
                            return True, assign
                        want[m] = _FALSE
                    for m in np.nonzero(unk_m & neg
                                        & (lb - obj_w > obj_bound))[0]:
                        if want[m] == _FALSE:
                            return True, assign
                        want[m] = _TRUE

            pending = want != 0
            new = pending & (assign == _UNASSIGNED)
            clash = pending & (assign != _UNASSIGNED) & (assign != want)
            if clash.any():
                return True, assign
            if not new.any():
                return False, assign
            assign = assign.copy()
            assign[new] = want[new]

    # ----------------------------------------------------------------- Test

    def _test(
        self,
        guessed: Sequence[int],
        extra_true: Sequence[int] = (),
        extra_false: Sequence[int] = (),
        anchors_assumed: bool = True,
        act_enabled: Optional[np.ndarray] = None,
    ) -> Tuple[int, np.ndarray]:
        """Propagation-only check of the current assumption set — the analog
        of gini's ``Test`` (inter.S; used at solve.go:79, search.go:76).
        Returns SAT only when propagation alone yields a total assignment."""
        self._count_step()
        assign = self._base.copy()
        if act_enabled is not None:
            assign[self.n :] = np.where(act_enabled, _TRUE, _UNASSIGNED)
        if anchors_assumed:
            assign[self.p.anchors] = _TRUE
        for m in guessed:
            assign[m] = _TRUE
        for m in extra_true:
            assign[m] = _TRUE
        for m in extra_false:
            assign[m] = _FALSE
        conflict, assign = self._bcp(assign)
        if conflict:
            return UNSAT, assign
        if (assign[: self.n] != _UNASSIGNED).all():
            return SAT, assign
        return UNKNOWN, assign

    # ----------------------------------------------------------------- DPLL

    def _dpll(
        self,
        fixed_true: Sequence[int] = (),
        fixed_false: Sequence[int] = (),
        anchors_assumed: bool = True,
        act_enabled: Optional[np.ndarray] = None,
        min_mask: Optional[np.ndarray] = None,
        min_w: int = 0,
        obj_w: Optional[np.ndarray] = None,
        obj_bound: int = 0,
    ) -> Tuple[bool, Optional[np.ndarray]]:
        """Complete search under assumptions — the analog of gini ``Solve()``
        (search.go:168, solve.go:107).  Chronological DPLL, deciding the
        lowest-index unassigned problem variable false first, so discovered
        models are biased toward minimal installs before the explicit
        cardinality-minimization pass.  The false-first / lowest-index order
        also makes the returned model the lexicographically least model
        (false < true over var index), which the optimize tier relies on as
        its canonical tie-break."""
        assign = self._base.copy()
        if act_enabled is not None:
            assign[self.n :] = np.where(act_enabled, _TRUE, _UNASSIGNED)
        if anchors_assumed:
            assign[self.p.anchors] = _TRUE
        for m in fixed_true:
            assign[m] = _TRUE
        for m in fixed_false:
            assign[m] = _FALSE

        conflict, assign = self._bcp(assign, min_mask, min_w, obj_w, obj_bound)
        if conflict:
            return False, None
        # stack of (var, phase_tried_second, snapshot)
        stack: List[Tuple[int, bool, np.ndarray]] = []
        while True:
            self._count_step()
            unassigned = np.nonzero(assign[: self.n] == _UNASSIGNED)[0]
            if unassigned.size == 0:
                return True, assign
            var = int(unassigned[0])
            self._count_decision()
            stack.append((var, False, assign))
            trial = assign.copy()
            trial[var] = _FALSE
            conflict, trial = self._bcp(trial, min_mask, min_w, obj_w, obj_bound)
            while conflict:
                # Backtrack chronologically: flip the deepest unflipped
                # decision to true; pop flipped ones.
                while stack and stack[-1][1]:
                    stack.pop()
                if not stack:
                    return False, None
                var, _, snap = stack.pop()
                stack.append((var, True, snap))
                trial = snap.copy()
                trial[var] = _TRUE
                conflict, trial = self._bcp(trial, min_mask, min_w, obj_w, obj_bound)
            assign = trial

    # --------------------------------------------------------------- search

    def solve(self) -> Tuple[List[Variable], List[int]]:
        """Run the full algorithm.  Returns (installed variables in input
        order, installed indices).  Raises NotSatisfiable / Incomplete /
        InternalSolverError like the reference's error contract
        (solve.go:53-119)."""
        p = self.p
        if p.errors:
            raise InternalSolverError(p.errors)

        outcome, assign = self._test(guessed=())
        model: Optional[np.ndarray] = assign if outcome == SAT else None
        guessed_order: List[int] = []
        guessed: Set[int] = set()

        if outcome == UNKNOWN:
            outcome, guessed_order, model = self._search()
            guessed = set(guessed_order)
        elif outcome == SAT:
            # Search skipped: the baseline anchors play the role of the
            # guess set for minimization purposes (solve.go:77-83 keeps the
            # anchor assumptions when search doesn't run).
            guessed = set(int(x) for x in p.anchors)

        if outcome == SAT:
            assert model is not None
            return self._minimize(model, guessed)
        if outcome == UNSAT:
            raise NotSatisfiable(self._unsat_core())
        raise Incomplete()

    def _search(self) -> Tuple[int, List[int], Optional[np.ndarray]]:
        """Preference-ordered guess search (reference search.go:158-203)."""
        p = self.p
        dq: _deque = _deque()
        for r in range(len(p.anchors)):
            dq.append((r, 0))  # anchor choice rows come first in the table
        guesses: List[_Guess] = []
        result = UNKNOWN
        model: Optional[np.ndarray] = None

        def assumed_vars() -> List[int]:
            return [g.var for g in guesses if g.var >= 0]

        while True:
            if not dq and result == UNKNOWN:
                ok, m = self._dpll(fixed_true=assumed_vars())
                result = SAT if ok else UNSAT
                if ok:
                    model = m

            if result == UNSAT:
                self.backtracks += 1
                if self.tracer is not None:
                    self.tracer.trace(
                        _Position(
                            [p.variables[g.var] for g in guesses if g.var >= 0],
                            list(self.last_conflicts),
                        )
                        if self._trace_wants_position
                        else _EMPTY_POSITION
                    )
                if not guesses:
                    break
                # PopGuess (search.go:79-98): drop children from the back,
                # requeue the choice at the front advancing its candidate.
                g = guesses.pop()
                for _ in range(g.children):
                    dq.pop()
                dq.appendleft((g.choice, g.index + (1 if g.var >= 0 else 0)))
                if g.var >= 0:
                    result, assign = self._test(guessed=assumed_vars())
                    if result == SAT:
                        model = assign
                continue

            if not dq:
                break  # satisfiable and no decisions left (search.go:182-184)

            # PushGuess (search.go:34-77).
            cid, idx = dq.popleft()
            cands = [int(c) for c in p.choice_cand[cid] if c >= 0]
            var = cands[idx] if idx < len(cands) else -1
            assumed = set(assumed_vars())
            if any(c in assumed for c in cands):
                var = -1  # choice already satisfied by an assumption
            g = _Guess(choice=cid, index=idx, var=var, children=0)
            guesses.append(g)
            if var < 0:
                continue
            self._count_decision()
            for ch in p.var_choices[var] if var < len(p.var_choices) else []:
                if ch >= 0:
                    g.children += 1
                    dq.append((int(ch), 0))
            result, assign = self._test(guessed=assumed_vars())
            if result == SAT:
                model = assign

        return result, assumed_vars(), model

    # ------------------------------------------------------ incremental
    #
    # Two entries sit on top of the cold pipeline above:
    #
    #   * assume/test/untest — the gini incremental-scope surface
    #     (reference solve.go:79,99,104): push assumption literals, run
    #     a propagation-only Test under them, pop the scope.
    #   * solve_warm — the delta warm-start entry: seed the assignment
    #     from a cached model restricted to the untouched cone
    #     complement, re-run search/completion/minimization over the
    #     cone only, and raise WarmStartConflict the moment the run
    #     leaves the regime where warm output provably equals cold
    #     output (any UNSAT test — i.e. any would-be backtrack — or a
    #     conflicting warm prefix).
    #
    # The equivalence argument solve_warm certifies at runtime: the cone
    # is closed under clause/cardinality adjacency, so the problem
    # decomposes into an untouched component (where the cached final
    # model is reproduced verbatim) and the cone component (re-solved
    # cold-style).  Chronological DPLL with the lowest-index/false-first
    # policy returns the lexicographically least model of each
    # independent component, and extras-minimization distributes over
    # components (the global minimum is the sum of component minima, and
    # the lex-least global optimum is the product of component optima) —
    # so as long as no search backtrack occurs in either the cached
    # solve or the cone walk, splicing cached-off-cone with cold-on-cone
    # IS the cold answer.  Any backtrack voids the argument → fallback.

    def assume(self, lits: Sequence[int]) -> None:
        """Add signed 1-based literals to the current assumption set
        (``v+1`` assumes variable ``v`` true, ``-(v+1)`` false) — the
        analog of gini ``Assume``.  Consumed by the next :meth:`test`."""
        for lit in lits:
            if lit == 0 or abs(int(lit)) > self.v:
                raise InternalSolverError(
                    [f"assumption literal {lit} out of range"])
            self._assumed_lits.append(int(lit))

    def test(self) -> int:
        """Propagation-only check of the accumulated assumptions — the
        analog of gini ``Test``: pushes a scope owning every assumption
        added since the previous Test, and returns ``SAT`` / ``UNSAT``
        / ``UNKNOWN`` (SAT only when propagation alone yields a total
        assignment)."""
        # The scope STARTS where the previous one ended — recording the
        # current length instead would make untest() a no-op for the
        # very assumptions this Test evaluated.
        self._test_scopes.append(self._scope_base)
        self._scope_base = len(self._assumed_lits)
        outcome, _ = self._test(
            guessed=(),
            extra_true=[lit - 1 for lit in self._assumed_lits if lit > 0],
            extra_false=[-lit - 1 for lit in self._assumed_lits if lit < 0],
        )
        return outcome

    def untest(self) -> int:
        """Pop the most recent :meth:`test` scope, dropping the
        assumptions it owned — the analog of gini ``Untest``.  Returns
        the remaining scope depth."""
        if not self._test_scopes:
            raise InternalSolverError(["untest without a matching test"])
        self._scope_base = self._test_scopes.pop()
        del self._assumed_lits[self._scope_base:]
        return len(self._test_scopes)

    def solve_warm(
        self, warm_assign: np.ndarray, cone_mask: np.ndarray
    ) -> Tuple[List[Variable], List[int]]:
        """Warm-started solve: ``warm_assign`` (int8[n_vars], the cached
        final model as _TRUE/_FALSE) seeds every variable OUTSIDE
        ``cone_mask``; search, completion, and extras-minimization run
        over the cone only.  Returns exactly what :meth:`solve` returns
        on success; raises :class:`WarmStartConflict` whenever identity
        to a cold solve cannot be certified (the caller falls back)."""
        p = self.p
        if p.errors:
            raise InternalSolverError(p.errors)
        cone = np.asarray(cone_mask, dtype=bool)
        off = ~cone
        warm = np.asarray(warm_assign, dtype=np.int8)
        off_true = [int(i) for i in np.nonzero(off & (warm == _TRUE))[0]]
        off_false = [int(i) for i in np.nonzero(off & (warm != _TRUE))[0]]

        # Cold's own first step: a baseline that decides by propagation
        # alone takes a different (cheap) cold pipeline — fall back.
        outcome, _ = self._test(guessed=())
        if outcome != UNKNOWN:
            raise WarmStartConflict("baseline-decided")
        # The warm prefix: cached off-cone values must propagate without
        # conflict.  A conflict here is the chaos case — a stale or
        # poisoned cached model — and engages the cold fallback.
        outcome, _ = self._test(guessed=(), extra_true=off_true,
                                extra_false=off_false)
        if outcome == UNSAT:
            raise WarmStartConflict("warm-prefix-conflict")

        result, guessed_order, model = self._search_warm(
            off_true, off_false, cone)
        if result != SAT or model is None:
            raise WarmStartConflict("cone-search-conflict")
        return self._minimize_warm(model, set(guessed_order),
                                   off_true, off_false, cone)

    def _search_warm(
        self, off_true: List[int], off_false: List[int],
        cone: np.ndarray,
    ) -> Tuple[int, List[int], Optional[np.ndarray]]:
        """The preference-ordered guess search of :meth:`_search`,
        restricted to the cone component: only cone anchors seed the
        deque (their spawned choices are cone-closed), every Test runs
        under the warm off-cone prefix, and ANY UNSAT result aborts —
        zero backtracks is the certification condition, so the cold
        backtracking machinery is deliberately absent."""
        p = self.p
        dq: _deque = _deque()
        for r in range(len(p.anchors)):
            if cone[int(p.anchors[r])]:
                dq.append((r, 0))
        guesses: List[_Guess] = []
        result = UNKNOWN
        model: Optional[np.ndarray] = None

        def assumed_vars() -> List[int]:
            return [g.var for g in guesses if g.var >= 0]

        while True:
            if not dq and result == UNKNOWN:
                ok, m = self._dpll(fixed_true=assumed_vars() + off_true,
                                   fixed_false=off_false)
                result = SAT if ok else UNSAT
                if ok:
                    model = m
            if result == UNSAT:
                return UNSAT, assumed_vars(), None
            if not dq:
                break
            cid, idx = dq.popleft()
            cands = [int(c) for c in p.choice_cand[cid] if c >= 0]
            var = cands[idx] if idx < len(cands) else -1
            assumed = set(assumed_vars())
            if any(c in assumed for c in cands):
                var = -1
            g = _Guess(choice=cid, index=idx, var=var, children=0)
            guesses.append(g)
            if var < 0:
                continue
            self._count_decision()
            for ch in p.var_choices[var] if var < len(p.var_choices) else []:
                if ch >= 0:
                    g.children += 1
                    dq.append((int(ch), 0))
            result, assign = self._test(guessed=assumed_vars(),
                                        extra_true=off_true,
                                        extra_false=off_false)
            if result == SAT:
                model = assign
        return result, assumed_vars(), model

    def _minimize_warm(
        self, model: np.ndarray, guessed: Set[int],
        off_true: List[int], off_false: List[int], cone: np.ndarray,
    ) -> Tuple[List[Variable], List[int]]:
        """Extras-minimization over the cone component only: off-cone
        variables stay pinned at their cached (already-minimal) values,
        so the sweep's ``w`` range is the cone's extra count, not the
        problem's."""
        p = self.p
        extras = [
            i for i in range(self.n)
            if cone[i] and model[i] == _TRUE and i not in guessed
        ]
        excluded = [
            i for i in range(self.n)
            if cone[i] and model[i] != _TRUE and i not in guessed
        ]
        min_mask = np.zeros(self.n, dtype=bool)
        min_mask[extras] = True
        fixed_true = sorted(set(guessed) | set(off_true))
        fixed_false = excluded + off_false
        for w in range(len(extras) + 1):
            ok, m2 = self._dpll(
                fixed_true=fixed_true,
                fixed_false=fixed_false,
                min_mask=min_mask,
                min_w=w,
            )
            if ok:
                assert m2 is not None
                installed_idx = [i for i in range(self.n) if m2[i] == _TRUE]
                return [p.variables[i] for i in installed_idx], installed_idx
        # Cold minimization failing is an InternalSolverError; a WARM
        # sweep failing just means the certification regime broke —
        # answer cold instead of guessing.
        raise WarmStartConflict("cone-minimization-failed")

    # ----------------------------------------------------------- guided
    #
    # The gradient-relaxation entrant's certification surface.  The
    # continuous descent (``deppy_tpu/engine/grad_relax.py``, not ported
    # yet) proposes a rounded
    # assignment; this entry serves an answer ONLY when that answer is
    # provably the one :meth:`solve` would produce, and raises
    # :class:`GuidanceUnverified` the moment that proof breaks — the
    # portfolio racer then falls back to the discrete engines, so
    # correctness never depends on the heuristic.
    #
    # The equivalence argument, case by case:
    #
    #   * baseline-SAT (propagation from the base assumptions alone
    #     yields a total assignment): every variable is BCP-forced, so
    #     the extras-minimization sweep can only return that exact
    #     fixpoint (each w < n_extras conflicts on the forced trues;
    #     w = n_extras reproduces it) — serving the fixpoint directly
    #     is byte-identical while skipping the O(extras) sweep.  This
    #     is the deep-implication-chain class where lockstep DPLL
    #     burns whole-batch trips (the `hard` bench workload).
    #   * baseline-UNKNOWN: the rounded relaxation is first verified by
    #     one BCP pass (assume every variable at its rounded polarity;
    #     SAT means the rounding is a genuine model — a satisfiability
    #     certificate).  Then the preference-ordered guess search and
    #     the completion DPLL re-run exactly as :meth:`solve` would,
    #     except ANY would-be backtrack aborts (the solve_warm
    #     zero-backtrack discipline; _dpll_guided allows the one
    #     immediate false→true flip canonical DPLL performs in place).
    #     A run that never backtracks IS the canonical run, so the
    #     model — and the canonical `_minimize` that follows — match
    #     byte for byte.
    #   * baseline-UNSAT: unsat cores stay the discrete engines'
    #     business — always unverified.

    def solve_guided(
        self, hint_model: Optional[np.ndarray] = None
    ) -> Tuple[List[Variable], List[int]]:
        """Serve :meth:`solve`'s exact answer via the gradient-guided
        fast path, or raise :class:`GuidanceUnverified` (the caller
        falls back).  ``hint_model`` is the descent's rounded candidate
        (bool[n_vars]); None skips the verification gate and attempts
        the zero-backtrack walk directly (baseline-SAT problems need no
        hint at all)."""
        p = self.p
        if p.errors:
            raise InternalSolverError(p.errors)
        outcome, assign = self._test(guessed=())
        if outcome == UNSAT:
            raise GuidanceUnverified("baseline-unsat")
        if outcome == SAT:
            installed_idx = [i for i in range(self.n)
                             if assign[i] == _TRUE]
            return [p.variables[i] for i in installed_idx], installed_idx
        if hint_model is not None:
            hint = np.asarray(hint_model, dtype=bool)[: self.n]
            v_outcome, _ = self._test(
                guessed=(),
                extra_true=[int(i) for i in np.nonzero(hint)[0]],
                extra_false=[int(i) for i in np.nonzero(~hint)[0]],
            )
            if v_outcome != SAT:
                raise GuidanceUnverified("rounding-unverified")
        result, guessed_order, model = self._search_guided()
        if result != SAT or model is None:
            raise GuidanceUnverified("search-would-backtrack")
        return self._minimize(model, set(guessed_order))

    def _search_guided(self) -> Tuple[int, List[int], Optional[np.ndarray]]:
        """:meth:`_search` with the zero-backtrack discipline of
        :meth:`_search_warm` over the WHOLE problem: same deque walk,
        same Tests, but any UNSAT result aborts (via the UNSAT return —
        the caller raises) and the final completion runs
        :meth:`_dpll_guided`.  A walk that completes is, operation for
        operation, the canonical search's own no-backtrack trace."""
        p = self.p
        dq: _deque = _deque()
        for r in range(len(p.anchors)):
            dq.append((r, 0))
        guesses: List[_Guess] = []
        result = UNKNOWN
        model: Optional[np.ndarray] = None

        def assumed_vars() -> List[int]:
            return [g.var for g in guesses if g.var >= 0]

        while True:
            if not dq and result == UNKNOWN:
                model = self._dpll_guided(assumed_vars())
                result = SAT
            if result == UNSAT:
                return UNSAT, assumed_vars(), None
            if not dq:
                break
            cid, idx = dq.popleft()
            cands = [int(c) for c in p.choice_cand[cid] if c >= 0]
            var = cands[idx] if idx < len(cands) else -1
            assumed = set(assumed_vars())
            if any(c in assumed for c in cands):
                var = -1
            g = _Guess(choice=cid, index=idx, var=var, children=0)
            guesses.append(g)
            if var < 0:
                continue
            self._count_decision()
            for ch in p.var_choices[var] if var < len(p.var_choices) else []:
                if ch >= 0:
                    g.children += 1
                    dq.append((int(ch), 0))
            result, assign = self._test(guessed=assumed_vars())
            if result == SAT:
                model = assign
        return result, assumed_vars(), model

    def _dpll_guided(self, fixed_true: Sequence[int]) -> np.ndarray:
        """The completion DPLL of :meth:`_dpll`, restricted to the
        no-backtrack regime: lowest-index false-first decisions with the
        single in-place false→true flip canonical chronological
        backtracking performs on an immediate conflict.  Needing to pop
        a PREVIOUS decision voids the canonical-identity argument —
        raise and fall back."""
        assign = self._base.copy()
        assign[self.p.anchors] = _TRUE
        for m in fixed_true:
            assign[m] = _TRUE
        conflict, assign = self._bcp(assign)
        if conflict:
            raise GuidanceUnverified("completion-root-conflict")
        while True:
            self._count_step()
            unassigned = np.nonzero(assign[: self.n] == _UNASSIGNED)[0]
            if unassigned.size == 0:
                return assign
            var = int(unassigned[0])
            self._count_decision()
            trial = assign.copy()
            trial[var] = _FALSE
            conflict, trial = self._bcp(trial)
            if conflict:
                trial = assign.copy()
                trial[var] = _TRUE
                conflict, trial = self._bcp(trial)
                if conflict:
                    raise GuidanceUnverified("needs-backtrack")
            assign = trial

    # ----------------------------------------------------------- minimize

    def _minimize(
        self, model: np.ndarray, guessed: Set[int]
    ) -> Tuple[List[Variable], List[int]]:
        """Extras-only cardinality minimization (solve.go:86-113): variables
        chosen by the search stay installed, model-false variables stay out,
        and the count of incidental extras is driven to the minimum
        satisfiable w."""
        p = self.p
        extras = [
            i
            for i in range(self.n)
            if model[i] == _TRUE and i not in guessed
        ]
        excluded = [
            i
            for i in range(self.n)
            if model[i] != _TRUE and i not in guessed
        ]
        min_mask = np.zeros(self.n, dtype=bool)
        min_mask[extras] = True
        for w in range(len(extras) + 1):
            ok, m2 = self._dpll(
                fixed_true=sorted(guessed),
                fixed_false=excluded,
                min_mask=min_mask,
                min_w=w,
            )
            if ok:
                assert m2 is not None
                installed_idx = [i for i in range(self.n) if m2[i] == _TRUE]
                return [p.variables[i] for i in installed_idx], installed_idx
        raise InternalSolverError(["unexpected internal error: minimization failed"])

    # ------------------------------------------------- bounded solve (opt)

    def solve_bounded(
        self,
        obj_w: np.ndarray,
        obj_bound: int,
        seed_model: Optional[np.ndarray] = None,
        cone_mask: Optional[np.ndarray] = None,
    ) -> Tuple[bool, Optional[np.ndarray]]:
        """One bound-tightening probe for the optimize tier:
        find any model with ``sum(obj_w[v] for model-true v) <= obj_bound``,
        or prove none exists under the probe's scope.

        ``seed_model``/``cone_mask`` together form the warm (cone) variant
        mirroring the incremental tier's cone solve: off-cone vars are
        pinned to the seed model's phases and only the cone is re-searched.
        A warm probe's UNSAT is therefore NOT an optimality proof — the
        pinned prefix may be what blocks the bound — and callers must fall
        back to a cold (unseeded) probe before claiming one.  A cold
        probe's False return IS definitive: no model at this bound.

        Raises Incomplete/SolveCancelled through the step counter like
        every other entry point; ``p.errors`` raise InternalSolverError."""
        if self.p.errors:
            raise InternalSolverError(self.p.errors)
        fixed_true: List[int] = []
        fixed_false: List[int] = []
        if seed_model is not None and cone_mask is not None:
            for i in range(self.n):
                if cone_mask[i]:
                    continue
                if seed_model[i] == _TRUE:
                    fixed_true.append(i)
                else:
                    fixed_false.append(i)
        ok, model = self._dpll(
            fixed_true=fixed_true,
            fixed_false=fixed_false,
            obj_w=np.asarray(obj_w, dtype=np.int64)[: self.n],
            obj_bound=int(obj_bound),
        )
        return ok, model

    # ---------------------------------------------------------- unsat core

    def unsat_core_mask(self) -> np.ndarray:
        """Minimal unsat core as a boolean mask over applied-constraint
        indices, via deletion-based minimization: start from all
        constraints active and drop any whose removal keeps the remainder
        unsatisfiable, in constraint order.  Engine-agnostic analog of
        gini's failed-assumption ``Why`` (lit_mapping.go:198-207).

        Probes drop ONE constraint each, in constraint order: on an
        overconstrained catalog a single-drop probe dies to an immediate
        BCP conflict (~1 step), while a multi-drop segment or bisection
        probe leaves a weakly constrained remainder whose UNSAT proof
        needs real search.

        Public so the tensor driver can host-route core extraction for
        giant single problems (engine.driver.HOST_CORE_NCONS) with
        bit-identical results — this loop is the spec the device's
        chunked deletion matches."""
        p = self.p
        active = np.ones(p.n_cons, dtype=bool)
        for j in range(p.n_cons):
            if not active[j]:
                continue
            trial = active.copy()
            trial[j] = False
            ok, _ = self._dpll(anchors_assumed=False, act_enabled=trial)
            if not ok:
                active = trial
        return active

    def _unsat_core(self) -> List[AppliedConstraint]:
        """The mask above decoded to ``AppliedConstraint``s — what
        ``NotSatisfiable`` carries; yields the same (unique-minimal) cores
        the reference tests pin (solve_test.go:111-123,178-197,209-229)."""
        p = self.p
        if p.n_cons == 0:
            return []
        active = self.unsat_core_mask()
        return [p.applied[j] for j in range(p.n_cons) if active[j]]

    # ------------------------------------------------------------- budget

    def _count_step(self) -> None:
        self._steps += 1
        if self._cancel is not None and self._cancel.is_set():
            raise SolveCancelled()
        if self.max_steps is not None and self._steps > self.max_steps:
            raise Incomplete()

    def _count_decision(self) -> None:
        self.decisions += 1
        if self._hook_decision is not None:
            self._hook_decision()
