"""Host (CPU/NumPy) spec engine, the part the unsat core reaches (copy of ``deppy_tpu/sat/host.py:123-447``, ``:968-1025``).

The tensor engine implements the same algorithm with dense fixed-shape
state; this NumPy engine is its executable specification.  The port keeps
only what :meth:`HostEngine.unsat_core_mask` needs: the constructor, the
dense BCP fixpoint (``_bcp``/``_bcp_loop``), the chronological DPLL
(``_dpll``), the deletion-based unsat core and the step budget.  The
driver routes the core of a giant UNSAT problem here
(:data:`deppy_tpu_torch.engine.driver.HOST_CORE_NCONS`), as the reference
driver does: the answer is bit-identical to the device core phase, and the
steps follow the reference's convention.

Left out (later slices): the preference-ordered search, minimization,
warm/guided/bounded solves, assumption scopes and cancellation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .constraints import AppliedConstraint
from .encode import Problem
from .errors import Incomplete
from .tracer import StatsTracer, Tracer

_UNASSIGNED = 0
_TRUE = 1
_FALSE = -1


class HostEngine:
    """Spec engine over a lowered :class:`Problem`."""

    def __init__(self, problem: Problem, tracer: Optional[Tracer] = None,
                 max_steps: Optional[int] = None):
        self.p = problem
        # StatsTracer is the default tracer: every host solve counts
        # decisions and propagation rounds at the cost of a few int adds.
        self.tracer = tracer if tracer is not None else StatsTracer()
        self.max_steps = max_steps
        self._steps = 0
        self.decisions = 0
        self.propagation_rounds = 0
        self._hook_decision = getattr(self.tracer, "count_decision", None)
        self._hook_propagation = getattr(self.tracer, "count_propagation",
                                         None)

        p = problem
        self.n = p.n_vars
        self.v = p.n_total
        # Clause index/sign planes for vectorized propagation.
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
            self._base[self.n:] = _TRUE
        self.last_conflicts: List[AppliedConstraint] = []

    @property
    def steps(self) -> int:
        """Engine iterations consumed so far (decisions and their DPLL
        loop trips) — the host-side counterpart of ``SolveResult.steps``."""
        return self._steps

    # ------------------------------------------------------------------ BCP

    def _conflict_cons(self, idx) -> None:
        """Record a BCP conflict's applied-constraint indices."""
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        self.last_conflicts = [self.p.applied[j] for j in idx]

    def _bcp(self, assign: np.ndarray, min_mask: Optional[np.ndarray] = None,
             min_w: int = 0) -> Tuple[bool, np.ndarray]:
        """Propagate to fixpoint.  Returns (conflict, assignment).  One
        round evaluates every clause and cardinality row at once;
        ``min_mask``/``min_w`` is the dynamic "at most w of the extras"
        side constraint of the minimization loop (solve.go:100-110)."""
        self._bcp_rounds = 0
        try:
            return self._bcp_loop(assign, min_mask, min_w)
        finally:
            self.propagation_rounds += self._bcp_rounds
            if self._hook_propagation is not None:
                self._hook_propagation(self._bcp_rounds)

    def _bcp_loop(self, assign: np.ndarray, min_mask: Optional[np.ndarray],
                  min_w: int) -> Tuple[bool, np.ndarray]:
        p = self.p
        self.last_conflicts = []
        while True:
            self._bcp_rounds += 1
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

            pending = want != 0
            new = pending & (assign == _UNASSIGNED)
            clash = pending & (assign != _UNASSIGNED) & (assign != want)
            if clash.any():
                return True, assign
            if not new.any():
                return False, assign
            assign = assign.copy()
            assign[new] = want[new]

    # ----------------------------------------------------------------- DPLL

    def _dpll(self, fixed_true: Sequence[int] = (),
              fixed_false: Sequence[int] = (), anchors_assumed: bool = True,
              act_enabled: Optional[np.ndarray] = None,
              min_mask: Optional[np.ndarray] = None, min_w: int = 0
              ) -> Tuple[bool, Optional[np.ndarray]]:
        """Complete search under assumptions — the analog of gini
        ``Solve()`` (search.go:168, solve.go:107): chronological DPLL,
        deciding the lowest-index unassigned problem variable false
        first."""
        assign = self._base.copy()
        if act_enabled is not None:
            assign[self.n:] = np.where(act_enabled, _TRUE, _UNASSIGNED)
        if anchors_assumed:
            assign[self.p.anchors] = _TRUE
        for m in fixed_true:
            assign[m] = _TRUE
        for m in fixed_false:
            assign[m] = _FALSE

        conflict, assign = self._bcp(assign, min_mask, min_w)
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
            conflict, trial = self._bcp(trial, min_mask, min_w)
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
                conflict, trial = self._bcp(trial, min_mask, min_w)
            assign = trial

    # ---------------------------------------------------------- unsat core

    def unsat_core_mask(self) -> np.ndarray:
        """Minimal unsat core as a boolean mask over applied-constraint
        indices, by deletion: start from all constraints active and drop
        any whose removal keeps the remainder unsatisfiable, in constraint
        order, one constraint per probe (lit_mapping.go:198-207).  The
        device core phase's chunked deletion provably returns the same
        core."""
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

    # ------------------------------------------------------------- budget

    def _count_step(self) -> None:
        self._steps += 1
        if self.max_steps is not None and self._steps > self.max_steps:
            raise Incomplete()

    def _count_decision(self) -> None:
        self.decisions += 1
        if self._hook_decision is not None:
            self._hook_decision()
