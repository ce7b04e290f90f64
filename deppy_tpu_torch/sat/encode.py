"""Lowering to dense problem tensors (copy of ``deppy_tpu/sat/encode.py:1-388``).

This is the tensor-engine equivalent of upstream deppy's ``LitMapping``
(``pkg/sat/lit_mapping.go:40-77``): a two-pass construction that
(1) assigns an index to every variable, rejecting duplicates
(lit_mapping.go:49-57), and (2) lowers every constraint into solver inputs
(lit_mapping.go:59-74).  Where the reference builds a gini logic circuit and
Tseitin-translates it to CNF (lit_mapping.go:132-134), this encoder emits:

  * a dense padded clause matrix ``clauses: int32[C, K]`` in signed-DIMACS
    convention (literal ``v+1`` means "variable v true", ``-(v+1)`` false,
    ``0`` is padding), and
  * native **cardinality rows** for ``AtMost`` constraints, which the tensor
    engine propagates directly (count true members; ``> n`` is a conflict,
    ``== n`` forces the rest false).  This replaces gini's sorting-network
    ``CardSort`` (reference constraints.go:180-186) — a pointer-heavy circuit
    that lowers poorly to dense tensors — with an arc-consistency-equivalent
    formulation that is a single masked reduction over bitplanes.

Activation variables: every applied constraint ``j`` owns an auxiliary
boolean ``N + j`` that guards its clauses (``act → clause``).  Assuming all
activation variables true enforces every constraint — the analog of
``AssumeConstraints`` (lit_mapping.go:136-140) — while unsat-core extraction
re-solves with subsets of activations enabled, the analog of gini's
failed-assumption ``Why`` (lit_mapping.go:198-207).

Index conventions used throughout the framework:
  * clause literals: signed 1-based, 0 = padding;
  * every other index tensor: 0-based, -1 = padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .constraints import (
    AppliedConstraint,
    AtMost,
    Conflict,
    Dependency,
    Identifier,
    Mandatory,
    Prohibited,
    Variable,
    mandatory,
    prohibited,
)
from .errors import DuplicateIdentifier


@dataclass
class Problem:
    """A fully lowered constraint-resolution problem.

    Host-side metadata (variables, applied constraints, id maps) lives
    alongside the dense tensors so solutions and unsat cores can be decoded
    back to the caller's vocabulary, mirroring LitMapping's bidirectional
    translation role (lit_mapping.go:24-34).
    """

    # --- host metadata ---
    variables: List[Variable]                 # input order (inorder, lit_mapping.go:28)
    applied: List[AppliedConstraint]          # global constraint order
    id_to_index: Dict[Identifier, int]
    errors: List[str]                         # missing-reference errors (lit_mapping.go:81-88)

    # --- dense tensors (numpy; batching/jit conversion happens downstream) ---
    clauses: np.ndarray        # int32[C, K]   signed 1-based lits, 0 pad
    clause_con: np.ndarray     # int32[C]      applied-constraint index per clause
    card_ids: np.ndarray       # int32[NA, M]  0-based member var indices, -1 pad
    card_n: np.ndarray         # int32[NA]     bound per row
    card_act: np.ndarray       # int32[NA]     0-based activation var index
    card_con: np.ndarray       # int32[NA]     applied-constraint index per row
    anchors: np.ndarray        # int32[A]      0-based anchor var indices, input order
    choice_cand: np.ndarray    # int32[NC, Kc] candidate var indices per choice, -1 pad
    var_choices: np.ndarray    # int32[N, W]   choice rows spawned by guessing var, -1 pad

    @property
    def n_vars(self) -> int:
        """Number of problem variables (entities)."""
        return len(self.variables)

    @property
    def n_cons(self) -> int:
        """Number of applied constraints (= number of activation vars)."""
        return len(self.applied)

    @property
    def n_total(self) -> int:
        """Total boolean variables: problem vars + activation vars."""
        return self.n_vars + self.n_cons

    def act_index(self, j: int) -> int:
        """Activation variable index of applied constraint ``j``."""
        return self.n_vars + j


def _pad2d(rows: Sequence[Sequence[int]], pad: int, min_width: int = 1) -> np.ndarray:
    lens = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
    width = max(int(lens.max(initial=0)), min_width)
    out = np.full((len(rows), width), pad, dtype=np.int32)
    # One flattened fill via a ragged mask instead of a per-row python
    # loop: encode() is the framework's hottest pure-host path and this
    # function was ~1/3 of it.
    flat = np.fromiter(
        (x for r in rows for x in r), np.int32, count=int(lens.sum()))
    out[np.arange(width) < lens[:, None]] = flat
    return out


def encode(variables: Sequence[Variable]) -> Problem:
    """Lower ``variables`` to a :class:`Problem`.

    Raises :class:`DuplicateIdentifier` on repeated identifiers
    (lit_mapping.go:52-54); accumulates references to unprovided identifiers
    in ``Problem.errors`` instead of failing, matching the deferred
    internal-error contract of the reference (lit_mapping.go:81-88 with the
    deferred check at solve.go:54-61).
    """
    variables = list(variables)
    id_to_index: Dict[Identifier, int] = {}
    for i, v in enumerate(variables):
        if v.identifier in id_to_index:
            raise DuplicateIdentifier(v.identifier)
        id_to_index[v.identifier] = i
    n = len(variables)

    errors: List[str] = []

    def lookup(ident: Identifier) -> int:
        idx = id_to_index.get(ident)
        if idx is None:
            errors.append(f'variable "{ident}" referenced but not provided')
            return -1
        return idx

    applied: List[AppliedConstraint] = []
    clause_rows: List[List[int]] = []
    clause_con: List[int] = []
    card_rows: List[List[int]] = []
    card_n: List[int] = []
    card_act: List[int] = []
    card_con: List[int] = []
    anchors: List[int] = []
    anchor_set = set()
    # Choice table: rows 0..A-1 are anchor singletons (seeded into the search
    # deque in input order, reference search.go:159-161); subsequent rows are
    # Dependency candidate lists in global constraint order, spawned when
    # their subject variable is guessed (search.go:60-69).
    dep_choice_rows: List[List[int]] = []
    var_dep_choices: List[List[int]] = [[] for _ in range(n)]

    for i, v in enumerate(variables):
        for con in v.constraints:
            j = len(applied)
            applied.append(AppliedConstraint(v, con))
            act = n + j  # activation var; clause form is (¬act ∨ formula)
            subj = i
            if isinstance(con, Mandatory):
                clause_rows.append([-(act + 1), subj + 1])
                clause_con.append(j)
                if i not in anchor_set:
                    anchor_set.add(i)
                    anchors.append(i)
            elif isinstance(con, Prohibited):
                clause_rows.append([-(act + 1), -(subj + 1)])
                clause_con.append(j)
            elif isinstance(con, Dependency):
                # (¬act ∨ ¬subject ∨ id₁ ∨ id₂ …) — reference builds the same
                # disjunction as an Or-gate fold (constraints.go:117-123).  An
                # empty Dependency degenerates to (¬act ∨ ¬subject): the
                # subject cannot be installed (constraints.go:107-108).
                # Duplicate target literals are dropped (x ∨ x ≡ x) so the
                # per-occurrence and per-variable (bitplane) propagation
                # counts agree on every clause.
                row = [-(act + 1), -(subj + 1)]
                seen_lits = set(row)
                for ident in con.ids:
                    t = lookup(ident)
                    if t >= 0 and (t + 1) not in seen_lits:
                        seen_lits.add(t + 1)
                        row.append(t + 1)
                clause_rows.append(row)
                clause_con.append(j)
                if con.ids:
                    cid = len(dep_choice_rows)
                    # Candidates are exactly the resolved tail of the clause.
                    dep_choice_rows.append([lit - 1 for lit in row[2:]])
                    var_dep_choices[i].append(cid)
            elif isinstance(con, Conflict):
                # Self-conflict (id == subject) degenerates to ¬subject;
                # dedup keeps the per-occurrence and bitplane counts equal.
                t = lookup(con.id)
                row = [-(act + 1), -(subj + 1)]
                if t >= 0 and -(t + 1) not in row:
                    row.append(-(t + 1))
                clause_rows.append(row)
                clause_con.append(j)
            elif isinstance(con, AtMost):
                # Dedup members: bitplane cardinality rows count each
                # variable once, so the dense row must as well.
                members = []
                for ident in con.ids:
                    m = lookup(ident)
                    if m >= 0 and m not in members:
                        members.append(m)
                card_rows.append(members)
                card_n.append(con.n)
                card_act.append(act)
                card_con.append(j)
            else:  # pragma: no cover - defensive
                errors.append(f"unknown constraint type {type(con).__name__!r}")

    a = len(anchors)
    # Final choice table: anchor singletons first, then dependency rows
    # (dependency choice ids shift by ``a``).
    choice_rows: List[List[int]] = [[x] for x in anchors] + dep_choice_rows
    var_choices = [[a + cid for cid in cids] for cids in var_dep_choices]

    return Problem(
        variables=variables,
        applied=applied,
        id_to_index=id_to_index,
        errors=errors,
        clauses=_pad2d(clause_rows, pad=0) if clause_rows else np.zeros((0, 1), np.int32),
        clause_con=np.asarray(clause_con, dtype=np.int32),
        card_ids=_pad2d(card_rows, pad=-1) if card_rows else np.zeros((0, 1), np.int32),
        card_n=np.asarray(card_n, dtype=np.int32),
        card_act=np.asarray(card_act, dtype=np.int32),
        card_con=np.asarray(card_con, dtype=np.int32),
        anchors=np.asarray(anchors, dtype=np.int32),
        choice_cand=_pad2d(choice_rows, pad=-1) if choice_rows else np.zeros((0, 1), np.int32),
        var_choices=_pad2d(var_choices, pad=-1) if var_choices else np.zeros((0, 1), np.int32),
    )


def encode_assumed(problem: Problem,
                   assumptions: Sequence[Tuple[Identifier, bool]]) -> Problem:
    """O(delta) relowering of an already-encoded ``problem`` under an
    assumption stack: each ``(identifier, installed)`` pair becomes a
    ``Mandatory`` (installed) or ``Prohibited`` constraint on its
    subject variable — exactly ``encode(assumed_variables(...))``, built
    by splicing the assumption unit clauses into the retained tensors
    instead of re-walking the whole catalog (a session's per-step
    cost must scale with the CHANGE, not the catalog).

    The dense tensors are byte-identical to the full relowering's —
    pinned by the differential test — because an assumption constraint
    lowers to one unit clause inserted at the end of its subject
    variable's applied block: every later applied index (and therefore
    every later activation literal) shifts by the insertion count before
    it, Mandatory subjects join ``anchors`` in variable order, and the
    anchor-singleton head of the choice table regrows around the
    untouched dependency rows.  Unknown identifiers are dropped, exactly
    as :func:`deppy_tpu_torch.sat.solver.assumed_variables` drops them.

    Tensors the delta cannot touch (``card_ids``/``card_n``, and the
    choice tables when no new anchor appears) are SHARED with the base
    problem, not copied — every consumer treats problem tensors as
    read-only (the driver pads into fresh arrays, ``driver.pad_stack``)."""
    if not assumptions:
        return problem
    n = problem.n_vars
    by_var: Dict[int, List[bool]] = {}
    for ident, installed in assumptions:
        idx = problem.id_to_index.get(ident)
        if idx is not None:
            by_var.setdefault(idx, []).append(bool(installed))
    if not by_var:
        return problem
    # Cumulative applied-constraint count per variable: cum[i + 1] is
    # the applied index where variable i's block ends — the insertion
    # point for its assumption constraints.  Memoized: the facade calls
    # this per step against ONE retained base problem.
    cum = problem.__dict__.get("_assume_cum")
    if cum is None:
        cum = np.concatenate([
            np.zeros(1, np.int64),
            np.cumsum(np.fromiter((len(v.constraints)
                                   for v in problem.variables),
                                  np.int64, count=n))])
        problem.__dict__["_assume_cum"] = cum
    ins_vars: List[int] = []
    ins_installed: List[bool] = []
    ins_pos: List[int] = []
    for i in sorted(by_var):
        for flag in by_var[i]:
            ins_vars.append(i)
            ins_installed.append(flag)
            ins_pos.append(int(cum[i + 1]))
    k = len(ins_pos)
    pos = np.asarray(ins_pos, dtype=np.int64)

    def remap(j) -> np.ndarray:
        """Old applied index -> new: shifted past every insertion at or
        before it."""
        j = np.asarray(j, dtype=np.int64)
        return j + np.searchsorted(pos, j, side="right")

    new_j = pos + np.arange(k, dtype=np.int64)   # inserted applied idx
    acts = n + new_j                             # their activation vars

    # Clause matrix: renumber activation literals, splice unit rows in
    # applied order (clause rows ARE in applied order — AtMost rows
    # live in the cardinality tensors).
    c = problem.clauses
    if c.size:
        cc = c.astype(np.int64)
        m = np.abs(cc) > n
        vals = np.abs(cc[m]) - 1 - n
        cc[m] = np.sign(cc[m]) * (n + remap(vals) + 1)
    else:
        cc = np.zeros((0, 2), np.int64)
    rows = np.zeros((k, cc.shape[1]), dtype=np.int64)
    rows[:, 0] = -(acts + 1)
    subj = np.asarray(ins_vars, dtype=np.int64) + 1
    rows[:, 1] = np.where(np.asarray(ins_installed, dtype=bool),
                          subj, -subj)
    r_ins = np.searchsorted(problem.clause_con, pos, side="left")
    clauses_new = np.insert(cc, r_ins, rows, axis=0).astype(np.int32)
    clause_con_new = np.insert(remap(problem.clause_con), r_ins,
                               new_j).astype(np.int32)

    if problem.card_act.size:
        card_act_new = (n + remap(problem.card_act.astype(np.int64) - n)
                        ).astype(np.int32)
        card_con_new = remap(problem.card_con).astype(np.int32)
    else:
        card_act_new = problem.card_act
        card_con_new = problem.card_con

    # Anchors: Mandatory assumptions promote their subjects.  encode()
    # appends anchors in variable order, so the merged list is the
    # sorted union.
    mand = {v for v, flag in zip(ins_vars, ins_installed) if flag}
    base_anchor = set(problem.anchors.tolist())
    anchors_new = problem.anchors
    choice_cand_new = problem.choice_cand
    var_choices_new = problem.var_choices
    if mand - base_anchor:
        anchors_new = np.asarray(sorted(base_anchor | mand),
                                 dtype=np.int32)
        a_old = problem.anchors.size
        a_new = anchors_new.size
        dep = (problem.choice_cand[a_old:] if problem.choice_cand.size
               else np.zeros((0, 1), np.int32))
        head = np.full((a_new, dep.shape[1]), -1, dtype=np.int32)
        head[:, 0] = anchors_new
        choice_cand_new = np.concatenate([head, dep], axis=0)
        vc = problem.var_choices
        var_choices_new = np.where(vc >= 0, vc + (a_new - a_old),
                                   vc).astype(np.int32)

    # Host metadata: extended Variable objects for assumed subjects,
    # fresh AppliedConstraint entries spliced into the applied order.
    variables_new = list(problem.variables)
    applied_new: List[AppliedConstraint] = []
    prev = 0
    for i in sorted(by_var):
        end = int(cum[i + 1])
        applied_new.extend(problem.applied[prev:end])
        prev = end
        v = problem.variables[i]
        cons = tuple(mandatory() if flag else prohibited()
                     for flag in by_var[i])
        nv = Variable(v.identifier, tuple(v.constraints) + cons)
        variables_new[i] = nv
        applied_new.extend(AppliedConstraint(nv, con) for con in cons)
    applied_new.extend(problem.applied[prev:])

    return Problem(
        variables=variables_new,
        applied=applied_new,
        id_to_index=problem.id_to_index,
        errors=list(problem.errors),
        clauses=clauses_new,
        clause_con=clause_con_new,
        card_ids=problem.card_ids,
        card_n=problem.card_n,
        card_act=card_act_new,
        card_con=card_con_new,
        anchors=anchors_new,
        choice_cand=choice_cand_new,
        var_choices=var_choices_new,
    )
