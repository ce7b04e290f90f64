"""Optimize-request parsing and objective construction (copy of ``deppy_tpu/optimize/objective.py:1-296``).

The optimization tier answers *best* solutions, and every query class
reduces to one shape: a linear objective over the problem variables,
minimized by the bound-tightening loop in :mod:`.loop`.  This module is
the format layer — it turns the wire document (decoded with the port's
:mod:`deppy_tpu_torch.io`) into variables plus an
:class:`Objective` in SIGNED form:

    cost(model) = offset + sum(signed[v] for model-true v)

where ``signed[v] = cost_true[v] - cost_false[v]`` and ``offset`` is the
sum of the cost-when-false terms.  Folding to signed form is what lets
one engine-side bound (``HostEngine.solve_bounded``) serve all three
query classes: a "keep this installed" preference is a cost WHEN FALSE,
which becomes a negative signed weight, not a second constraint kind.

Query classes:

* ``upgrade`` — minimal-change upgrade planning: "newest acceptable
  bundles, fewest installed entities touched".  Lexicographic via big-M:
  each missed ``prefer`` id costs BIG = n_vars + 1, each touch (an
  installed id removed, a non-installed id added) costs 1.  BIG strictly
  dominates the touch level (at most n touches exist), so one combined
  objective preserves the two-level order inside ONE tightening loop.
* ``soft`` — MaxSAT-style weighted preferences: each violated soft
  constraint costs its weight (positive integer, capped by the
  ``DEPPY_GPU_OPT_MAX_WEIGHT`` knob).
* ``explain`` — no objective at all: the named goals become mandatory
  and the answer is either a plan or the unsat core as a blocking set.

An all-{0,1}-signed objective ("unit-positive") additionally lowers
NATIVELY: the bound "at most W of the weighted vars true" is exactly an
``AtMost`` row carried by a synthetic variable, which makes the probe a
plain :class:`Problem` every registry backend can race.  Mixed-sign or
weighted objectives stay on the host objective engine (the one
``bound_weights`` backend) — see ``registry.optimize_candidates``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sat.constraints import Variable, at_most, mandatory, variable
from ..sat.encode import Problem

QUERIES = ("upgrade", "soft", "explain")

# Carrier for the native AtMost lowering.  Dunder-fenced so a real
# catalog id never collides by accident; a catalog that DOES use the
# name simply loses the native route (the loop falls back to the host
# objective engine), never correctness.
BOUND_VARIABLE_ID = "__deppy_optimize_bound__"


class OptimizeFormatError(ValueError):
    """Raised on a malformed optimize request document (a 400, like
    ``PublishFormatError`` on the publish endpoint)."""


class Objective:
    """A linear objective in signed form over ``n`` problem variables.

    ``signed`` is int64[n]; ``offset`` re-bases values so
    :meth:`value` reports the human cost (0 = every preference met).
    ``floor`` is the least value ANY assignment can take — reaching it
    proves optimality without an UNSAT probe."""

    __slots__ = ("signed", "offset")

    def __init__(self, signed: np.ndarray, offset: int):
        self.signed = np.asarray(signed, dtype=np.int64)
        self.offset = int(offset)

    @property
    def floor(self) -> int:
        return self.offset + int(self.signed[self.signed < 0].sum())

    def value(self, model_true: np.ndarray) -> int:
        """Objective of one model, from its boolean installed mask."""
        return self.offset + int(self.signed[model_true].sum())

    def bound_for(self, value: int) -> int:
        """The engine-side ``obj_bound`` for "cost <= value"."""
        return int(value) - self.offset

    @property
    def unit_positive(self) -> bool:
        """Whether the objective lowers natively to one AtMost row."""
        return self.offset == 0 and bool(
            ((self.signed == 0) | (self.signed == 1)).all())

    def bearing_mask(self, model_true: np.ndarray) -> np.ndarray:
        """Vars where THIS model pays: true with positive weight, or
        false with negative weight — the warm probe's cone seed (any
        cheaper model must flip at least one of these)."""
        return ((model_true & (self.signed > 0))
                | (~model_true & (self.signed < 0)))


class OptimizeRequest:
    """One parsed optimize request: catalog variables + query fields."""

    __slots__ = ("variables", "query", "installed", "prefer", "soft",
                 "goal", "warm")

    def __init__(self, variables: Tuple[Variable, ...], query: str,
                 installed: Tuple[str, ...], prefer: Tuple[str, ...],
                 soft: Tuple[dict, ...], goal: Tuple[str, ...],
                 warm: bool):
        self.variables = variables
        self.query = query
        self.installed = installed
        self.prefer = prefer
        self.soft = soft
        self.goal = goal
        self.warm = warm

    @classmethod
    def from_doc(cls, doc, max_weight: int) -> "OptimizeRequest":
        from .. import io as problem_io

        if not isinstance(doc, dict):
            raise OptimizeFormatError(
                f"optimize body must be an object, got {type(doc).__name__}")
        raw_vars = doc.get("variables")
        if not isinstance(raw_vars, list) or not raw_vars:
            raise OptimizeFormatError(
                '"variables" must be a non-empty list')
        try:
            variables = tuple(problem_io.variable_from_dict(v)
                              for v in raw_vars)
        except problem_io.ProblemFormatError as e:
            raise OptimizeFormatError(str(e)) from e
        query = doc.get("query")
        if query not in QUERIES:
            raise OptimizeFormatError(
                f'"query" must be one of {list(QUERIES)}, got {query!r}')
        known = {str(v.identifier) for v in variables}

        def ids(field: str, require_known: bool) -> Tuple[str, ...]:
            raw = doc.get(field, [])
            if not isinstance(raw, list) \
                    or not all(isinstance(i, str) for i in raw):
                raise OptimizeFormatError(
                    f'"{field}" must be a list of ids')
            if require_known:
                for i in raw:
                    if i not in known:
                        raise OptimizeFormatError(
                            f'"{field}" names unknown id {i!r}')
            return tuple(raw)

        # Installed ids absent from the catalog are IGNORED, not errors:
        # a withdrawn bundle is the normal reason to plan an upgrade.
        installed = tuple(i for i in ids("installed", False) if i in known)
        prefer = ids("prefer", True)
        goal = ids("goal", True)
        soft_raw = doc.get("soft", [])
        if not isinstance(soft_raw, list):
            raise OptimizeFormatError('"soft" must be a list')
        soft: List[dict] = []
        for entry in soft_raw:
            if not isinstance(entry, dict) \
                    or not isinstance(entry.get("id"), str):
                raise OptimizeFormatError(
                    'each soft constraint requires a string "id"')
            if entry["id"] not in known:
                raise OptimizeFormatError(
                    f'"soft" names unknown id {entry["id"]!r}')
            w = entry.get("weight", 1)
            if not isinstance(w, int) or isinstance(w, bool) or w < 1:
                raise OptimizeFormatError(
                    f'soft weight for {entry["id"]!r} must be a '
                    f'positive integer, got {w!r}')
            if w > max_weight:
                raise OptimizeFormatError(
                    f'soft weight for {entry["id"]!r} exceeds the '
                    f'configured cap ({w} > {max_weight})')
            installed_pref = entry.get("installed", True)
            if not isinstance(installed_pref, bool):
                raise OptimizeFormatError(
                    f'soft "installed" for {entry["id"]!r} must be a '
                    'boolean')
            soft.append({"id": entry["id"], "installed": installed_pref,
                         "weight": w})
        if query == "soft" and not soft:
            raise OptimizeFormatError(
                'query "soft" requires a non-empty "soft" list')
        if query == "explain" and not goal:
            raise OptimizeFormatError(
                'query "explain" requires a non-empty "goal" list')
        warm = doc.get("warm", True)
        if not isinstance(warm, bool):
            raise OptimizeFormatError('"warm" must be a boolean')
        return cls(variables, query, installed, prefer, tuple(soft),
                   goal, warm)


def build_objective(req: OptimizeRequest,
                    index: Dict[str, int], n: int) -> Objective:
    """The request's objective in signed form (upgrade/soft queries)."""
    signed = np.zeros(n, dtype=np.int64)
    offset = 0
    if req.query == "upgrade":
        big = n + 1
        installed = set(req.installed)
        for pid in req.prefer:
            signed[index[pid]] -= big
            offset += big
        for i in range(n):
            # Level 2, the touch count: removing an installed entity
            # and adding a non-installed one each cost 1.
            vid = str(req.variables[i].identifier)
            if vid in installed:
                signed[i] -= 1
                offset += 1
            else:
                signed[i] += 1
    else:
        for entry in req.soft:
            i = index[entry["id"]]
            if entry["installed"]:
                signed[i] -= entry["weight"]
                offset += entry["weight"]
            else:
                signed[i] += entry["weight"]
    return Objective(signed, offset)


def explain_variables(req: OptimizeRequest) -> Tuple[Variable, ...]:
    """The catalog with every goal id made mandatory — feasibility of
    this family IS the explain question, and its unsat core IS the
    blocking set."""
    goals = set(req.goal)
    out: List[Variable] = []
    for v in req.variables:
        if str(v.identifier) in goals:
            out.append(Variable(v.identifier,
                                tuple(v.constraints) + (mandatory(),)))
        else:
            out.append(v)
    return tuple(out)


def native_bound_variables(
        variables: Sequence[Variable], objective: Objective,
        bound: int) -> Optional[Tuple[Variable, ...]]:
    """The probe family for the native AtMost lowering, or None when
    the objective (or an id collision) disqualifies it.

    A unit-positive objective's bound "cost <= W" is exactly "at most W
    of the weight-1 vars true" — one AtMost row on a synthetic carrier
    variable.  Activation vars are always assumed TRUE, so the row
    applies unconditionally; the carrier itself is otherwise free and
    is stripped from the answer by the loop."""
    if not objective.unit_positive or bound < 0:
        return None
    if any(str(v.identifier) == BOUND_VARIABLE_ID for v in variables):
        return None
    members = [str(variables[i].identifier)
               for i in np.nonzero(objective.signed == 1)[0]]
    carrier = variable(BOUND_VARIABLE_ID, at_most(int(bound), *members))
    return tuple(variables) + (carrier,)


def cone_mask(problem: Problem, model_true: np.ndarray,
              objective: Objective, hops: int = 2) -> np.ndarray:
    """The warm probe's cone: the previous model's cost-bearing vars
    expanded ``hops`` times through shared clause/cardinality rows —
    the same shape as the incremental tier's delta cone, seeded by
    objective incidence instead of changed constraints.  Off-cone vars
    get pinned to the seed model's phases, so a warm probe only
    re-searches where an improvement can actually come from."""
    n = problem.n_vars
    mask = objective.bearing_mask(model_true).copy()
    cls = problem.clauses
    cls_var = np.abs(cls) - 1           # -1 on pads
    cls_ok = (cls != 0) & (cls_var >= 0) & (cls_var < n)
    card_var = problem.card_ids
    card_ok = (card_var >= 0) & (card_var < n)
    for _ in range(max(int(hops), 0)):
        grown = mask.copy()
        if cls_var.size:
            hit = (cls_ok & mask[np.where(cls_ok, cls_var, 0)]).any(axis=1)
            touched = cls_var[hit][cls_ok[hit]]
            grown[touched] = True
        if card_var.size:
            hit = (card_ok & mask[np.where(card_ok, card_var, 0)]).any(axis=1)
            touched = card_var[hit][card_ok[hit]]
            grown[touched] = True
        if (grown == mask).all():
            break
        mask = grown
    return mask
