"""Problem-file codec: JSON ⇄ variables (copy of ``deppy_tpu/io.py:1-185``).

Upstream deppy ships no file format; this module defines the wire format
of the CLI and the service — a direct JSON rendering of the constraint
model:

Single problem::

    {
      "variables": [
        {"id": "a", "constraints": [
          {"type": "mandatory"},
          {"type": "dependency", "ids": ["b", "c"]},
          {"type": "conflict", "id": "d"},
          {"type": "atMost", "n": 1, "ids": ["x", "y"]},
          {"type": "prohibited"}
        ]},
        {"id": "b"}
      ]
    }

Batch of independent problems::

    {"problems": [{"variables": [...]}, {"variables": [...]}]}

``dependency.ids`` order is preference order, exactly as in the in-memory
model (upstream constraints.go:125-137).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

from .sat.constraints import (
    AppliedConstraint,
    AtMost,
    Conflict,
    Constraint,
    Dependency,
    Mandatory,
    Prohibited,
    Variable,
)


class ProblemFormatError(ValueError):
    """Raised on a malformed problem document."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProblemFormatError(msg)


def constraint_from_dict(d: Dict[str, Any]) -> Constraint:
    _require(isinstance(d, dict), f"constraint must be an object, got {type(d).__name__}")
    kind = d.get("type")
    if kind == "mandatory":
        return Mandatory()
    if kind == "prohibited":
        return Prohibited()
    if kind == "dependency":
        ids = d.get("ids")
        _require(isinstance(ids, list) and all(isinstance(i, str) for i in ids),
                 "dependency requires a list of string ids")
        return Dependency(tuple(ids))
    if kind == "conflict":
        _require(isinstance(d.get("id"), str), "conflict requires a string id")
        return Conflict(d["id"])
    if kind == "atMost":
        n, ids = d.get("n"), d.get("ids")
        _require(isinstance(n, int) and not isinstance(n, bool) and n >= 0,
                 "atMost requires a non-negative integer n")
        _require(isinstance(ids, list) and all(isinstance(i, str) for i in ids),
                 "atMost requires a list of string ids")
        return AtMost(n, tuple(ids))
    raise ProblemFormatError(f"unknown constraint type {kind!r}")


def constraint_to_dict(c: Constraint) -> Dict[str, Any]:
    if isinstance(c, Mandatory):
        return {"type": "mandatory"}
    if isinstance(c, Prohibited):
        return {"type": "prohibited"}
    if isinstance(c, Dependency):
        return {"type": "dependency", "ids": list(c.ids)}
    if isinstance(c, Conflict):
        return {"type": "conflict", "id": c.id}
    if isinstance(c, AtMost):
        return {"type": "atMost", "n": c.n, "ids": list(c.ids)}
    raise ProblemFormatError(f"unknown constraint {c!r}")


def variable_from_dict(d: Dict[str, Any]) -> Variable:
    _require(isinstance(d, dict), f"variable must be an object, got {type(d).__name__}")
    _require(isinstance(d.get("id"), str), "variable requires a string id")
    raw = d.get("constraints", [])
    _require(isinstance(raw, list), "variable constraints must be a list")
    return Variable(d["id"], tuple(constraint_from_dict(c) for c in raw))


def variable_to_dict(v: Variable) -> Dict[str, Any]:
    out: Dict[str, Any] = {"id": v.identifier}
    if v.constraints:
        out["constraints"] = [constraint_to_dict(c) for c in v.constraints]
    return out


def problem_from_dict(d: Dict[str, Any]) -> List[Variable]:
    _require(isinstance(d, dict), "problem must be an object")
    raw = d.get("variables")
    _require(isinstance(raw, list), 'problem requires a "variables" list')
    return [variable_from_dict(v) for v in raw]


def parse_document(doc: Any) -> Tuple[List[List[Variable]], bool]:
    """Accepts ``{"variables": [...]}`` (one problem) or
    ``{"problems": [...]}`` (a batch); returns (problems, is_batch).
    ``is_batch`` reflects the input form so callers can keep the output
    schema a function of the input shape."""
    _require(isinstance(doc, dict), "document must be a JSON object")
    if "problems" in doc:
        raw = doc["problems"]
        _require(isinstance(raw, list), '"problems" must be a list')
        return [problem_from_dict(p) for p in raw], True
    return [problem_from_dict(doc)], False


def problems_from_document(doc: Any) -> List[List[Variable]]:
    return parse_document(doc)[0]


def load_document(path: str) -> Tuple[List[List[Variable]], bool]:
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ProblemFormatError(f"{path}: invalid JSON: {e}") from e
    return parse_document(doc)


def solution_to_dict(solution: Dict[str, bool]) -> Dict[str, Any]:
    """Render a Solution (every input id → selected?) the way upstream deppy's
    facade reports it (solver.go:52-62), plus the selected subset for
    humans."""
    return {
        "status": "sat",
        "selected": sorted(k for k, v in solution.items() if v),
        "solution": dict(solution),
    }


def unsat_to_dict(constraints: Sequence[AppliedConstraint]) -> Dict[str, Any]:
    """Render a NotSatisfiable core: the same constraint strings the error
    message carries (upstream solve.go:20-30)."""
    return {
        "status": "unsat",
        "conflicts": [str(c) for c in constraints],
    }


def incomplete_to_dict(error: Exception) -> Dict[str, Any]:
    """Render an Incomplete outcome (step budget exhausted before a
    definitive answer — upstream deppy's ErrIncomplete, solve.go:14)."""
    return {
        "status": "incomplete",
        "error": str(error),
    }


def result_to_dict(result: Any) -> Dict[str, Any]:
    """Render one per-problem BatchResolver result — a Solution dict, a
    NotSatisfiable error, or an Incomplete marker — into its wire form.
    The single dispatch shared by the CLI and the service so their output
    schemas cannot drift."""
    from .sat.errors import Incomplete, NotSatisfiable

    if isinstance(result, NotSatisfiable):
        return unsat_to_dict(result.constraints)
    if isinstance(result, Incomplete):
        return incomplete_to_dict(result)
    return solution_to_dict(result)
