"""Independent solution checker (copy of ``deppy_tpu/utils/verify.py:1-46``).

Validates a proposed installed set against the constraint semantics defined
by the reference (constraints.go:72-75,96-102,133-140,160-165,196-204)
without involving any solver machinery — the oracle of the port's tests and
of ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Set

from ..sat.constraints import (
    AppliedConstraint,
    AtMost,
    Conflict,
    Dependency,
    Mandatory,
    Prohibited,
    Variable,
)


def check_solution(
    variables: Sequence[Variable], installed: Iterable[str]
) -> List[AppliedConstraint]:
    """Return the applied constraints violated by ``installed`` (empty list
    means the solution is valid)."""
    chosen: Set[str] = set(installed)
    violations: List[AppliedConstraint] = []
    for v in variables:
        for con in v.constraints:
            ok = True
            if isinstance(con, Mandatory):
                ok = v.identifier in chosen
            elif isinstance(con, Prohibited):
                ok = v.identifier not in chosen
            elif isinstance(con, Dependency):
                ok = v.identifier not in chosen or any(d in chosen for d in con.ids)
            elif isinstance(con, Conflict):
                ok = not (v.identifier in chosen and con.id in chosen)
            elif isinstance(con, AtMost):
                ok = sum(1 for d in con.ids if d in chosen) <= con.n
            if not ok:
                violations.append(AppliedConstraint(v, con))
    return violations
