"""Solver error types (copy of ``deppy_tpu/sat/errors.py:1-67``).

Mirrors the error surface of the reference (pkg/sat/solve.go:14-30,
lit_mapping.go:12-22) as Python exceptions.
"""

from __future__ import annotations

from typing import List, Sequence

from .constraints import AppliedConstraint, Identifier


class NotSatisfiable(Exception):
    """Raised when no solution exists.  Carries a minimal set of applied
    constraints sufficient to make a solution impossible
    (reference solve.go:16-30).

    The message format matches the reference exactly:
    ``constraints not satisfiable: a is mandatory, a is prohibited``.
    """

    def __init__(self, constraints: Sequence[AppliedConstraint] = ()):
        self.constraints: List[AppliedConstraint] = list(constraints)
        super().__init__(self._message())

    def _message(self) -> str:
        msg = "constraints not satisfiable"
        if not self.constraints:
            return msg
        return f"{msg}: {', '.join(str(c) for c in self.constraints)}"

    def __str__(self) -> str:
        return self._message()


class DuplicateIdentifier(Exception):
    """Raised at solver construction when two input variables share an
    identifier (reference lit_mapping.go:12-16, solve_test.go:359-365)."""

    def __init__(self, identifier: Identifier):
        self.identifier = identifier
        super().__init__(f'duplicate identifier "{identifier}" in input')


class Incomplete(Exception):
    """Raised when the solve is cancelled (deadline/iteration budget) before
    a definitive answer is found (reference solve.go:14).  Unlike the
    reference — whose search never actually honors its context
    (solve.go:83 passes context.Background()) — the rebuilt engine enforces
    an iteration budget so hung searches surface as this error."""

    def __init__(self, message: str = "cancelled before a solution could be found"):
        super().__init__(message)


class InternalSolverError(Exception):
    """Aggregated internal-consistency failures, e.g. a constraint
    referencing an identifier that was never provided as a variable
    (reference lit_mapping.go:18-22,81-88,115-128)."""

    def __init__(self, errors: Sequence[str]):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} errors encountered: {', '.join(self.errors)}"
        )
