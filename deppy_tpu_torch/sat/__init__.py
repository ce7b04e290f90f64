"""Boolean-constraint layer (counterpart: ``deppy_tpu/sat/__init__.py``).

Constraint vocabulary, dense lowering and the :class:`Solver` facade; the
solve itself runs in :mod:`deppy_tpu_torch.engine`.
"""

from .constraints import (
    AppliedConstraint,
    AtMost,
    Conflict,
    Constraint,
    Dependency,
    Identifier,
    Mandatory,
    Prohibited,
    Variable,
    at_most,
    conflict,
    dependency,
    mandatory,
    prohibited,
    variable,
)
from .encode import Problem, encode
from .errors import (
    DuplicateIdentifier,
    Incomplete,
    InternalSolverError,
    NotSatisfiable,
)
from .solver import Solver

__all__ = [
    "AppliedConstraint",
    "AtMost",
    "Conflict",
    "Constraint",
    "Dependency",
    "DuplicateIdentifier",
    "Identifier",
    "Incomplete",
    "InternalSolverError",
    "Mandatory",
    "NotSatisfiable",
    "Problem",
    "Prohibited",
    "Solver",
    "Variable",
    "at_most",
    "conflict",
    "dependency",
    "encode",
    "mandatory",
    "prohibited",
    "variable",
]
