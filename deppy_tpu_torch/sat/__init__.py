"""Boolean-constraint layer (counterpart: ``deppy_tpu/sat/__init__.py``).

Constraint vocabulary, dense lowering, the host spec engine and the
:class:`Solver` facade; the device solve runs in
:mod:`deppy_tpu_torch.engine`.
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
    BackendCapabilityError,
    DuplicateIdentifier,
    Incomplete,
    InternalSolverError,
    NotSatisfiable,
)
from .host import HostEngine
from .solver import Solver, assumed_variables
from .tracer import (DefaultTracer, LoggingTracer, SearchPosition,
                     StatsTracer, Tracer)

__all__ = [
    "AppliedConstraint",
    "AtMost",
    "BackendCapabilityError",
    "Conflict",
    "Constraint",
    "DefaultTracer",
    "Dependency",
    "DuplicateIdentifier",
    "HostEngine",
    "Identifier",
    "Incomplete",
    "InternalSolverError",
    "LoggingTracer",
    "Mandatory",
    "NotSatisfiable",
    "Problem",
    "Prohibited",
    "SearchPosition",
    "Solver",
    "StatsTracer",
    "Tracer",
    "Variable",
    "assumed_variables",
    "at_most",
    "conflict",
    "dependency",
    "encode",
    "mandatory",
    "prohibited",
    "variable",
]
