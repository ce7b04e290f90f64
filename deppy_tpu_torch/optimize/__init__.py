"""Optimization tier (counterpart: ``deppy_tpu/optimize/__init__.py:1-33``): best-solution queries above plain
resolution — minimal-change upgrade planning, weighted soft
constraints, and explain-why-not blocking sets, all served by one
bound-tightening loop that rides the scheduler's idle-priority queue.

Surface: :class:`Planner` (the serving core; the service endpoint
``POST /v1/optimize`` comes with ROADMAP A5.6.6), :class:`OptimizeRequest`
/ :class:`Objective` (the format layer), and
:class:`OptimizeFormatError` (a malformed request document)."""

from .loop import Planner
from .objective import (
    BOUND_VARIABLE_ID,
    Objective,
    OptimizeFormatError,
    OptimizeRequest,
    build_objective,
    cone_mask,
    explain_variables,
    native_bound_variables,
)

__all__ = [
    "BOUND_VARIABLE_ID",
    "Objective",
    "OptimizeFormatError",
    "OptimizeRequest",
    "Planner",
    "build_objective",
    "cone_mask",
    "explain_variables",
    "native_bound_variables",
]
