"""Constraint generators and the resolution facade (counterpart: ``deppy_tpu/resolution/__init__.py``)."""

from .facade import BatchResolver, Resolver, Solution
from .generator import ConstraintAggregator, ConstraintGenerator

__all__ = [
    "BatchResolver",
    "ConstraintAggregator",
    "ConstraintGenerator",
    "Resolver",
    "Solution",
]
