"""Batch resolution facade (counterpart: ``deppy_tpu/resolution/__init__.py``)."""

from .facade import BatchResolver, Solution

__all__ = ["BatchResolver", "Solution"]
