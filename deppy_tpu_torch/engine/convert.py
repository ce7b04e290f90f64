"""Carry problems, entities, batches and phase outputs across from the JAX package (no counterpart).

The tests feed the same inputs to both implementations.
:func:`variables_from_objects` and :func:`entities_from_objects` rebuild
variables and entities in this package's vocabulary from any objects
with the JAX package's field and class names, read by duck typing.  The JAX
package's ``driver.pad_stack`` returns its ``ProblemTensors`` as numpy
arrays; :func:`problem_tensors_from_numpy` turns any object with this
package's field names (that one included; its watched clause-bank fields
are ignored) into a :class:`~deppy_tpu_torch.engine.core.ProblemTensors`
of int32 tensors on ``device``.  :func:`phase_outputs_from_numpy` does the
same for a phase's outputs (results, models, guessed sets, steps), keeping
bool arrays bool and turning integers into int32.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..entity.entity import Entity
from ..sat import constraints as _c
from ..sat.constraints import Variable
from .core import ProblemTensors


def _constraint(c: Any) -> _c.Constraint:
    kind = type(c).__name__
    if kind == "Mandatory":
        return _c.mandatory()
    if kind == "Prohibited":
        return _c.prohibited()
    if kind == "Dependency":
        return _c.dependency(*c.ids)
    if kind == "Conflict":
        return _c.conflict(c.id)
    if kind == "AtMost":
        return _c.at_most(c.n, *c.ids)
    raise TypeError(f"unknown constraint class {kind!r}")


def variables_from_objects(variables: Sequence[Any]) -> List[Variable]:
    """The same problem in this package's constraint vocabulary: each
    object's ``identifier`` and ``constraints`` (``Mandatory``,
    ``Prohibited``, ``Dependency.ids``, ``Conflict.id``, ``AtMost.n`` and
    ``.ids``, told apart by class name), in order."""
    return [_c.variable(v.identifier, *map(_constraint, v.constraints))
            for v in variables]


def entities_from_objects(entities: Sequence[Any]) -> List[Entity]:
    """The same entities in this package: each object's ``id`` and a copy
    of its ``properties``, in order."""
    return [Entity(e.id, dict(e.properties)) for e in entities]


def _tensor(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr.copy(), device=device)
    return torch.as_tensor(arr.astype(np.int32), device=device)


def problem_tensors_from_numpy(pts: Any, device="cpu") -> ProblemTensors:
    """int32 tensors on ``device`` for every field of ``pts``."""
    return ProblemTensors(**{
        f: torch.as_tensor(np.ascontiguousarray(getattr(pts, f),
                                                dtype=np.int32),
                           device=device)
        for f in ProblemTensors._fields})


def phase_outputs_from_numpy(outs: Sequence[Any], device="cpu"
                             ) -> Tuple[torch.Tensor, ...]:
    """A phase's output tuple as tensors on ``device``."""
    return tuple(_tensor(a, device) for a in outs)


def to_numpy(x: Any) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
