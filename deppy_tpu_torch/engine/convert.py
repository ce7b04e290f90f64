"""Carry problem batches and phase outputs across from the JAX package (no counterpart).

The tests feed one phase's inputs to both implementations.  The JAX
package's ``driver.pad_stack`` returns its ``ProblemTensors`` as numpy
arrays; :func:`problem_tensors_from_numpy` turns any object with this
package's field names (that one included; its watched clause-bank fields
are ignored) into a :class:`~deppy_tpu_torch.engine.core.ProblemTensors`
of int32 tensors on ``device``.  :func:`phase_outputs_from_numpy` does the
same for a phase's outputs (results, models, guessed sets, steps), keeping
bool arrays bool and turning integers into int32.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

from .core import ProblemTensors


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
