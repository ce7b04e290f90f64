"""Random-instance generator (copy of ``deppy_tpu/models/random_instance.py:1-52``).

Re-creation of the reference benchmark's seeded random problem
(upstream deppy's ``pkg/sat/bench_test.go:10-64``): ``length`` variables named by
their index, each independently given a Mandatory constraint with
probability ``p_mandatory``, a Dependency on 1..n_dependency-1 random other
variables with probability ``p_dependency``, and 1..n_conflict-1 Conflict
constraints with probability ``p_conflict``.  Python's ``random`` replaces
Go's ``math/rand`` so literal streams differ, but the distribution matches.
"""

from __future__ import annotations

import random
from typing import List

from ..sat.constraints import Constraint, Variable, conflict, dependency, mandatory


def random_instance(
    length: int = 256,
    seed: int = 9,
    p_mandatory: float = 0.1,
    p_dependency: float = 0.15,
    n_dependency: int = 6,
    p_conflict: float = 0.05,
    n_conflict: int = 3,
) -> List[Variable]:
    rng = random.Random(seed)

    def other(i: int) -> int:
        if length < 2:
            return i
        y = i
        while y == i:
            y = rng.randrange(length)
        return y

    out: List[Variable] = []
    for i in range(length):
        cons: List[Constraint] = []
        if rng.random() < p_mandatory:
            cons.append(mandatory())
        if rng.random() < p_dependency:
            n = rng.randrange(1, n_dependency)
            cons.append(dependency(*[str(other(i)) for _ in range(n)]))
        if rng.random() < p_conflict:
            n = rng.randrange(1, n_conflict)
            for _ in range(n):
                cons.append(conflict(str(other(i))))
        out.append(Variable(str(i), tuple(cons)))
    return out
