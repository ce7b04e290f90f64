"""Constraint generators: the domain-logic plugin point (copy of ``deppy_tpu/resolution/generator.py:1-65``).

Upstream deppy's ``pkg/constraints/constraint_generator.go``.  A
``ConstraintGenerator`` inspects an entity store and emits constrained
variables (e.g. "every required API group must have exactly one
provider").  The ``ConstraintAggregator`` fans over registered generators
and concatenates their variables (constraint_generator.go:29-40) —
optionally over a thread pool, the upstream scatter-gather TODO
(constraint_generator.go:30).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Protocol, Sequence, Union, runtime_checkable

from ..entity.source import EntityQuerier
from ..sat.constraints import Variable


@runtime_checkable
class ConstraintGenerator(Protocol):
    """Generates solver variables from an entity store
    (constraint_generator.go:11-13)."""

    def get_variables(self, querier: EntityQuerier) -> Sequence[Variable]: ...


# Plain functions are accepted wherever a generator is expected.
GeneratorLike = Union[ConstraintGenerator, Callable[[EntityQuerier], Sequence[Variable]]]


def _call(gen: GeneratorLike, querier: EntityQuerier) -> Sequence[Variable]:
    if hasattr(gen, "get_variables"):
        return gen.get_variables(querier)
    return gen(querier)


class ConstraintAggregator:
    """Aggregates several generators, concatenating their variables in
    registration order (constraint_generator.go:19-40).  With
    ``parallel=True`` generators run over a thread pool — upstream deppy's
    own scatter-gather TODO (constraint_generator.go:30) — joined in
    registration order so output stays deterministic; the default is the
    upstream serial behavior, safe for queriers that aren't thread-safe.
    """

    def __init__(self, *generators: GeneratorLike, parallel: bool = False):
        self._generators: List[GeneratorLike] = list(generators)
        self._parallel = parallel

    def get_variables(self, querier: EntityQuerier) -> List[Variable]:
        if not self._generators:
            return []
        if not self._parallel or len(self._generators) == 1:
            out: List[Variable] = []
            for gen in self._generators:
                out.extend(_call(gen, querier))
            return out
        with ThreadPoolExecutor(max_workers=len(self._generators)) as pool:
            results = list(pool.map(lambda g: _call(g, querier), self._generators))
        out = []
        for r in results:
            out.extend(r)
        return out
