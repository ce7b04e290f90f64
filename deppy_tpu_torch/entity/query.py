"""Entity list helpers and predicate combinators (copy of ``deppy_tpu/entity/query.py:1-43``).

Upstream deppy's ``pkg/entitysource/query.go``.  Predicates are plain
callables ``Entity -> bool``; ``and_``/``or_`` short-circuit like the
upstream combinators (query.go:28-58).  Sorting uses Python's stable sort
directly.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

from .entity import Entity, EntityID

Predicate = Callable[[Entity], bool]
EntityList = List[Entity]
EntityListMap = Dict[str, EntityList]


def and_(*predicates: Predicate) -> Predicate:
    def combined(entity: Entity) -> bool:
        return all(p(entity) for p in predicates)

    return combined


def or_(*predicates: Predicate) -> Predicate:
    def combined(entity: Entity) -> bool:
        return any(p(entity) for p in predicates)

    return combined


def not_(predicate: Predicate) -> Predicate:
    def negated(entity: Entity) -> bool:
        return not predicate(entity)

    return negated


def collect_ids(entities: Iterable[Entity]) -> List[EntityID]:
    """IDs of ``entities`` in order (upstream query.go:19-26)."""
    return [e.id for e in entities]
