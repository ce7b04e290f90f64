"""Entity sources: query + content interfaces over entity stores (copy of ``deppy_tpu/entity/source.py:1-136``).

Upstream deppy's ``pkg/entitysource/entity_source.go`` and
``cache_querier.go``.  Protocols replace Go interfaces; iteration helpers
are Python generators.  ``Group`` multiplexes several sources behind one
interface (entity_source.go:47-110) — with the upstream ``GetContent``
inverted-condition bug (entity_source.go:103-110, returns content only
when ``err != nil``) deliberately fixed.
"""

from __future__ import annotations

from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Protocol,
    Sequence,
    runtime_checkable,
)

from .entity import Entity, EntityID
from .query import EntityList, EntityListMap, Predicate

GroupByFunction = Callable[[Entity], Sequence[str]]


@runtime_checkable
class EntityQuerier(Protocol):
    """Query interface over an entity store (entity_source.go:24-29)."""

    def get(self, id: EntityID) -> Optional[Entity]: ...

    def filter(self, predicate: Predicate) -> EntityList: ...

    def group_by(self, fn: GroupByFunction) -> EntityListMap: ...

    def iterate(self) -> Iterator[Entity]: ...


@runtime_checkable
class EntityContentGetter(Protocol):
    """Fetches the installable payload linked to an entity
    (entity_source.go:33-35)."""

    def get_content(self, id: EntityID) -> Any: ...


@runtime_checkable
class EntitySource(EntityQuerier, EntityContentGetter, Protocol):
    """A queryable store that can also deliver content
    (entity_source.go:38-41)."""


class CacheQuerier:
    """In-memory entity store with linear-scan queries
    (upstream cache_querier.go:7-53).  Insertion order is preserved and
    observable through filter/iterate, unlike upstream deppy's map ordering."""

    def __init__(self, entities: Mapping[EntityID, Entity]):
        self._entities: Dict[EntityID, Entity] = dict(entities)

    @classmethod
    def from_entities(cls, entities: Sequence[Entity]) -> "CacheQuerier":
        return cls({e.id: e for e in entities})

    def get(self, id: EntityID) -> Optional[Entity]:
        return self._entities.get(id)

    def filter(self, predicate: Predicate) -> EntityList:
        return [e for e in self._entities.values() if predicate(e)]

    def group_by(self, fn: GroupByFunction) -> EntityListMap:
        out: EntityListMap = {}
        for e in self._entities.values():
            for key in fn(e):
                out.setdefault(key, []).append(e)
        return out

    def iterate(self) -> Iterator[Entity]:
        return iter(self._entities.values())


class NoContentSource:
    """Content getter stub returning nothing (upstream no_content.go:5-11)."""

    def get_content(self, id: EntityID) -> Any:
        return None


class Group:
    """Multiplexes several entity sources behind the single-source interface
    (upstream entity_source.go:47-110): first-hit ``get``, concatenating
    ``filter``, merging ``group_by``, sequential ``iterate``, first-hit
    ``get_content``."""

    def __init__(self, *sources: Any):
        self._sources: List[Any] = list(sources)

    def get(self, id: EntityID) -> Optional[Entity]:
        for s in self._sources:
            e = s.get(id)
            if e is not None:
                return e
        return None

    def filter(self, predicate: Predicate) -> EntityList:
        out: EntityList = []
        for s in self._sources:
            out.extend(s.filter(predicate))
        return out

    def group_by(self, fn: GroupByFunction) -> EntityListMap:
        out: EntityListMap = {}
        for s in self._sources:
            for key, entities in s.group_by(fn).items():
                out.setdefault(key, []).extend(entities)
        return out

    def iterate(self) -> Iterator[Entity]:
        for s in self._sources:
            yield from s.iterate()

    def get_content(self, id: EntityID) -> Any:
        for s in self._sources:
            getter = getattr(s, "get_content", None)
            if getter is None:
                continue
            content = getter(id)
            if content is not None:
                return content
        return None
