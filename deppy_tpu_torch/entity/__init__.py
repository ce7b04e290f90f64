"""Entity/data layer (copy of ``deppy_tpu/entity/__init__.py:1-36``).

Upstream deppy's ``pkg/entitysource``: entities with opaque string
properties, query interfaces over entity stores, an in-memory cache
querier, a multiplexing source group, and predicate combinators.
"""

from .entity import Entity, EntityID, EntityPropertyNotFoundError
from .source import (
    CacheQuerier,
    EntityContentGetter,
    EntityQuerier,
    EntitySource,
    Group,
    NoContentSource,
)
from .query import EntityList, EntityListMap, and_, collect_ids, not_, or_

__all__ = [
    "CacheQuerier",
    "Entity",
    "EntityContentGetter",
    "EntityID",
    "EntityList",
    "EntityListMap",
    "EntityPropertyNotFoundError",
    "EntityQuerier",
    "EntitySource",
    "Group",
    "NoContentSource",
    "and_",
    "collect_ids",
    "not_",
    "or_",
]
