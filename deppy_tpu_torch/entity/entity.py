"""Entities: the unit of content a resolution selects (copy of ``deppy_tpu/entity/entity.py:1-48``).

Upstream deppy's ``pkg/entitysource/entity.go``: an entity is an opaque
identifier plus a string-valued property bag (e.g. an operator bundle
with its package/version/GVK properties).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping

EntityID = str


class EntityPropertyNotFoundError(KeyError):
    """Raised by :meth:`Entity.get_property` for missing keys
    (upstream entity.go:7-11)."""

    def __init__(self, key: str):
        self.key = key
        super().__init__(key)

    def __str__(self) -> str:
        return f"Property '({self.key})' Not Found"


@dataclass(frozen=True)
class Entity:
    """An identified bag of string properties (upstream entity.go:14-35).

    Hashable by ``id`` (ids are unique within a store), so entities can be
    deduplicated across Group sources; equality still compares properties.
    """

    id: EntityID
    properties: Mapping[str, str] = field(default_factory=dict, hash=False)

    def __hash__(self) -> int:
        return hash(self.id)

    def get_property(self, key: str) -> str:
        """Return the property value or raise
        :class:`EntityPropertyNotFoundError` (upstream entity.go:29-35)."""
        try:
            return self.properties[key]
        except KeyError:
            raise EntityPropertyNotFoundError(key) from None
