"""Workload generators (counterpart: ``deppy_tpu/models/__init__.py``)."""

from .catalog import (
    fleet_states,
    giant_pinned_conflict,
    gvk_conflict_catalog,
    operatorhub_catalog,
    pinned_tenant_catalog,
    version_pinned_chains,
)
from .entity_catalog import operatorhub_entities, operatorhub_generators
from .hard import chain_requests
from .random_instance import random_instance

__all__ = [
    "chain_requests",
    "fleet_states",
    "giant_pinned_conflict",
    "gvk_conflict_catalog",
    "operatorhub_catalog",
    "operatorhub_entities",
    "operatorhub_generators",
    "pinned_tenant_catalog",
    "random_instance",
    "version_pinned_chains",
]
