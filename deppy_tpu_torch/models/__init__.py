"""Workload generators (counterpart: ``deppy_tpu/models/__init__.py``)."""

from .catalog import (
    fleet_states,
    giant_pinned_conflict,
    gvk_conflict_catalog,
    operatorhub_catalog,
    pinned_tenant_catalog,
    version_pinned_chains,
)
from .churn import churn_requests
from .entity_catalog import operatorhub_entities, operatorhub_generators
from .hard import chain_requests
from .publish import catalog_family, round_delta
from .random_instance import random_instance
from .session import derived_doc, session_catalog, walk_steps

__all__ = [
    "catalog_family",
    "chain_requests",
    "churn_requests",
    "derived_doc",
    "fleet_states",
    "giant_pinned_conflict",
    "gvk_conflict_catalog",
    "operatorhub_catalog",
    "operatorhub_entities",
    "operatorhub_generators",
    "pinned_tenant_catalog",
    "random_instance",
    "round_delta",
    "session_catalog",
    "version_pinned_chains",
    "walk_steps",
]
