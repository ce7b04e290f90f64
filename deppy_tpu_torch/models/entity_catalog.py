"""The operatorhub catalog as entities and constraint generators (no counterpart).

:func:`operatorhub_entities` builds the bundle entities of
:func:`~deppy_tpu_torch.models.operatorhub_catalog` — ``p<i>.v<j>`` with
the properties ``package``, ``version`` and, where the seeded draw gives
one, ``requires`` — from the same draws in the same order.
:func:`operatorhub_generators` returns the constraint generators that turn
those entities back into that function's exact variable list: for each
package, in catalog order, :func:`package_variable` (the package's
variable: a Dependency on its versions, newest first, the version
uniqueness AtMost(1) over them, and Mandatory at the root) and then
:func:`bundle_dependencies` (the package's bundle variables, each with a
Dependency on the package it requires).  The generators are registered
per package because the catalog lists each package's variable right
before its bundles', and an aggregator concatenates its generators'
variables in registration order.
"""

from __future__ import annotations

import random
from typing import Callable, List

from ..entity import Entity, collect_ids
from ..sat.constraints import Variable, at_most, dependency, mandatory


def operatorhub_entities(n_packages: int = 40, versions_per_package: int = 5,
                         seed: int = 0) -> List[Entity]:
    """The ``n_packages * versions_per_package`` bundle entities of
    ``operatorhub_catalog(n_packages, versions_per_package, seed)``."""
    rng = random.Random(seed)
    out: List[Entity] = []
    for p in range(n_packages):
        for v in range(versions_per_package):
            props = {"package": f"p{p}", "version": str(v)}
            if p + 1 < n_packages and rng.random() < 0.6:
                props["requires"] = f"p{rng.randrange(p + 1, n_packages)}"
            out.append(Entity(f"p{p}.v{v}", props))
    return out


def _versions(querier, package: str) -> List[Entity]:
    return querier.filter(lambda e: e.get_property("package") == package)


def package_variable(package: str, root: bool) -> Callable:
    """Generator: the package's variable — any of its versions (newest
    first, in the source's order), at most one of them, mandatory at the
    root."""

    def gen(querier) -> List[Variable]:
        ids = collect_ids(_versions(querier, package))
        cons = (dependency(*ids), at_most(1, *ids))
        return [Variable(package, ((mandatory(),) + cons) if root else cons)]

    return gen


def bundle_dependencies(package: str) -> Callable:
    """Generator: the package's bundle variables; a ``requires`` property
    becomes a Dependency on the required package's variable."""

    def gen(querier) -> List[Variable]:
        out = []
        for e in _versions(querier, package):
            req = e.properties.get("requires")
            out.append(Variable(e.id, (dependency(req),) if req else ()))
        return out

    return gen


def operatorhub_generators(querier, root: str = "p0") -> List[Callable]:
    """The generators of every package of ``querier``, in catalog order."""
    packages = querier.group_by(lambda e: [e.get_property("package")])
    return [g for pkg in packages
            for g in (package_variable(pkg, pkg == root),
                      bundle_dependencies(pkg))]
