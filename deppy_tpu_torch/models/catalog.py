"""Catalog-shaped workload families (copy of ``deppy_tpu/models/catalog.py:1-187``).

Five workload generators modeling the operator-catalog resolution patterns
the reference framework was built for (OLM bundles, package version pins,
GVK uniqueness), sized per the repository's BASELINE.json configs:

1. :func:`operatorhub_catalog` — ~200 bundles across packages/channels,
   Mandatory roots + preference-ordered Dependency edges.
2. :func:`version_pinned_chains` — deep transitive chains with AtMost-1 per
   package (version pinning).
3. :func:`gvk_conflict_catalog` — Conflict-heavy GVK-uniqueness problems.
4. :func:`pinned_tenant_catalog` — UNSAT-heavy version-pin collisions
   (tenants pinning incompatible providers of a shared GVK).
5. :func:`fleet_states` — N independent cluster states over a shared
   catalog: the fleet-scale batched workload.
6. :func:`giant_pinned_conflict` — ONE giant unsatisfiable catalog (a
   3-constraint core buried in ~1.7k constraints): the host-routed
   core-extraction workload.
"""

from __future__ import annotations

import random
from typing import List

from ..sat.constraints import (
    Variable,
    at_most,
    conflict,
    dependency,
    mandatory,
)


def operatorhub_catalog(
    n_packages: int = 40,
    versions_per_package: int = 5,
    seed: int = 0,
) -> List[Variable]:
    """Mandatory+Dependency catalog: each package ships several versions
    (newest preferred), one root package per problem is mandatory, and each
    version depends on a random other package (any of its versions, newest
    preferred).  ~``n_packages * versions_per_package`` bundles."""
    rng = random.Random(seed)
    out: List[Variable] = []
    for p in range(n_packages):
        vids = [f"p{p}.v{v}" for v in range(versions_per_package)]
        # Version pinning: at most one installed version per package.
        out.append(
            Variable(
                f"p{p}",
                (mandatory(), dependency(*vids), at_most(1, *vids))
                if p == 0
                else (dependency(*vids), at_most(1, *vids)),
            )
        )
        for v, vid in enumerate(vids):
            cons = []
            if p + 1 < n_packages and rng.random() < 0.6:
                dep = rng.randrange(p + 1, n_packages)
                cons.append(dependency(f"p{dep}"))
            out.append(Variable(vid, tuple(cons)))
    return out


def version_pinned_chains(
    depth: int = 20,
    width: int = 3,
    seed: int = 0,
) -> List[Variable]:
    """Deep transitive dependency chains with AtMost-1 version pins: package
    i at each chain level offers ``width`` versions, the mandatory root
    pulls level 0, and each version depends on some version of the next
    level (preference order = newest first)."""
    rng = random.Random(seed)
    out: List[Variable] = [
        Variable("root", (mandatory(), dependency(*[f"l0.v{w}" for w in range(width)])))
    ]
    for level in range(depth):
        vids = [f"l{level}.v{w}" for w in range(width)]
        out.append(Variable(f"l{level}", (at_most(1, *vids),)))
        for vid in vids:
            cons = []
            if level + 1 < depth:
                nxt = [f"l{level + 1}.v{w}" for w in range(width)]
                rng.shuffle(nxt)
                cons.append(dependency(*nxt))
            out.append(Variable(vid, tuple(cons)))
    return out


def gvk_conflict_catalog(
    n_groups: int = 20,
    providers_per_group: int = 4,
    n_required: int = 10,
    seed: int = 0,
) -> List[Variable]:
    """GVK-uniqueness style: each API group has several providers that all
    conflict pairwise (only one provider of a GVK may be installed
    cluster-wide); ``n_required`` groups must be satisfied."""
    rng = random.Random(seed)
    out: List[Variable] = []
    for g in range(n_groups):
        provs = [f"g{g}.op{i}" for i in range(providers_per_group)]
        required = g < n_required
        out.append(
            Variable(
                f"gvk{g}",
                (mandatory(), dependency(*provs)) if required else (dependency(*provs),),
            )
        )
        for i, pid in enumerate(provs):
            cons = [conflict(other) for other in provs[:i]]
            if rng.random() < 0.3:
                peer = rng.randrange(n_groups)
                if peer != g:
                    cons.append(dependency(f"gvk{peer}"))
            out.append(Variable(pid, tuple(cons)))
    return out


def pinned_tenant_catalog(
    n_groups: int = 8,
    providers_per_group: int = 3,
    n_tenants: int = 4,
    pin_pool: int = 2,
    seed: int = 0,
) -> List[Variable]:
    """Version-pin collision workload: the UNSAT-heavy fleet shape.

    A GVK catalog (providers of a group conflict pairwise) plus
    ``n_tenants`` mandatory tenants, each *pinning* one exact provider
    drawn from the first ``pin_pool`` groups.  Two tenants pinning
    different providers of the same group make the cluster state
    unsatisfiable with a small, human-readable core (tenant A is
    mandatory, requires pA; tenant B is mandatory, requires pB; pA
    conflicts with pB) — the "two operators demand incompatible
    dependencies" failure the reference's README walks through
    (README.md:77-107).  With the defaults ~90% of seeds are UNSAT
    (P(SAT) ≈ 0.10 by direct enumeration; measured 1823/2048), so a
    fleet of these exercises the unsat-core phase at scale (the
    gated/compacted core strategies in the driver)."""
    rng = random.Random(seed)
    out: List[Variable] = []
    for g in range(n_groups):
        provs = [f"g{g}.op{i}" for i in range(providers_per_group)]
        out.append(Variable(f"gvk{g}", (dependency(*provs),)))
        for i, pid in enumerate(provs):
            out.append(Variable(pid, tuple(conflict(o) for o in provs[:i])))
    for t in range(n_tenants):
        g = rng.randrange(min(pin_pool, n_groups))
        p = rng.randrange(providers_per_group)
        out.append(
            Variable(f"tenant{t}", (mandatory(), dependency(f"g{g}.op{p}")))
        )
    return out


def giant_pinned_conflict(
    n_packages: int = 250,
    versions_per_package: int = 8,
    seed: int = 0,
) -> List[Variable]:
    """ONE giant unsatisfiable catalog: an :func:`operatorhub_catalog`
    (~``n_packages * versions_per_package`` bundles, ~1.7k applied
    constraints at the defaults) plus two mandatory pins that conflict —
    the cluster-wide "two mandatory operators are incompatible" failure
    at full catalog scale.  The answer is a 3-constraint core buried in
    thousands of irrelevant constraints: the workload that exercises
    host-routed core extraction (engine.driver.HOST_CORE_NCONS) and,
    historically, the long-device-program worker crash it guards against
    (BASELINE.md round-3 notes)."""
    out = list(operatorhub_catalog(n_packages, versions_per_package, seed))
    out.append(Variable("pin-a", (mandatory(), conflict("pin-b"))))
    out.append(Variable("pin-b", (mandatory(),)))
    return out


def fleet_states(
    n_states: int,
    base_seed: int = 0,
    generator=gvk_conflict_catalog,
    **kwargs,
) -> List[List[Variable]]:
    """``n_states`` independent problems over the same catalog family —
    the fleet-scale batched workload (BASELINE.json config 5)."""
    return [generator(seed=base_seed + i, **kwargs) for i in range(n_states)]
