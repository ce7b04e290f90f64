"""Interactive session walks (copy of ``deppy_tpu/benchmarks/session.py:41-90``).

Interactive traffic is conversation-shaped: an operator pins an entity,
asks for the plan, pins another, asks again — N small steps against ONE
catalog.  These are the reference benchmark's generators for it:
:func:`session_catalog` (the retained catalog; the benchmark's default
is ``session_catalog(96, 8)``, 768 variables in 96 independent bundle
chains), :func:`walk_steps` (the exploration walk) and
:func:`derived_doc` (what a session-less client re-ships every step).
The session tier (:mod:`deppy_tpu_torch.sessions`) serves the walk
from retained state; a stateless client resolves each derived document
cold.
"""

from __future__ import annotations

from typing import List

# The reference benchmark's defaults (session.py:176).
BUNDLES = 96
BUNDLE_SIZE = 8
STEPS = 48


def session_catalog(bundles: int, size: int) -> dict:
    """The retained catalog: bundle 0 is mandatory behind a dependency
    chain, every other bundle an independent optional chain — the shape
    real package catalogs decompose into (bundles share no edges), so an
    assumption's consequence cone is one bundle, not the world.  Pinning
    an optional entity genuinely changes the answer (it drags its whole
    chain in); excluding one genuinely constrains it."""
    variables = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0 and b == 0:
                cons.append({"type": "mandatory"})
            if j < size - 1:
                cons.append({"type": "dependency",
                             "ids": [f"b{b}v{j + 1}"]})
            variables.append({"id": f"b{b}v{j}", "constraints": cons})
    return {"variables": variables}


def walk_steps(bundles: int, size: int, steps: int) -> List[tuple]:
    """The exploration walk: step ``i`` additionally pins one entity
    from a rotating bundle (installed for even steps, excluded for odd)
    — every step's accumulated assumption set is distinct, so the
    stateless baseline can never serve a step from the exact-result
    cache."""
    out = []
    for i in range(steps):
        b = 1 + (i % max(bundles - 1, 1))
        j = (i // max(bundles - 1, 1)) % size
        out.append((f"b{b}v{j}", i % 2 == 0))
    return out


def derived_doc(doc: dict, assumptions: List[tuple]) -> dict:
    """The stateless client's per-step document: the full catalog with
    each accumulated (id, installed) assumption folded in as a
    mandatory/prohibited constraint — what a session-less client must
    re-ship and the server must re-encode, every step."""
    extra: dict = {}
    for ident, installed in assumptions:
        extra.setdefault(ident, []).append(
            {"type": "mandatory" if installed else "prohibited"})
    variables = []
    for v in doc["variables"]:
        cons = list(v.get("constraints") or [])
        cons += extra.get(v["id"], [])
        variables.append({"id": v["id"], "constraints": cons})
    return {"variables": variables}
