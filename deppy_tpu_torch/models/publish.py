"""Publish churn (copy of ``deppy_tpu/benchmarks/publish.py:43-87``).

Production churn is push-shaped: one catalog publish fans out to many
dependent client families, which all re-ask.  :func:`catalog_family`
builds one family's initial catalog state and :func:`round_delta` the
round's publish, the workload of the speculation tier
(:mod:`deppy_tpu_torch.speculate`).  The replay harness (``replay``,
``run``, at the defaults of 16 families, 5 rounds and 8 bundles of 16)
comes with the bench (ROADMAP A7.2).
"""

from __future__ import annotations


def catalog_family(phase: str, family: int,
                   n_bundles: int, bundle_size: int) -> list:
    """One client family's INITIAL catalog state.  All families share
    one vocabulary (the phase-prefixed bundle ids — warm starts and
    affected-fingerprint enumeration need comparable row keys) and
    differ in preference order: bit ``b`` of ``family`` flips bundle
    ``b``'s v1 candidate order, giving ``2**n_bundles`` distinct
    fingerprints of identical shape.  Later states are produced by
    applying round deltas, exactly as a real client tracks publishes."""
    from .. import sat

    def vid(b: int, j: int) -> str:
        return f"{phase}.b{b}v{j}"

    vs = []
    for b in range(n_bundles):
        for j in range(bundle_size):
            cons = []
            if j == 0:
                cons.append(sat.mandatory())
                cons.append(sat.dependency(vid(b, 1)))
            elif j == 1:
                lo, hi = ((2, 3) if (family >> b) & 1 == 0 else (3, 2))
                cons.append(sat.dependency(vid(b, lo), vid(b, hi)))
            elif j < bundle_size - 2:
                cons.append(sat.dependency(
                    vid(b, j + 1), vid(b, min(j + 2, bundle_size - 1))))
            vs.append(sat.variable(vid(b, j), *cons))
    return vs


def round_delta(phase: str, rnd: int, n_bundles: int, bundle_size: int):
    """The round-``rnd`` catalog publish: an ABSOLUTE replacement of
    bundle ``rnd % n_bundles``'s v2 dependency row, always distinct
    from the initial row so every round changes every family."""
    from ..speculate import PublishDelta

    b = rnd % n_bundles
    c1 = 4 + rnd % max(bundle_size - 5, 1)
    c2 = min(c1 + 1, bundle_size - 1)
    return PublishDelta.from_doc({"updates": [{
        "id": f"{phase}.b{b}v2",
        "constraints": [{"type": "dependency",
                         "ids": [f"{phase}.b{b}v{c1}",
                                 f"{phase}.b{b}v{c2}"]}]}]})
