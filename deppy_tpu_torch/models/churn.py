"""Catalog churn (copy of ``deppy_tpu/benchmarks/churn.py:33-67``).

The dominant production access pattern is re-resolution: a catalog
changes ONE bundle's constraints and every dependent client re-asks a
99%-identical problem.  :func:`churn_requests` builds that traffic: a
bundle catalog where each consecutive request flips exactly one
dependency clause, the workload the incremental tier
(:mod:`deppy_tpu_torch.incremental`) serves with warm starts.
"""

from __future__ import annotations

from typing import List

# The reference benchmark's defaults (churn.py:33, :128-130).
N_REQUESTS = 120
N_BUNDLES = 32
BUNDLE_SIZE = 12
VARIANTS = 3


def churn_requests(n_requests: int = N_REQUESTS, n_bundles: int = N_BUNDLES,
                   bundle_size: int = BUNDLE_SIZE,
                   variants: int = VARIANTS) -> List[list]:
    """The replay: request ``i`` rotates bundle ``i % n_bundles``'s
    mid-chain dependency to its next candidate pair — consecutive
    requests differ by exactly one clause (one row removed, its
    replacement added: a ``mixed`` delta whose cone is one bundle)."""
    from .. import sat

    def catalog(state):
        vs = []
        for b in range(n_bundles):
            for j in range(bundle_size):
                cons = []
                if j == 0:
                    cons.append(sat.mandatory())
                if j < bundle_size - 2:
                    off = state[b] if j == 2 else 0
                    c1 = (j + 1 + off) % bundle_size or 1
                    c2 = (j + 2 + off) % bundle_size or 2
                    if c1 <= j:
                        c1 = j + 1
                    if c2 <= j:
                        c2 = min(j + 2, bundle_size - 1)
                    cons.append(sat.dependency(f"b{b}v{c1}",
                                               f"b{b}v{c2}"))
                vs.append(sat.variable(f"b{b}v{j}", *cons))
        return vs

    state = [0] * n_bundles
    out = []
    for i in range(n_requests):
        state[i % n_bundles] = (state[i % n_bundles] + 1) % variants
        out.append(catalog(list(state)))
    return out
