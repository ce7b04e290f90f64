"""Distribution-shift waves (copy of ``deppy_tpu/benchmarks/routes.py:57-80``).

The route-health plane's workload (:mod:`deppy_tpu_torch.routes`): waves
of chain problems of one depth, so a whole wave coalesces into one size
class, three of every four carrying one UNSAT lane.  The reference's
bench around it (``deppy_tpu/benchmarks/routes.py:173-300``: the backend
probe and the frozen, learned, oracle and observe passes at depth 40, 6
lanes, 8 warm and 12 measured waves) runs in ``chip_smoke.py``'s
``routes`` phase; the bench entry comes with ROADMAP A7.2.
"""

from __future__ import annotations


def route_wave(depth: int, lanes: int, tag: str,
               unsat: bool = True) -> list:
    """One submit()'s worth of chain problems — all the same depth so
    the whole wave coalesces into a single size class.  ``unsat`` makes
    the last lane an UNSAT chain (prohibited tail): the relaxation
    entrant can never answer that flush definitively, so a frozen row
    that excludes the fast exact backend pays the full serial-host
    wall.  SAT-only waves let the relaxation WIN against the frozen
    default — the races that accrue regret."""
    from .. import sat

    wave = []
    for lane in range(lanes):
        t = f"{tag}l{lane}"
        vs = [sat.variable(f"{t}n0", sat.mandatory(),
                           sat.dependency(f"{t}n1"))]
        vs += [sat.variable(f"{t}n{i}", sat.dependency(f"{t}n{i + 1}"))
               for i in range(1, depth - 1)]
        if unsat and lane == lanes - 1:
            vs.append(sat.variable(f"{t}n{depth - 1}", sat.prohibited()))
        else:
            vs.append(sat.variable(f"{t}n{depth - 1}"))
        wave.append(vs)
    return wave
