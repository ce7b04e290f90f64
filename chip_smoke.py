#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold each of its
CUDA kernels against its plain PyTorch version.

Run from the repository root, with one card visible::

    python3 chip_smoke.py            # the full run
    python3 chip_smoke.py --scale 0.05   # the same phases on 5% of the batches

Phases, each fatal on failure:

1. the card's name and power limit, and the build of the five kernels
   from ``deppy_tpu_torch/engine/csrc``;
2. the bits path (``set_bcp_impl("auto")``) at the sizes users run (the
   BASELINE.json configs on one card): ``BatchResolver(device="cuda")
   .solve`` over 10,000 ``gvk_conflict_catalog(20, 4, 10)`` cluster
   states, 1,000 ``pinned_tenant_catalog`` states (mostly UNSAT, so the
   unsat-core phase runs at scale) and 1,000 ``version_pinned_chains(20,
   3)`` catalogs, then one ``Solver(operatorhub_catalog(40, 5)).solve()``;
3. the blockwise path (``set_bcp_impl("blockwise")``): one
   ``Solver(operatorhub_catalog(1000, 8)).solve()`` (the giant catalog:
   8,192 clause rows over 24,576 variables), ``BatchResolver`` over 64
   ``operatorhub_catalog(250, 8)`` catalogs and 256 pinned-tenant states,
   and one 803-constraint UNSAT problem whose core the host engine
   extracts.  Each family of both paths prints its wall time, problems
   per second, outcome counts and the launches of each kernel (counts set
   to 0 just before it runs and read just after), and the giant its steps,
   backtracks and ms per step;
4. the deppy surface (the ``surface`` path): ``Resolver`` over entity
   catalogs whose generators give ``operatorhub_catalog(40, 5)`` and
   ``operatorhub_catalog(250, 8)`` exactly (the latter under both impls),
   the 1,000 pinned-tenant states of phase 2 as a JSON document through
   the codec and ``BatchResolver``, and assume/test/untest scopes on
   ``Solver(operatorhub_catalog(40, 5))`` (a SAT and an UNSAT
   assumption); every answer must equal the host backend's and the main
   paths' for the same problem, and each card solve's wall is printed
   beside the host backend's;
5. the answers: every solution satisfies every constraint of its
   problem, every unsat core is non-empty, no result is Incomplete; the
   first problems of each bits family give the same answers on
   ``device="cpu"`` (the kernels' plain versions), the blockwise answers
   equal the bits path's on the same problems, and the 803-constraint
   problem's core is its three conflicting constraints;
6. one 512-problem chunk of the headline fleet, and the 64-catalog batch
   under blockwise, under ``torch.profiler``: device time by kernel and
   the card's busy share;
7. each kernel against its plain version on the same inputs, 32 lanes of
   each family padded to the family's main-path dims, plus 32 lanes of a
   small family whose minimization probes do run: every output must be
   equal (integers, tolerance 0).  Kernels 1, 3, 4 and 5 are timed on
   the bits path's dims, the blockwise kernel on every family's baseline
   fixpoint in the full space (held against kernel 1 there too), and the
   search kernel under blockwise on the giant catalog and the 64-catalog
   batch.  The blockwise kernel is also held at tiles of 1 and 7 rows on
   every family, one of them with repeated literals and rows holding x
   and ~x, and the phase kernels under blockwise at tiles of 1 and 7 rows
   and at the natural tile; the small-family plain versions run on CPU
   copies of the inputs in a pool of worker processes.  On the big
   families the phase kernels are held at the natural tile against plain
   versions run on the card, at a cut step budget, and both row
   placements are timed at 128-1024 threads (every configuration must
   give the same outputs).  Kernels 1, 4 and 5 run on every bits family
   (and on 32 lanes of the ``operatorhub`` problem's shape) under the
   team the shape rule picks (``teams.team``) and forced to the block
   team and to the warp team at 1, 2, 4 and 8 warps a block, each held
   against the plain version on 32 lanes (kernel 1:
   disabled lanes, entry overlaps, extras bounds, and the zero extras row
   against a bound that cannot bind; kernels 4-5: full budget, tight
   budgets, padding lanes) and timed there and on the family's 512-lane
   chunk, where every configuration must give the block team's outputs
   (kernel 1 also on an odd number of the chunk's lanes, and on
   ``operatorhub`` on the one lane the main path launches, its bound
   reported there too; ``choice`` lines).  Kernel 1 on the
   blockwise comparison's full-space planes runs the block team on the
   big families and is held against kernel 2 under both teams on the
   others.  Each kernel's time is its own device time
   from ``torch.profiler``; the
   wrapper's time (CUDA events, the host work that prepares a launch
   included) and the plain version's time stand beside it, with a bound
   from bytes and operations;
8. the ``kernels:`` line and the JSON summary of every kernel.

The last line is ``{"ok": true, "device": {...}}``.  Without a card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the 32-bit
# non-tensor rate used for the kernels' integer bit operations.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

COMPARE_LANES = 32
REFERENCE_LANES = 16
# A kernel's time: the median of TIMED_PASSES profiled passes of
# TIMED_REPS calls each.
TIMED_REPS = 5
TIMED_PASSES = 3

# The blockwise path: the repo's over-VMEM case, one giant catalog
# (deppy_tpu/benchmarks/pallas_case.py:129-133), and a batch at that
# benchmark's default size (:126-127).
GIANT = (1000, 8)
BATCH = (250, 8)
BATCH_LANES = 64
TENANT_LANES = 256
# Tile heights the kernels are held at under blockwise besides the natural
# one, and the lanes compared where a plain version at that height is
# slow (gvk_fleet's search at 1-row tiles; kernel 2 on the 64-catalog
# batch's 2048 rows).
SMALL_TILES = (1, 7)
SMALL_TILE_LANES = {("gvk_fleet", 1): 8, ("operatorhub_batch", 1): 8,
                    ("operatorhub_batch", 7): 16}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def clock_line() -> str:
    """The card's SM clock, its maximum and the power drawn, now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"not read ({out.stderr.strip()[:80]})")


# --------------------------------------------------------------------------
# workloads


def families(scale: float):
    from deppy_tpu_torch.models import (gvk_conflict_catalog,
                                        pinned_tenant_catalog,
                                        version_pinned_chains)

    def n(full):
        return max(COMPARE_LANES, int(full * scale))

    return [
        ("gvk_fleet", n(10_000),
         lambda i: gvk_conflict_catalog(20, 4, 10, seed=i)),
        ("pinned_tenant", n(1_000), lambda i: pinned_tenant_catalog(seed=i)),
        ("chains", n(1_000), lambda i: version_pinned_chains(20, 3, seed=i)),
    ]


def forced_extras(i: int):
    """A dependency chain that propagation alone installs: the
    minimization phase then has extras to probe, which the main-path
    families rarely give it.  Compared, never timed on the main path."""
    from deppy_tpu_torch.sat import conflict, dependency, mandatory, variable

    n = 3 + i % 6
    vs = [variable("root", mandatory(), dependency("a1"))]
    vs += [variable(f"a{k}", dependency(f"a{k + 1}")) for k in range(1, n)]
    return vs + [variable(f"a{n}"), variable("x", conflict("root"))]


def operatorhub_lanes(i: int):
    """The main path's one class-m problem (``i`` 0) and seeded siblings
    of the same shape (C 256, NA 64, Wr 8): the kernels are compared and
    timed at the shape of its launch."""
    from deppy_tpu_torch.models import operatorhub_catalog

    return operatorhub_catalog(40, 5, seed=i)


def check_solution(variables, solution) -> None:
    """Every constraint of the problem holds under ``solution``."""
    from deppy_tpu_torch.sat.constraints import (AtMost, Conflict,
                                                 Dependency, Mandatory,
                                                 Prohibited)

    if set(solution) != {v.identifier for v in variables}:
        fail("solution does not cover exactly the problem's identifiers")
    for v in variables:
        on = solution[v.identifier]
        for c in v.constraints:
            if isinstance(c, Mandatory):
                ok = on
            elif isinstance(c, Prohibited):
                ok = not on
            elif isinstance(c, Dependency):
                ok = not on or any(solution.get(i, False) for i in c.ids)
            elif isinstance(c, Conflict):
                ok = not (on and solution.get(c.id, False))
            elif isinstance(c, AtMost):
                ok = sum(solution.get(i, False) for i in set(c.ids)) <= c.n
            else:
                fail(f"unknown constraint {c!r}")
            if not ok:
                fail(f"solution violates {c.string(v.identifier)!r}")


def operatorhub_batch(scale: float):
    """The blockwise path's batch: 64 ``operatorhub_catalog(250, 8)``."""
    from deppy_tpu_torch.models import operatorhub_catalog

    return [operatorhub_catalog(*BATCH, seed=s)
            for s in range(max(8, int(BATCH_LANES * scale)))]


def giant_unsat(fillers: int = 800):
    """``x0`` mandatory and conflicting with ``x1``, ``x1`` mandatory,
    plus ``fillers`` mandatory fillers: 803 applied constraints whose core
    is the first three, past the host-core threshold."""
    from deppy_tpu_torch.sat import conflict, mandatory, variable

    vs = [variable("x0", mandatory(), conflict("x1")),
          variable("x1", mandatory())]
    return vs + [variable(f"f{i}", mandatory()) for i in range(fillers)]


def solve_one(variables, stats=None):
    """``Solver(variables, device="cuda").solve()`` as a solution dict, or
    the NotSatisfiable it raised; the solver's steps and backtracks land
    in ``stats`` when given."""
    from deppy_tpu_torch.sat import NotSatisfiable, Solver

    solver = Solver(variables, device="cuda")
    try:
        installed = solver.solve()
    except NotSatisfiable as e:
        return e
    finally:
        if stats is not None:
            stats.update(steps=solver.steps, backtracks=solver.backtracks)
    answer = {v.identifier: False for v in variables}
    answer.update({v.identifier: True for v in installed})
    return answer


def check_answers(name: str, pool, results) -> None:
    """Every solution satisfies its problem, every core is non-empty,
    nothing is Incomplete."""
    from deppy_tpu_torch.sat import NotSatisfiable

    for variables, r in zip(pool, results):
        if isinstance(r, dict):
            check_solution(variables, r)
        elif isinstance(r, NotSatisfiable):
            if not r.constraints:
                fail(f"{name}: empty unsat core")
        else:
            fail(f"{name}: unexpected result {r!r}")


def render(result):
    from deppy_tpu_torch.sat.errors import NotSatisfiable

    if isinstance(result, dict):
        return ("sat", tuple(sorted(k for k, on in result.items() if on)))
    if isinstance(result, NotSatisfiable):
        return ("unsat", tuple(sorted((ac.variable.identifier, str(ac))
                                      for ac in result.constraints)))
    return ("incomplete",)


def all_warp(name: str, counts: dict) -> dict:
    """The warp-team launches of kernels 1, 4 and 5 (the baseline fixpoint
    and phases 2 and 3) since the counts were reset; fails unless every
    launch of those kernels (``counts``) went to the warp team, as the
    shape rule gives every bits-path shape."""
    from deppy_tpu_torch import engine

    warps = engine.warp_launch_counts()
    for k, n in warps.items():
        if n != counts[k]:
            fail(f"{name}: {counts[k] - n} of {counts[k]} {k} launches of "
                 f"the bits path went to the block team")
    return warps


def run_main_path(scale: float):
    """Phases 2 and 4: resolve every family of the bits path on the card
    and check it."""
    import torch

    from deppy_tpu_torch import engine
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat import Incomplete, NotSatisfiable
    from deppy_tpu_torch.sat.encode import encode

    launches = {k: 0 for k in engine.KERNELS}
    per_family = {}
    samples = {}
    kept = {}
    for name, count, make in families(scale):
        pool = [make(i) for i in range(count)]
        t0 = time.perf_counter()
        for variables in pool:
            encode(variables)
        t_encode = time.perf_counter() - t0
        torch.cuda.synchronize()
        engine.reset_launch_counts()
        t0 = time.perf_counter()
        results = BatchResolver(device="cuda").solve(pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = engine.launch_counts()
        warps = all_warp(name, counts)
        n_sat = sum(isinstance(r, dict) for r in results)
        n_unsat = sum(isinstance(r, NotSatisfiable) for r in results)
        n_inc = sum(isinstance(r, Incomplete) for r in results)
        print(f"main path {name}: {count} problems in {wall:.3f} s "
              f"({count / wall:.1f} problems/s); sat {n_sat} unsat "
              f"{n_unsat} incomplete {n_inc}; launches {counts}, warp team "
              f"{warps}; host encode alone {t_encode:.3f} s", flush=True)
        for k in launches:
            launches[k] += counts[k]
        per_family[name] = dict(problems=count, wall_s=wall,
                                problems_per_s=count / wall,
                                encode_s=t_encode, sat=n_sat,
                                unsat=n_unsat, incomplete=n_inc,
                                launches=counts)
        if n_inc:
            fail(f"{name}: {n_inc} Incomplete results at the default budget")
        check_answers(name, pool, results)
        samples[name] = (pool[:REFERENCE_LANES], results[:REFERENCE_LANES])
        if name == "pinned_tenant":
            kept[name] = (pool, results)

    variables = operatorhub_catalog(40, 5)
    engine.reset_launch_counts()
    t0 = time.perf_counter()
    answer = solve_one(variables)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = engine.launch_counts()
    warps = all_warp("operatorhub", counts)
    for k in launches:
        launches[k] += counts[k]
    print(f"main path operatorhub: 1 problem in {wall:.3f} s; "
          f"{render(answer)[0]}; launches {counts}, warp team {warps}",
          flush=True)
    per_family["operatorhub"] = dict(problems=1, wall_s=wall,
                                     launches=counts,
                                     outcome=render(answer)[0])
    if isinstance(answer, dict):
        check_solution(variables, answer)
    elif not answer.constraints:
        fail("operatorhub: empty unsat core")
    samples["operatorhub"] = ([variables], [answer])
    kept["operatorhub"] = answer
    print("answers checked: every solution satisfies its constraints, "
          "every core is non-empty, none incomplete", flush=True)

    # The same problems through the plain versions on the host.
    for name, (pool, results) in samples.items():
        ref = BatchResolver(device="cpu").solve(pool)
        got = [render(r) for r in results]
        want = [render(r) for r in ref]
        if got != want:
            bad = sum(a != b for a, b in zip(got, want))
            fail(f"{name}: {bad} of {len(pool)} answers differ from the "
                 f"device='cpu' reference")
        print(f"reference {name}: {len(pool)} answers equal to "
              f"device='cpu'", flush=True)
    return launches, per_family, kept


def run_blockwise_path(scale: float):
    """Phases 3 and 4 under ``set_bcp_impl("blockwise")``: the giant
    catalog, the 64-catalog batch, pinned tenants and the host-routed
    giant core; then the same batches on the bits path, whose answers the
    blockwise ones must equal."""
    import torch

    from deppy_tpu_torch import engine
    from deppy_tpu_torch.engine import core
    from deppy_tpu_torch.models import (operatorhub_catalog,
                                        pinned_tenant_catalog)
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat import NotSatisfiable
    from deppy_tpu_torch.sat.encode import encode

    giant = operatorhub_catalog(*GIANT, seed=0)
    batch = operatorhub_batch(scale)
    tenants = [pinned_tenant_catalog(seed=s)
               for s in range(max(COMPARE_LANES, int(TENANT_LANES * scale)))]
    unsat = giant_unsat()
    giant_stats = {}
    work = [("giant", [giant], lambda: [solve_one(giant, giant_stats)]),
            ("operatorhub_batch", batch,
             lambda: BatchResolver(device="cuda").solve(batch)),
            ("tenants", tenants,
             lambda: BatchResolver(device="cuda").solve(tenants)),
            ("host_core", [unsat], lambda: [solve_one(unsat)])]
    launches = {k: 0 for k in engine.KERNELS}
    per_family, answers = {}, {}
    core.set_bcp_impl("blockwise")
    try:
        for name, pool, run in work:
            torch.cuda.synchronize()
            engine.reset_launch_counts()
            t0 = time.perf_counter()
            results = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = engine.launch_counts()
            if any(engine.warp_launch_counts().values()):
                fail(f"{name}: a blockwise launch went to the warp team")
            for k in launches:
                launches[k] += counts[k]
            n_sat = sum(isinstance(r, dict) for r in results)
            print(f"blockwise path {name}: {len(pool)} problems in "
                  f"{wall:.3f} s ({len(pool) / wall:.2f} problems/s); sat "
                  f"{n_sat} unsat {len(pool) - n_sat}; launches {counts}",
                  flush=True)
            per_family[name] = dict(problems=len(pool), wall_s=wall,
                                    problems_per_s=len(pool) / wall,
                                    sat=n_sat, launches=counts)
            check_answers(name, pool, results)
            answers[name] = results
    finally:
        core.set_bcp_impl("auto")

    steps = giant_stats["steps"]
    wall_ms = per_family["giant"]["wall_s"] * 1e3
    per_family["giant"].update(giant_stats, ms_per_step=wall_ms / steps)
    print(f"blockwise path giant: steps {steps} backtracks "
          f"{giant_stats['backtracks']} ms per step {wall_ms / steps:.6f} "
          f"(wall / steps)", flush=True)

    want = sorted(str(c) for c in encode(unsat).applied[:3])
    got = answers["host_core"][0]
    if (not isinstance(got, NotSatisfiable)
            or sorted(str(c) for c in got.constraints) != want):
        fail(f"host_core: expected the core {want}, got {got!r}")
    print(f"blockwise path host_core: core {want}", flush=True)

    # The same problems on the bits path: the answers must be equal.
    for name, pool, run in work:
        t0 = time.perf_counter()
        ref = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [render(r) for r in answers[name]]
        if got != [render(r) for r in ref]:
            fail(f"{name}: blockwise answers differ from the bits path's")
        per_family[name]["bits_wall_s"] = wall
        print(f"bits path {name}: {len(pool)} answers equal to blockwise's "
              f"in {wall:.3f} s", flush=True)
    return launches, per_family, answers


# The surface phase: the entity catalogs at BASELINE.json config 1's size
# and at the blockwise batch's (pallas_case.py:126-127), and the first
# lanes of the JSON tenant batch that the host backend also solves.
SURFACE_CATALOGS = ((40, 5), BATCH)
SURFACE_HOST_LANES = 64


class SurfaceRun:
    """The surface path's card solves: each one's launches are counted
    (counts set to 0 just before it, read just after) and its wall is
    printed beside the host backend's wall for the same call."""

    def __init__(self):
        from deppy_tpu_torch import engine

        self.launches = {k: 0 for k in engine.KERNELS}
        self.walls = {}

    def card(self, label: str, fn):
        import torch

        from deppy_tpu_torch import engine

        torch.cuda.synchronize()
        engine.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = engine.launch_counts()
        for k in self.launches:
            self.launches[k] += counts[k]
        self.walls[label] = dict(card_s=wall, launches=counts)
        return out, counts

    def host(self, label: str, fn):
        from deppy_tpu_torch import engine

        engine.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        if any(engine.launch_counts().values()):
            fail(f"surface {label}: the host backend launched a kernel")
        w = self.walls[label]
        w["host_s"] = wall
        print(f"surface {label}: card {w['card_s']:.4f} s, host backend "
              f"{wall:.4f} s; launches {w['launches']}", flush=True)
        return out


def _solved(solve):
    """``solve()``'s answer, or the NotSatisfiable it raised."""
    from deppy_tpu_torch.sat import NotSatisfiable

    try:
        return solve()
    except NotSatisfiable as e:
        return e


def _view(variables, result):
    """:func:`render` of a ``Solver.solve`` answer (installed variables,
    mapped with the facade's ``_to_solution``) or of the error it gave."""
    from deppy_tpu_torch.resolution.facade import _to_solution

    if isinstance(result, list):
        result = _to_solution(variables, result)
    return render(result)


def surface_catalogs(run: SurfaceRun, main_answer, batch_answer) -> None:
    """Step 1: ``Resolver`` over the operatorhub entity catalogs, on the
    card (the bits path and, at (250, 8), blockwise too) and on the host
    backend, against the main paths' answers for the same catalogs."""
    from deppy_tpu_torch.engine import core
    from deppy_tpu_torch.entity import CacheQuerier
    from deppy_tpu_torch.models import (operatorhub_catalog,
                                        operatorhub_entities,
                                        operatorhub_generators)
    from deppy_tpu_torch.resolution import ConstraintAggregator, Resolver

    for size, main in zip(SURFACE_CATALOGS, (main_answer, batch_answer)):
        name = f"catalog{size}".replace(" ", "")
        source = CacheQuerier.from_entities(operatorhub_entities(*size,
                                                                 seed=0))
        gens = operatorhub_generators(source)
        variables = ConstraintAggregator(*gens).get_variables(source)
        if variables != operatorhub_catalog(*size, seed=0):
            fail(f"surface {name}: the generators' variables differ from "
                 f"operatorhub_catalog{size}")
        card, counts = run.card(name, Resolver(source, *gens).solve)
        host = run.host(name, Resolver(source, *gens, backend="host").solve)
        check_solution(variables, card)
        if render(card) != render(host):
            fail(f"surface {name}: the card's answer differs from the host "
                 f"backend's")
        if render(card) != render(main):
            fail(f"surface {name}: the card's answer differs from the main "
                 f"path's for the same catalog")
        print(f"surface {name}: {len(variables)} variables from "
              f"{len(gens)} generators; card, host backend and main path "
              f"agree: {render(card)[1]}", flush=True)
        if size != BATCH:
            continue
        core.set_bcp_impl("blockwise")
        try:
            bw, counts = run.card(f"{name} blockwise",
                                  Resolver(source, *gens).solve)
        finally:
            core.set_bcp_impl("auto")
        run.host(f"{name} blockwise",
                 Resolver(source, *gens, backend="host").solve)
        if counts["blockwise_fixpoint"] <= 0:
            fail(f"surface {name}: no blockwise_fixpoint launch under "
                 f"blockwise")
        if render(bw) != render(card):
            fail(f"surface {name}: the blockwise answer differs from the "
                 f"bits path's")
        print(f"surface {name}: the blockwise answer equals the bits "
              f"path's", flush=True)


def surface_codec(run: SurfaceRun, pool, results) -> None:
    """Step 2: the main path's tenant states through the JSON codec and
    ``BatchResolver`` on the card; each result document must equal the
    main path's, and the first lanes the host backend's."""
    import json

    from deppy_tpu_torch import io
    from deppy_tpu_torch.resolution import BatchResolver

    doc = {"problems": [{"variables": [io.variable_to_dict(v) for v in vs]}
                        for vs in pool]}
    problems = io.problems_from_document(json.loads(json.dumps(doc)))
    card, counts = run.card("tenant batch",
                            lambda: BatchResolver().solve(problems))
    if counts["core"] <= 0:
        fail("surface tenant batch: no core launch")
    want = [io.result_to_dict(r) for r in results]
    got = [io.result_to_dict(r) for r in card]
    bad = sum(a != b for a, b in zip(got, want))
    if bad or len(got) != len(want):
        fail(f"surface tenant batch: {bad} of {len(want)} result documents "
             f"differ from the main path's")
    head = problems[:SURFACE_HOST_LANES]
    label = f"tenant batch, first {len(head)}"
    card_head, _ = run.card(label, lambda: BatchResolver().solve(head))
    host = run.host(label,
                    lambda: BatchResolver(backend="host").solve(head))
    docs = [io.result_to_dict(r) for r in host]
    if docs != got[:len(head)] or docs != [io.result_to_dict(r)
                                           for r in card_head]:
        fail(f"surface {label}: the host backend's documents differ")
    n_unsat = sum(d["status"] == "unsat" for d in got)
    print(f"surface tenant batch: {len(got)} documents in "
          f"{run.walls['tenant batch']['card_s']:.4f} s on the card, equal "
          f"to the main path's ({n_unsat} unsat); the first {len(head)} "
          f"equal to the host backend's, cores included; launches {counts}",
          flush=True)


def surface_scopes(run: SurfaceRun, main_answer) -> None:
    """Step 3: assume/test/untest on ``Solver(operatorhub_catalog(40, 5))``
    on the card, against a host-backend solver and a plain card solve of
    the derived problem."""
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.sat import NotSatisfiable, Solver, assumed_variables

    variables = operatorhub_catalog(40, 5, seed=0)
    pick = next(f"p{p}.v1" for p in range(1, 40)
                if not main_answer[f"p{p}.v1"])
    cases = (("sat", [pick]), ("unsat", ["p0.v0", "p0.v1"]))
    for kind, assumed in cases:
        card = Solver(variables)
        host = Solver(variables, backend="host")
        for s in (card, host):
            s.assume(*assumed)
            s.test()
        label = f"scope {kind} {'+'.join(assumed)}"
        got, _ = run.card(label, lambda: _solved(card.solve))
        want = run.host(label, lambda: _solved(host.solve))
        derived = assumed_variables(variables, card.assumptions())
        plain, _ = run.card(f"{label}, derived problem",
                            lambda: _solved(Solver(derived).solve))
        run.host(f"{label}, derived problem",
                 lambda: _solved(Solver(derived, backend="host").solve))
        views = [_view(variables, r) for r in (got, want, plain)]
        if views[0] != views[1] or views[0] != views[2]:
            fail(f"surface {label}: card {views[0]}, host {views[1]}, "
                 f"derived {views[2]}")
        if kind == "sat" and (not isinstance(got, list)
                              or pick not in {v.identifier for v in got}):
            fail(f"surface {label}: the assumed version is not installed")
        if kind == "unsat":
            names = ([str(c) for c in got.constraints]
                     if isinstance(got, NotSatisfiable) else [])
            if not all(f"{a} is mandatory" in names for a in assumed):
                fail(f"surface {label}: the core {names} does not name the "
                     f"assumptions")
        card.untest()
        after, _ = run.card(f"{label}, after untest",
                            lambda: _solved(card.solve))
        if _view(variables, after) != render(main_answer):
            fail(f"surface {label}: the solve after untest differs from "
                 f"the unscoped answer")
        print(f"surface {label}: card, host backend and the derived "
              f"problem agree ({views[0][0]}); after untest the unscoped "
              f"answer", flush=True)


def run_surface_path(main_answers, blockwise_answers):
    """The deppy surface on the card: entity catalogs through
    ``Resolver``, the JSON tenant batch through ``BatchResolver`` and
    scoped solves, each against the host backend and the main paths'
    answers.  Returns the surface path's launches and walls."""
    run = SurfaceRun()
    print(f"surface timings on {card_line()}", flush=True)
    surface_catalogs(run, main_answers["operatorhub"],
                     blockwise_answers["operatorhub_batch"][0])
    surface_codec(run, *main_answers["pinned_tenant"])
    surface_scopes(run, main_answers["operatorhub"])
    return run.launches, run.walls


def profile_solve(name: str, pool, impl: str = "auto") -> dict:
    """Device time by kernel over one resolve of ``pool``, from
    ``torch.profiler``: where the time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deppy_tpu_torch.engine import core
    from deppy_tpu_torch.resolution import BatchResolver

    core.set_bcp_impl(impl)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        BatchResolver(device="cuda").solve(pool)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            BatchResolver(device="cuda").solve(pool)
            torch.cuda.synchronize()
    finally:
        core.set_bcp_impl("auto")
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and e.key != "Activity Buffer Request"),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    print(f"profile {name} ({impl}), {len(pool)} problems: wall "
          f"{wall_ms:.1f} ms (unprofiled), device {device_ms:.2f} ms, busy "
          f"share {device_ms / wall_ms:.4f}", flush=True)
    for key, ms, n in rows[:8]:
        print(f"  device {ms:9.3f} ms  x{n:<5d} {key[:90]}", flush=True)
    return dict(family=name, impl=impl, problems=len(pool), wall_ms=wall_ms,
                device_ms=device_ms,
                top=[dict(kernel=k[:90], ms=ms, calls=n)
                     for k, ms, n in rows[:8]])


def profile_chunk(scale: float) -> dict:
    """One main-path chunk (512 problems) of the headline fleet."""
    name, count, make = families(scale)[0]
    return profile_solve(name, [make(i) for i in range(min(count, 512))])


# --------------------------------------------------------------------------
# kernels against their plain versions


# Each kernel's symbols (its teams), as the profiler names its device
# activity.
KERNEL_SYMBOLS = {"bcp_fixpoint": ("bcp_kernel", "bcp_warp_kernel"),
                  "blockwise_fixpoint": ("blockwise_kernel",),
                  "search": ("search_kernel",),
                  "minimize": ("minimize_kernel", "minimize_warp_kernel"),
                  "core": ("core_kernel", "core_warp_kernel")}


def _device_ms(prof, symbols):
    """(device ms, launches) the profiler recorded of a kernel's symbols."""
    rows = [e for e in prof.key_averages()
            if any(s in e.key for s in symbols)]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def _timed(fn, kernel: str, reps: int):
    """(result, kernel ms, wrapper ms) per call: the kernel's own device
    time from ``torch.profiler`` per launch it recorded (the median of
    :data:`TIMED_PASSES` passes; the profiler now and then drops a short
    kernel's launches, so a pass's time is over the launches it kept),
    and the whole wrapper call (the host work that prepares the launch
    included) by CUDA events.  Every wrapper timed here launches its
    kernel once a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    wrapper_ms = start.elapsed_time(stop) / reps
    passes, kept = [], []
    for _ in range(TIMED_PASSES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms, seen = _device_ms(prof, KERNEL_SYMBOLS[kernel])
        kept.append(seen)
        if seen:
            passes.append(ms / seen)
    if sum(kept) != reps * TIMED_PASSES:
        print(f"kernel {kernel}: the profiler kept {kept} of {reps} "
              f"launches a pass", flush=True)
    if passes:
        ms = statistics.median(passes)
    else:
        print(f"kernel {kernel}: the profiler saw no device time; ms is "
              f"the wrapper's event time", flush=True)
        ms = wrapper_ms
    return out, ms, wrapper_ms


def _timed_plain(fn):
    """(result, ms, propagation rounds) of one plain-version call."""
    import torch

    from deppy_tpu_torch.engine import core

    torch.cuda.synchronize()
    r0 = core.plain_rounds
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, core.plain_rounds - r0


def _mismatch(a, b):
    """(differing elements, max abs difference) over two output tuples."""
    import torch

    bad, err = 0, 0
    for x, y in zip(a, b):
        x = x.to(torch.int64)
        y = y.to(torch.int64)
        if x.shape != y.shape:
            fail(f"output shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            d = (x - y).abs()
            bad += int((d != 0).sum())
            err = max(err, int(d.max()))
    return bad, err


def _same(kernel: str, family: str, what: str, got, want) -> None:
    """A correctness-only comparison (not timed, launches not counted)."""
    bad, _ = _mismatch(got, want)
    print(f"kernel {kernel} on {family}, {what}: mismatches {bad}",
          flush=True)
    if bad:
        fail(f"kernel {kernel} disagrees with its plain version on "
             f"{family} at {what} ({bad} elements)")


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _ops_per_round(C: int, NA: int, W: int) -> int:
    """32-bit integer operations of one propagation round of one problem:
    per clause word ~12 (membership, satisfied and unassigned masks, two
    popcounts, sums), per AtMost word ~7, per assignment word ~8."""
    return 12 * C * W + 7 * NA * W + 8 * W


def compare_kernels(scale: float, launches: dict):
    """Phase 4: every kernel and its plain version on the same tensors."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_bcp, cuda_search, driver
    from deppy_tpu_torch.engine import teams as rule
    from deppy_tpu_torch.sat.encode import encode

    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    rows, teams = {}, {}
    print(f"clocks before the bits kernels' timings: {clock_line()}",
          flush=True)

    def record(kernel, family, got, want, timing, plain_ms, rounds, nbytes,
               C, NA, W, chunk=None):
        """One kernel's 32-lane comparison and time, with its bound; and
        ``chunk``, the bound at the family's chunk (the shape the main
        path launches) where given."""
        ms, wrapper_ms = timing
        bad, err = _mismatch(got, want)
        bound_ms, bound_by = _bound(nbytes, rounds * _ops_per_round(C, NA, W))
        line = (f"kernel {kernel} on {family}: main-path launches "
                f"{launches[kernel]} ms {ms:.4f} wrapper_ms "
                f"{wrapper_ms:.4f} plain_ms "
                f"{plain_ms:.3f} mismatches {bad} max_abs_err {err} "
                f"rounds {rounds} bytes {nbytes} bound_ms {bound_ms:.8f} "
                f"({bound_by})")
        if chunk is not None:
            line += (f"; {chunk['lanes']}-lane chunk: rounds "
                     f"{chunk['rounds']} bytes {chunk['bytes']} bound_ms "
                     f"{chunk['bound_ms']:.8f} ({chunk['bound_by']})")
        print(line, flush=True)
        if bad:
            fail(f"kernel {kernel} disagrees with its plain version on "
                 f"{family} ({bad} elements)")
        row = rows.setdefault(kernel, dict(max_abs_err=0, families={}))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["families"][family] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            **({"chunk": chunk} if chunk is not None else {}))

    for name, count, make in families(scale) + [
            ("forced_extras", COMPARE_LANES, forced_extras),
            ("operatorhub", COMPARE_LANES, operatorhub_lanes)]:
        probs = [encode(make(i)) for i in range(min(count, driver.MAX_LANES))]
        d = driver._Dims(probs, len(probs))
        lanes = probs[:COMPARE_LANES]
        B = len(lanes)
        pts = driver._upload(driver.pad_stack(lanes, d, B), dev)
        red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
        full = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
        en = torch.ones(B, dtype=torch.bool, device=dev)
        print(f"compare {name}: {B} lanes, C {d.C} NA {d.NA} NV {d.NV} "
              f"NCON {d.NCON} NC {d.NC} Kc {d.Kc} Wr {d.Wr} Wv {d.Wv}",
              flush=True)

        chunk = chunk_inputs(probs, d, B)
        bcp_in = bcp_inputs(red, d.NV, d.Wr, en)
        if name == "operatorhub":
            # The main path launches kernel 1 on its one problem alone.
            chunk = dict(bcp_fixpoint=[("1-lane launch",
                                        [x[:1] for x in bcp_in])])

        # Kernel 1: the baseline fixpoint under the anchors, under the team
        # the shape rule picks; the bound also at the launch the main path
        # makes (the family's chunk), whose plain version is held against
        # the block team there.
        got, *timing = _timed(lambda: cuda_bcp.bcp_fixpoint(*bcp_in),
                              "bcp_fixpoint", TIMED_REPS)
        want, pms, rounds = _timed_plain(
            lambda: cuda_bcp.bcp_fixpoint_plain(*bcp_in))
        c_row = None
        if chunk:
            c_label, c_in = chunk["bcp_fixpoint"][0]
            c_want, c_pms, c_rounds = _timed_plain(
                lambda: cuda_bcp.bcp_fixpoint_plain(*c_in))
            _same("bcp_fixpoint", name, f"{c_label}, block team",
                  cuda_bcp.bcp_fixpoint(*c_in, _team="block"), c_want)
            c_bytes = _nbytes(*c_in, *c_want)
            c_bound, c_by = _bound(
                c_bytes, c_rounds * _ops_per_round(d.C, d.NA, d.Wr))
            c_row = dict(lanes=int(c_in[0].shape[0]), plain_ms=c_pms,
                         rounds=c_rounds, bytes=c_bytes, bound_ms=c_bound,
                         bound_by=c_by)
        record("bcp_fixpoint", name, got, want, timing, pms, rounds,
               _nbytes(*bcp_in, *got), d.C, d.NA, d.Wr, chunk=c_row)

        # Both teams of kernel 1 on the main path's inputs, on lanes of
        # five kinds (disabled, entry overlap, two extras bounds), and with
        # the zero extras row against a bound that cannot bind; here and
        # on the family's chunk.
        unbound = list(bcp_in)
        unbound[5] = torch.full_like(bcp_in[5], -1)
        unbound[6] = torch.full_like(bcp_in[6], 32 * d.Wr + 1)
        mixed = mixed_lanes(bcp_in)
        bcp_cases = [
            ("anchors", bcp_in, want),
            ("disabled, overlap and bounded lanes", mixed,
             cuda_bcp.bcp_fixpoint_plain(*mixed)),
            ("zero extras row against a bound that cannot bind", bcp_in,
             cuda_bcp.bcp_fixpoint_plain(*unbound))]
        teams.setdefault("bcp_fixpoint", {})[name] = by_team = compare_teams(
            "bcp_fixpoint", name,
            lambda a, team: cuda_bcp.bcp_fixpoint(*a, _team=team),
            bcp_cases, (d.C, d.NA, d.Wr, d.NV, 0),
            chunk.get("bcp_fixpoint", []))
        if c_row is not None:
            c_row["ms"] = by_team[f"warp/{rule.WARPS}"]["chunk_ms"]

        # Kernel 3: phase 1 (its wrapper also launches kernel 1).
        search_in = (red.pos_bits_r, red.neg_bits_r, red.card_member_bits_r,
                     red.card_n, red.card_valid, red.choice_cand,
                     red.var_choices, red.anchors, red.n_vars, en)
        got, *timing = _timed(
            lambda: cuda_search.batched_search_fused(red, budget, en),
            "search", TIMED_REPS)
        want, pms, rounds = _timed_plain(
            lambda: cuda_search.batched_search_plain(red, budget, en))
        record("search", name, got, want, timing, pms, rounds,
               _nbytes(*search_in, *got), d.C, d.NA, d.Wr)
        result, guessed, model, steps = got[0], got[1], got[2], got[3]

        # Kernel 4: phase 2 on the SAT lanes, under the team the shape
        # rule picks.
        min_args = (red, result, model, guessed, budget, steps, en)
        got, *timing = _timed(
            lambda: cuda_search.batched_minimize_fused(*min_args),
            "minimize", TIMED_REPS)
        want, pms, rounds = _timed_plain(
            lambda: cuda_search.batched_minimize_plain(*min_args))
        record("minimize", name, got, want, timing, pms, rounds,
               _nbytes(red.pos_bits_r, red.neg_bits_r,
                       red.card_member_bits_r, red.card_n, red.card_valid,
                       red.anchors, red.n_vars, result, model, guessed,
                       steps, en, *got), d.C, d.NA, d.Wr)
        min_cases = [("full budget", min_args, want)]

        # Tight budgets and padding lanes: the step accounting behind
        # Incomplete, and lanes that must run nothing.
        en_pad = en.clone()
        en_pad[-max(1, B // 4):] = False
        for tight in (1, 17):
            _same("search", name, f"budget {tight}, padding lanes",
                  cuda_search.batched_search_fused(red, tight, en_pad),
                  cuda_search.batched_search_plain(red, tight, en_pad))
            tight_args = (red, result, model, guessed, tight + 2, steps,
                          en_pad)
            min_cases.append((f"budget {tight + 2}, padding lanes",
                              tight_args,
                              cuda_search.batched_minimize_plain(*tight_args)))

        # Both teams of kernel 4, here and on the family's chunk.
        teams.setdefault("minimize", {})[name] = compare_teams(
            "minimize", name,
            lambda a, team: cuda_search.batched_minimize_fused(*a,
                                                               _team=team),
            min_cases, (d.C, d.NA, d.Wr, d.NV, 0),
            chunk.get("minimize", []))

        # Kernel 5: phase 3 on the UNSAT lanes, full plane space.
        en_c = en & (result == core.UNSAT)
        if not bool(en_c.any()):
            print(f"kernel core on {name}: no UNSAT lane, not compared",
                  flush=True)
            continue
        tight_args = (full, 25, steps, en_c & en_pad)
        core_args = (full, budget, steps, en_c)
        got, *timing = _timed(
            lambda: cuda_search.batched_core_fused(*core_args, NCON=d.NCON),
            "core", TIMED_REPS)
        want, pms, rounds = _timed_plain(
            lambda: cuda_search.batched_core_plain(*core_args, NCON=d.NCON))
        record("core", name, got, want, timing, pms, rounds,
               _nbytes(full.pos_bits, full.neg_bits, full.card_member_bits,
                       full.card_n, full.card_act_bits, full.n_vars,
                       full.n_cons, steps, en_c, *got),
               d.C, d.NA, d.Wv)
        core_cases = [
            ("full budget", core_args, want),
            ("budget 25, padding lanes", tight_args,
             cuda_search.batched_core_plain(*tight_args, NCON=d.NCON))]
        teams.setdefault("core", {})[name] = compare_teams(
            "core", name,
            lambda a, team: cuda_search.batched_core_fused(
                *a, NCON=d.NCON, _team=team),
            core_cases, (d.C, d.NA, d.Wv, d.NV, d.NCON),
            chunk.get("core", []))
    for k, by_family in teams.items():
        rows[k]["teams"] = by_family
    return rows


def bcp_inputs(red, NV: int, W: int, en):
    """Kernel 1's arguments as phase 1's baseline fixpoint gives them on
    the bits path: the reduced planes, the anchors true and the padding
    past ``n_vars`` false, a zero extras row with ``min_w`` 0."""
    import torch

    from deppy_tpu_torch.engine import core

    B = en.shape[0]
    pv = torch.arange(NV, device=en.device) < red.n_vars.unsqueeze(-1)
    zero = torch.zeros((B, W), dtype=torch.int32, device=en.device)
    return (red.pos_bits_r, red.neg_bits_r, red.card_member_bits_r,
            red.card_valid, red.card_n, zero, zero[:, 0].contiguous(),
            core.pack_mask(core._anchor_mask(red, NV), W),
            core.pack_mask(~pv, W), en.to(torch.int32))


def mixed_lanes(x):
    """Kernel 1's arguments ``x`` with lane b of kind b % 5: as given;
    disabled; every anchor also set false (an entry overlap, which the
    kernel does not check); the extras row of every problem variable with
    ``min_w`` the anchors' count, which the anchors saturate, so the first
    round forces every other variable false; the extras row of the
    unassigned variables with ``min_w`` 1."""
    import torch

    from deppy_tpu_torch.engine import core

    pos, neg, mem, act, card_n, min_bits, min_w, t0, f0, en = x
    kind = torch.arange(en.shape[0], device=en.device) % 5
    col = kind.unsqueeze(-1)
    anchors = core._popcount_u(core._to_u(t0)).sum(-1).to(torch.int32)
    min_bits = torch.where(col == 3, ~f0,
                           torch.where(col == 4, ~(t0 | f0), min_bits))
    min_w = torch.where(kind == 3, anchors,
                        torch.where(kind == 4, 1, min_w))
    f0 = torch.where(col == 2, f0 | t0, f0)
    en = torch.where(kind == 1, 0, en)
    return (pos, neg, mem, act, card_n, min_bits.to(torch.int32),
            min_w.to(torch.int32), t0, f0.to(torch.int32),
            en.to(torch.int32))


def chunk_inputs(probs, d, B: int) -> dict:
    """Each kernel's chunk cases on the family's whole first chunk
    (``probs``, up to 512 lanes, as the main path runs it), a list of
    (label, arguments) each: kernel 1 at phase 1's baseline, and on an odd
    number of lanes (no whole count of warp-team blocks) of
    :func:`mixed_lanes`; kernel 4 on phase 1's outputs from the search
    kernel; kernel 5 on the UNSAT lanes.  Empty when the chunk is the
    compared lanes."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_search, driver

    n = len(probs)
    if n <= B:
        return {}
    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    pts = driver._upload(driver.pad_stack(probs, d, n), dev)
    red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
    full = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
    en = torch.ones(n, dtype=torch.bool, device=dev)
    result, guessed, model, steps = cuda_search.batched_search_fused(
        red, budget, en)[:4]
    unsat = en & (result == core.UNSAT)
    bcp_in = bcp_inputs(red, d.NV, d.Wr, en)
    odd = n - 1 if n % 2 == 0 else n - 2
    return dict(
        bcp_fixpoint=[(f"{n}-lane chunk", bcp_in),
                      (f"{odd} lanes of the chunk, disabled, overlap and "
                       f"bounded lanes",
                       [x[:odd] for x in mixed_lanes(bcp_in)])],
        minimize=[(f"{n}-lane chunk",
                   (red, result, model, guessed, budget, steps, en))],
        core=[(f"{n}-lane chunk, {int(unsat.sum())} UNSAT lanes",
               (full, budget, steps, unsat))] if bool(unsat.any()) else [])


# Problems a block of the warp team is timed at (teams.WARPS is
# picked from these times).
CHOICE_WARPS = (1, 2, 4, 8)


# The shape rule's name of each kernel with two teams.
RULE_NAMES = {"bcp_fixpoint": "bcp", "minimize": "minimize", "core": "core"}


def compare_teams(kernel: str, family: str, run, cases, dims, chunks):
    """Kernel 1, 4 or 5 on one family under the block team and under the
    warp team at each of :data:`CHOICE_WARPS` warps a block the shape rule
    admits (``run(args, team)``): every case (label, args, the plain
    version's outputs) must give the plain outputs, and the first is
    timed; so is the first of ``chunks`` (label, args), and on every chunk
    every configuration must give the block team's outputs.  Returns
    {configuration: times}."""
    from deppy_tpu_torch.engine import teams

    C, NA, W, NV, NCON = dims
    default = teams.WARPS
    out, refs = {}, {}
    print(f"clocks before choice {kernel} {family}: {clock_line()}",
          flush=True)
    try:
        for team, warps in [("block", default)] + [("warp", w)
                                                   for w in CHOICE_WARPS]:
            teams.WARPS = warps
            key = team if team == "block" else f"warp/{warps}"
            lean = teams.warp_smem_bytes(RULE_NAMES[kernel], C, NA, W, NV,
                                         NCON, False)
            if team == "warp" and teams.team(0, W, lean) != "warp":
                print(f"choice {kernel} {family} {key}: refused by the "
                      f"shape rule ({lean} bytes a problem)", flush=True)
                continue
            for label, args, want in cases[1:]:
                _same(kernel, family, f"{key}, {label}", run(args, team),
                      want)
            label, args, want = cases[0]
            got, ms, wrapper_ms = _timed(lambda: run(args, team), kernel,
                                         TIMED_REPS)
            bad, _ = _mismatch(got, want)
            row = dict(ms=ms, wrapper_ms=wrapper_ms)
            line = (f"choice {kernel} {family} {key}: ms {ms:.7f} "
                    f"wrapper_ms {wrapper_ms:.4f} ({label}, mismatches "
                    f"{bad})")
            for i, (c_label, c_args) in enumerate(chunks):
                if i == 0:
                    c_got, c_ms, c_wrap = _timed(lambda: run(c_args, team),
                                                 kernel, TIMED_REPS)
                    row.update(chunk_ms=c_ms, chunk_wrapper_ms=c_wrap)
                    line += (f"; {c_label} ms {c_ms:.7f} wrapper_ms "
                             f"{c_wrap:.4f}")
                else:
                    c_got = run(c_args, team)
                    line += f"; {c_label}"
                c_bad, _ = _mismatch(c_got, refs.setdefault(c_label, c_got))
                bad += c_bad
                line += f" (mismatches against block {c_bad})"
            print(line, flush=True)
            if bad:
                fail(f"kernel {kernel} under the {key} team disagrees on "
                     f"{family} ({bad} elements)")
            out[key] = row
    finally:
        teams.WARPS = default
    return out


def _plain_task(module: str, fn: str, args, kwargs):
    """Run one plain version on CPU tensors in a worker process."""
    import importlib

    import torch

    torch.set_num_threads(1)
    mod = importlib.import_module(f"deppy_tpu_torch.engine.{module}")
    return [x.numpy() for x in getattr(mod, fn)(*args, **kwargs)]


def _lanes(x, lo: int, hi: int):
    """Lanes [lo, hi) of an argument, on the CPU: tensors and
    ProblemTensors are cut on their batch axis, anything else passes."""
    import torch

    from deppy_tpu_torch.engine import core

    if isinstance(x, core.ProblemTensors):
        return core.ProblemTensors(*[f[lo:hi].cpu() for f in x])
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x[lo:hi].cpu()
    return x


class PlainPool:
    """Plain versions run on CPU copies of the kernels' inputs, a few lanes
    per task, in a pool of worker processes; :meth:`check` compares each
    with the kernel's outputs once every task is in."""

    def __init__(self):
        workers = max(1, min(8, os.cpu_count() or 1))
        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = []

    def submit(self, label, got, module, fn, args, kwargs, B, chunk=2):
        futures = [self.pool.submit(
            _plain_task, module, fn, [_lanes(a, lo, lo + chunk) for a in args],
            {k: _lanes(v, lo, lo + chunk) for k, v in kwargs.items()})
            for lo in range(0, B, chunk)]
        self.jobs.append((label, [g.cpu() for g in got], futures))

    def check(self) -> int:
        """Compare every submitted job; returns the comparisons made."""
        import numpy as np
        import torch

        for (kernel, family, what), got, futures in self.jobs:
            parts = [f.result() for f in futures]
            want = [torch.from_numpy(np.concatenate(o)) for o in zip(*parts)]
            _same(kernel, family, what, got, want)
        n = len(self.jobs)
        self.jobs = []
        return n

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def _bound(nbytes: int, ops: int):
    """(bound ms, bound_by): the larger of bytes over the HBM rate and
    32-bit operations over the non-tensor rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _ops_compact(rows, W: int, tiles: int, rounds: int, sweeps: int,
                 steps: int = 0):
    """32-bit operations of blockwise fixpoints on compact rows, per lane
    summed: ~8 per literal test (load, sign, shift, mask, test, count) and
    ~10 per assignment word (clear, apply, compare) in each tile round,
    ~8 per AtMost member once per sweep.  ``rounds``/``sweeps`` are the
    plain version's counts on the same inputs; where they are not known
    (``steps`` given: a whole search), every step is taken to evaluate
    every row once, the least a fixpoint can do."""
    B = rows.lits.shape[0]
    lits = int((rows.lits != 0).sum()) / B
    members = int((rows.mlits != 0).sum()) / B
    if steps:
        return int(steps * (8 * lits + 10 * W + 8 * members))
    return int(rounds * (8 * lits / tiles + 10 * W) + sweeps * 8 * members)


def repeated_literals(i: int):
    """``version_pinned_chains(6, 3)`` plus a self-dependent variable (a
    clause row holding x and ~x); compare_blockwise also repeats a literal
    of every clause row and a member of every AtMost row (with_repeats)."""
    from deppy_tpu_torch.models import version_pinned_chains
    from deppy_tpu_torch.sat import dependency, variable

    return version_pinned_chains(6, 3, seed=i) + [
        variable("self-dependent", dependency("self-dependent"))]


def with_repeats(pts):
    """``pts`` with the first entry of every clause row and AtMost row
    written again into the row's first free slot."""
    import torch

    def rep(x, empty):
        n = (x != empty).sum(-1, keepdim=True)
        slot = n.clamp(max=x.shape[-1] - 1).long()
        free = (n > 0) & (n < x.shape[-1])
        return x.scatter(-1, slot, torch.where(free, x[..., :1],
                                               x.gather(-1, slot)))

    return pts._replace(clauses=rep(pts.clauses, 0),
                        card_ids=rep(pts.card_ids, -1))


def _timed_once(fn, kernel: str):
    """(result, kernel ms, wrapper ms) of one call: a search too long to
    repeat."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
    wrapper_ms = start.elapsed_time(stop)
    ms = _device_ms(prof, KERNEL_SYMBOLS[kernel])[0]
    if ms <= 0:
        print(f"kernel {kernel}: the profiler saw no device time; ms is "
              f"the wrapper's event time", flush=True)
        ms = wrapper_ms
    return out, ms, wrapper_ms


# Thread counts and row placements measured on the big families
# (cuda_blockwise.THREADS and the "auto" placement of
# cuda_blockwise.Compact are picked from them), and the step budget of
# the giant's search in that measurement.
CHOICE_THREADS = (128, 256, 512, 1024)
CHOICE_GIANT_BUDGET = 2000


def measure_choices(name: str, kin, full, en, tile: int, NCON: int, W: int):
    """Kernel 2 and the search kernel under each row placement (resident,
    streamed) and thread count, on one big family: every configuration
    must give the first one's outputs."""
    import torch

    from deppy_tpu_torch.engine import cuda_blockwise, cuda_search, driver

    budget = (CHOICE_GIANT_BUDGET if name == "giant"
              else driver.DEFAULT_MAX_STEPS)
    kw = dict(impl="blockwise", NCON=NCON)
    rows = cuda_blockwise.compact_rows(full.clauses, full.card_ids, W)
    default = cuda_blockwise.THREADS
    out = {}
    ref = None
    try:
        for placement in ("resident", "streamed"):
            placed = rows._replace(placement=placement)
            for threads in CHOICE_THREADS:
                cuda_blockwise.THREADS = threads
                fp, fp_ms, _ = _timed(
                    lambda: cuda_blockwise.bcp_fixpoint(
                        *kin, block_rows=tile, rows=placed),
                    "blockwise_fixpoint", TIMED_REPS)
                srch, s_ms, _ = _timed_once(
                    lambda: cuda_search.batched_search_fused(
                        full, budget, en, rows=placed, **kw), "search")
                got = (*fp, *srch[:4])
                if ref is None:
                    ref = got
                bad, _ = _mismatch(got, ref)
                steps = int(srch[3].sum())
                key = f"{placement}/{threads}"
                out[key] = dict(blockwise_fixpoint_ms=fp_ms, search_ms=s_ms,
                                search_steps=steps,
                                search_ms_per_step=s_ms / max(steps, 1))
                print(f"choice {name} {key}: blockwise_fixpoint ms "
                      f"{fp_ms:.4f} search ms {s_ms:.3f} (budget {budget}, "
                      f"{steps} steps) mismatches {bad}", flush=True)
                if bad:
                    fail(f"{name}: {key} disagrees with the first "
                         f"configuration ({bad} elements)")
    finally:
        cuda_blockwise.THREADS = default
    torch.cuda.synchronize()
    return out


# The step budget of the phase kernels' comparisons on the big families,
# whose plain versions run on the card (some 20-40 ms a step on the
# giant), and the lanes of the 64-catalog batch compared.
BIG_PHASE_BUDGET = 200
BIG_PHASE_LANES = 8


def compare_big_phases(name: str, full, en, tile: int, NCON: int, searched):
    """The phase kernels under blockwise at the natural tile on a big
    family, every output held against the plain version run on the card
    on the same inputs: the search at :data:`BIG_PHASE_BUDGET` steps, the
    minimization of the full-budget search's outputs (``searched``) given
    that many steps (and again with the guessed set cut to the anchors,
    so that every other installed variable is an extra and the
    minimization's DPLL probes run), and the core of any UNSAT lane."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_search

    nb = min(int(en.shape[0]), BIG_PHASE_LANES)
    sub = core.ProblemTensors(*[f[:nb] for f in full])
    en_b = en[:nb]
    zero = torch.zeros(nb, dtype=torch.int32, device=en.device)
    kw = dict(impl="blockwise", block_rows=tile, NCON=NCON)
    what = (f"tile {tile} (natural), {nb} lanes, budget "
            f"{BIG_PHASE_BUDGET}, plain on the card")
    s_args = (sub, BIG_PHASE_BUDGET, en_b)
    got = cuda_search.batched_search_fused(*s_args, **kw)
    _same("search", name, f"{what}, steps {got[3].tolist()}", got,
          cuda_search.batched_search_plain(*s_args, **kw))
    result, guessed, model = (x[:nb] for x in searched[:3])
    anchored = guessed & core._anchor_mask(sub, guessed.shape[1])
    for label, g in (("", guessed), (", guessed cut to the anchors",
                                     anchored)):
        m_args = (sub, result, model, g, BIG_PHASE_BUDGET, zero, en_b)
        got = cuda_search.batched_minimize_fused(*m_args, **kw)
        _same("minimize", name, f"{what}{label}, steps {got[2].tolist()}",
              got, cuda_search.batched_minimize_plain(*m_args, **kw))
    en_c = en_b & (result == core.UNSAT)
    if not bool(en_c.any()):
        print(f"kernel core on {name}: no UNSAT lane, not compared",
              flush=True)
        return
    c_args = (sub, BIG_PHASE_BUDGET, zero, en_c)
    _same("core", name, what, cuda_search.batched_core_fused(*c_args, **kw),
          cuda_search.batched_core_plain(*c_args, **kw))


def compare_blockwise(scale: float, launches: dict, plain: PlainPool):
    """Phase 6 for the blockwise impl: the blockwise kernel against its
    plain version on every family at the natural tile (timed) and at
    tiles of 1 and 7 rows, and against kernel 1 on the same inputs; the
    phase kernels under blockwise against their plain versions at tiles
    of 1 and 7 rows and at the natural tile (on the big families at the
    natural tile and a cut budget, :func:`compare_big_phases`); on the
    big families the search kernel's time and the row placements and
    thread counts measured.
    Returns (kernel 2's row, the search kernel's big-family rows, the
    choices measured)."""
    import torch

    from deppy_tpu_torch.engine import (core, cuda_bcp, cuda_blockwise,
                                        cuda_search, driver, teams)
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.sat.encode import encode

    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    row = dict(max_abs_err=0, families={})
    print(f"clocks before the blockwise kernels' timings: {clock_line()}",
          flush=True)
    search_rows, choices = {}, {}
    small = families(scale) + [
        ("forced_extras", COMPARE_LANES, forced_extras),
        ("repeated", COMPARE_LANES, repeated_literals)]
    big = [("giant", 1, lambda i: operatorhub_catalog(*GIANT, seed=0)),
           ("operatorhub_batch", COMPARE_LANES,
            lambda i: operatorhub_catalog(*BATCH, seed=i))]
    big_names = {name for name, _, _ in big}
    for name, count, make in small + big:
        probs = [encode(make(i)) for i in range(min(count, driver.MAX_LANES))]
        d = driver._Dims(probs, len(probs))
        lanes = probs[:COMPARE_LANES]
        B = len(lanes)
        pts = driver._upload(driver.pad_stack(lanes, d, B), dev)
        if name == "repeated":
            pts = with_repeats(pts)
        full = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
        en = torch.ones(B, dtype=torch.bool, device=dev)
        tile = cuda_blockwise.tile_rows(cuda_blockwise.BLOCK_ROWS, d.C, d.K,
                                        d.M, d.Wv, d.NA)
        rows = cuda_blockwise.compact_rows(full.clauses, full.card_ids, d.Wv)
        resident = cuda_blockwise.resident(rows, d.Wv, tile)
        repeats = int((full.clauses != 0).sum()) - int((rows.lits != 0).sum())
        print(f"compare blockwise {name}: {B} lanes, C {d.C} K {d.K} NA "
              f"{d.NA} M {d.M} NV {d.NV} NCON {d.NCON} Wv {d.Wv}, tile rows "
              f"{tile}, compact widths {rows.lits.shape[2]} and "
              f"{rows.mlits.shape[2]} ({rows.lit_bytes}-byte literals, "
              f"{'resident' if resident else 'streamed'}), repeated literals "
              f"dropped {repeats}", flush=True)
        if name == "repeated" and not repeats:
            fail("the repeated family has no repeated literal")

        # Kernel 2: the baseline fixpoint of phase 1 under blockwise, on
        # the compact tensors; its plain version on the dense planes.
        V = d.NV + d.NCON
        base = core._apply_anchors(
            full, core._base_assignment(full, V, d.NCON), V)
        t_in = core.pack_mask(base == core.TRUE, d.Wv)
        f_in = core.pack_mask(base == core.FALSE, d.Wv)
        act = ((full.card_act_bits & t_in.unsqueeze(1)) != 0).any(-1)
        args = (act.to(torch.int32), full.card_n,
                torch.zeros((B, d.Wv), dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev), t_in, f_in,
                en.to(torch.int32))
        kin = (full.clauses, full.card_ids, *args)
        pin = (full.pos_bits, full.neg_bits, full.card_member_bits, *args)
        got, *timing = _timed(
            lambda: cuda_blockwise.bcp_fixpoint(*kin, block_rows=tile),
            "blockwise_fixpoint", TIMED_REPS)
        s0 = core.plain_sweeps
        want, pms, rounds = _timed_plain(
            lambda: cuda_blockwise.bcp_fixpoint_plain(*pin, block_rows=tile))
        sweeps = core.plain_sweeps - s0
        bad, err = _mismatch(got, want)
        ms, wrapper_ms = timing
        tiles = -(-d.C // tile)
        bound_ms, bound_by = _bound(
            _nbytes(rows.lits, rows.mlits, *args, *got),
            _ops_compact(rows, d.Wv, tiles, rounds, sweeps))
        print(f"kernel blockwise_fixpoint on {name}: main-path launches "
              f"{launches['blockwise_fixpoint']} ms {ms:.4f} wrapper_ms "
              f"{wrapper_ms:.4f} plain_ms {pms:.3f} mismatches {bad} "
              f"max_abs_err {err} tile rows {tile} sweeps per fixpoint "
              f"{sweeps / B:.2f} rounds {rounds} bound_ms {bound_ms:.6f} "
              f"({bound_by})", flush=True)
        if bad:
            fail(f"kernel blockwise_fixpoint disagrees with its plain "
                 f"version on {name} ({bad} elements)")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        fam = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=pms,
                   bound_ms=bound_ms, bound_by=bound_by, tile_rows=tile,
                   resident=resident, sweeps_per_fixpoint=sweeps / B,
                   rounds=rounds)
        # Kernel 1 on the same inputs, under the team the shape rule picks
        # (the block team on the big families' wide planes) and under the
        # block team: the same conflict flags, and the same planes
        # wherever there is no conflict.
        bcp_team = teams.plan("bcp", 0, d.C, d.NA, d.Wv, 0, 0, None)[0]
        if name in big_names and bcp_team != "block":
            fail(f"kernel 1 on {name}'s full-space planes left the block "
                 f"team")
        bits, bcp_ms, _ = _timed(lambda: cuda_bcp.bcp_fixpoint(*pin),
                                 "bcp_fixpoint", TIMED_REPS)
        outs = {bcp_team: bits}
        if bcp_team != "block":
            outs["block"] = cuda_bcp.bcp_fixpoint(*pin, _team="block")
        ok = got[0] == 0
        for team, out in outs.items():
            bad = (int((out[0] != got[0]).sum())
                   + int((out[1] != got[1])[ok].sum())
                   + int((out[2] != got[2])[ok].sum()))
            print(f"kernel blockwise_fixpoint on {name}: against kernel 1, "
                  f"{team} team (bcp_fixpoint ms {bcp_ms:.4f} under "
                  f"{bcp_team}, kernel 2 / kernel 1 {ms / bcp_ms:.3f} in "
                  f"this run) mismatches {bad}", flush=True)
            if bad:
                fail(f"kernel blockwise_fixpoint disagrees with kernel 1's "
                     f"{team} team on {name} ({bad} elements)")
        fam.update(bcp_fixpoint_ms=bcp_ms, bcp_fixpoint_team=bcp_team)
        row["families"][name] = fam

        # Kernel 2 at tiles of 1 and 7 rows, plain versions in the pool.
        for br in SMALL_TILES:
            nb = min(B, SMALL_TILE_LANES.get((name, br), B))
            what = f"tile {br}, {nb} lanes"
            sub_k = [x[:nb] for x in kin]
            sub_p = [x[:nb] for x in pin]
            got = cuda_blockwise.bcp_fixpoint(*sub_k, block_rows=br)
            kw = dict(block_rows=cuda_blockwise.tile_rows(
                br, d.C, d.K, d.M, d.Wv, d.NA))
            if name in big_names:
                # Thousands of tiles of wide rows: the plain version runs
                # on the card, where each round takes a fraction of the
                # time it takes on one CPU core.
                _same("blockwise_fixpoint", name, what, got,
                      cuda_blockwise.bcp_fixpoint_plain(*sub_p, **kw))
            else:
                plain.submit(("blockwise_fixpoint", name, what), got,
                             "cuda_blockwise", "bcp_fixpoint_plain", sub_p,
                             kw, nb)

        if name in big_names:
            # The search kernel on the big family: its time per path, and
            # the row placements and thread counts measured.
            kw = dict(impl="blockwise", NCON=d.NCON)
            srch, s_ms, s_wrap = _timed_once(
                lambda: cuda_search.batched_search_fused(full, budget, en,
                                                         **kw), "search")
            steps = int(srch[3].sum())
            s_bound, s_by = _bound(
                _nbytes(rows.lits, rows.mlits, full.card_n, full.card_act,
                        full.choice_cand, full.var_choices, full.anchors,
                        full.n_vars, *srch),
                _ops_compact(rows, d.Wv, tiles, 0, 0, steps=steps))
            print(f"kernel search on {name} (blockwise): main-path launches "
                  f"{launches['search']} ms {s_ms:.3f} wrapper_ms "
                  f"{s_wrap:.3f} steps {steps} ms per step "
                  f"{s_ms / max(steps, 1):.6f} bound_ms {s_bound:.6f} "
                  f"({s_by})", flush=True)
            search_rows[name] = dict(ms=s_ms, wrapper_ms=s_wrap,
                                     plain_ms=None, bound_ms=s_bound,
                                     bound_by=s_by, steps=steps,
                                     launches_blockwise=launches["search"])
            choices[name] = measure_choices(name, kin, full, en, tile,
                                            d.NCON, d.Wv)
            compare_big_phases(name, full, en, tile, d.NCON, srch)
            continue

        # The phase kernels at tiles of 1 and 7 rows and at the natural
        # tile, plain versions in the pool.
        for br in SMALL_TILES + (tile,):
            nb = min(B, SMALL_TILE_LANES.get((name, br), B))
            sub = core.ProblemTensors(*[f[:nb] for f in full])
            en_b = en[:nb]
            kw = dict(impl="blockwise", block_rows=br, NCON=d.NCON)
            what = f"tile {br}{' (natural)' if br == tile else ''}, {nb} lanes"
            s_args = (sub, budget, en_b)
            got = cuda_search.batched_search_fused(*s_args, **kw)
            plain.submit(("search", name, what), got, "cuda_search",
                         "batched_search_plain", s_args, kw, nb)
            result, guessed, model, steps = got[0], got[1], got[2], got[3]
            m_args = (sub, result, model, guessed, budget, steps, en_b)
            got = cuda_search.batched_minimize_fused(*m_args, **kw)
            plain.submit(("minimize", name, what), got, "cuda_search",
                         "batched_minimize_plain", m_args, kw, nb)
            en_c = en_b & (result == core.UNSAT)
            if bool(en_c.any()):
                c_args = (sub, budget, steps, en_c)
                got = cuda_search.batched_core_fused(*c_args, **kw)
                plain.submit(("core", name, what), got, "cuda_search",
                             "batched_core_plain", c_args, kw, nb)
    torch.cuda.synchronize()
    return row, search_rows, choices


# --------------------------------------------------------------------------


# The family whose numbers stand in the summary line for each kernel: the
# headline fleet for kernels 1, 3 and 4, and the UNSAT-heavy fleet for the
# core kernel (the only family where phase 3 carries the load).
SUMMARY_FAMILY = {"bcp_fixpoint": "gvk_fleet",
                  "blockwise_fixpoint": "giant", "search": "gvk_fleet",
                  "minimize": "gvk_fleet", "core": "pinned_tenant"}
SOURCES = {
    "bcp_fixpoint": ("deppy_tpu_torch/engine/csrc/bcp.cu",
                     "deppy_tpu/engine/pallas_bcp.py:92"),
    "blockwise_fixpoint": ("deppy_tpu_torch/engine/csrc/blockwise.cu",
                           "deppy_tpu/engine/pallas_blockwise.py:127"),
    "search": ("deppy_tpu_torch/engine/csrc/search.cu",
               "deppy_tpu/engine/pallas_search.py:860"),
    "minimize": ("deppy_tpu_torch/engine/csrc/minimize.cu",
                 "deppy_tpu/engine/pallas_search.py:616"),
    "core": ("deppy_tpu_torch/engine/csrc/core.cu",
             "deppy_tpu/engine/pallas_search.py:785"),
}


# The kernels each path must launch (bcp_fixpoint is the bits path's
# baseline fixpoint, blockwise_fixpoint the blockwise path's; the surface
# path runs both impls).
PATH_KERNELS = {
    "bits": ("bcp_fixpoint", "search", "minimize", "core"),
    "blockwise": ("blockwise_fixpoint", "search", "minimize", "core"),
    "surface": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
                "core"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of each family's batch to resolve "
                         "(default 1.0: the full sizes)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from deppy_tpu_torch import engine
    from deppy_tpu_torch.engine import _build

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    plain = PlainPool()
    try:
        t0 = time.perf_counter()
        _build.load()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {_build.build_seconds:.1f} s, 0 = reused) at "
              f"{_build.library_path()}", flush=True)

        def stamp(phase):
            print(f"phase {phase} done at {time.perf_counter() - t_all:.1f} "
                  f"s", flush=True)

        by_path = {}
        by_path["bits"], per_family, main_answers = run_main_path(args.scale)
        stamp("bits path")
        (by_path["blockwise"], per_family_bw,
         bw_answers) = run_blockwise_path(args.scale)
        stamp("blockwise path")
        by_path["surface"], per_family["surface"] = run_surface_path(
            main_answers, bw_answers)
        del main_answers, bw_answers
        stamp("surface path")
        per_family["profile"] = profile_chunk(args.scale)
        per_family["profile_blockwise"] = profile_solve(
            "operatorhub_batch", operatorhub_batch(args.scale),
            impl="blockwise")
        stamp("profiles")
        rows = compare_kernels(args.scale, by_path["bits"])
        stamp("bits kernels compared")
        (rows["blockwise_fixpoint"], search_big,
         per_family["choices"]) = compare_blockwise(
            args.scale, by_path["blockwise"], plain)
        rows["search"]["families"].update(
            {f"{k} (blockwise)": v for k, v in search_big.items()})
        stamp("blockwise kernels compared")
        t0 = time.perf_counter()
        n = plain.check()
        print(f"{n} comparisons at small tiles checked in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        stamp("small tiles")
    finally:
        plain.close()

    launches = {k: sum(p[k] for p in by_path.values())
                for k in engine.KERNELS}
    for path, counts in by_path.items():
        print(f"kernels ({path} path): " + " ".join(
            f"{k}={counts[k]}" for k in engine.KERNELS), flush=True)
        missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
        if missing:
            fail(f"the {path} path never launched {missing}")
    print("kernels: " + " ".join(f"{k}={launches[k]}"
                                 for k in engine.KERNELS), flush=True)
    missing = [k for k in engine.KERNELS if k not in rows]
    if missing:
        fail(f"kernels never compared with their plain versions: {missing}")

    summary = []
    for k in engine.KERNELS:
        fam = SUMMARY_FAMILY[k]
        m = rows[k]["families"][fam]
        src, replaces = SOURCES[k]
        summary.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=launches[k],
            launches_by_path={p: c[k] for p, c in by_path.items()},
            max_abs_err=rows[k]["max_abs_err"],
            ms=m["ms"], wrapper_ms=m["wrapper_ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, family=fam,
            by_family=rows[k]["families"],
            **({"teams": rows[k]["teams"]} if "teams" in rows[k] else {})))
    per_family.update({f"blockwise_{k}": v for k, v in per_family_bw.items()})
    print(f"total {time.perf_counter() - t_all:.1f} s; per family "
          f"{json.dumps(per_family)}", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
