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
4b. the impls path: the reference's other BCP impls, ``watched``,
   ``gather`` and ``pallas`` (``set_bcp_impl``), on the bits path's
   batches at their full sizes and one ``Solver`` each on
   ``operatorhub_catalog(40, 5)``, ``operatorhub_catalog(250, 8)`` and
   the giant (not under pallas); each prints its wall, problems/s, the
   launches of each kernel, its real-bank and dummy-bank launches and,
   for one problem, its steps; every result (outcome, installed, core,
   steps, backtracks) must equal the bits path's, every watched launch
   must read a real bank, and no plain version may run;
4c. the tracing path: ``Solver(vars, tracer=..., trace_cap=T,
   device="cuda")`` under bits, blockwise and watched on the two
   instances of ``tests/test_tracer_backends.py`` and on each put ahead
   of ``operatorhub_catalog(40, 5)`` (thousands of backtracks), each held
   against ``backend="host"`` with the same tracer: the same outcome and
   backtrack count, every assumption stack equal event for event, the
   conflicts equal wherever the card's replay reports any; the doomed
   catalogs at the default depth (the truncation warning must fire) and
   at their backtrack count (every event); no plain version may run.
   Then one batch with ``DEPPY_GPU_TELEMETRY_FILE`` set, whose JSONL must
   hold the four driver spans and one report event.  Every family of the
   bits path, and each profiled solve, prints its ``driver split`` (the
   ``SolveReport`` walls and the ``driver.decode`` span) beside its
   encode time and the profiler's device-busy ms;
4d. the sched path: the port's request scheduler
   (``deppy_tpu_torch.sched.Scheduler``, its default 5 ms wait and
   256-lane fill) serving concurrent clients on the card: (A) 32 client
   threads submit 128 requests of 16 ``gvk_conflict_catalog(20, 4, 10)``
   states, beside (B) 32 requests of 8 distinct ``pinned_tenant_catalog``
   states and (C) one ``operatorhub_catalog(250, 8)``; (D) 32 of A's
   requests again through ``BatchResolver(scheduler=)``, each a cache
   hit with 0 steps and no dispatch; (E) on a second scheduler (50 ms
   wait, no cache) 4 requests with a 1 ms deadline, queued first, among
   4 live ones: the expired lanes Incomplete, the live ones answered;
   (F) after the others drained, under ``set_bcp_impl("blockwise")``, 8
   clients with 8 ``operatorhub_catalog(250, 8)`` each.  Every answer
   and step count must equal the unscheduled port's on the card
   (``BatchResolver(device="cuda").solve`` of the same request), A must
   coalesce (fewer dispatches than requests), no dispatch may mix size
   classes, C must flush alone, and every dispatch and every launch must
   come from the dispatch-loop thread (kernels 1, 3, 4 and 5 in A+B+C,
   kernel 2 in F).  Each part prints its dispatches, lanes per dispatch,
   p50/p99 request latency, queue-wait share and one dispatch's driver
   split; A+B+C's scheduled wall stands beside the unscheduled calls'
   summed walls;
4e. the race path: the port's portfolio racing (``Scheduler(portfolio=
   ...)``, the engine registry, the host worker pool and the grad_relax
   entrant) on the card, :func:`run_race_path`'s parts 1-7: the deep
   chains of ``deppy_tpu/benchmarks/hard.py`` raced top-3 (device, host,
   grad_relax; under bits, then top-2 under blockwise), the ``sched``
   burst raced top-2 beside it unraced, the ``auto`` mode with and
   without a measured row, the host pool against the inline engine on
   the 1,000 pinned-tenant states (and after a scripted worker crash),
   straggler triage, the grad_relax descent twice on the card and once
   on the CPU, and the registry's per-class costs (``race cost`` lines).
   Every answer equals the unraced scheduler's, no sampled cross-check
   disagrees, no device entrant raises, every launch of a race window
   comes from the race's device thread (losers included), and the first
   race-thread launch of each kernel is held against its plain version
   (both phases run their schedulers with the incremental tier off);
4f. the incremental path: the port's incremental tier
   (``deppy_tpu_torch.incremental``, the scheduler's warm class) on the
   card, :func:`run_incremental_path`'s parts 1-4: the churn replay of
   ``deppy_tpu/benchmarks/churn.py`` at its own defaults (120 requests,
   32 bundles x 12, one dependency clause flipped each) through
   ``Scheduler()`` from one thread with the tier on and off, 3 replays
   each, then once 8 requests a submit; the screen on the card against
   its CPU run over replay 1's warm plans and the same plans poisoned;
   the ``sched`` burst A+B with the tier on and off; the ``warm``
   backend's per-class cost (``incremental cost`` lines).  Answers must
   be equal lane for lane with the tier on and off (steps too on every
   churn lane, and every burst request, with no lane served warm), every
   warm flush of two or more lanes must run the screen on ``cuda``,
   every screen must equal its CPU run, no ``incremental_screen_failed``
   event may fire, and the first loop-thread launch of each kernel in
   the churn replays and in the burst is held against its plain version;
4g. the sessions path: resolution sessions (``deppy_tpu_torch.sessions``,
   the scheduler's session lanes) on the card, :func:`run_sessions_path`'s
   parts 1-3 over ``session_catalog(96, 8)`` (the reference benchmark's
   default: 768 variables in 96 bundle chains): one session's 48-step
   walk beside the same walk as stateless submits, 16 sessions in
   lockstep with a test scope and an UNSAT ``explain`` every 8th step,
   and the handoff of the warm state and the sessions to a fresh
   scheduler (4 more steps each).  Every answer must equal the one-shot
   cold solve of its derived problem on the card, byte for byte (steps
   too where no warm start was planned), no session answer may reach the
   shared cache or index, every warm flush of two or more lanes must be
   screened on ``cuda``, every session-class flush must be ``immediate``,
   and the first loop-thread launch of kernels 1, 3, 4 and 5 is held
   against its plain version;
4h. the faults path: the driver's fault envelope, the circuit breaker
   and the ``auto`` backend on the card, :func:`run_faults_path`'s parts
   1-13 over 256 ``gvk_conflict_catalog(20, 4, 10)`` and 64
   ``pinned_tenant_catalog`` states: no earlier phase may have counted a
   driver failure or a host-routed lane; the baseline on the card and on
   the host backend; one transient ``driver.dispatch`` and one
   ``driver.device_put`` fault (a retry each); a poison group that
   exhausts its attempts and is halved; a dead card (every dispatch
   fails) that trips the breaker (threshold 2) and host-routes every
   lane, the short circuit under the open breaker (0 launches) and the
   half-open probe after the cooldown; a chunk deadline of 1 ns that
   charges the breaker with real dispatches; ``BatchResolver(deadline_s=
   0.0)`` (0 launches) and a generous deadline; budget escalation with a
   compacted redo and with a full rerun; a checkpointed solve crashed
   after its first group and resumed; a transient fault under blockwise
   (kernel 2 on the retry); and ``auto``: the subprocess engine probe,
   then a ``Scheduler(backend="auto", portfolio="on")`` whose flushes run
   on the card, trip the breaker, drain on the host with no device
   entrant, and upgrade through the deferred re-probe.  Every answer
   equals the baseline's (steps too, except where a split or the host
   routed a lane: those equal the host backend's), every part's counter
   deltas and breaker transitions are the scripted ones, and the first
   launch of each kernel in the phase is held against its plain version.
   At the end of the run the driver failures and host-routed lanes must
   equal the phase's scripted totals (with 4i's);
4i. the optimize path: the trip profiler (``deppy_tpu_torch.profile``,
   armed at sample 1.0 over the phase, on a sink of its own) and the
   optimization tier (``deppy_tpu_torch.optimize.Planner`` over
   ``Scheduler(device="cuda")``, whose feasibility solves, native probes
   and explains ride the idle queue), :func:`run_optimize_path`: (1) 8
   soft documents over ``operatorhub_catalog(40, 5)`` (unit-positive:
   optimum 1, floor 0, the last probe an UNSAT proof on kernel 5) from 8
   clients at once; (2) the reference's upgrade replay at its defaults
   (96 packages x 4 versions, 6 rounds of 4 releases), a cold pass and a
   warm pass, with the µs a probe from the sink's ``optimize`` events;
   (3) workload 1 again beside a live burst of 32 requests x 16
   ``gvk_conflict_catalog(20, 4, 10)`` states from 8 clients, the live
   p50/p99 with the load and without it and the probes' queue waits;
   then the profiler's sites: ``BatchResolver(device="cuda")`` over 512
   ``gvk_fleet`` states (disarmed and armed, in turns) and 64
   ``pinned_tenant`` states, 8 ``operatorhub_catalog(250, 8)`` under
   blockwise, a host flush, a churn replay's warm flushes and one
   scripted dead-card host fallback, and each site at sample 0.25.
   Every response equals the host scheduler's byte for byte and every
   ``selected`` set is a solution; every live answer and step count
   equals its unscheduled solve; every idle flush drained with no live
   lane queued; there is one ``profile`` event per sampled dispatch and
   flush, each report's ledger fields are its events' sums, the
   ``gvk_fleet`` and ``pinned_tenant`` events' steps and fields, and one
   blockwise catalog's dispatched alone, equal the plain versions' on the
   CPU (in the pool), exactly 1 of 4 dispatches a site is sampled
   at 0.25, the sink read back by ``profile.report.summarize`` holds
   every event, and the first loop-thread launch of kernels 1, 3, 4 and 5
   from an idle flush and the blockwise run's kernel 2 launch are held
   against their plain versions;
4j. the speculate path: speculative pre-resolution
   (``deppy_tpu_torch.speculate``, the scheduler's pre-solves on the idle
   queue), :func:`run_speculate_path`: the reference's publish-churn
   replay at its defaults (16 ``catalog_family(., f, 8, 16)`` families,
   5 ``round_delta`` publishes, every family re-asking through ``submit``
   after each) on ``Scheduler(device="cuda")`` with the incremental tier
   on, speculation off (A) and on (B, each publish drained, then a 0.25 s
   settle beat), two passes each, the lower p99 kept; then (C) 256
   families (every distinct fingerprint) with the incremental tier off,
   so that every pre-solve is a cold dispatch on the card, through the 5
   rounds and a withdrawal of ``b0v1`` (every family UNSAT), a live
   request riding round 3's drain.  A's and B's responses are equal with
   the prefix stripped, B's hit ratio is at least 0.9, every re-ask in C
   is a cache hit (0 steps, no report) equal to a cold
   ``BatchResolver(device="cuda")`` solve of the same 256 states, the
   withdrawal's cores are the three constraints of ``b0v0``/``b0v1``,
   every SAT answer is a solution, no idle drain ran with a live lane
   queued, the backlog gauge reads 0 after every drain and the
   presolves and dropped counters equal the publishes' sums, C's idle
   flushes launch kernels 1, 3, 4 and 5, and the first loop-thread
   launch of each in C is held against its plain version;
5. the answers: every solution satisfies every constraint of its
   problem, every unsat core is non-empty, no result is Incomplete; the
   first problems of each bits family give the same answers on
   ``device="cpu"`` (the kernels' plain versions), the blockwise answers
   equal the bits path's on the same problems, and the 803-constraint
   problem's core is its three conflicting constraints;
6. one 512-problem chunk of the headline fleet (under bits and under
   watched), and the 64-catalog batch under blockwise, under
   ``torch.profiler``: device time by kernel and the card's busy share;
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
7b. kernels 1, 3, 4 and 5 under each arm of the impls path (the
   watched arm and the gather rounds of ``csrc/watched.cuh``, the pallas
   impl's dense rounds in the full space) against their plain versions:
   32 lanes of each small family, 8 of the 64-catalog batch and the giant
   (not under pallas) with the phases at a cut step budget; kernel 1's
   plain version on the card, the phases' in the pool; each arm timed by
   the profiler, with its bound from the plain version's rounds and pops;
7c. kernel 3 with a trace buffer (T 4 and 64) against its plain version
   on 64 lanes of small backtracking problems (decided, disabled and
   truncated lanes among them): every output bit-equal; and kernel 3
   timed at T 0 and T 64, in turns, on the 32 gvk_fleet lanes;
8. the ``kernels:`` lines and the JSON summary of every kernel and arm.

The last line is ``{"ok": true, "device": {...}}``.  Without a card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
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
    the NotSatisfiable it raised; the solver's steps, backtracks and
    report land in ``stats`` when given."""
    from deppy_tpu_torch.sat import NotSatisfiable, Solver

    solver = Solver(variables, device="cuda")
    try:
        installed = solver.solve()
    except NotSatisfiable as e:
        return e
    finally:
        if stats is not None:
            stats.update(steps=solver.steps, backtracks=solver.backtracks,
                         report=solver.report)
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


class Recorder:
    """While on, every ``core.SolveResult`` the driver returns, as a key
    per problem: (outcome, installed variables, core constraints, steps,
    backtracks), which the facade's answers do not all carry.  The impls
    path holds each impl's keys against the bits path's."""

    def __init__(self):
        self.keys = []

    def __enter__(self):
        from deppy_tpu_torch.engine import driver

        self._solve = driver.solve_problems

        def solve_problems(*args, **kwargs):
            out = self._solve(*args, **kwargs)
            self.keys += [solve_key(r) for r in out]
            return out

        driver.solve_problems = solve_problems
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.engine import driver

        driver.solve_problems = self._solve


def solve_key(r):
    """One problem's result as a comparable key."""
    return (int(r.outcome), tuple(r.installed.nonzero()[:, 0].tolist()),
            tuple(r.core.nonzero()[:, 0].tolist()), int(r.steps),
            int(r.trace_n))


def run_main_path(scale: float, bits_keys: dict):
    """Phases 2 and 4: resolve every family of the bits path on the card
    and check it; each family's result keys land in ``bits_keys``."""
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
        resolver = BatchResolver(device="cuda")
        with Recorder() as rec:
            results = resolver.solve(pool)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = driver_split(resolver.last_report)
        bits_keys[name] = rec.keys
        counts = engine.launch_counts()
        warps = all_warp(name, counts)
        n_sat = sum(isinstance(r, dict) for r in results)
        n_unsat = sum(isinstance(r, NotSatisfiable) for r in results)
        n_inc = sum(isinstance(r, Incomplete) for r in results)
        print(f"main path {name}: {count} problems in {wall:.3f} s "
              f"({count / wall:.1f} problems/s); sat {n_sat} unsat "
              f"{n_unsat} incomplete {n_inc}; launches {counts}, warp team "
              f"{warps}; host encode alone {t_encode:.3f} s", flush=True)
        rest = wall * 1e3 - split["encode"] - split["solve"] - split["decode"]
        print(f"driver split {name}: {_split_text(split)}; encode alone "
              f"{t_encode * 1e3:.3f} ms; wall {wall * 1e3:.3f} ms, of which "
              f"{rest:.3f} ms outside encode, solve and decode", flush=True)
        for k in launches:
            launches[k] += counts[k]
        per_family[name] = dict(problems=count, wall_s=wall,
                                problems_per_s=count / wall,
                                encode_s=t_encode, sat=n_sat,
                                unsat=n_unsat, incomplete=n_inc,
                                launches=counts, split_ms=split)
        if n_inc:
            fail(f"{name}: {n_inc} Incomplete results at the default budget")
        check_answers(name, pool, results)
        samples[name] = (pool[:REFERENCE_LANES], results[:REFERENCE_LANES])
        if name == "pinned_tenant":
            kept[name] = (pool, results)

    variables = operatorhub_catalog(40, 5)
    engine.reset_launch_counts()
    one = {}
    t0 = time.perf_counter()
    with Recorder() as rec:
        answer = solve_one(variables, one)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = driver_split(one["report"])
    split["decode"] = None
    bits_keys["operatorhub"] = rec.keys
    counts = engine.launch_counts()
    warps = all_warp("operatorhub", counts)
    for k in launches:
        launches[k] += counts[k]
    print(f"main path operatorhub: 1 problem in {wall:.3f} s; "
          f"{render(answer)[0]}; launches {counts}, warp team {warps}",
          flush=True)
    print(f"driver split operatorhub: {_split_text(split)}; wall "
          f"{wall * 1e3:.3f} ms", flush=True)
    per_family["operatorhub"] = dict(problems=1, wall_s=wall,
                                     launches=counts,
                                     outcome=render(answer)[0],
                                     split_ms=split)
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


def run_blockwise_path(scale: float, bits_keys: dict):
    """Phases 3 and 4 under ``set_bcp_impl("blockwise")``: the giant
    catalog, the 64-catalog batch, pinned tenants and the host-routed
    giant core; then the same batches on the bits path, whose answers the
    blockwise ones must equal (the giant's result key lands in
    ``bits_keys``)."""
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

    split = driver_split(giant_stats.pop("report"))
    split["decode"] = None
    print(f"driver split giant (blockwise): {_split_text(split)}",
          flush=True)
    steps = giant_stats["steps"]
    wall_ms = per_family["giant"]["wall_s"] * 1e3
    per_family["giant"].update(giant_stats, ms_per_step=wall_ms / steps,
                               split_ms=split)
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
        with Recorder() as rec:
            ref = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "giant":
            bits_keys[name] = rec.keys
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


# The impls path: the reference's other BCP impls, each on the main
# path's families at their full sizes.  The giant is not run under pallas:
# every fixpoint there is the dense rounds on its full-space planes
# (8,192 rows x 768 words), which took 54.1 s in the port's first
# full-space kernel (PERF.md).
IMPL_ARMS = ("watched", "gather", "pallas")

# The gvk_fleet states run under gather and pallas: the depth cut that
# keeps the whole run near 600 s (the full 10,000 run under watched).
CUT_FLEET = 2000


def impl_families(scale: float):
    """(name, problems, batched) of the impls path: the bits path's
    batches, then one ``Solver`` each on ``operatorhub_catalog(40, 5)``,
    ``operatorhub_catalog(250, 8)`` and the giant."""
    from deppy_tpu_torch.models import operatorhub_catalog

    out = [(name, [make(i) for i in range(count)], True)
           for name, count, make in families(scale)]
    out += [("operatorhub", [operatorhub_catalog(40, 5)], False),
            ("operatorhub_250", [operatorhub_catalog(*BATCH, seed=0)], False),
            ("giant", [operatorhub_catalog(*GIANT, seed=0)], False)]
    return out


def run_impls_path(scale: float, bits_keys: dict):
    """Every family of :func:`impl_families` under each impl of
    :data:`IMPL_ARMS` on the card (``gvk_fleet`` cut to its first
    :data:`CUT_FLEET` states under gather and pallas): wall, problems/s,
    the launches of each kernel and arm, and those that read a real bank
    or fell through on a dummy one; every result key (outcome, installed,
    core, steps, backtracks) must equal the bits path's (``bits_keys``,
    recorded by the earlier paths; ``operatorhub_250``'s is recorded
    here).  No plain version may run: the plain rounds and pops stay as
    they were.
    Returns ({impl: launches}, {impl: {family: numbers}})."""
    import torch

    from deppy_tpu_torch import engine
    from deppy_tpu_torch.engine import core
    from deppy_tpu_torch.resolution import BatchResolver

    fams = impl_families(scale)
    stats = {}

    def solve(pool, batched):
        if batched:
            return BatchResolver(device="cuda").solve(pool)
        return [solve_one(pool[0], stats)]

    print(f"impls path on {card_line()}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        solve(*[(p, b) for n, p, b in fams if n == "operatorhub_250"][0])
        torch.cuda.synchronize()
    bits_keys["operatorhub_250"] = rec.keys
    print(f"impls path bits operatorhub_250 (the reference): 1 problem in "
          f"{time.perf_counter() - t0:.4f} s; steps {rec.keys[0][3]}",
          flush=True)
    launches, per_impl = {}, {}
    for impl in IMPL_ARMS:
        launches[impl] = {k: 0 for k in engine.KERNELS}
        per_impl[impl] = {}
        core.set_bcp_impl(impl)
        try:
            for name, pool, batched in fams:
                if impl != "watched" and name == "gvk_fleet":
                    pool = pool[:CUT_FLEET]
                if impl == "pallas" and name == "giant":
                    print("impls path pallas giant: not run (every fixpoint "
                          "the dense rounds on 8,192 x 768-word planes; the "
                          "port's first full-space kernel took 54.1 s on "
                          "it)", flush=True)
                    continue
                plain = _plain_work()
                torch.cuda.synchronize()
                engine.reset_launch_counts()
                t0 = time.perf_counter()
                with Recorder() as rec:
                    results = solve(pool, batched)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = engine.launch_counts()
                arms = engine.impl_launch_counts()
                banks = engine.bank_launch_counts()
                if _plain_work() != plain:
                    fail(f"impls path {impl} {name}: a plain version ran")
                if any(set(a) - {impl} for a in arms.values()):
                    fail(f"impls path {impl} {name}: launches under another "
                         f"impl: {arms}")
                dummy = sum(b["dummy"] for b in banks.values())
                if dummy:
                    fail(f"impls path {impl} {name}: {dummy} watched "
                         f"launches on dummy banks")
                want = bits_keys[name][:len(pool)]
                bad = sum(a != b for a, b in zip(rec.keys, want))
                if bad or len(rec.keys) != len(want):
                    fail(f"impls path {impl} {name}: {bad} of {len(pool)} "
                         f"results differ from the bits path's")
                check_answers(f"{impl} {name}", pool, results)
                for k in launches[impl]:
                    launches[impl][k] += counts[k]
                row = dict(problems=len(pool), wall_s=wall,
                           problems_per_s=len(pool) / wall, launches=counts,
                           real_bank={k: b["real"] for k, b in banks.items()})
                line = (f"impls path {impl} {name}: {len(pool)} problems in "
                        f"{wall:.4f} s ({len(pool) / wall:.2f} problems/s); "
                        f"launches {counts}, real-bank launches "
                        f"{row['real_bank']}, dummy-bank launches {dummy}; "
                        f"results equal to the bits path's")
                if not batched:
                    steps = rec.keys[0][3]
                    row.update(steps=steps, backtracks=rec.keys[0][4],
                               ms_per_step=wall * 1e3 / max(steps, 1))
                    line += (f"; steps {steps} backtracks {rec.keys[0][4]} "
                             f"ms per step {row['ms_per_step']:.6f}")
                print(line, flush=True)
                per_impl[impl][name] = row
        finally:
            core.set_bcp_impl("auto")
    return launches, per_impl


# --------------------------------------------------------------------------
# the tracing path

# The impls the card's traces are held against the host backend's under.
TRACE_IMPLS = ("bits", "blockwise", "watched")
# The driver's default trace depth (driver.DEFAULT_TRACE_CAP), which the
# doomed catalogs overflow.
TRACE_DEFAULT = 256
# Kernel 3 against its plain version at T > 0: lanes and depths.
TRACE_LANES = 64
TRACE_DEPTHS = (4, 64)
# The depth kernel 3 is timed at beside T = 0 on the gvk_fleet lanes.
TRACE_TIMED_T = 64


def _doomed(b: str):
    """``b`` needs one of {x, y} and one of {w, z}, and every cross pair
    conflicts: doomed one guess deeper than propagation sees
    (tests/test_tracer_backends.py:22-33)."""
    from deppy_tpu_torch.sat import conflict, dependency, variable

    return [variable(b, dependency("x", "y"), dependency("w", "z")),
            variable("x", conflict("w"), conflict("z")),
            variable("y", conflict("w"), conflict("z")),
            variable("w"), variable("z")]


def backtracking_instance():
    """The preferred candidate ``b`` is doomed: the search backtracks out
    of it and falls back to ``c`` (tests/test_tracer_backends.py:36-43)."""
    from deppy_tpu_torch.sat import dependency, mandatory, variable

    return [variable("a", mandatory(), dependency("b", "c")),
            variable("c")] + _doomed("b")


def unsat_instance():
    """The only candidate is doomed: the search exhausts every guess
    (tests/test_tracer_backends.py:46-52)."""
    from deppy_tpu_torch.sat import dependency, mandatory, variable

    return [variable("a", mandatory(), dependency("b"))] + _doomed("b")


def tracing_instances():
    """The two reference instances, and each ahead of
    ``operatorhub_catalog(40, 5)``: a preferred bundle whose dependencies
    clash, which the search only learns after walking the catalog's
    choices under it (thousands of backtracks)."""
    from deppy_tpu_torch.models import operatorhub_catalog

    return [("backtrack_sat", backtracking_instance()),
            ("exhaust_unsat", unsat_instance()),
            ("doomed_catalog_sat",
             backtracking_instance() + operatorhub_catalog(40, 5)),
            ("doomed_catalog_unsat",
             unsat_instance() + operatorhub_catalog(40, 5))]


class RecordingTracer:
    """Every position a solve's tracer receives: (assumption stack,
    conflicts), both as identifiers and strings."""

    def __init__(self):
        self.positions = []

    def trace(self, position) -> None:
        self.positions.append((
            [v.identifier for v in position.variables()],
            [str(c) for c in position.conflicts()]))


def traced_solve(variables, backend: str, T=None):
    """(outcome, positions, backtracks, truncation warnings, wall s) of
    one ``Solver(variables, tracer=...)`` solve on ``backend`` (the
    device backend on the card)."""
    import warnings

    import torch

    from deppy_tpu_torch.sat import NotSatisfiable, Solver

    rec = RecordingTracer()
    solver = Solver(variables, tracer=rec, backend=backend, device="cuda",
                    trace_cap=T)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        try:
            out = ("sat", sorted(v.identifier for v in solver.solve()))
        except NotSatisfiable as e:
            out = ("unsat", sorted(str(c) for c in e.constraints))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "trace buffer holds" in str(w.message)]
    return out, rec.positions, solver.backtracks, warned, wall


def run_tracing_path():
    """Phase 4c: ``Solver(vars, tracer=rec, trace_cap=T, device="cuda")``
    under each impl of :data:`TRACE_IMPLS` on :func:`tracing_instances`,
    each held against ``backend="host"`` with the same tracer: the same
    outcome, the card's backtrack count equal to the host's, every
    assumption stack equal event for event, conflicts equal wherever the
    card's replay reports any.  The doomed catalogs run twice: at the
    default depth, where the truncation warning must fire and the first
    :data:`TRACE_DEFAULT` events match, and at the host's backtrack
    count, where every event matches.  No plain version may run.
    Returns (launches, {instance: numbers})."""
    from deppy_tpu_torch import engine
    from deppy_tpu_torch.engine import core

    launches = {k: 0 for k in engine.KERNELS}
    per_instance = {}
    work0 = _plain_work()
    for name, variables in tracing_instances():
        h_out, h_pos, h_bt, _, h_wall = traced_solve(variables, "host")
        if h_bt != len(h_pos) or h_bt == 0:
            fail(f"tracing {name}: the host engine traced {len(h_pos)} of "
                 f"{h_bt} backtracks")
        depths = [None] if h_bt <= TRACE_DEFAULT else [None, h_bt]
        row = per_instance[name] = dict(host_backtracks=h_bt,
                                        host_wall_s=h_wall, runs={})
        for impl in TRACE_IMPLS:
            for T in depths:
                core.set_bcp_impl(impl)
                try:
                    engine.reset_launch_counts()
                    out, pos, bt, warned, wall = traced_solve(
                        variables, "device", T)
                    counts = engine.launch_counts()
                finally:
                    core.set_bcp_impl("auto")
                depth = TRACE_DEFAULT if T is None else T
                label = f"tracing {name} under {impl} at T {depth}"
                if out != h_out:
                    fail(f"{label}: outcome {out[0]} against the host's "
                         f"{h_out[0]}")
                if bt != h_bt:
                    fail(f"{label}: {bt} backtracks against the host's "
                         f"{h_bt}")
                if counts["search"] <= 0:
                    fail(f"{label}: the search kernel was not launched")
                if len(pos) != min(depth, h_bt):
                    fail(f"{label}: {len(pos)} events, expected "
                         f"{min(depth, h_bt)}")
                if bool(warned) != (h_bt > depth):
                    fail(f"{label}: truncation warning "
                         f"{'fired' if warned else 'missing'}")
                stacks = sum(p[0] != q[0] for p, q in zip(pos, h_pos))
                conflicts = sum(bool(p[1]) and p[1] != q[1]
                                for p, q in zip(pos, h_pos))
                replayed = sum(bool(p[1]) for p in pos)
                print(f"{label}: {out[0]}, backtracks {bt} (host {h_bt}), "
                      f"events {len(pos)}, stack mismatches {stacks}, "
                      f"conflict mismatches {conflicts} of {replayed} "
                      f"replayed, warning {bool(warned)}; wall {wall:.3f} s "
                      f"(host backend {h_wall:.3f} s); launches {counts}",
                      flush=True)
                if stacks or conflicts:
                    fail(f"{label}: {stacks} stacks and {conflicts} "
                         f"conflict sets differ from the host backend's")
                for k in launches:
                    launches[k] += counts[k]
                row["runs"][f"{impl}/T{depth}"] = dict(
                    wall_s=wall, events=len(pos), replayed=replayed,
                    warned=bool(warned), launches=counts)
    if _plain_work() != work0:
        fail("tracing path: a plain version ran during a card solve")
    return launches, per_instance


def trace_batch(n: int):
    """Kernel 3's comparison batch at T > 0: ``n`` lanes of small
    backtracking problems (the doomed package ahead of seeded
    ``operatorhub_catalog(4, 3)`` catalogs, and the two reference
    instances), with every eighth lane a problem whose baseline decides
    (no search) and the last quarter disabled."""
    import torch

    from deppy_tpu_torch.engine import core, driver
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.sat import mandatory, variable
    from deppy_tpu_torch.sat.encode import encode

    def make(i):
        if i % 8 == 7:
            return [variable("s", mandatory())]
        if i % 8 == 6:
            return unsat_instance()
        head = unsat_instance() if i % 2 else backtracking_instance()
        return head + operatorhub_catalog(4, 3, seed=i)

    probs = [encode(make(i)) for i in range(n)]
    d = driver._Dims(probs, n)
    dev = torch.device("cuda")
    pts = driver._upload(driver.pad_stack(probs, d, n), dev)
    red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
    en = torch.arange(n, device=dev) < n - n // 4
    return red, en, d


def compare_trace_kernel(plain) -> dict:
    """Kernel 3 at each depth of :data:`TRACE_DEPTHS` against its plain
    version (run in the pool on CPU copies) on :func:`trace_batch`:
    tr_stack, tr_n, result and steps bit-equal; and kernel 3 timed at
    T = 0 and at :data:`TRACE_TIMED_T` on the first 32 lanes of the
    gvk_fleet chunk (the ``kernel search`` row's lanes), in turns."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_search, driver
    from deppy_tpu_torch.sat.encode import encode

    budget = driver.DEFAULT_MAX_STEPS
    red, en, d = trace_batch(TRACE_LANES)
    for T in TRACE_DEPTHS:
        got = cuda_search.batched_search_fused(red, budget, en, T=T)
        torch.cuda.synchronize()
        tr, trn = got[4], got[5]
        print(f"kernel search at T {T} on {TRACE_LANES} backtracking lanes: "
              f"tr_stack {list(tr.shape)}, backtracks per lane max "
              f"{int(trn.max())} sum {int(trn.sum())}, lanes past T "
              f"{int((trn > T).sum())}; held against the plain version in "
              f"the pool", flush=True)
        if int(trn.min()) != 0 or (T == TRACE_DEPTHS[0]
                                   and int((trn > T).sum()) == 0):
            fail(f"trace batch at T {T}: expected lanes without "
                 f"backtracks, and lanes past the smallest depth")
        plain.submit(("search", f"trace batch T {T}", "tr"), got,
                     "cuda_search", "batched_search_plain",
                     (red, budget, en), dict(T=T), TRACE_LANES, chunk=8)

    name, count, make = families(1.0)[0]
    probs = [encode(make(i)) for i in range(min(count, driver.MAX_LANES))]
    d = driver._Dims(probs, len(probs))
    lanes = probs[:COMPARE_LANES]
    dev = torch.device("cuda")
    pts = driver._upload(driver.pad_stack(lanes, d, len(lanes)), dev)
    red = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=False)
    en = torch.ones(len(lanes), dtype=torch.bool, device=dev)
    times = {0: [], TRACE_TIMED_T: []}
    outs = {}
    for T in (0, TRACE_TIMED_T, TRACE_TIMED_T, 0):
        out, ms, wrapper_ms = _timed(
            lambda: cuda_search.batched_search_fused(red, budget, en, T=T),
            "search", TIMED_REPS)
        times[T].append((ms, wrapper_ms))
        outs[T] = out
    _same("search", name, f"T {TRACE_TIMED_T} against T 0",
          [outs[TRACE_TIMED_T][i] for i in (0, 1, 2, 3, 5)],
          [outs[0][i] for i in (0, 1, 2, 3, 5)])
    row = {f"T{T}": dict(ms=statistics.mean(m for m, _ in v),
                         wrapper_ms=statistics.mean(w for _, w in v),
                         ms_runs=[m for m, _ in v])
           for T, v in times.items()}
    print(f"kernel search on {name} ({len(lanes)} lanes): T 0 ms "
          f"{row['T0']['ms']:.4f} (runs {row['T0']['ms_runs']}), T "
          f"{TRACE_TIMED_T} ms {row[f'T{TRACE_TIMED_T}']['ms']:.4f} (runs "
          f"{row[f'T{TRACE_TIMED_T}']['ms_runs']}); wrapper ms "
          f"{row['T0']['wrapper_ms']:.4f} and "
          f"{row[f'T{TRACE_TIMED_T}']['wrapper_ms']:.4f}", flush=True)
    return row


def driver_split(report) -> dict:
    """A solve's driver split in ms: the ``SolveReport`` walls
    (``pad_pack``, ``device_put``, ``solve`` = the whole driver call) and
    the last ``driver.decode`` span (absent where nothing decoded)."""
    from deppy_tpu_torch import telemetry

    if report is None:
        fail("a card solve left no SolveReport")
    split = {k: report.wall.get(k, 0.0) * 1e3
             for k in ("encode", "pad_pack", "device_put", "solve")}
    decode = [e for e in telemetry.default_registry().recent_spans()
              if e["name"] == "driver.decode"]
    split["decode"] = decode[-1]["dur_s"] * 1e3 if decode else None
    return split


def _split_text(split: dict) -> str:
    dec = split["decode"]
    return (f"encode {split['encode']:.3f} ms (in the call; 0 for "
            f"Solver), pad_pack {split['pad_pack']:.3f} ms, device_put "
            f"{split['device_put']:.3f} ms, solve {split['solve']:.3f} ms "
            f"(the driver call), decode "
            f"{'not spanned' if dec is None else f'{dec:.3f} ms'}")


TELEMETRY_SPANS = ("driver.pad_pack", "driver.device_put", "driver.solve",
                   "driver.decode")


def check_telemetry_sink(scale: float) -> dict:
    """One card batch with ``DEPPY_GPU_TELEMETRY_FILE`` set: the JSONL it
    writes must hold the four driver spans and exactly one report
    event.  The batch runs on a registry of its own, which the run's
    faults gates never read, so its driver failures and host-routed
    lanes are gated here: both must be 0, in the registry and in the
    batch's report."""
    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.resolution import BatchResolver

    path = os.path.join("build", "telemetry", "sink.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    name, count, make = families(scale)[0]
    pool = [make(i) for i in range(COMPARE_LANES)]
    os.environ["DEPPY_GPU_TELEMETRY_FILE"] = path
    prev = telemetry.set_default_registry(None)
    try:
        resolver = BatchResolver(device="cuda")
        resolver.solve(pool)
        telemetry.default_registry().configure_sink(None)
        snap = _fault_snapshot()
    finally:
        telemetry.set_default_registry(prev)
        del os.environ["DEPPY_GPU_TELEMETRY_FILE"]
    if (snap["deppy_fault_failures_total"]
            or snap["deppy_fault_host_routed_total"]
            or resolver.last_report.fault_host_routed):
        fail(f"telemetry sink: the card batch counted "
             f"{snap['deppy_fault_failures_total']} driver failures and "
             f"{snap['deppy_fault_host_routed_total']} host-routed lanes "
             f"(report: {resolver.last_report.fault_host_routed})")
    events = [e for e in telemetry.iter_sink_events(path) if e is not None]
    names = {e.get("name") for e in events if e.get("kind") == "span"}
    reports = [e["report"] for e in events if e.get("kind") == "report"]
    missing = [s for s in TELEMETRY_SPANS if s not in names]
    faulted = [e for e in events if e.get("kind") == "fault"]
    if faulted:
        fail(f"telemetry sink: {len(faulted)} fault events in the card "
             f"batch, the first {faulted[0]}")
    if missing or len(reports) != 1:
        fail(f"telemetry sink: spans missing {missing}, {len(reports)} "
             f"report events")
    if reports[0] != resolver.last_report.to_dict():
        fail("telemetry sink: the report event is not the batch's report")
    print(f"telemetry sink ({path}): {len(events)} events, spans "
          f"{sorted(names)}, one report event of {reports[0]['n_problems']} "
          f"problems", flush=True)
    return dict(events=len(events), spans=sorted(names))


# The sched path: the port's request scheduler (deppy_tpu_torch.sched)
# serving concurrent clients on the card at the families' real widths;
# only the request counts are cut, so that the phase stays near a minute.
SCHED_CLIENTS = 32
SCHED_FLEET = (128, 16)   # part A: requests x gvk_fleet states each
SCHED_TENANTS = (32, 8)   # part B: requests x pinned_tenant states each
SCHED_REPEATS = 32        # part D: the first of A's requests again
SCHED_DEADLINES = (4, 8)  # part E: expired (and as many live) requests x states
SCHED_BATCH = (8, 8)      # part F: clients x operatorhub_catalog(250, 8)
SCHED_CACHE = 4096        # A's repeats (part D) are not evicted
SCHED_LOOP = "deppy-sched"
# The sched and race phases measure cold batching and hold each answer's
# steps against an unscheduled (or unraced) solve, so their schedulers
# run with the incremental tier off: on by default, it would serve some
# lanes warm, with the host engine's step counts.  The incremental phase
# measures the tier.


def _pct(vals, q: float) -> float:
    """The ``q``-quantile of ``vals`` (nearest rank)."""
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q * len(s) + 0.5)) - 1))]


def distinct_tenant_states(n: int):
    """The first ``n`` pinned_tenant states in seed order whose encoded
    problems differ (by fingerprint): a repeat inside part B's burst
    would be served from the cache with 0 steps, which part D tests on
    its own."""
    from deppy_tpu_torch.models import pinned_tenant_catalog
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import fingerprint

    out, seen, seed = [], set(), 0
    while len(out) < n:
        vs = pinned_tenant_catalog(seed=seed)
        key = fingerprint(encode(vs))
        if key not in seen:
            seen.add(key)
            out.append(vs)
        seed += 1
    return out


class DispatchLog:
    """While on, every ``driver.solve_problems`` call: the thread that
    made it, its problems' fingerprints (one per lane), its wall and the
    kernel launches counted while it ran."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import threading

        from deppy_tpu_torch import engine
        from deppy_tpu_torch.engine import driver
        from deppy_tpu_torch.sched import fingerprint

        self._solve = driver.solve_problems

        def solve_problems(problems, *args, **kwargs):
            before = engine.launch_counts()
            t0 = time.perf_counter()
            out = self._solve(problems, *args, **kwargs)
            wall = time.perf_counter() - t0
            after = engine.launch_counts()
            self.calls.append(dict(
                thread=threading.current_thread().name,
                keys=[fingerprint(p) for p in problems],
                wall_s=wall,
                launches={k: after[k] - before[k] for k in after}))
            return out

        driver.solve_problems = solve_problems
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.engine import driver

        driver.solve_problems = self._solve


def burst_jobs(scale: float):
    """The ``sched`` phase's burst A+B as (label, request) jobs: 128
    requests of 16 ``gvk_conflict_catalog(20, 4, 10)`` states, with 32 of
    8 distinct ``pinned_tenant_catalog`` states in flight among them
    (every fifth job)."""
    from deppy_tpu_torch.models import gvk_conflict_catalog

    n_fleet = max(8, int(SCHED_FLEET[0] * scale))
    n_tenant = max(4, int(SCHED_TENANTS[0] * scale))
    fleet = [("A", [gvk_conflict_catalog(20, 4, 10, seed=SCHED_FLEET[1] * i + j)
                    for j in range(SCHED_FLEET[1])]) for i in range(n_fleet)]
    states = distinct_tenant_states(n_tenant * SCHED_TENANTS[1])
    tenants = [("B", states[SCHED_TENANTS[1] * i:SCHED_TENANTS[1] * (i + 1)])
               for i in range(n_tenant)]
    jobs = list(fleet)
    for i, job in enumerate(tenants):
        jobs.insert(min(len(jobs), 5 * i + 3), job)
    return jobs


def run_clients(clients: int, jobs, submit):
    """``jobs`` (label, request) shared round-robin among ``clients``
    threads, each running its jobs in turn, all released at once.
    ``submit(request, stats)`` returns the answers.  Returns the wall
    from release to the last answer and, per job, a dict with its
    answers (or the error raised), stats and latency."""
    import threading

    records = [None] * len(jobs)
    gate = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        gate.wait()
        for k in range(c, len(jobs), clients):
            st: dict = {}
            t0 = time.perf_counter()
            try:
                out = submit(jobs[k][1], st)
            except BaseException as e:  # noqa: BLE001 — reported below
                out = e
            records[k] = dict(answers=out, stats=st,
                              latency_s=time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("sched: a client thread never returned")
    for (label, _), rec in zip(jobs, records):
        if isinstance(rec["answers"], BaseException):
            raise RuntimeError(f"chip_smoke: sched {label} raised") \
                from rec["answers"]
    return wall, records


def unscheduled(jobs):
    """Each job's request through ``BatchResolver(device="cuda").solve``,
    one call each: (answers rendered, steps, wall) per job."""
    import torch

    from deppy_tpu_torch.resolution import BatchResolver

    out = []
    for _, request in jobs:
        resolver = BatchResolver(device="cuda")
        t0 = time.perf_counter()
        answers = resolver.solve(request)
        torch.cuda.synchronize()
        out.append(([render(r) for r in answers], resolver.last_steps,
                    time.perf_counter() - t0))
    return out


def sched_mismatches(name: str, records, want) -> int:
    """Requests whose scheduled answers or steps differ from the
    unscheduled solve's."""
    bad = 0
    for rec, (answers, steps, _) in zip(records, want):
        got = [render(r) for r in rec["answers"]]
        if got != answers or rec["stats"]["steps"] != steps:
            bad += 1
    print(f"sched {name}: {len(records)} requests, mismatches {bad} "
          f"against the unscheduled solves", flush=True)
    if bad:
        fail(f"sched {name}: {bad} requests differ from the unscheduled "
             f"solve of the same request")
    return bad


def sched_split(stats: dict) -> dict:
    """The driver split of the dispatch that served a request: its
    report's walls and the scheduler's decode time."""
    rep = stats["report"]
    if rep is None:
        fail("sched: a dispatched request carries no SolveReport")
    split = {k: rep.wall.get(k, 0.0) * 1e3
             for k in ("encode", "pad_pack", "device_put", "solve")}
    split["decode"] = stats["timings"].get("decode_s", 0.0) * 1e3
    return split


def part_numbers(name: str, records, calls, keys: set) -> dict:
    """Print and return one part's requests, dispatches, lanes per
    dispatch, latency percentiles, queue-wait share and driver split."""
    mine = [c for c in calls if keys & set(c["keys"])]
    lanes = [len(c["keys"]) for c in mine]
    lat = [r["latency_s"] for r in records]
    waits = [r["stats"]["timings"].get("queue_wait_s", 0.0)
             for r in records]
    share = sum(waits) / sum(lat)
    split = sched_split(records[0]["stats"])
    row = dict(requests=len(records), dispatches=len(mine),
               lanes_per_dispatch=lanes,
               p50_ms=_pct(lat, 0.5) * 1e3, p99_ms=_pct(lat, 0.99) * 1e3,
               queue_wait_share=share,
               queue_wait_share_median=statistics.median(
                   w / t for w, t in zip(waits, lat)),
               split_ms=split)
    print(f"sched {name}: {len(records)} requests in {len(mine)} "
          f"dispatches, lanes per dispatch {lanes}; latency p50 "
          f"{row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms; queue wait "
          f"{share:.4f} of the latency (median per request "
          f"{row['queue_wait_share_median']:.4f})", flush=True)
    print(f"driver split sched {name} (its first request's dispatch): "
          f"{_split_text(split)}", flush=True)
    return row


def _loop_only(label: str, calls, counts: dict) -> None:
    """Every dispatch since the counts were reset came from the
    dispatch-loop thread, and every launch since then was counted while
    one of those dispatches ran (the launches of the window equal the
    sum of the dispatches' own)."""
    others = sorted({c["thread"] for c in calls} - {SCHED_LOOP})
    if others:
        fail(f"sched {label}: dispatches on threads {others}")
    inside = {k: sum(c["launches"][k] for c in calls) for k in counts}
    if inside != counts:
        fail(f"sched {label}: {counts} launched, {inside} of them inside "
             f"the loop's dispatches")


def run_sched_path(scale: float):
    """The port's request scheduler on the card (parts A-F of the
    module docstring); every answer and step count is held against the
    unscheduled port on the card, one ``BatchResolver(device="cuda")
    .solve`` per request.  Returns the path's launches and numbers."""
    import torch

    from deppy_tpu_torch import engine, telemetry
    from deppy_tpu_torch.engine import core
    from deppy_tpu_torch.models import gvk_conflict_catalog, operatorhub_catalog
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat import Incomplete
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import Scheduler, fingerprint

    print(f"sched timings on {card_line()}", flush=True)
    n_fleet = max(8, int(SCHED_FLEET[0] * scale))
    n_tenant = max(4, int(SCHED_TENANTS[0] * scale))
    fleet = [("A", [gvk_conflict_catalog(20, 4, 10, seed=SCHED_FLEET[1] * i + j)
                    for j in range(SCHED_FLEET[1])]) for i in range(n_fleet)]
    states = distinct_tenant_states(n_tenant * SCHED_TENANTS[1])
    tenants = [("B", states[SCHED_TENANTS[1] * i:SCHED_TENANTS[1] * (i + 1)])
               for i in range(n_tenant)]
    big = [("C", [operatorhub_catalog(*BATCH, seed=0)])]
    # C's and B's requests in flight among A's: every fifth job, C first.
    jobs = list(fleet)
    for i, job in enumerate(big + tenants):
        jobs.insert(min(len(jobs), 5 * i + 3), job)
    keys = {p: {fingerprint(encode(vs)) for lab, req in jobs if lab == p
                for vs in req} for p in "ABC"}
    launches = {k: 0 for k in engine.KERNELS}
    numbers = {}
    work0 = _plain_work()

    def scheduled(label, sched, clients, jobs, submit):
        torch.cuda.synchronize()
        engine.reset_launch_counts()
        with DispatchLog() as log:
            wall, records = run_clients(clients, jobs, submit)
        torch.cuda.synchronize()
        counts = engine.launch_counts()
        _loop_only(label, log.calls, counts)
        for k in launches:
            launches[k] += counts[k]
        print(f"sched {label}: {len(jobs)} requests from {clients} clients "
              f"in {wall:.3f} s; launches {counts} (all from the dispatch "
              f"loop)", flush=True)
        return wall, records, log.calls, counts

    def submit_to(sched):
        return lambda request, st: sched.submit(request, stats=st)

    # Parts A, B and C: one burst through one scheduler.
    reg = telemetry.Registry()
    sched = Scheduler(cache_size=SCHED_CACHE, registry=reg,
                      incremental="off")
    sched.start()
    try:
        wall, records, calls, counts = scheduled(
            "A+B+C", sched, SCHED_CLIENTS, jobs, submit_to(sched))
        missing = [k for k in ("bcp_fixpoint", "search", "minimize", "core")
                   if counts[k] <= 0]
        if missing:
            fail(f"sched A+B+C: {missing} never launched")
        snap = reg.snapshot()
        flushes = snap["deppy_sched_flushes_total"]
        print(f"sched A+B+C: {snap['deppy_sched_dispatches_total']} "
              f"dispatches for {len(jobs)} requests, flushes {flushes}, "
              f"cache misses {snap['deppy_cache_misses_total']} hits "
              f"{snap.get('deppy_cache_hits_total', 0)}", flush=True)
        for c in calls:
            parts = {p for p in "ABC" if keys[p] & set(c["keys"])}
            if len(parts) != 1:
                fail(f"sched: one dispatch mixed the size classes of {parts}")
        by_part = {p: [r for (lab, _), r in zip(jobs, records) if lab == p]
                   for p in "ABC"}
        want = unscheduled(jobs)
        plain_wall = sum(w for _, _, w in want)
        wants = {p: [w for (lab, _), w in zip(jobs, want) if lab == p]
                 for p in "ABC"}
        names = {"A": "A gvk_fleet", "B": "B pinned_tenant",
                 "C": "C operatorhub_catalog(250, 8)"}
        for p in "ABC":
            sched_mismatches(names[p], by_part[p], wants[p])
            numbers[p] = part_numbers(names[p], by_part[p], calls, keys[p])
        if numbers["A"]["dispatches"] >= len(by_part["A"]):
            fail(f"sched A: {numbers['A']['dispatches']} dispatches for "
                 f"{len(by_part['A'])} requests: nothing coalesced")
        if numbers["C"]["lanes_per_dispatch"] != [1]:
            fail(f"sched C: lanes per dispatch "
                 f"{numbers['C']['lanes_per_dispatch']}, not one of its own")
        if counts["core"] <= 0:
            fail("sched B: the core kernel was not launched")
        print(f"sched A+B+C: scheduled wall {wall:.3f} s against "
              f"{plain_wall:.3f} s for the {len(jobs)} unscheduled calls "
              f"one by one (ratio {wall / plain_wall:.4f})", flush=True)
        numbers["ABC"] = dict(wall_s=wall, unscheduled_wall_s=plain_wall,
                              dispatches=snap["deppy_sched_dispatches_total"],
                              flushes=flushes, launches=counts)

        # Part D: repeats of A's requests through BatchResolver: every
        # one a cache hit, no dispatch, 0 steps.
        repeats = fleet[:min(SCHED_REPEATS, len(fleet))]
        before = reg.snapshot()["deppy_sched_dispatches_total"]

        def resolve(request, st):
            resolver = BatchResolver(scheduler=sched)
            out = resolver.solve(request)
            st.update(steps=resolver.last_steps,
                      report=resolver.last_report)
            return out

        wall_d, rec_d, _, counts_d = scheduled(
            "D repeats", sched, SCHED_CLIENTS, repeats, resolve)
        after = reg.snapshot()["deppy_sched_dispatches_total"]
        bad = sum(r["stats"]["steps"] != 0 or r["stats"]["report"] is not None
                  or [render(a) for a in r["answers"]] != w[0]
                  for r, w in zip(rec_d, wants["A"]))
        if after != before or any(counts_d.values()) or bad:
            fail(f"sched D: {after - before} new dispatches, launches "
                 f"{counts_d}, {bad} requests not served from the cache")
        lat = [r["latency_s"] for r in rec_d]
        print(f"sched D repeats: {len(rec_d)} requests, 0 new dispatches, "
              f"last_steps 0 on each, answers equal to A's; latency p50 "
              f"{_pct(lat, 0.5) * 1e3:.3f} ms p99 {_pct(lat, 0.99) * 1e3:.3f} "
              f"ms", flush=True)
        numbers["D"] = dict(requests=len(rec_d), wall_s=wall_d,
                            p50_ms=_pct(lat, 0.5) * 1e3,
                            p99_ms=_pct(lat, 0.99) * 1e3)
    finally:
        sched.stop()

    # Part E: expired lanes beside live batchmates, on a second
    # scheduler; the expired requests queue first, the live ones join
    # them inside the 50 ms window.
    n_dead, width = SCHED_DEADLINES
    e_jobs = [("E", [vs for vs in req[:width]])
              for _, req in fleet[:2 * n_dead]]
    reg_e = telemetry.Registry()
    sched_e = Scheduler(max_wait_ms=50, cache_size=0, registry=reg_e,
                        incremental="off")
    missed0 = telemetry.default_registry().snapshot().get(
        "deppy_deadline_exceeded", 0)
    sched_e.start()
    try:
        import threading

        dead_in = threading.Event()

        def submit_e(request, st):
            live = any(request is req for _, req in e_jobs[n_dead:])
            if live:
                dead_in.wait(30)
            return sched_e.submit(request, stats=st,
                                  deadline_s=None if live else 0.001)

        def watch():
            t_end = time.monotonic() + 30
            while (sched_e.queue_depth() < n_dead * width
                   and time.monotonic() < t_end):
                time.sleep(0.0005)
            dead_in.set()

        threading.Thread(target=watch, daemon=True).start()
        wall_e, rec_e, calls_e, counts_e = scheduled(
            "E deadlines", sched_e, len(e_jobs), e_jobs, submit_e)
    finally:
        sched_e.stop()
    missed = telemetry.default_registry().snapshot().get(
        "deppy_deadline_exceeded", 0) - missed0
    want_e = unscheduled(e_jobs[n_dead:])
    for r in rec_e[:n_dead]:
        if (not all(isinstance(a, Incomplete) for a in r["answers"])
                or r["stats"]["deadline_misses"] != width
                or r["stats"]["steps"] != 0):
            fail(f"sched E: an expired request came back "
                 f"{[render(a)[0] for a in r['answers']]}, deadline misses "
                 f"{r['stats']['deadline_misses']}")
    sched_mismatches("E live batchmates", rec_e[n_dead:], want_e)
    if missed < n_dead:
        fail(f"sched E: deppy_deadline_exceeded moved by {missed}")
    print(f"sched E deadlines: {n_dead} expired requests ({n_dead * width} "
          f"lanes Incomplete, degraded) among {len(e_jobs) - n_dead} live "
          f"ones in {len(calls_e)} dispatches "
          f"({reg_e.snapshot()['deppy_sched_flushes_total']}); "
          f"deppy_deadline_exceeded +{missed}", flush=True)
    numbers["E"] = dict(requests=len(e_jobs), dispatches=len(calls_e),
                        deadline_exceeded=missed, launches=counts_e)

    # Part F: the blockwise impl through a scheduler, after the others
    # drained (the impl is process-wide).
    n_clients, width = SCHED_BATCH
    f_jobs = [("F", [operatorhub_catalog(*BATCH, seed=width * i + j)
                     for j in range(width)]) for i in range(n_clients)]
    core.set_bcp_impl("blockwise")
    try:
        sched_f = Scheduler(registry=telemetry.Registry(),
                            incremental="off")
        sched_f.start()
        try:
            wall_f, rec_f, calls_f, counts_f = scheduled(
                "F blockwise", sched_f, n_clients, f_jobs,
                submit_to(sched_f))
        finally:
            sched_f.stop()
        want_f = unscheduled(f_jobs)
    finally:
        core.set_bcp_impl("auto")
    if counts_f["blockwise_fixpoint"] <= 0:
        fail("sched F: the blockwise kernel was not launched")
    sched_mismatches("F blockwise", rec_f, want_f)
    numbers["F"] = part_numbers("F blockwise", rec_f, calls_f,
                                {fingerprint(encode(vs))
                                 for _, req in f_jobs for vs in req})
    numbers["F"].update(wall_s=wall_f, launches=counts_f,
                        unscheduled_wall_s=sum(w for _, _, w in want_f))
    print(f"sched F blockwise: scheduled wall {wall_f:.3f} s against "
          f"{numbers['F']['unscheduled_wall_s']:.3f} s unscheduled; "
          f"launches {counts_f}", flush=True)

    if _plain_work() != work0:
        fail("sched path: a plain version ran during a card solve")
    print(f"sched path launches (all from the dispatch loop): {launches}",
          flush=True)
    return launches, numbers


RACE_LANES = 8             # part 1: hard.py's lanes per depth (192/384/768)
RACE_THREAD = "deppy-race-device"
RACE_COMPARE_LANES = 8     # lanes of each race-thread launch held against plain
RACE_STRAGGLERS = (4, 8)   # part 5: tight-deadline (and as many live) requests x states
RACE_POOL_STATES = 1000    # part 4: the bits path's pinned_tenant states
RACE_GRAD_CHAINS = 1000    # part 6: version_pinned_chains(20, 3)
RACE_COST_DEPTHS = {"m": 192, "l": 768}   # part 7: chain depth per class
RACE_COST_CALLS = 5        # part 7: timed calls per backend and class (median)
RACE_COST_CALLS_HOST_M = 3  # the host engine's m calls take seconds each
# The descents' logits on the card and the CPU agree within this, and
# their rounding agrees wherever |sigmoid(x) - 0.5| passes the margin
# (the CPU tests' tolerances against JAX).
GRAD_ATOL = 1e-4
GRAD_MARGIN = 1e-3
# The race-thread launches compared with their plain versions: the
# wrapper module and function of each kernel.
RACE_WRAPPERS = {"bcp_fixpoint": ("cuda_bcp", "bcp_fixpoint"),
                 "blockwise_fixpoint": ("cuda_blockwise", "bcp_fixpoint"),
                 "search": ("cuda_search", "batched_search_fused"),
                 "minimize": ("cuda_search", "batched_minimize_fused"),
                 "core": ("cuda_search", "batched_core_fused")}


class ThreadLaunches:
    """While on, every kernel launch the wrappers count
    (``engine.counts.count``), by the thread that made it."""

    def __init__(self):
        import collections

        self.by_thread = collections.Counter()

    def __enter__(self):
        import threading

        from deppy_tpu_torch.engine import counts

        self._count = counts.count
        lock = threading.Lock()

        def count(kernel, *args, **kwargs):
            self._count(kernel, *args, **kwargs)
            with lock:
                self.by_thread[threading.current_thread().name, kernel] += 1

        counts.count = count
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.engine import counts

        counts.count = self._count

    def threads(self) -> dict:
        """{thread: {kernel: launches}}."""
        out: dict = {}
        for (thread, kernel), n in sorted(self.by_thread.items()):
            out.setdefault(thread, {})[kernel] = n
        return out


class RaceCapture:
    """While on, the first launch of each of ``kernels`` made on the thread
    named ``thread`` (the race's device thread unless given): the wrapper's
    inputs and outputs, cloned (compact rows dropped: the plain versions
    read the planes)."""

    def __init__(self, kernels, thread: str = RACE_THREAD):
        self.kernels = tuple(kernels)
        self.thread = thread
        self.calls = {}

    def __enter__(self):
        import importlib
        import threading

        import torch

        from deppy_tpu_torch.engine import core

        def clone(x):
            if isinstance(x, core.ProblemTensors):
                return core.ProblemTensors(*[f.clone() for f in x])
            return x.clone() if isinstance(x, torch.Tensor) else x

        lock = threading.Lock()
        self._saved = []
        for kernel in self.kernels:
            mod_name, fn_name = RACE_WRAPPERS[kernel]
            mod = importlib.import_module(f"deppy_tpu_torch.engine.{mod_name}")
            orig = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, orig))

            def wrapped(*args, _k=kernel, _orig=orig, **kwargs):
                mine = (_k not in self.calls
                        and threading.current_thread().name == self.thread)
                if mine:
                    ins = ([clone(a) for a in args],
                           {k: (None if k == "rows" else clone(v))
                            for k, v in kwargs.items()})
                out = _orig(*args, **kwargs)
                if mine:
                    with lock:
                        if _k not in self.calls:
                            self.calls[_k] = (ins, [o.clone() for o in out])
                return out

            setattr(mod, fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self._saved:
            setattr(mod, fn_name, orig)

    def submit(self, plain: "PlainPool", family: str,
               need=None) -> None:
        """Hold the first :data:`RACE_COMPARE_LANES` lanes of each captured
        launch against its plain version (the same wrapper on CPU copies,
        in the pool); fails when a kernel of ``need`` (every kernel unless
        given) was never captured."""
        missing = [k for k in (self.kernels if need is None else need)
                   if k not in self.calls]
        if missing:
            fail(f"{family}: no launch of {missing} on {self.thread} was "
                 f"seen")
        for kernel, ((args, kwargs), out) in sorted(self.calls.items()):
            n = min(RACE_COMPARE_LANES, out[0].shape[0])
            mod_name, fn_name = RACE_WRAPPERS[kernel]
            plain.submit((kernel, family, f"{n} lanes of a {self.thread} "
                          f"launch ({out[0].shape[0]} lanes)"),
                         [o[:n] for o in out], mod_name, fn_name,
                         [_lanes(a, 0, n) for a in args],
                         {k: _lanes(v, 0, n) for k, v in kwargs.items()}, n)


class RaceEvents:
    """While on, the ``race`` and ``fault`` events of the default
    registry."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from deppy_tpu_torch import telemetry

        self._reg = telemetry.default_registry()
        self._fn = lambda e: (self.events.append(e)
                              if e.get("kind") in ("race", "fault") else None)
        self._reg.add_forwarder(self._fn)
        return self

    def __exit__(self, *exc):
        self._reg.remove_forwarder(self._fn)

    def races(self):
        return [e for e in self.events
                if e["kind"] == "race" and "winner" in e]


def race_numbers(label: str, reg, events, card: str) -> dict:
    """Wins per backend, the race spans' walls, the win margins, cancels
    and sampled checks of one part; fails on a ``race_mismatch``."""
    snap = reg.snapshot()
    spans = [s["dur_s"] for s in reg.recent_spans() if s["name"] == "race"]
    margins = [e["win_margin_s"] for e in events.races()
               if e.get("win_margin_s") is not None]
    checks = [e["checked"] for e in events.races() if e.get("checked")]
    mismatches = snap.get("deppy_race_check_mismatch_total", 0) + sum(
        1 for e in events.events if e.get("fault") == "race_mismatch")
    by_class: dict = {}
    for e in events.races():
        cls = by_class.setdefault(e["size_class_name"], {})
        cls[e["winner"]] = cls.get(e["winner"], 0) + 1
    row = dict(races=len(spans), wins=snap.get("deppy_race_wins_total", {}),
               wins_by_class=by_class,
               cancels=snap.get("deppy_race_cancels_total", {}),
               race_wall_s=sum(spans),
               race_wall_p50_ms=_pct(spans, 0.5) * 1e3 if spans else None,
               race_wall_max_ms=max(spans) * 1e3 if spans else None,
               win_margin_min_ms=min(margins) * 1e3 if margins else None,
               win_margin_p50_ms=_pct(margins, 0.5) * 1e3 if margins
               else None, checks=checks, race_mismatch=mismatches)
    print(f"race {label}: {row['races']} races, wins {row['wins']} (by "
          f"class {by_class}), cancels {row['cancels']}, race span wall "
          f"{row['race_wall_s']:.4f} "
          f"s (p50 {row['race_wall_p50_ms']} ms, max "
          f"{row['race_wall_max_ms']} ms), win margin min "
          f"{row['win_margin_min_ms']} ms p50 {row['win_margin_p50_ms']} "
          f"ms, sampled checks {checks}, race_mismatch {mismatches} "
          f"[{card}]", flush=True)
    if mismatches:
        fail(f"race {label}: {mismatches} race_mismatch")
    return row


def _entrant_failures(label: str, reg, events: "RaceEvents") -> None:
    """Fails when any race entrant raised: a device entrant's error also
    fails its dispatch (or the next), but one that lands after the last
    race of a part is only counted and evented."""
    errors = reg.snapshot().get("deppy_race_entrant_errors_total") or {}
    if errors:
        said = [e.get("error") for e in events.events
                if e.get("fault") == "race_entrant_error"]
        fail(f"race {label}: race entrants raised: {errors} {said[:3]}")


def _device_entrants(reg) -> int:
    return (reg.snapshot().get("deppy_race_starts_total") or {}).get(
        "device", 0)


def _race_threads_only(label: str, launches: ThreadLaunches,
                       counts: dict) -> dict:
    """Every launch of the window came from the race's device thread (a
    loser's included); returns the launches by thread."""
    threads = launches.threads()
    others = sorted(set(threads) - {RACE_THREAD})
    if others:
        fail(f"race {label}: launches from threads {others}: {threads}")
    mine = threads.get(RACE_THREAD, {})
    if {k: mine.get(k, 0) for k in counts} != counts:
        fail(f"race {label}: {counts} launched, {mine} of them on "
             f"{RACE_THREAD}")
    return threads


def race_costs(card: str) -> dict:
    """Per-lane µs of the device, host and hostpool backends on batches of
    each size class the phase reaches (the registry's ``cost_us``): xs 64
    distinct pinned_tenant states, s 64 gvk_fleet states, m 8 chains of
    depth 192, l 8 of depth 768 (the device only: the host engine takes
    tens of seconds a lane there).  Each cost is the median of
    :data:`RACE_COST_CALLS` timed calls (:data:`RACE_COST_CALLS_HOST_M`
    for the host engine on m) after one untimed call on the same batch
    (the device's first call on a shape allocates; the pool's starts its
    workers); the calls' spread is printed beside it."""
    import torch

    from deppy_tpu_torch import hostpool
    from deppy_tpu_torch.engine import driver
    from deppy_tpu_torch.models import chain_requests, gvk_conflict_catalog
    from deppy_tpu_torch.sat.encode import encode

    sets = {"xs": ("pinned_tenant", distinct_tenant_states(64), True),
            "s": ("gvk_fleet", [gvk_conflict_catalog(20, 4, 10, seed=s)
                                for s in range(64)], True)}
    for cls, depth in RACE_COST_DEPTHS.items():
        sets[cls] = (f"chain({depth})", chain_requests((depth,), 8),
                     cls != "l")
    out = {}
    for cls, (name, vss, host_too) in sets.items():
        problems = [encode(vs) for vs in vss]
        got = driver.padded_class(problems)
        if got != cls:
            fail(f"race cost: {name} is class {got}, not {cls}")
        walls, spread = {}, {}
        runs = [("device", lambda: driver.solve_problems(problems,
                                                         device="cuda"))]
        if host_too:
            runs += [("host", lambda: hostpool.solve_inline(problems)),
                     ("hostpool",
                      lambda: hostpool.solve_host_problems(problems))]
        for backend, fn in runs:
            fn()
            calls = (RACE_COST_CALLS_HOST_M if (backend, cls) == ("host", "m")
                     else RACE_COST_CALLS)
            samples = []
            for _ in range(calls):
                if backend == "device":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) / len(problems)
                               * 1e6)
            walls[backend] = statistics.median(samples)
            spread[backend] = (min(samples), max(samples), calls)
        out[cls] = dict(family=name, lanes=len(problems), us=walls,
                        spread=spread)
        print(f"race cost {cls} ({name}, {len(problems)} lanes): " + ", ".join(
            f"{b} {us:.1f} us/lane (median of {spread[b][2]}, "
            f"{spread[b][0]:.1f}-{spread[b][1]:.1f})"
            for b, us in walls.items()) + f" [{card}]", flush=True)
    return out


def run_race_path(scale: float, plain: "PlainPool"):
    """Portfolio racing on the card (ROADMAP A5.2, A5.3, A9): racing
    ``Scheduler``s whose device entrants launch every kernel from their
    race threads.  Parts:

    1. ``chain_requests`` (192/384/768 x 8 lanes, ``deppy_tpu/benchmarks/
       hard.py:46-63``) through ``Scheduler(portfolio="on", portfolio_k=3,
       portfolio_sample_check=1.0, cache_size=0)``: device, host and
       grad_relax race; then with ``portfolio="off"``.  Every answer
       equal to the unraced device's; then the same under
       ``set_bcp_impl("blockwise")``, top-2 (kernel 2 from a race thread);
    2. the ``sched`` phase's burst (128 requests x 16 ``gvk_fleet`` states
       and 32 x 8 distinct ``pinned_tenant`` states from 32 clients)
       unraced, then raced top-2 (device, host): wins, the two walls, the
       device entrants' launches by thread, answers equal;
    3. ``portfolio="auto"``: the gvk burst with a temporary
       ``DEPPY_GPU_MEASURED_DEFAULTS`` row ``{"gpu": {"portfolio.s":
       "device,host"}}`` races; with none it does not (0 race spans) and
       its answers and steps equal part 2's unraced ones;
    4. ``hostpool.solve_host_problems`` against ``solve_inline`` on the
       1,000 ``pinned_tenant`` states (lane keys identical), then once
       under a ``hostpool.worker_crash`` fault plan;
    5. straggler triage: requests whose deadline is under the device
       estimate go to the pool, their batchmates to the device entrant;
    6. ``grad_relax.candidate_logits`` twice on the card (bit-equal) and on
       the CPU (within :data:`GRAD_ATOL`, rounding equal past
       :data:`GRAD_MARGIN`) on the deep chains and 1,000
       ``version_pinned_chains(20, 3)``, and its certified lanes;
    7. the per-class costs of :func:`race_costs`.

    Each kernel's first race-thread launch (parts 1b and 2) is held
    against its plain version in ``plain``'s pool.  Returns the launches
    of the race windows (losers' included) and the numbers."""
    import tempfile

    import torch

    from deppy_tpu_torch import engine, faults, hostpool, telemetry
    from deppy_tpu_torch.engine import core, defaults, grad_relax, registry
    from deppy_tpu_torch.models import (chain_requests, pinned_tenant_catalog,
                                        version_pinned_chains)
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import Scheduler, fingerprint
    from deppy_tpu_torch.sched import scheduler as sched_mod

    card = card_line()
    print(f"race timings on {card}; host pool workers "
          f"{hostpool.effective_workers()}", flush=True)
    launches = {k: 0 for k in engine.KERNELS}
    numbers = {}
    work0 = _plain_work()

    def raced(label, sched, clients, jobs, reg, capture=None):
        """Run ``jobs`` through a started ``sched``; (wall, records,
        launches by thread, numbers)."""
        torch.cuda.synchronize()
        sched_mod._join_race_threads()
        engine.reset_launch_counts()
        with ThreadLaunches() as tl, \
                RaceEvents() as ev, DispatchLog() as dl, \
                (capture or contextlib.nullcontext()):
            wall, records = run_clients(clients, jobs, lambda r, st:
                                        sched.submit(r, stats=st))
            # Losers run on after their race is decided: wait for them so
            # every launch of the window is counted.
            sched_mod._join_race_threads()
            torch.cuda.synchronize()
        counts = engine.launch_counts()
        _entrant_failures(label, reg, ev)
        threads = _race_threads_only(label, tl, counts)
        for k in launches:
            launches[k] += counts[k]
        row = race_numbers(label, reg, ev, card)
        row.update(wall_s=wall, launches_by_thread=threads,
                   device_entrants=_device_entrants(reg),
                   device_calls=len(dl.calls))
        print(f"race {label}: {len(jobs)} requests from {clients} clients in "
              f"{wall:.3f} s; {row['device_entrants']} device entrants for "
              f"{row['races']} races; launches by thread {threads} "
              f"[{card}]", flush=True)
        return wall, records, dl.calls, row

    def unraced(label, jobs, clients, **kw):
        sched = Scheduler(portfolio="off", cache_size=0,
                          registry=telemetry.Registry(), incremental="off",
                          **kw)
        sched.start()
        try:
            torch.cuda.synchronize()
            wall, records = run_clients(clients, jobs, lambda r, st:
                                        sched.submit(r, stats=st))
        finally:
            sched.stop()
        print(f"race {label} unraced: {len(jobs)} requests from {clients} "
              f"clients in {wall:.3f} s [{card}]", flush=True)
        return wall, records

    def same(label, records, want, steps=True) -> int:
        bad = 0
        for rec, w in zip(records, want):
            if [render(r) for r in rec["answers"]] != \
                    [render(r) for r in w["answers"]] or (
                    steps and rec["stats"]["steps"] != w["stats"]["steps"]):
                bad += 1
        print(f"race {label}: {len(records)} requests, mismatches {bad} "
              f"against the unraced answers{' and steps' if steps else ''}",
              flush=True)
        if bad:
            fail(f"race {label}: {bad} requests differ from the unraced "
                 f"scheduler's")
        return bad

    # Part 1: the deep chains, top-3, every non-canonical win checked.
    depths = (192, 384, 768)
    chains = [("chains", chain_requests(depths, RACE_LANES))]
    for impl, k in (("bits", 3), ("blockwise", 2)):
        core.set_bcp_impl("auto" if impl == "bits" else impl)
        try:
            wall_off, off = unraced(f"1 chains ({impl})", chains, 1)
            reg = telemetry.Registry()
            sched = Scheduler(portfolio="on", portfolio_k=k,
                              portfolio_sample_check=1.0, cache_size=0,
                              registry=reg, incremental="off")
            sched.start()
            try:
                cap = (RaceCapture(["blockwise_fixpoint"])
                       if impl == "blockwise" else None)
                wall, rec, _, row = raced(f"1 chains ({impl}, top-{k})",
                                          sched, 1, chains, reg, cap)
            finally:
                sched.stop()
            if cap is not None:
                cap.submit(plain, "chains (blockwise race)")
        finally:
            core.set_bcp_impl("auto")
        same(f"1 chains ({impl})", rec, off,
             steps=set(row["wins"]) == {"device"})
        if row["races"] != 1:
            fail(f"race 1 chains ({impl}): {row['races']} races, not 1")
        row.update(unraced_wall_s=wall_off)
        numbers[f"chains_{impl}"] = row

    # Part 2: the sched phase's burst, unraced then raced top-2.
    jobs = burst_jobs(scale)
    fleet = [job for job in jobs if job[0] == "A"]
    wall_off, off = unraced("2 burst", jobs, SCHED_CLIENTS)
    reg = telemetry.Registry()
    sched = Scheduler(portfolio="on", portfolio_k=2, cache_size=0,
                      registry=reg, incremental="off")
    sched.start()
    cap = RaceCapture(["bcp_fixpoint", "search", "minimize", "core"])
    try:
        wall, rec, _, row = raced("2 burst (top-2)", sched, SCHED_CLIENTS,
                                  jobs, reg, cap)
    finally:
        sched.stop()
    cap.submit(plain, "race burst")
    same("2 burst", rec, off, steps=set(row["wins"]) == {"device"})
    row.update(unraced_wall_s=wall_off)
    print(f"race 2 burst: raced wall {wall:.3f} s against {wall_off:.3f} s "
          f"unraced (ratio {wall / wall_off:.4f}) [{card}]", flush=True)
    numbers["burst"] = row

    # Part 3: the auto mode, with a measured row and without one.
    fleet_off = [r for (lab, _), r in zip(jobs, off) if lab == "A"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "measured_defaults.json")
        with open(path, "w") as f:
            json.dump({"gpu": {"portfolio.s": "device,host"}}, f)
        prev = os.environ.get("DEPPY_GPU_MEASURED_DEFAULTS")
        for with_row in (True, False):
            os.environ["DEPPY_GPU_MEASURED_DEFAULTS"] = (
                path if with_row else os.path.join(tmp, "none.json"))
            defaults.reload_measured_defaults()
            label = f"3 auto ({'row' if with_row else 'no row'})"
            reg = telemetry.Registry()
            sched = Scheduler(cache_size=0, registry=reg,
                              incremental="off")
            sched.start()
            try:
                if with_row:
                    wall, rec, _, row = raced(label, sched, SCHED_CLIENTS,
                                              fleet, reg)
                else:
                    torch.cuda.synchronize()
                    wall, rec = run_clients(SCHED_CLIENTS, fleet,
                                            lambda r, st: sched.submit(
                                                r, stats=st))
                    spans = [s for s in reg.recent_spans()
                             if s["name"] == "race"]
                    row = dict(races=len(spans), wall_s=wall)
                    print(f"race {label}: {len(fleet)} requests in "
                          f"{wall:.3f} s, {len(spans)} race spans "
                          f"[{card}]", flush=True)
            finally:
                sched.stop()
            if with_row and row["races"] == 0:
                fail("race 3 auto: a measured portfolio row raced nothing")
            if not with_row and row["races"] != 0:
                fail(f"race 3 auto: {row['races']} races without a row")
            same(label, rec, fleet_off, steps=not with_row
                 or set(row["wins"]) == {"device"})
            numbers[f"auto_{'row' if with_row else 'none'}"] = row
        if prev is None:
            os.environ.pop("DEPPY_GPU_MEASURED_DEFAULTS", None)
        else:
            os.environ["DEPPY_GPU_MEASURED_DEFAULTS"] = prev
        defaults.reload_measured_defaults()

    # Part 4: the host pool against the inline engine.
    problems = [encode(pinned_tenant_catalog(seed=s))
                for s in range(RACE_POOL_STATES)]
    t0 = time.perf_counter()
    inline = hostpool.solve_inline(problems)
    inline_s = time.perf_counter() - t0
    # The pool's start (forkserver and workers) is timed apart: a
    # server pays it once.
    t0 = time.perf_counter()
    hostpool.solve_host_problems(problems[:2 * hostpool.effective_workers()])
    start_s = time.perf_counter() - t0
    snap0 = telemetry.default_registry().snapshot()
    t0 = time.perf_counter()
    pooled = hostpool.solve_host_problems(problems)
    pool_s = time.perf_counter() - t0
    faults.configure_plan(faults.plan_from_spec(json.dumps(
        [{"point": "hostpool.worker_crash", "kind": "error", "times": 1}])))
    try:
        crashed = hostpool.solve_host_problems(problems)
    finally:
        faults.configure_plan(None)
    snap = telemetry.default_registry().snapshot()
    keys = [r.key() for r in inline]
    crashes = (snap.get("deppy_hostpool_worker_crashes_total", 0)
               - snap0.get("deppy_hostpool_worker_crashes_total", 0))
    fallbacks = (snap.get("deppy_hostpool_inline_fallback_total", 0)
                 - snap0.get("deppy_hostpool_inline_fallback_total", 0))
    workers = hostpool.effective_workers()
    print(f"race 4 hostpool: {len(problems)} pinned_tenant states, inline "
          f"{inline_s:.3f} s, pool {pool_s:.3f} s on {workers} workers "
          f"(started in {start_s:.3f} s before) "
          f"(ratio {pool_s / inline_s:.4f}); identical "
          f"{[r.key() for r in pooled] == keys}, after a worker crash "
          f"{[r.key() for r in crashed] == keys} (crashes {crashes}, "
          f"inline fallbacks {fallbacks}) [{card}]", flush=True)
    if workers < 2 or fallbacks:
        fail(f"race 4 hostpool: {workers} workers, {fallbacks} inline "
             f"fallbacks: the pool did not serve")
    if [r.key() for r in pooled] != keys or \
            [r.key() for r in crashed] != keys:
        fail("race 4 hostpool: the pool's lanes differ from inline")
    if crashes != 1:
        fail(f"race 4 hostpool: {crashes} worker crashes under the plan")
    numbers["hostpool"] = dict(states=len(problems), inline_s=inline_s,
                               pool_s=pool_s, start_s=start_s,
                               workers=workers,
                               crashes=crashes)

    # Part 5: straggler triage.  The device estimate is the dispatch EWMA
    # (set to 30 s here, as the reference's test does), so a 20 s deadline
    # is a straggler; the batchmates carry none.
    n_tight, width = RACE_STRAGGLERS
    s_jobs = [("S", req[:width]) for _, req in fleet[:2 * n_tight]]
    tight = {id(req) for _, req in s_jobs[:n_tight]}
    reg = telemetry.Registry()
    sched = Scheduler(portfolio="on", portfolio_k=2, cache_size=0,
                      max_wait_ms=200.0, registry=reg, incremental="off")
    sched._dispatch_ewma_s = 30.0
    sched.start()
    try:
        with DispatchLog() as dl, RaceEvents() as ev:
            wall, rec = run_clients(
                len(s_jobs), s_jobs, lambda r, st: sched.submit(
                    r, stats=st, deadline_s=20.0 if id(r) in tight else None))
            sched_mod._join_race_threads()
    finally:
        sched.stop()
    _entrant_failures("5 stragglers", reg, ev)
    resub = reg.snapshot().get("deppy_race_straggler_resubmits_total", 0)
    device_keys = {k for c in dl.calls if c["thread"] == RACE_THREAD
                   for k in c["keys"]}
    tight_keys = {fingerprint(encode(vs)) for _, req in s_jobs[:n_tight]
                  for vs in req}
    mate_keys = {fingerprint(encode(vs)) for _, req in s_jobs[n_tight:]
                 for vs in req}
    want_s = [r for (lab, req), r in zip(jobs, off)
              if any(req is q for _, q in fleet[:2 * n_tight])]
    bad = sum([render(a) for a in r["answers"]]
              != [render(a) for a in w["answers"][:width]]
              for r, w in zip(rec, want_s))
    print(f"race 5 stragglers: {n_tight} requests x {width} states with a "
          f"20 s deadline under a 30 s estimate among {n_tight} without: "
          f"resubmitted {resub} lanes; device entrant lanes {len(device_keys)}"
          f" (batchmates {len(mate_keys & device_keys)} of {len(mate_keys)}, "
          f"stragglers {len(tight_keys & device_keys)}); wins "
          f"{reg.snapshot().get('deppy_race_wins_total', {})}; mismatches "
          f"{bad}; wall {wall:.3f} s [{card}]", flush=True)
    if resub != n_tight * width or tight_keys & device_keys or \
            mate_keys - device_keys or bad:
        fail("race 5 stragglers: triage did not split the flush as due")
    numbers["stragglers"] = dict(resubmitted=resub, wall_s=wall,
                                 wins=reg.snapshot().get(
                                     "deppy_race_wins_total", {}))

    # Part 6: grad_relax on the card.
    grad = {}
    for name, vss in (("chains", chain_requests(depths, RACE_LANES)),
                      ("version_pinned_chains",
                       [version_pinned_chains(20, 3, seed=s)
                        for s in range(RACE_GRAD_CHAINS)])):
        problems = [encode(vs) for vs in vss]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = grad_relax.candidate_logits(problems, device="cuda")
        torch.cuda.synchronize()
        descent_s = time.perf_counter() - t0
        b = grad_relax.candidate_logits(problems, device="cuda")
        cpu = grad_relax.candidate_logits(problems, device="cpu")
        a, b = a.cpu(), b.cpu()
        same_bits = torch.equal(a, b)
        err = float((a - cpu).abs().max())
        far = (torch.sigmoid(a) - 0.5).abs() > GRAD_MARGIN
        rounded = bool(((torch.sigmoid(a) > 0.5) == (torch.sigmoid(cpu) > 0.5))
                       [far].all())
        t0 = time.perf_counter()
        lanes = grad_relax.solve_lanes(problems, device="cuda")
        certify_s = time.perf_counter() - t0
        # The canonical answers: the device's (bit-identical to the host
        # engine's, which takes tens of seconds a lane on the deepest
        # chains).
        canon = registry.solve_via("device", problems, device="cuda")
        served = [(c, r) for c, r in zip(canon, lanes) if r is not None]
        wrong = sum((r.outcome, r.installed_idx) != (c.outcome,
                                                     c.installed_idx)
                    for c, r in served)
        print(f"race 6 grad_relax {name}: {len(problems)} lanes, descent "
              f"{descent_s * 1e3:.3f} ms on the card, two runs bit-equal "
              f"{same_bits}, max |logit - CPU| {err:.3g} (atol {GRAD_ATOL}), "
              f"rounding equal past {GRAD_MARGIN} {rounded}; certified "
              f"{len(served)} lanes in {certify_s:.3f} s, "
              f"{wrong} differ from the canonical answer [{card}]",
              flush=True)
        if not same_bits or err > GRAD_ATOL or not rounded or wrong:
            fail(f"race 6 grad_relax {name}: not reproducible or off the "
                 f"CPU descent")
        grad[name] = dict(lanes=len(problems), descent_ms=descent_s * 1e3,
                          certified=len(served), certify_s=certify_s,
                          max_abs_logit_err=err)
    numbers["grad_relax"] = grad

    # Part 7: the per-class costs of the registry.
    numbers["cost_us"] = race_costs(card)

    if _plain_work() != work0:
        fail("race path: a plain version ran during a card solve")
    print(f"race path launches (from {RACE_THREAD}, losers included): "
          f"{launches}", flush=True)
    return launches, numbers


# --------------------------------------------------------------------------
# the incremental path


INC_REPLAYS = 3      # part 1: churn replays with the tier on, and off
INC_BATCH = 8        # part 1b: churn requests a submit
INC_COST_CALLS = 5   # part 4: timed solve_via("warm") calls per class
# The kernels of the incremental path's cold dispatches, whose first
# launch on the scheduler's loop thread is held against its plain version.
INC_KERNELS = ("bcp_fixpoint", "search", "minimize", "core")


class WarmLog:
    """While on, every incremental-class flush of every scheduler (the
    scheduler's device, its lanes' plans and which lanes were served
    warm) and every ``driver.warm_screen`` call (device, inputs,
    verdicts)."""

    def __enter__(self):
        from deppy_tpu_torch.engine import driver
        from deppy_tpu_torch.sched.scheduler import Scheduler

        self.flushes, self.screens = [], []
        self._saved = [(Scheduler, "_solve_incremental",
                        Scheduler._solve_incremental),
                       (driver, "warm_screen", driver.warm_screen)]
        flush, screen = self._saved[0][2], self._saved[1][2]
        log = self

        def solve_incremental(sched, live, rep, timing, backend):
            first = len(log.screens)
            flush(sched, live, rep, timing, backend)
            log.flushes.append(dict(
                device=str(sched.device), plans=[lane.warm for lane in live],
                served=[lane.index_steps is not None for lane in live],
                screens=log.screens[first:]))

        def warm_screen(problems, models, cones, *, device="cuda"):
            ok = screen(problems, models, cones, device=device)
            log.screens.append(dict(device=str(device),
                                    args=(problems, models, cones),
                                    ok=ok))
            return ok

        Scheduler._solve_incremental = solve_incremental
        driver.warm_screen = warm_screen
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def check(self, label: str) -> dict:
        """Every warm flush of more than one lane ran exactly one screen,
        on ``cuda``, over all its lanes, and each screen's verdicts equal
        its run on the CPU.  Returns the flushes' and screens' numbers."""
        import numpy as np

        from deppy_tpu_torch.engine import driver

        multi = [f for f in self.flushes if len(f["plans"]) > 1]
        for f in multi:
            if [(s["device"], len(s["args"][0])) for s in f["screens"]] != \
                    [("cuda", len(f["plans"]))]:
                fail(f"incremental {label}: a warm flush of "
                     f"{len(f['plans'])} lanes on {f['device']} ran the "
                     f"screens {[(s['device'], len(s['args'][0])) for s in f['screens']]}")
        for s in self.screens:
            cpu = driver.warm_screen(*s["args"], device="cpu")
            if not np.array_equal(cpu, s["ok"]):
                fail(f"incremental {label}: the card's screen of "
                     f"{len(cpu)} lanes differs from its CPU run")
        return dict(
            warm_flushes=len(self.flushes),
            warm_flush_lanes=[len(f["plans"]) for f in self.flushes],
            served=sum(sum(f["served"]) for f in self.flushes),
            screens=len(self.screens),
            screen_lanes=sum(len(s["ok"]) for s in self.screens),
            screen_flagged=int(sum((~s["ok"]).sum() for s in self.screens)))

    def served_keys(self) -> set:
        """The fingerprints of the lanes served warm."""
        return {p.key for f in self.flushes
                for p, s in zip(f["plans"], f["served"]) if s}


def plan_clock(reg) -> list:
    """[ms, calls] of the clause-set index's ``plan`` on ``reg``, summed
    from its ``incremental.delta`` spans as they are emitted."""
    import threading

    acc, lock = [0.0, 0], threading.Lock()

    def note(event):
        if event.get("kind") == "span" and \
                event.get("name") == "incremental.delta":
            with lock:
                acc[0] += event["dur_s"] * 1e3
                acc[1] += 1

    reg.add_forwarder(note)
    return acc


def _screen_device_ms(fn) -> float:
    """Device ms of every kernel ``fn`` launched, from ``torch.profiler``
    (the screen's torch ops; no kernel of the port)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.key != "Activity Buffer Request") / 1e3


def _med(vals) -> str:
    return (f"median {statistics.median(vals):.3f} s (range "
            f"{min(vals):.3f}-{max(vals):.3f})")


def churn_replay(requests, tier: str, batch: int = 1) -> dict:
    """One pass of the churn replay through a fresh started
    ``Scheduler(incremental=tier)`` on the card from this thread,
    ``batch`` requests a submit: wall, rendered answers, steps per
    submit, the tier's counters and the index's ``plan`` time."""
    import torch

    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.sched import Scheduler

    reg = telemetry.Registry()
    plans = plan_clock(reg)
    sched = Scheduler(incremental=tier, registry=reg)
    sched.start()
    answers, steps = [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, len(requests), batch):
            st: dict = {}
            answers += [render(r) for r in
                        sched.submit(requests[lo:lo + batch], stats=st)]
            steps.append(st["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.stop()
    snap = reg.snapshot()
    return dict(wall_s=wall, answers=answers, steps=steps,
                hit_ratio=(sched.incremental.hit_ratio()
                           if sched.incremental is not None else 0.0),
                hits=snap.get("deppy_incremental_hits_total", 0),
                fallbacks=snap.get("deppy_incremental_warm_fallbacks_total",
                                   0),
                dispatches=snap["deppy_sched_dispatches_total"],
                plan_ms=plans[0], plans=plans[1])


def poison(plan, problem):
    """``plan``'s cached model with off-cone variables flipped, in index
    order, until the port's screen on the CPU flags the lane."""
    import numpy as np

    from deppy_tpu_torch.engine import driver

    model = plan.warm_assign > 0
    for v in np.nonzero(~plan.cone)[0]:
        model = model.copy()
        model[v] = not model[v]
        if not driver.warm_screen([problem], [model], [plan.cone],
                                  device="cpu")[0]:
            return model
    fail("incremental: no off-cone flip made the screen flag a lane")


def warm_costs(plans, card: str) -> dict:
    """Per-lane µs of ``solve_via("warm", ...)`` on each class's plans:
    the median of :data:`INC_COST_CALLS` calls after one untimed call,
    and their range."""
    from deppy_tpu_torch.engine import driver, registry

    by_class: dict = {}
    for plan in plans:
        by_class.setdefault(driver.padded_class([plan.problem]),
                            []).append(plan)
    out = {}
    for cls, ps in sorted(by_class.items()):
        registry.solve_via("warm", ps)
        samples = []
        for _ in range(INC_COST_CALLS):
            t0 = time.perf_counter()
            registry.solve_via("warm", ps)
            samples.append((time.perf_counter() - t0) / len(ps) * 1e6)
        out[cls] = dict(lanes=len(ps), us=statistics.median(samples),
                        range=(min(samples), max(samples)))
        print(f"incremental cost {cls} ({len(ps)} warm plans): warm "
              f"{out[cls]['us']:.1f} us/lane (median of {INC_COST_CALLS}, "
              f"{min(samples):.1f}-{max(samples):.1f}) [{card}]", flush=True)
    return out


def run_incremental_path(scale: float, plain: "PlainPool"):
    """The incremental tier on the card (parts 1-4): the churn replay of
    ``deppy_tpu/benchmarks/churn.py`` at its own defaults through
    ``Scheduler(device="cuda")`` with the tier on and off, 3 replays each
    from one client thread (answers equal lane for lane; steps equal on
    every lane the tier did not serve warm), and once with the tier on at
    :data:`INC_BATCH` requests a submit (warm flushes of several lanes:
    the screen on the card); the screen on ``cuda`` against ``cpu`` over
    replay 1's warm plans and the same plans poisoned; the ``sched``
    burst A+B with the tier on and off (answers equal, and steps on
    every request none of whose lanes was served warm); and the ``warm``
    backend's per-class cost.  Every warm flush of more than one lane
    must run the screen on ``cuda``, every screen must equal its CPU run,
    and no ``incremental_screen_failed`` event may fire.  The first
    ``deppy-sched`` launch of each kernel in the churn replays and in the
    burst is held against its plain version in ``plain``'s pool.
    Returns the path's launches (parts 1 and 3, the main path) and
    numbers."""
    import numpy as np
    import torch

    from deppy_tpu_torch import engine, telemetry
    from deppy_tpu_torch.engine import driver
    from deppy_tpu_torch.models import churn_requests
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import Scheduler, fingerprint

    t_phase = time.perf_counter()
    card = card_line()
    print(f"incremental timings on {card}", flush=True)
    requests = churn_requests()
    keys = [fingerprint(encode(vs)) for vs in requests]
    numbers = {}
    work0 = _plain_work()
    events = RaceEvents()
    events.__enter__()
    try:
        torch.cuda.synchronize()
        engine.reset_launch_counts()
        # Part 1: the churn replay, tier on and off.
        runs = {"on": [], "off": []}
        logs = {}
        churn_cap = RaceCapture(INC_KERNELS, thread=SCHED_LOOP)
        for r in range(INC_REPLAYS):
            for tier in ("on", "off"):
                with WarmLog() as log, churn_cap:
                    run = churn_replay(requests, tier)
                row = log.check(f"churn {tier} replay {r + 1}")
                run.update(row)
                runs[tier].append(run)
                logs.setdefault(tier, log)
                print(f"incremental churn {tier} replay {r + 1}: "
                      f"{len(requests)} requests in {run['wall_s']:.3f} s; "
                      f"hit ratio {run['hit_ratio']}, served warm "
                      f"{run['hits']}, warm fallbacks {run['fallbacks']}, "
                      f"dispatches {run['dispatches']} (warm flushes "
                      f"{row['warm_flushes']}); screens {row['screens']} "
                      f"({row['screen_lanes']} lanes, "
                      f"{row['screen_flagged']} flagged); index plan "
                      f"{run['plan_ms']:.3f} ms over {run['plans']} "
                      f"[{card}]", flush=True)
        churn_cap.submit(plain, "incremental churn", need=())
        off0 = runs["off"][0]
        warm_keys = logs["on"].served_keys()
        bad_answers = sum(run["answers"] != off0["answers"]
                          for tier in runs for run in runs[tier])
        bad_steps = sum(run["steps"] != runs[tier][0]["steps"]
                        for tier in runs for run in runs[tier])
        bad_steps += sum(a != b for k, a, b in zip(
            keys, runs["on"][0]["steps"], off0["steps"])
            if k not in warm_keys)
        print(f"incremental churn: answers equal lane for lane across "
              f"{2 * INC_REPLAYS} replays (mismatches {bad_answers}), steps "
              f"equal replay for replay and on every lane not served warm "
              f"(mismatches {bad_steps}; {len(warm_keys)} lanes served "
              f"warm)", flush=True)
        if bad_answers or bad_steps:
            fail(f"incremental churn: {bad_answers} replays' answers and "
                 f"{bad_steps} step counts differ")
        if runs["on"][0]["hits"] == 0:
            fail("incremental churn: the tier served nothing warm")
        walls = {t: [run["wall_s"] for run in runs[t]] for t in runs}
        ratio = (statistics.median(walls["on"])
                 / statistics.median(walls["off"]))
        print(f"incremental churn walls: on {_med(walls['on'])}, off "
              f"{_med(walls['off'])}; on/off {ratio:.4f} [{card}]",
              flush=True)
        numbers["churn"] = dict(
            requests=len(requests), walls_on_s=walls["on"],
            walls_off_s=walls["off"], on_over_off=ratio,
            hit_ratio=runs["on"][0]["hit_ratio"],
            served=runs["on"][0]["hits"],
            fallbacks=runs["on"][0]["fallbacks"],
            dispatches_on=runs["on"][0]["dispatches"],
            dispatches_off=off0["dispatches"],
            screens=runs["on"][0]["screens"],
            plan_ms=runs["on"][0]["plan_ms"], plans=runs["on"][0]["plans"])

        # Part 1b: the replay at INC_BATCH requests a submit, tier on.
        with WarmLog() as log:
            run = churn_replay(requests, "on", batch=INC_BATCH)
        row = log.check("churn batched")
        if run["answers"] != off0["answers"]:
            fail("incremental churn batched: answers differ from the "
                 "serial replay's")
        if row["screens"] == 0:
            fail("incremental churn batched: no warm flush ran the screen")
        print(f"incremental churn batched ({INC_BATCH} a submit, tier on): "
              f"{len(requests)} requests in {run['wall_s']:.3f} s; warm "
              f"flushes {row['warm_flushes']} (lanes "
              f"{row['warm_flush_lanes']}), served warm {run['hits']}, "
              f"fallbacks {run['fallbacks']}; screens on cuda "
              f"{row['screens']} ({row['screen_lanes']} lanes, "
              f"{row['screen_flagged']} flagged), each equal to its CPU "
              f"run; answers equal the serial replay's [{card}]",
              flush=True)
        numbers["churn_batched"] = dict(wall_s=run["wall_s"],
                                        hits=run["hits"],
                                        fallbacks=run["fallbacks"], **row)

        # Part 3: the sched burst A+B, tier on and off.
        jobs = burst_jobs(scale)
        burst, burst_plans, burst_warm = {}, [], set()
        burst_cap = RaceCapture(INC_KERNELS, thread=SCHED_LOOP)
        for tier in ("on", "off"):
            reg = telemetry.Registry()
            plan_ms = plan_clock(reg)
            sched = Scheduler(incremental=tier, cache_size=SCHED_CACHE,
                              registry=reg)
            sched.start()
            try:
                with WarmLog() as log, burst_cap:
                    torch.cuda.synchronize()
                    wall, records = run_clients(
                        SCHED_CLIENTS, jobs,
                        lambda q, st: sched.submit(q, stats=st))
                    torch.cuda.synchronize()
            finally:
                sched.stop()
            row = log.check(f"burst {tier}")
            burst_plans += [p for f in log.flushes for p in f["plans"]]
            burst_warm |= log.served_keys()
            snap = reg.snapshot()
            total = snap["deppy_sched_dispatches_total"]
            row.update(wall_s=wall, dispatches=total,
                       plan_ms=plan_ms[0], plans=plan_ms[1],
                       cold_dispatches=total - row["warm_flushes"],
                       deltas=snap.get("deppy_incremental_delta_total", {}),
                       records=records)
            burst[tier] = row
            print(f"incremental burst {tier}: {len(jobs)} requests from "
                  f"{SCHED_CLIENTS} clients in {wall:.3f} s; dispatches "
                  f"{total} (cold {row['cold_dispatches']}, incremental "
                  f"class {row['warm_flushes']}), served warm "
                  f"{row['served']}; delta classes {row['deltas']}; index "
                  f"plan {row['plan_ms']:.3f} ms over {row['plans']} "
                  f"[{card}]", flush=True)
        # The burst's launches are compared with their plain versions
        # after the churn's: those the churn never made must be here.
        burst_cap.submit(plain, "incremental burst",
                         need=[k for k in INC_KERNELS
                               if k not in churn_cap.calls])
        # Steps are held on every request none of whose lanes was served
        # warm (a warm lane reports the host engine's warm steps).
        bad_answers = bad_steps = held = 0
        for (_, request), a, b in zip(jobs, burst["on"].pop("records"),
                                      burst["off"].pop("records")):
            if [render(r) for r in a["answers"]] != \
                    [render(r) for r in b["answers"]]:
                bad_answers += 1
            if burst_warm.isdisjoint(fingerprint(encode(vs))
                                     for vs in request):
                held += 1
                bad_steps += a["stats"]["steps"] != b["stats"]["steps"]
        print(f"incremental burst: {len(jobs)} requests, mismatches "
              f"{bad_answers} (answers) and {bad_steps} (steps, on the "
              f"{held} requests with no lane served warm) tier on against "
              f"off; wall on/off "
              f"{burst['on']['wall_s'] / burst['off']['wall_s']:.4f} "
              f"[{card}]", flush=True)
        if bad_answers or bad_steps:
            fail(f"incremental burst: {bad_answers} requests' answers and "
                 f"{bad_steps} step counts differ with the tier on")
        if held == 0:
            fail("incremental burst: every request had a lane served warm; "
                 "no step count was held")
        numbers["burst_steps_held"] = held
        numbers["burst"] = burst
        torch.cuda.synchronize()
        launches = engine.launch_counts()
        if _plain_work() != work0:
            fail("incremental path: a plain version ran during a card solve")

        # Part 2: the screen on the card against its CPU run, over
        # replay 1's warm plans and the same plans poisoned.
        plans = [p for f in logs["on"].flushes for p in f["plans"]]
        problems = [p.problem for p in plans] * 2
        models = ([p.warm_assign > 0 for p in plans]
                  + [poison(p, p.problem) for p in plans])
        cones = [p.cone for p in plans] * 2
        cuda = driver.warm_screen(problems, models, cones, device="cuda")
        cpu = driver.warm_screen(problems, models, cones, device="cpu")
        n = len(problems)
        chunks = -(-n // driver._Dims(problems,
                                      min(n, driver.MAX_LANES)).B)
        walls_s = []
        for _ in range(INC_COST_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            driver.warm_screen(problems, models, cones, device="cuda")
            walls_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        driver.warm_screen(problems, models, cones, device="cpu")
        cpu_s = time.perf_counter() - t0
        device_ms = _screen_device_ms(
            lambda: driver.warm_screen(problems, models, cones,
                                       device="cuda"))
        flagged = int((~cuda).sum())
        print(f"incremental screen: {n} lanes ({len(plans)} warm plans of "
              f"replay 1, the same poisoned), {chunks} chunk(s); cuda "
              f"equals cpu {np.array_equal(cuda, cpu)}, flagged {flagged} "
              f"({int((~cuda[:len(plans)]).sum())} clean, every poisoned "
              f"lane {bool((~cuda[len(plans):]).all())}); "
              f"device {device_ms / chunks:.4f} ms a chunk, call "
              f"{statistics.median(walls_s) * 1e3:.3f} ms (median of "
              f"{INC_COST_CALLS}) on the card, {cpu_s * 1e3:.3f} ms on the "
              f"CPU [{card}]", flush=True)
        if not np.array_equal(cuda, cpu) or flagged == 0 or \
                cuda[len(plans):].any():
            fail("incremental screen: the card's verdicts differ from the "
                 "CPU's or from the plans' poisoning")
        numbers["screen"] = dict(lanes=n, chunks=chunks, flagged=flagged,
                                 device_ms_per_chunk=device_ms / chunks,
                                 call_ms=statistics.median(walls_s) * 1e3,
                                 cpu_ms=cpu_s * 1e3)

        # Part 4: the warm backend's per-class cost.
        numbers["cost_us"] = warm_costs(plans + burst_plans, card)
    finally:
        events.__exit__()
    failed = [e for e in events.events
              if e.get("fault") == "incremental_screen_failed"]
    if failed:
        fail(f"incremental: {len(failed)} incremental_screen_failed events")
    seconds = time.perf_counter() - t_phase
    numbers["seconds"] = seconds
    print(f"incremental path: {seconds:.1f} s; launches (parts 1 and 3) "
          f"{launches}", flush=True)
    return launches, numbers


# --------------------------------------------------------------------------
# the sessions path


SESS_CATALOG = (96, 8)      # session_catalog: the reference benchmark's default
SESS_STEPS = 48             # part 1: walk_steps(96, 8, 48), the benchmark's walk
SESS_CLIENTS = 16           # part 2: concurrent sessions in lockstep
SESS_LOCKSTEP = 24          # part 2: walk steps a session
SESS_EXPLAIN_EVERY = 8      # part 2: every 8th step test, contradict, explain, untest
SESS_HANDOFF_STEPS = 4      # part 3: steps each imported session takes


class SessionLog:
    """While on, every ``Scheduler.submit_session`` call's outcome by the
    thread that made it: whether a warm start was planned, its steps and
    the applied constraints of the problem it solved."""

    def __enter__(self):
        import threading

        from deppy_tpu_torch.sched.scheduler import Scheduler

        self.last = {}
        self.calls = 0
        self._lock = threading.Lock()
        self._orig = Scheduler.submit_session
        log = self

        def submit_session(sched, *args, **kwargs):
            st = kwargs.get("stats")
            if st is None:
                st = kwargs["stats"] = {}
            out = log._orig(sched, *args, **kwargs)
            with log._lock:
                log.calls += 1
                log.last[threading.current_thread().name] = dict(
                    warm=st["warm"], steps=st["steps"],
                    n_cons=kwargs["problem"].n_cons)
            return out

        Scheduler.submit_session = submit_session
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.sched.scheduler import Scheduler

        Scheduler.submit_session = self._orig

    def take(self) -> dict:
        """The calling thread's last ``submit_session`` (and forget it)."""
        import threading

        with self._lock:
            return self.last.pop(threading.current_thread().name)


class FlushLog:
    """While on, every flush of every scheduler: its groups' size
    classes, its lanes and its reason."""

    def __enter__(self):
        from deppy_tpu_torch.sched.scheduler import Scheduler

        self.flushes = []
        self._orig = Scheduler._dispatch
        log = self

        def dispatch(sched, groups, reason):
            log.flushes.append(dict(sched=id(sched),
                                    classes=[g.size_class for g in groups],
                                    lanes=sum(len(g.lanes) for g in groups),
                                    reason=reason))
            return log._orig(sched, groups, reason)

        Scheduler._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.sched.scheduler import Scheduler

        Scheduler._dispatch = self._orig

    def of(self, sched) -> list:
        return [f for f in self.flushes if f["sched"] == id(sched)]


class SpanClock:
    """While on, [ms, count] of each named span emitted on the given
    registries, as they are emitted."""

    NAMES = ("session.op", "incremental.delta", "sched.queue_wait")

    def __init__(self, *registries):
        self.regs = registries

    def __enter__(self):
        import threading

        lock = threading.Lock()
        self.acc = {}

        def note(event):
            if event.get("kind") == "span" and event.get("name") in \
                    self.NAMES:
                name = event["name"]
                if name == "session.op":
                    name = f"session.op {event['attrs']['op']}"
                with lock:
                    a = self.acc.setdefault(name, [0.0, 0])
                    a[0] += event["dur_s"] * 1e3
                    a[1] += 1

        self._note = note
        for reg in self.regs:
            reg.add_forwarder(note)
        return self

    def __exit__(self, *exc):
        for reg in self.regs:
            reg.remove_forwarder(self._note)

    def text(self) -> str:
        return ", ".join(f"{k} {v[0]:.3f} ms over {v[1]} "
                         f"({v[0] / max(v[1], 1):.3f} a span)"
                         for k, v in sorted(self.acc.items()))


def contradiction(stack):
    """A pin that contradicts the last installed pin of ``stack``:
    exclude the next entity of its chain (which the pin's dependency
    drags in), or the pinned entity itself at a chain's end."""
    ident = next(i for i, on in reversed(stack) if on)
    b, j = ident[1:].split("v")
    j = int(j)
    return (f"b{b}v{j + 1}" if j + 1 < SESS_CATALOG[1] else ident), False


class ScopeMirror:
    """The assumption stack a session's ops leave, kept beside the
    session the way its engine keeps it: ``test`` opens a scope owning
    every assumption since the previous ``test``, ``untest`` drops the
    last scope with the assumptions it owns."""

    def __init__(self):
        self.stack, self.scopes, self.base = [], [], 0

    def assume(self, pin) -> None:
        self.stack.append(pin)

    def test(self) -> None:
        self.scopes.append(self.base)
        self.base = len(self.stack)

    def untest(self) -> None:
        self.base = self.scopes.pop()
        del self.stack[self.base:]


def session_walk(store, sid: str, log: SessionLog, walk, mirror, records,
                 part: str, explain_every: int = 0, barrier=None) -> list:
    """Drive ``walk`` through one session: per step assume then resolve,
    and every ``explain_every``-th step a probe — ``test`` (a scope over
    the walk so far), a contradicting pin, ``test`` again (the pin's own
    scope), ``explain``, ``untest`` (the pin dropped, the walk kept).
    Each solve is recorded with the stack it answers for (``mirror``),
    its output and its ``submit_session`` numbers, each probe's second
    ``test`` verdict under ``probe``.  With ``barrier``, every step's
    solve starts with the other sessions'.  Returns the client-visible
    seconds of each step (assume + resolve)."""
    samples = []

    def op(doc):
        out = store.op(sid, doc)
        if doc["op"] == "assume":
            mirror.assume((doc["identifiers"][0], doc["installed"]))
        elif doc["op"] in ("test", "untest"):
            getattr(mirror, doc["op"])()
        return out

    for i, (ident, installed) in enumerate(walk):
        if barrier is not None:
            barrier.wait()
        t0 = time.perf_counter()
        op({"op": "assume", "identifiers": [ident], "installed": installed})
        out = op({"op": "resolve"})
        samples.append(time.perf_counter() - t0)
        records.append(dict(part=part, op="resolve",
                            stack=list(mirror.stack), out=out, **log.take()))
        if explain_every and (i + 1) % explain_every == 0:
            if barrier is not None:
                barrier.wait()
            op({"op": "test"})
            pin = contradiction(mirror.stack)
            op({"op": "assume", "identifiers": [pin[0]], "installed": pin[1]})
            probe = op({"op": "test"})["result"]
            out = op({"op": "explain"})
            records.append(dict(part=part, op="explain",
                                stack=list(mirror.stack), out=out,
                                probe=probe, **log.take()))
            op({"op": "untest"})
    return samples


def lockstep(store, sids, log, walks, mirrors, records, part: str,
             explain_every: int = 0) -> float:
    """Each session of ``sids`` on its own thread, all released step by
    step by one barrier; returns the wall."""
    import threading

    barrier = threading.Barrier(len(sids), timeout=300)
    errors = []
    mine = [[] for _ in sids]

    def client(k: int) -> None:
        try:
            session_walk(store, sids[k], log, walks[k], mirrors[k],
                         mine[k], part, explain_every, barrier)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"session-{k}")
               for k in range(len(sids))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"sessions {part}: a session thread never returned")
    if errors:
        raise RuntimeError(f"chip_smoke: sessions {part} raised") \
            from errors[0]
    for rows in mine:
        records += rows
    return wall


def _dist(samples) -> str:
    ms = [s * 1e3 for s in samples]
    return (f"p50 {_pct(ms, 0.5):.3f} ms, p99 {_pct(ms, 0.99):.3f} ms, "
            f"mean {statistics.mean(ms):.3f} ms")


def _flush_text(flushes) -> str:
    """Flushes by size class: count and mean lanes."""
    from deppy_tpu_torch.sched.scheduler import (INCREMENTAL_CLASS,
                                                 SESSION_CLASS)

    names = {SESSION_CLASS: "session", INCREMENTAL_CLASS: "incremental"}
    by: dict = {}
    for f in flushes:
        by.setdefault(names.get(f["classes"][0], "cold"), []).append(
            f["lanes"])
    return ", ".join(f"{k} {len(v)} (mean {statistics.mean(v):.2f} lanes)"
                     for k, v in sorted(by.items()))


def run_sessions_path(scale: float, plain: "PlainPool"):
    """Resolution sessions on the card (parts 1-3): one
    ``Scheduler(device="cuda")`` at the reference's defaults and one
    ``SessionStore`` on it over ``session_catalog(96, 8)`` (768
    variables, 673 constraints). Part 1: the benchmark's walk (48 steps
    of assume then resolve) through one session, then the same walk
    stateless (each step's derived document through ``problem_from_dict``
    and ``submit``). Part 2: 16 sessions in lockstep, each its own walk,
    every 8th step a test scope with a contradicting pin and an UNSAT
    ``explain``. Part 3: the warm state and the sessions exported, sent
    through JSON, verified and imported into a fresh card scheduler,
    where each imported session takes 4 more steps; a tampered copy must
    be refused. An explain probe is ``test`` (a scope over the walk), the
    contradicting pin, ``test`` (the pin's own scope), ``explain`` and
    ``untest``: the pin is dropped and the walk kept, so the sessions
    carry nested scopes into the handoff. Every answer must equal the one-shot cold solve of its
    derived problem on the card (and the stateless pass's), steps too
    where no warm start was planned; the first loop-thread launch of
    kernels 1, 3, 4 and 5 is held against its plain version; every warm
    flush of two or more lanes must be screened on ``cuda`` and equal
    its CPU run; no session answer may reach the shared cache or index;
    every session flush is an ``immediate`` one. Returns the path's
    launches (parts 1-3) and numbers."""
    import json

    import torch

    from deppy_tpu_torch import engine, io, telemetry
    from deppy_tpu_torch.engine import driver
    from deppy_tpu_torch.fleet import (SnapshotFormatError,
                                       export_warm_state, import_warm_state,
                                       verify_snapshot)
    from deppy_tpu_torch.models import (derived_doc, session_catalog,
                                        walk_steps)
    from deppy_tpu_torch.sat.solver import assumed_variables
    from deppy_tpu_torch.sched import Scheduler
    from deppy_tpu_torch.sched.scheduler import SESSION_CLASS
    from deppy_tpu_torch.sessions import SessionStore

    t_phase = time.perf_counter()
    card = card_line()
    print(f"sessions timings on {card}", flush=True)
    bundles, size = SESS_CATALOG
    n_steps = max(8, int(SESS_STEPS * scale))
    n_lock = max(SESS_EXPLAIN_EVERY, int(SESS_LOCKSTEP * scale))
    doc = session_catalog(bundles, size)
    variables = io.problem_from_dict(doc)
    numbers = {}
    records = []
    work0 = _plain_work()
    reg = telemetry.Registry()
    sched = Scheduler(registry=reg)
    store = SessionStore(sched, metrics=reg)
    sched.start()
    events = RaceEvents()
    cap = RaceCapture(INC_KERNELS, thread=SCHED_LOOP)
    sched_b = store_b = None
    try:
        with events, cap, SessionLog() as log, FlushLog() as flog:
            torch.cuda.synchronize()
            engine.reset_launch_counts()
            # Part 1: one session, serially, then the same walk stateless.
            walk = walk_steps(bundles, size, n_steps)
            sid = store.create(doc)["id"]
            with WarmLog() as wlog, SpanClock(
                    reg, telemetry.default_registry()) as clock:
                t0 = time.perf_counter()
                sess_s = session_walk(store, sid, log, walk, ScopeMirror(),
                                      records, "serial")
                sess_wall = time.perf_counter() - t0
            wlog.check("sessions serial")
            part1 = records[:]
            if len(sched.cache) or any(e.key.startswith("scope:") for e in
                                       sched.incremental.export_entries()):
                fail("sessions: a session solve reached the shared cache "
                     "or index")
            stateless_s, stateless = [], []
            acc = []
            with WarmLog() as wlog_s:
                t0 = time.perf_counter()
                for step in walk:
                    t1 = time.perf_counter()
                    acc.append(step)
                    [r] = sched.submit([io.problem_from_dict(
                        derived_doc(doc, acc))])
                    stateless_s.append(time.perf_counter() - t1)
                    stateless.append(io.result_to_dict(r))
                stateless_wall = time.perf_counter() - t0
            wlog_s.check("sessions stateless")
            n_shared = len(sched.cache)
            bad = sum(json.dumps(a["out"]["result"], sort_keys=True)
                      != json.dumps(b, sort_keys=True)
                      for a, b in zip(part1, stateless))
            warm1 = sum(r["warm"] for r in part1)
            ratio_mean = statistics.mean(stateless_s) / statistics.mean(
                sess_s)
            ratio_p50 = _pct(stateless_s, 0.5) / _pct(sess_s, 0.5)
            print(f"sessions serial: {len(walk)} steps (assume + resolve) "
                  f"on session_catalog{SESS_CATALOG} ({doc_size(doc)}) in "
                  f"{sess_wall:.3f} s, a step {_dist(sess_s)}; warm "
                  f"{warm1}/{len(part1)}; spans {clock.text()} [{card}]",
                  flush=True)
            print(f"sessions stateless: the same {len(walk)} steps as "
                  f"derived documents through submit in "
                  f"{stateless_wall:.3f} s, a step {_dist(stateless_s)}; "
                  f"answers equal the session's (mismatches {bad}); "
                  f"stateless/session {ratio_mean:.3f} (means), "
                  f"{ratio_p50:.3f} (p50s) [{card}]", flush=True)
            if bad:
                fail(f"sessions: {bad} stateless answers differ from the "
                     f"session's")
            numbers["serial"] = dict(
                steps=len(walk), wall_s=sess_wall,
                p50_ms=_pct(sess_s, 0.5) * 1e3,
                p99_ms=_pct(sess_s, 0.99) * 1e3,
                mean_ms=statistics.mean(sess_s) * 1e3, warm=warm1,
                spans=clock.acc)
            numbers["stateless"] = dict(
                wall_s=stateless_wall, p50_ms=_pct(stateless_s, 0.5) * 1e3,
                p99_ms=_pct(stateless_s, 0.99) * 1e3,
                mean_ms=statistics.mean(stateless_s) * 1e3,
                ratio_mean=ratio_mean, ratio_p50=ratio_p50,
                shared_cache=n_shared)

            # Part 2: SESS_CLIENTS sessions in lockstep.
            sids = [store.create(doc, tenant=f"t{k % 4}")["id"]
                    for k in range(SESS_CLIENTS)]
            walks = [walk_steps(bundles, size, n_lock + SESS_HANDOFF_STEPS
                                + k)[k:] for k in range(SESS_CLIENTS)]
            mirrors = [ScopeMirror() for _ in sids]
            n0 = len(records)
            with WarmLog() as wlog2, SpanClock(
                    reg, telemetry.default_registry()) as clock2:
                wall2 = lockstep(store, sids, log,
                                 [w[:n_lock] for w in walks], mirrors,
                                 records, "lockstep", SESS_EXPLAIN_EVERY)
            row2 = wlog2.check("sessions lockstep")
            multi = [f for f in wlog2.flushes if len(f["plans"]) > 1]
            if not multi:
                fail("sessions lockstep: no warm flush of two or more lanes")
            part2 = records[n0:]
            unsat = [r for r in part2 if r["op"] == "explain"]
            if any(r["out"]["result"]["status"] != "unsat" for r in unsat):
                fail("sessions lockstep: an explain of a contradicting pin "
                     "was not UNSAT")
            max_cons = max(r["n_cons"] for r in unsat)
            probes = sum(r["probe"] == -1 for r in unsat)
            if max_cons > driver.HOST_CORE_NCONS:
                fail(f"sessions lockstep: an UNSAT lane of {max_cons} "
                     f"constraints routes its core to the host")
            flushes2 = [f for f in flog.of(sched)
                        if f["reason"] != "inline"]
            print(f"sessions lockstep: {SESS_CLIENTS} sessions x {n_lock} "
                  f"steps ({len(part2)} solves, {len(unsat)} UNSAT "
                  f"explains, {probes} of their probes a conflict by "
                  f"propagation, most applied constraints of an UNSAT lane "
                  f"{max_cons} <= {driver.HOST_CORE_NCONS}) in "
                  f"{wall2:.3f} s; warm {sum(r['warm'] for r in part2)}/"
                  f"{len(part2)}; warm flushes {row2['warm_flushes']} "
                  f"(of 2+ lanes {len(multi)}, lanes "
                  f"{sorted(len(f['plans']) for f in multi)[-5:]} largest), "
                  f"screens on cuda {row2['screens']} "
                  f"({row2['screen_lanes']} lanes, "
                  f"{row2['screen_flagged']} flagged), each equal to its "
                  f"CPU run; spans {clock2.text()} [{card}]", flush=True)
            numbers["lockstep"] = dict(
                sessions=SESS_CLIENTS, steps=n_lock, solves=len(part2),
                explains=len(unsat), max_unsat_cons=max_cons, wall_s=wall2,
                warm=sum(r["warm"] for r in part2), spans=clock2.acc,
                **{k: v for k, v in row2.items()
                   if k != "warm_flush_lanes"},
                multi_lane_warm_flushes=len(multi))

            # Isolation and flush reasons on the first scheduler.
            scoped = [k for k in sched.cache._entries
                      if k.startswith("scope:")]
            scoped += [e.key for e in sched.incremental.export_entries()
                       if e.key.startswith("scope:")]
            if scoped or len(sched.cache) != n_shared:
                fail(f"sessions: {len(scoped)} scope keys in the shared "
                     f"tier, shared cache {len(sched.cache)} entries "
                     f"against {n_shared} from the stateless pass")
            reasons = reg.snapshot()["deppy_sched_flushes_total"]
            session_flushes = [f for f in flog.of(sched)
                               if SESSION_CLASS in f["classes"]]
            if reasons.get("immediate", 0) < len(session_flushes):
                fail(f"sessions: {reasons.get('immediate', 0)} immediate "
                     f"flushes against {len(session_flushes)} session-class "
                     f"flushes")
            print(f"sessions flushes: {sum(reasons.values())} by reason "
                  f"{dict(sorted(reasons.items()))}; by class "
                  f"{_flush_text(flushes2)}; shared cache {n_shared} "
                  f"entries (the stateless pass's), 0 scope keys in the "
                  f"shared cache and index", flush=True)
            numbers["flushes"] = dict(reasons=reasons,
                                      session_class=len(session_flushes),
                                      by_class=_flush_text(flushes2))

            # Part 3: the handoff to a fresh card scheduler.
            t0 = time.perf_counter()
            snap = export_warm_state(sched, sessions=store)
            text = json.dumps(snap)
            moved = verify_snapshot(json.loads(text))
            tampered = json.loads(text)
            tampered["sessions"][0]["tenant"] = "mallory"
            try:
                verify_snapshot(tampered)
                fail("sessions handoff: a tampered snapshot verified")
            except SnapshotFormatError:
                pass
            reg_b = telemetry.Registry()
            sched_b = Scheduler(registry=reg_b)
            store_b = SessionStore(sched_b, metrics=reg_b)
            sched_b.start()
            got = import_warm_state(sched_b, moved, sessions=store_b)
            handoff_s = time.perf_counter() - t0
            bad_state = 0
            for entry in snap["sessions"]:
                want = ([tuple(a) for a in entry["assumptions"]],
                        entry["scopes"], entry["scope_base"])
                have = store_b._sessions[entry["id"]].solver.scope_state()
                bad_state += have != want
            for k, m in zip(sids, mirrors):
                have = store_b._sessions[k].solver.scope_state()
                bad_state += have != (m.stack, m.scopes, m.base)
            if got["sessions_imported"] != 1 + SESS_CLIENTS or bad_state:
                fail(f"sessions handoff: imported {got}, {bad_state} scope "
                     f"states differ")
            n0 = len(records)
            with WarmLog() as wlog3:
                wall3 = lockstep(store_b, sids, log,
                                 [w[n_lock:] for w in walks], mirrors,
                                 records, "handoff")
            row3 = wlog3.check("sessions handoff")
            part3 = records[n0:]
            first_warm = sum(part3[k * SESS_HANDOFF_STEPS]["warm"]
                             for k in range(SESS_CLIENTS))
            if first_warm == 0:
                fail("sessions handoff: no imported session's next step was "
                     "served warm from its imported index")
            print(f"sessions handoff: {len(text)} bytes, "
                  f"{len(snap['index'])} index entries, "
                  f"{len(snap['cache'])} cache seeds, "
                  f"{len(snap['sessions'])} sessions exported, verified and "
                  f"imported in {handoff_s:.3f} s ({got}); scope states "
                  f"equal (scope depth {len(mirrors[0].scopes)}); a "
                  f"tampered copy refused; {SESS_CLIENTS} sessions "
                  f"x {SESS_HANDOFF_STEPS} steps in {wall3:.3f} s, warm "
                  f"{sum(r['warm'] for r in part3)}/{len(part3)} (first "
                  f"step after the import {first_warm}/{SESS_CLIENTS}); "
                  f"warm flushes {row3['warm_flushes']} [{card}]",
                  flush=True)
            numbers["handoff"] = dict(bytes=len(text), import_s=handoff_s,
                                      imported=got, wall_s=wall3,
                                      warm=sum(r["warm"] for r in part3),
                                      first_warm=first_warm)
            torch.cuda.synchronize()
            launches = engine.launch_counts()
        cap.submit(plain, "sessions")
        failed = [e for e in events.events
                  if e.get("fault") == "incremental_screen_failed"]
        if failed:
            fail(f"sessions: {len(failed)} incremental_screen_failed events")
    finally:
        store.stop()
        sched.stop()
        if store_b is not None:
            store_b.stop()
            sched_b.stop()

    # The oracle: every solve's derived problem, cold, in one batch.
    oracle = Scheduler(incremental="off", portfolio="off", cache_size=0,
                       registry=telemetry.Registry())
    derived = [assumed_variables(variables, r["stack"]) for r in records]
    t0 = time.perf_counter()
    with Recorder() as rec:
        answers = oracle.submit(derived)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    if len(rec.keys) != len(records):
        fail(f"sessions oracle: {len(rec.keys)} lanes solved for "
             f"{len(records)} problems")
    bad_answers = bad_steps = held = 0
    for i, (r, want, key) in enumerate(zip(records, answers, rec.keys)):
        if json.dumps(r["out"]["result"], sort_keys=True) != json.dumps(
                io.result_to_dict(want), sort_keys=True):
            bad_answers += 1
            if bad_answers <= 3:
                print(f"sessions oracle: solve {i} ({r['part']} {r['op']}, "
                      f"{len(r['stack'])} pins, warm {r['warm']}) answered "
                      f"{json.dumps(r['out']['result'])[:300]}, the cold "
                      f"solve {json.dumps(io.result_to_dict(want))[:300]}",
                      flush=True)
        if not r["warm"]:
            held += 1
            bad_steps += r["steps"] != key[3]
    if _plain_work() != work0:
        fail("sessions path: a plain version ran during a card solve")
    print(f"sessions oracle: {len(records)} solves against their one-shot "
          f"cold solve on the card ({oracle_s:.3f} s, one batch): "
          f"mismatches {bad_answers} (answers, byte for byte), {bad_steps} "
          f"(steps, on the {held} solves with no warm start planned) "
          f"[{card}]", flush=True)
    if bad_answers or bad_steps:
        fail(f"sessions: {bad_answers} answers and {bad_steps} step counts "
             f"differ from the one-shot cold solves")
    if held == 0:
        fail("sessions: every solve was planned warm; no step count was "
             "held")
    seconds = time.perf_counter() - t_phase
    numbers.update(solves=len(records), steps_held=held, oracle_s=oracle_s,
                   seconds=seconds)
    print(f"sessions path: {seconds:.1f} s; launches (parts 1-3) "
          f"{launches}", flush=True)
    return launches, numbers


FAULT_GVK = 256          # part 2: gvk_conflict_catalog(20, 4, 10) states
FAULT_TENANTS = 64       # part 2: pinned_tenant_catalog states
FAULT_BLOCKWISE = 8      # part 10: operatorhub_catalog(250, 8) catalogs
FAULT_CKPT_GROUP = 128   # part 9: problems a checkpoint group
FAULT_REPROBE_S = 1.0    # part 11: DEPPY_GPU_REPROBE
# The fault counters each part's line reports (deltas on the default
# registry).
FAULT_COUNTERS = ("deppy_fault_retries", "deppy_fault_failures_total",
                  "deppy_fault_host_routed_total", "deppy_deadline_exceeded",
                  "deppy_breaker_transitions_total", "deppy_escalation_total")


class FaultLog:
    """While on, the ``breaker`` and ``fault`` events of the default
    registry, and the flight-recorder dumps a fresh breaker trip makes."""

    def __enter__(self):
        from deppy_tpu_torch import telemetry
        from deppy_tpu_torch.telemetry import trace

        self.events, self.dumps = [], 0
        self._reg = telemetry.default_registry()
        self._fn = lambda e: (self.events.append(e)
                              if e.get("kind") in ("breaker", "fault")
                              else None)
        self._reg.add_forwarder(self._fn)
        self._dump = trace.notify_breaker_open

        def dump():
            self.dumps += 1
            self._dump()

        trace.notify_breaker_open = dump
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.telemetry import trace

        self._reg.remove_forwarder(self._fn)
        trace.notify_breaker_open = self._dump

    def mark(self) -> tuple:
        return len(self.events), self.dumps

    def since(self, mark: tuple) -> dict:
        """The breaker states, fault kinds (with the deadline expiries'
        ``where``) and dumps since ``mark``."""
        new = self.events[mark[0]:]
        return dict(
            breaker=[e["state"] for e in new if e["kind"] == "breaker"],
            faults=[e["fault"] + (f"@{e['where']}" if "where" in e else "")
                    for e in new if e["kind"] == "fault"
                    and e["fault"] != "injected"],
            dumps=self.dumps - mark[1])


def _fault_snapshot() -> dict:
    from deppy_tpu_torch import telemetry

    snap = telemetry.default_registry().snapshot()
    return {k: snap.get(k, {} if k in ("deppy_breaker_transitions_total",
                                       "deppy_escalation_total") else 0)
            for k in FAULT_COUNTERS}


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            d = {s: n - before[k].get(s, 0) for s, n in v.items()
                 if n - before[k].get(s, 0)}
        else:
            d = v - before[k]
        out[k.replace("deppy_", "").replace("_total", "")] = d
    return out


def run_faults_path(scale: float, plain: "PlainPool"):
    """The fault envelope, the breaker and ``auto`` on the card (parts
    1-13 of the module docstring's phase 4h).  Returns the path's
    launches, its numbers and the driver failures and host-routed lanes
    it scripted, which the end of the run holds the counters to."""
    import shutil
    import tempfile

    import torch

    from deppy_tpu_torch import engine, faults, hostpool, telemetry
    from deppy_tpu_torch.engine import checkpoint, core, driver
    from deppy_tpu_torch.models import (gvk_conflict_catalog,
                                        operatorhub_catalog,
                                        pinned_tenant_catalog)
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat import solver as sat_solver
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import Scheduler
    from deppy_tpu_torch.sched import scheduler as sched_mod

    t_phase = time.perf_counter()
    card = card_line()
    print(f"faults timings on {card}", flush=True)
    # Part 1: the gate on the run so far.
    snap = _fault_snapshot()
    if snap["deppy_fault_failures_total"] or \
            snap["deppy_fault_host_routed_total"]:
        fail(f"faults: the earlier phases counted "
             f"{snap['deppy_fault_failures_total']} driver failures and "
             f"{snap['deppy_fault_host_routed_total']} host-routed lanes")
    n_gvk = max(COMPARE_LANES, int(FAULT_GVK * scale))
    n_ten = max(COMPARE_LANES, int(FAULT_TENANTS * scale))
    states = ([gvk_conflict_catalog(20, 4, 10, seed=i) for i in range(n_gvk)]
              + [pinned_tenant_catalog(seed=i) for i in range(n_ten)])
    problems = [encode(vs) for vs in states]
    n = len(problems)
    groups = driver.partition_buckets(problems)
    env_keys = ("DEPPY_GPU_BREAKER_THRESHOLD", "DEPPY_GPU_BREAKER_RESET_S",
                "DEPPY_GPU_CHUNK_DEADLINE_S", "DEPPY_GPU_REPROBE")
    env0 = {k: os.environ.get(k) for k in env_keys}
    numbers, lines = {}, []
    launches = {k: 0 for k in engine.KERNELS}
    scripted = dict(failures=0, host_routed=0)
    ckpt_dir = tempfile.mkdtemp(prefix="deppy-faults-")

    def card_solve(plan=None, **kw):
        faults.configure_plan(None if plan is None
                              else faults.plan_from_spec(plan))
        try:
            out = driver.solve_problems(problems, device="cuda", **kw)
            torch.cuda.synchronize()
        finally:
            faults.configure_plan(None)
        return out

    def part(name, fn, want, **extra):
        """Run part ``name`` (``fn()`` returns its results' keys and a
        dict of its own numbers); its counter deltas must include
        ``want`` (failures, host_routed, retries, ...)."""
        before, mark = _fault_snapshot(), log.mark()
        torch.cuda.synchronize()
        engine.reset_launch_counts()
        t0 = time.perf_counter()
        own = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = engine.launch_counts()
        for k in engine.KERNELS:
            launches[k] += counts[k]
        d = _delta(before, _fault_snapshot())
        d.update(log.since(mark))
        for k, v in want.items():
            if d.get(k) != v:
                fail(f"faults {name}: {k} {d.get(k)!r}, scripted {v!r}")
        scripted["failures"] += d["fault_failures"]
        scripted["host_routed"] += d["fault_host_routed"]
        row = dict(wall_s=wall, launches=counts, **d, **own)
        numbers[name] = row
        print(f"faults {name}: wall {wall:.3f} s; retries "
              f"{d['fault_retries']} failures {d['fault_failures']} "
              f"host-routed {d['fault_host_routed']} deadline-exceeded "
              f"{d['deadline_exceeded']}; breaker {d['breaker']} "
              f"(dumps {d['dumps']}); escalation {d['escalation']}; "
              f"faults {d['faults']}; launches "
              + " ".join(f"{k}={counts[k]}" for k in engine.KERNELS)
              + "".join(f"; {k} {v}" for k, v in own.items()
                        if not isinstance(v, (list, dict)))
              + f" [{card}]", flush=True)
        return row

    def same(name, got, want, steps=True):
        cut = (lambda k: k[:4]) if steps else (lambda k: k[:3])
        bad = sum(cut(a) != cut(b) for a, b in zip(got, want))
        if len(got) != len(want) or bad:
            fail(f"faults {name}: {bad} of {len(want)} lanes differ from "
                 f"the baseline ({'answers and steps' if steps else 'answers'})")

    cap = RaceCapture(engine.KERNELS, thread="MainThread")
    base = {}
    try:
        with cap, FaultLog() as log:
            # Part 2: the baseline on the card, and on the host backend.
            def baseline():
                base["results"] = card_solve()
                base["keys"] = [solve_key(r) for r in base["results"]]
                # Twice: the first call may start the host pool.
                walls = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    host = hostpool.solve_host_problems(problems)
                    walls.append(time.perf_counter() - t0)
                base["host_steps"] = [r.steps for r in host]
                base["host_s"] = walls[1]
                return dict(groups=len(groups), lanes=n,
                            host_first_s=walls[0], host_s=walls[1])

            part("2 baseline", baseline, dict(fault_failures=0,
                                              fault_host_routed=0))
            base["answers"] = driver.decode_results(problems,
                                                    base["results"])
            check_answers("faults baseline", states, base["answers"])

            # Part 3: transient faults.
            for point in ("driver.dispatch", "driver.device_put"):
                def transient(point=point):
                    got = [solve_key(r) for r in card_solve(
                        f'[{{"point": "{point}", "times": 1}}]')]
                    same(f"3 transient {point}", got, base["keys"])
                    return {}

                part(f"3 transient {point}", transient,
                     dict(fault_retries=1, fault_failures=1,
                          fault_host_routed=0, breaker=[]))

            # Part 4: a poison split.
            attempts = faults.RetryPolicy.from_env().max_attempts

            def poison():
                got = [solve_key(r) for r in card_solve(
                    f'[{{"point": "driver.dispatch", "times": {attempts}}}]')]
                same("4 poison split", got, base["keys"], steps=False)
                return dict(step_mismatches=sum(
                    a[3] != b[3] for a, b in zip(got, base["keys"])))

            row = part("4 poison split", poison,
                       dict(fault_retries=attempts - 1,
                            fault_failures=attempts, fault_host_routed=0,
                            breaker=[]))
            if row["faults"].count("group_split") != 1:
                fail(f"faults 4 poison split: events {row['faults']}")

            # Part 5: a dead card, the open breaker and recovery.  The
            # dead card's host fallback of the batch runs after the trip,
            # inside the cooldown, and the short circuit after it must
            # still find the breaker open: the cooldown is 1 s plus three
            # times the host backend's wall on the batch (part 2's second
            # call).
            reset_s = round(1.0 + 3.0 * base["host_s"], 1)
            numbers["breaker_reset_s"] = reset_s
            os.environ["DEPPY_GPU_BREAKER_THRESHOLD"] = "2"
            os.environ["DEPPY_GPU_BREAKER_RESET_S"] = str(reset_s)
            faults.set_default_breaker(None)
            breaker = faults.default_breaker()

            def dead():
                out = card_solve('[{"point": "driver.dispatch", '
                                 '"times": -1}]')
                got = [solve_key(r) for r in out]
                same("5 dead card", got, base["keys"], steps=False)
                if [k[3] for k in got] != base["host_steps"]:
                    fail("faults 5 dead card: steps differ from the host "
                         "backend's")
                return dict(cooldown_left_s=breaker.remaining_s())

            part("5 dead card", dead,
                 dict(fault_failures=2, fault_retries=1,
                      fault_host_routed=n, breaker=["open"], dumps=1))

            def short_circuit():
                if not breaker.blocks_device():
                    fail("faults 5 short circuit: the cooldown lapsed "
                         "before the solve")
                got = [solve_key(r) for r in card_solve()]
                same("5 short circuit", got, base["keys"], steps=False)
                return {}

            row = part("5 short circuit", short_circuit,
                       dict(fault_failures=0, fault_host_routed=n,
                            breaker=[]))
            if any(row["launches"].values()):
                fail(f"faults 5 short circuit: launches {row['launches']} "
                     f"under the open breaker")
            time.sleep(breaker.remaining_s() + 0.05)

            def half_open():
                got = [solve_key(r) for r in card_solve()]
                same("5 half-open probe", got, base["keys"])
                return {}

            row = part("5 half-open probe", half_open,
                       dict(fault_failures=0, fault_host_routed=0,
                            breaker=["half_open", "closed"], dumps=0))
            if not any(row["launches"].values()):
                fail("faults 5 half-open probe: no kernel launched")

            # Part 6: the chunk deadline charges the breaker with real
            # card dispatches: it opens at the last group's.
            os.environ["DEPPY_GPU_BREAKER_THRESHOLD"] = str(len(groups))
            os.environ["DEPPY_GPU_CHUNK_DEADLINE_S"] = "1e-9"
            faults.set_default_breaker(None)

            def chunk():
                got = [solve_key(r) for r in card_solve()]
                same("6 chunk deadline", got, base["keys"])
                if faults.default_breaker().state() != "open":
                    fail("faults 6 chunk deadline: the breaker is "
                         f"{faults.default_breaker().state()}")
                return {}

            row = part("6 chunk deadline", chunk,
                       dict(fault_failures=0, fault_host_routed=0,
                            deadline_exceeded=len(groups),
                            breaker=["open"], dumps=1))
            if row["faults"].count("deadline_exceeded@driver.chunk") != \
                    len(groups):
                fail(f"faults 6 chunk deadline: events {row['faults']}")
            _restore_env(env0, ("DEPPY_GPU_CHUNK_DEADLINE_S",))
            os.environ["DEPPY_GPU_BREAKER_THRESHOLD"] = "2"
            faults.set_default_breaker(None)

            # Part 7: deadlines.
            def deadlines():
                expired = BatchResolver(device="cuda", deadline_s=0.0)
                out = expired.solve(states)
                torch.cuda.synchronize()
                if any(engine.launch_counts().values()):
                    fail("faults 7: an expired deadline launched kernels")
                if not all(render(r) == ("incomplete",) for r in out):
                    fail("faults 7: an expired deadline answered")
                live = BatchResolver(device="cuda", deadline_s=600.0)
                if [render(r) for r in live.solve(states)] != \
                        [render(r) for r in base["answers"]]:
                    fail("faults 7: a generous deadline's answers differ")
                with faults.deadline_scope(faults.Deadline(0.0)):
                    got = driver.solve_problems(problems, device="cuda")
                if any(r.outcome != 0 or r.steps for r in got):
                    fail("faults 7: an expired scope did not degrade")
                return {}

            row = part("7 deadlines", deadlines,
                       dict(fault_failures=0, fault_host_routed=0,
                            breaker=[]))
            if row["faults"].count("deadline_exceeded@driver.dispatch") != \
                    2 * len(groups):
                fail(f"faults 7: events {row['faults']}")

            # Part 8: escalation, once with a quarter of the lanes or fewer
            # straggling in every group (the compacted redo), once with
            # more (the full rerun).
            steps = [k[3] for k in base["keys"]]
            eligible = [[steps[i] for i in g] for g in groups
                        if len(g) >= driver.STAGE1_MIN_BATCH]
            redo = _stage1_budget(eligible, driver.STAGE1_MAX_STRAGGLERS)
            if any(sum(x > 1 for x in g) <= driver.STAGE1_MAX_STRAGGLERS
                   * len(g) for g in eligible):
                fail("faults 8: a stage-1 budget of 1 step strands a quarter "
                     "of a group's lanes or fewer")
            for label, stage1 in (("compacted", redo), ("full", 1)):
                def escalate(stage1=stage1):
                    driver.STAGE1_STEPS = stage1
                    try:
                        got = [solve_key(r) for r in card_solve()]
                    finally:
                        driver.STAGE1_STEPS = 0
                    same(f"8 escalation {label}", got, base["keys"])
                    spans = [s for s in telemetry.default_registry()
                             .recent_spans()
                             if s["name"] == "driver.escalation"]
                    return dict(stage1=stage1, stragglers=[
                        sp["attrs"].get("stragglers")
                        for sp in spans[-len(groups):]])

                row = part(f"8 escalation {label}", escalate,
                           dict(fault_failures=0, fault_host_routed=0))
                if row["escalation"].get("2", 0) < 1 or \
                        sum(row["escalation"].values()) != len(groups) or \
                        row["escalation"].get("0", 0) != \
                        len(groups) - len(eligible):
                    fail(f"faults 8 escalation {label}: stages "
                         f"{row['escalation']}")

            # Part 9: checkpoints.
            group = FAULT_CKPT_GROUP if n > FAULT_CKPT_GROUP else \
                max(1, n // 3)

            def ckpt():
                faults.configure_plan(faults.plan_from_spec(
                    '[{"point": "checkpoint.save_group", "after": 1, '
                    '"times": -1}]'))
                try:
                    checkpoint.solve_problems_checkpointed(
                        problems, ckpt_dir, group=group, device="cuda")
                except faults.InjectedFault:
                    pass
                else:
                    fail("faults 9: the scripted crash did not fire")
                finally:
                    faults.configure_plan(None)
                saved = sorted(p for p in os.listdir(ckpt_dir)
                               if p.endswith(".npz"))
                if saved != ["group_00000.npz"]:
                    fail(f"faults 9: saved {saved} before the crash")
                with Recorder() as rec:
                    out = checkpoint.solve_problems_checkpointed(
                        problems, ckpt_dir, group=group, device="cuda")
                torch.cuda.synchronize()
                same("9 checkpoints", [solve_key(r) for r in out],
                     base["keys"], steps=False)
                resumed = n - len(rec.keys)
                if resumed != group:
                    fail(f"faults 9: resumed {resumed} lanes, not {group}")
                return dict(group=group, resumed=resumed,
                            solved=len(rec.keys))

            part("9 checkpoints", ckpt, dict(fault_failures=0,
                                             fault_host_routed=0))

            # Part 10: blockwise, kernel 2 on the retry.
            core.set_bcp_impl("blockwise")
            try:
                cats = [encode(operatorhub_catalog(250, 8, seed=i))
                        for i in range(FAULT_BLOCKWISE)]
                clean = []

                def blockwise_clean():
                    clean.extend(solve_key(r) for r in driver.solve_problems(
                        cats, device="cuda"))
                    return {}

                part("10 blockwise clean", blockwise_clean,
                     dict(fault_failures=0, fault_host_routed=0))

                def blockwise():
                    faults.configure_plan(faults.plan_from_spec(
                        '[{"point": "driver.dispatch", "times": 1}]'))
                    try:
                        got = [solve_key(r) for r in driver.solve_problems(
                            cats, device="cuda")]
                    finally:
                        faults.configure_plan(None)
                    if got != clean:
                        fail("faults 10 blockwise: the retry's answers "
                             "differ from the clean solve's")
                    return {}

                row = part("10 blockwise", blockwise,
                           dict(fault_retries=1, fault_failures=1,
                                fault_host_routed=0))
                if row["launches"]["blockwise_fixpoint"] <= 0:
                    fail("faults 10 blockwise: kernel 2 did not launch on "
                         "the retry")
            finally:
                core.set_bcp_impl("auto")

        # Part 11: auto on the card.
        with FaultLog() as log:
            sat_solver._ENGINE_USABLE.pop("cuda", None)
            t0 = time.perf_counter()
            if sat_solver.resolve_backend("auto", device="cuda") != "device":
                fail("faults 11: the engine probe on the card said host")
            probe_s = time.perf_counter() - t0
            print(f"faults 11 probe: resolve_backend('auto', device='cuda') "
                  f"= device in {probe_s:.3f} s (subprocess) [{card}]",
                  flush=True)
            numbers["probe_s"] = probe_s
            os.environ["DEPPY_GPU_REPROBE"] = str(FAULT_REPROBE_S)
            faults.set_default_breaker(None)
            tenants = states[n_gvk:]
            want = [render(r) for r in base["answers"][n_gvk:]]
            reg = telemetry.Registry()
            sched = Scheduler(backend="auto", device="cuda", portfolio="on",
                              portfolio_k=2, portfolio_sample_check=1.0,
                              incremental="off", cache_size=0, registry=reg)
            sched.start()
            try:
                def flush(label, backend, plan=None, device_entrant=True):
                    faults.configure_plan(None if plan is None
                                          else faults.plan_from_spec(plan))
                    try:
                        starts0 = dict(reg.snapshot().get(
                            "deppy_race_starts_total", {}))
                        st: dict = {}
                        out = sched.submit(tenants, stats=st)
                        sched_mod._join_race_threads()
                        torch.cuda.synchronize()
                    finally:
                        faults.configure_plan(None)
                    if [render(r) for r in out] != want:
                        fail(f"faults 11 {label}: answers differ from the "
                             f"baseline's")
                    got = st["report"].backend
                    started = reg.snapshot().get(
                        "deppy_race_starts_total", {}).get("device", 0) - \
                        starts0.get("device", 0)
                    if got != backend or bool(started) != device_entrant:
                        fail(f"faults 11 {label}: backend {got}, device "
                             f"entrants {started}")
                    return dict(backend=got, device_entrants=started)

                part("11 auto first flush",
                     lambda: flush("first flush", "device"),
                     dict(fault_failures=0, fault_host_routed=0))
                part("11 auto trip",
                     lambda: flush("trip", "device",
                                   '[{"point": "driver.dispatch", '
                                   '"times": -1}]'),
                     dict(fault_failures=2, fault_host_routed=len(tenants),
                          breaker=["open"], dumps=1))
                row = part("11 auto host drain",
                           lambda: flush("host drain", "host",
                                         device_entrant=False),
                           dict(fault_failures=0, fault_host_routed=0))
                if any(row["launches"].values()):
                    fail(f"faults 11 host drain: launches {row['launches']}")
                t_clear = time.perf_counter()
                thread = sched._reprobe_thread
                if thread is None:
                    fail("faults 11: the host drain kicked no re-probe")
                thread.join(120)
                upgrade_s = time.perf_counter() - t_clear
                reprobes = reg.snapshot().get("deppy_sched_reprobes_total", {})
                if reprobes != {"upgraded": 1} or \
                        faults.default_breaker().state() != "closed":
                    fail(f"faults 11: re-probes {reprobes}, breaker "
                         f"{faults.default_breaker().state()}")
                print(f"faults 11 re-probe: upgraded {upgrade_s:.3f} s after "
                      f"the plan was cleared (cooldown {reset_s} s, "
                      f"DEPPY_GPU_REPROBE {FAULT_REPROBE_S} s) [{card}]",
                      flush=True)
                numbers["upgrade_s"] = upgrade_s
                row = part("11 auto upgraded",
                           lambda: flush("upgraded", "device"),
                           dict(fault_failures=0, fault_host_routed=0))
                if not any(row["launches"].values()):
                    fail("faults 11 upgraded: no kernel launched")
            finally:
                sched.stop()
        # Part 12: each kernel's first launch in the phase against its
        # plain version (checked with the pool's other jobs).
        cap.submit(plain, "faults")
    finally:
        # Part 13: clean up.
        faults.configure_plan(None)
        driver.STAGE1_STEPS = 0
        core.set_bcp_impl("auto")
        _restore_env(env0, env_keys)
        faults.set_default_breaker(None)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if faults.default_breaker().state() != "closed":
        fail("faults: the breaker is not closed after the phase")
    seconds = time.perf_counter() - t_phase
    numbers.update(seconds=seconds, scripted=dict(scripted))
    print(f"faults path: {seconds:.1f} s; scripted failures "
          f"{scripted['failures']}, host-routed lanes "
          f"{scripted['host_routed']}; launches {launches}", flush=True)
    return launches, numbers, scripted


OPT_SOFT = (40, 5, 8)         # workload 1: operatorhub_catalog(40, 5, seed=s), s < 8
OPT_CLIENTS = 8               # workload 1: client threads, one document each
OPT_UPGRADE = (96, 4, 6, 4)   # workload 2: packages, versions, rounds, releases a round
OPT_LIVE = (32, 16)           # workload 3: requests x gvk_conflict_catalog(20, 4, 10) states
OPT_LIVE_CLIENTS = 8          # workload 3: the live burst's client threads
OPT_GVK = 512                 # profiler: gvk_conflict_catalog(20, 4, 10) states
OPT_TENANTS = 64              # profiler: pinned_tenant_catalog states
OPT_BLOCKWISE = 8             # profiler: operatorhub_catalog(250, 8) catalogs
OPT_CHURN = (1, 8, 8)         # profiler: churn requests a submit (a seed, then two warm flushes)
OPT_SAMPLE = 0.25             # profiler: the sampling check's rate, 4 dispatches a site
OPT_PLAIN_LANES = 32          # lanes a CPU pool task solves
OPT_SITES = ("device", "host", "warm", "hostpool")


def soft_docs():
    """Workload 1's documents: one ``soft`` query over each
    ``operatorhub_catalog(40, 5, seed=s)`` whose entries, each
    ``{"installed": false, "weight": 1}``, name every head bundle
    ``p{p}.v0`` and every version of the mandatory root ``p0``.  The
    objective is unit-positive (its probes lower to native AtMost
    probes that ride the idle queue to the card), its floor is 0 and its
    optimum 1 (some version of ``p0`` is installed), so the last probe
    is an UNSAT proof (kernel 5)."""
    from deppy_tpu_torch import io
    from deppy_tpu_torch.models import operatorhub_catalog

    P, V, n = OPT_SOFT
    ids = [f"p0.v{v}" for v in range(V)] + [f"p{p}.v0" for p in range(1, P)]
    return [{"query": "soft", "warm": False,
             "variables": [io.variable_to_dict(v)
                           for v in operatorhub_catalog(P, V, seed=s)],
             "soft": [{"id": i, "installed": False, "weight": 1}
                      for i in ids]}
            for s in range(n)]


def upgrade_catalog(n_packages: int, catalog_versions) -> list:
    """One round's bundle catalog (copy of
    ``deppy_tpu/benchmarks/upgrade.py:44-69``): package ``p`` is a
    version group (AtMost-1 pin) whose versions each depend on the next
    package, chained under one mandatory root; each dependency row lists
    its versions newest first, so the feasibility solve upgrades every
    package and the tightening loop walks the touch count back down."""
    from deppy_tpu_torch import sat

    variables = []
    for p in range(n_packages):
        vids = catalog_versions[p]
        cons = [sat.dependency(*vids), sat.at_most(1, *vids)]
        if p == 0:
            cons.insert(0, sat.mandatory())
        variables.append(sat.variable(f"p{p}", *cons))
        for vid in vids:
            vcons = []
            if p + 1 < n_packages:
                vcons.append(sat.dependency(f"p{p + 1}"))
            variables.append(sat.variable(vid, *vcons))
    return variables


def round_docs(n_packages: int, versions: int, rounds: int,
               n_drift: int) -> list:
    """The upgrade replay's documents (copy of
    ``deppy_tpu/benchmarks/upgrade.py:72-110``): each round a rotating
    window of ``n_drift`` packages ships a release the round's plan must
    adopt (``prefer``), and the installed state carries the optimal plan
    forward."""
    from deppy_tpu_torch import io

    catalog_versions = {p: [f"p{p}.v{v}" for v in range(versions)]
                        for p in range(n_packages)}
    installed = {p: f"p{p}.v{versions - 1}" for p in range(n_packages)}
    docs = []
    for rnd in range(rounds):
        drift = sorted((rnd * n_drift + i) % n_packages
                       for i in range(n_drift))
        prefer = []
        for p in drift:
            release = f"p{p}.r{rnd}"
            catalog_versions[p] = [release] + catalog_versions[p]
            prefer.append(release)
        docs.append({
            "query": "upgrade",
            "variables": [io.variable_to_dict(v) for v in
                          upgrade_catalog(n_packages, catalog_versions)],
            "installed": ([f"p{p}" for p in range(n_packages)]
                          + sorted(installed.values())),
            "prefer": prefer,
        })
        for p in drift:
            installed[p] = f"p{p}.r{rnd}"
    return docs


def probe_stats(events) -> dict:
    """Per-(tenant, mode) probe counts and µs a probe from ``optimize``
    events (the reference's ``probe_stats``,
    ``deppy_tpu/benchmarks/upgrade.py:147-168``, over events read back
    from the sink)."""
    out: dict = {}
    for ev in events:
        if ev.get("kind") != "optimize":
            continue
        agg = out.setdefault(f"{ev.get('tenant')}:{ev.get('mode')}",
                             {"probes": 0, "improved": 0, "dur_s": 0.0})
        agg["probes"] += 1
        agg["dur_s"] += float(ev.get("dur_s", 0.0) or 0.0)
        agg["improved"] += ev.get("outcome") == "improved"
    for agg in out.values():
        agg["us_per_probe"] = (agg["dur_s"] * 1e6 / agg["probes"]
                               if agg["probes"] else 0.0)
    return out


class SpecLog:
    """While on, every idle-queue drain of every scheduler: the live
    groups and lanes still queued when it drained (read under the
    scheduler's lock), and the idle groups and lanes it took."""

    def __enter__(self):
        from deppy_tpu_torch.sched.scheduler import Scheduler

        self.drains = []
        self._orig = Scheduler._drain_spec_locked
        log = self

        def drain(sched):
            live_groups, live_lanes = len(sched._queue), sched._depth
            take, reason = log._orig(sched)
            log.drains.append(dict(
                sched=id(sched), live_groups=live_groups,
                live_lanes=live_lanes, groups=len(take),
                lanes=sum(len(g.lanes) for g in take)))
            return take, reason

        Scheduler._drain_spec_locked = drain
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch.sched.scheduler import Scheduler

        Scheduler._drain_spec_locked = self._orig

    def check(self, label: str, sched) -> list:
        """The drains of ``sched`` (of every scheduler when None); fails
        unless every one found no live lane queued."""
        mine = [d for d in self.drains
                if sched is None or d["sched"] == id(sched)]
        busy = [d for d in mine if d["live_groups"] or d["live_lanes"]]
        if busy:
            fail(f"{label}: {len(busy)} idle flushes drained with "
                 f"live lanes queued: {busy[:3]}")
        return mine


class ProfileLog:
    """While on: the ``profile`` and ``optimize`` events of the default
    registry with the thread that emitted each; each site's
    ``profile.dispatch_t0`` calls and samples; each sampled device
    dispatch's ledger inputs (``driver._profile_dispatch``); and, per warm
    flush, whether it was sampled and how many lanes it served warm."""

    def __enter__(self):
        import collections
        import threading

        from deppy_tpu_torch import profile, telemetry
        from deppy_tpu_torch.engine import driver
        from deppy_tpu_torch.sched.scheduler import Scheduler

        self.events, self.ledgers = [], []
        self.calls = collections.Counter()
        self.sampled = collections.Counter()
        self.warm_expected = 0
        lock = threading.Lock()
        self._reg = telemetry.default_registry()

        def note(ev):
            if ev.get("kind") in ("profile", "optimize"):
                with lock:
                    self.events.append(
                        (threading.current_thread().name, ev))

        self._note = note
        self._reg.add_forwarder(note)
        self._t0 = profile.dispatch_t0
        self._ledger = driver._profile_dispatch
        self._inc = Scheduler._solve_incremental

        def dispatch_t0(site="device"):
            t0 = self._t0(site)
            with lock:
                self.calls[site] += 1
                self.sampled[site] += t0 is not None
            return t0

        def profile_dispatch(t0, problems, d, steps, live, total, chunk):
            self.ledgers.append(dict(
                problems=list(problems), steps=steps.copy(), live=live,
                total=total, chunk=chunk, C=d.C, K=d.K))
            return self._ledger(t0, problems, d, steps, live, total, chunk)

        def solve_incremental(sched, live, rep, timing, backend):
            before = self.sampled["warm"]
            out = self._inc(sched, live, rep, timing, backend)
            served = sum(lane.index_steps is not None for lane in live)
            if self.sampled["warm"] > before and served:
                self.warm_expected += 1
            return out

        profile.dispatch_t0 = dispatch_t0
        driver._profile_dispatch = profile_dispatch
        Scheduler._solve_incremental = solve_incremental
        return self

    def __exit__(self, *exc):
        from deppy_tpu_torch import profile
        from deppy_tpu_torch.engine import driver
        from deppy_tpu_torch.sched.scheduler import Scheduler

        self._reg.remove_forwarder(self._note)
        profile.dispatch_t0 = self._t0
        driver._profile_dispatch = self._ledger
        Scheduler._solve_incremental = self._inc

    def mark(self) -> tuple:
        return (len(self.events), len(self.ledgers), dict(self.calls),
                dict(self.sampled), self.warm_expected)

    def since(self, mark: tuple, kind: str = "profile", thread=None):
        return [ev for t, ev in self.events[mark[0]:]
                if ev["kind"] == kind and (thread is None or t == thread)]

    def check_sites(self, label: str, mark: tuple) -> dict:
        """One ``profile`` event per sampled dispatch and flush since
        ``mark``, by site (a warm flush that served no lane warm records
        none); returns {site: [calls, sampled, events]}."""
        evs = self.since(mark)
        out = {}
        for site in OPT_SITES:
            calls = self.calls[site] - mark[2].get(site, 0)
            sampled = self.sampled[site] - mark[3].get(site, 0)
            events = sum(e["backend"] == site for e in evs)
            want = (self.warm_expected - mark[4] if site == "warm"
                    else sampled)
            if events != want:
                fail(f"optimize {label}: {events} {site} profile events "
                     f"for {want} sampled dispatches ({calls} calls)")
            out[site] = [calls, sampled, events]
        return out


def ledger_sums(label: str, rep, events) -> None:
    """A report's ledger fields must be the sums of its device events'
    (dispatches, trips, lane steps), and with one event its useful-work
    ratio the event's."""
    dev = [e for e in events if "trips" in e]
    got = (rep.profiled_dispatches, rep.ledger_trips, rep.ledger_lane_steps)
    want = (len(dev), sum(e["trips"] for e in dev),
            sum(e["lane_steps"] for e in dev))
    if got != want or (len(dev) == 1 and round(rep.useful_work_ratio, 4)
                       != dev[0]["useful_work_ratio"]):
        fail(f"optimize {label}: the report's (dispatches, trips, lane "
             f"steps) {got} != its events' {want}")


def _opt_plain_steps(problems, impl: str):
    """Pool task: the plain versions' steps of ``problems`` on the CPU
    under ``impl`` (one thread), and the seconds they took."""
    import torch

    from deppy_tpu_torch.engine import core, driver

    torch.set_num_threads(1)
    core.set_bcp_impl(impl)
    t0 = time.perf_counter()
    out = [int(r.steps) for r in driver.solve_problems(problems,
                                                      device="cpu")]
    return out, time.perf_counter() - t0


def hold_ledger(plain: "PlainPool", label: str, ledger: dict, event: dict,
                impl: str) -> None:
    """Submit the CPU check of one sampled card dispatch: its live
    problems solved by the plain versions on the CPU in the pool (a few
    lanes a task; a lane's steps do not depend on its batchmates), their
    steps held against the card's lane for lane, the card's pad lanes
    at 0 steps, and the event recomputed by the ledger from the plain
    steps equal to the card's in every field but ``ts`` and
    ``solve_s``."""
    import numpy as np

    live = ledger["live"]
    problems = ledger["problems"]
    futures = [plain.pool.submit(_opt_plain_steps,
                                 problems[lo:lo + OPT_PLAIN_LANES], impl)
               for lo in range(0, live, OPT_PLAIN_LANES)]

    def done():
        from deppy_tpu_torch import profile, size_classes, telemetry
        from deppy_tpu_torch.engine import driver

        parts = [f.result() for f in futures]
        steps = np.array([s for p in parts for s in p[0]], np.int64)
        card = ledger["steps"]
        bad = int((steps != card[:live]).sum())
        if bad or card[live:].any():
            fail(f"optimize {label}: {bad} of {live} lanes' steps differ "
                 f"from the plain versions' (pad steps "
                 f"{card[live:].tolist()[:8]})")
        full = card.copy()
        full[:live] = steps
        reg = telemetry.Registry()
        seen = []
        reg.add_forwarder(seen.append)
        prev = telemetry.set_default_registry(reg)
        try:
            c = max(driver._cost_proxy(p) for p in problems)
            profile.record_device_dispatch(
                time.perf_counter(), steps=full, live=live,
                chunk=ledger["chunk"], size_class=size_classes.bucket(c),
                size_class_name=size_classes.class_of_cost(c),
                pad_cells=ledger["total"] * ledger["C"] * ledger["K"],
                live_cells=int(sum(p.clauses.size for p in problems)))
        finally:
            telemetry.set_default_registry(prev)
        strip = lambda e: {k: v for k, v in e.items()  # noqa: E731
                           if k not in ("ts", "solve_s")}
        if strip(seen[0]) != strip(event):
            fail(f"optimize {label}: the plain versions' event "
                 f"{strip(seen[0])} != the card's {strip(event)}")
        print(f"optimize profile {label}: {live} lanes' steps and the "
              f"event equal the plain versions' on the CPU "
              f"({sum(p[1] for p in parts):.1f} s in {len(parts)} pool "
              f"tasks)", flush=True)

    plain.calls.append(done)


def run_optimize_path(scale: float, plain: "PlainPool"):
    """The trip profiler and the optimization tier on the card (the
    module docstring's phase 4i).  Returns the path's launches, its
    numbers, and the driver failures and host-routed lanes it scripted
    (the dead-card fallbacks of the profiler's ``hostpool`` site)."""
    import json as _json
    import shutil
    import tempfile
    import threading

    import torch

    from deppy_tpu_torch import engine, faults, profile, telemetry
    from deppy_tpu_torch.engine import core, driver
    from deppy_tpu_torch.models import (churn_requests, gvk_conflict_catalog,
                                        operatorhub_catalog,
                                        pinned_tenant_catalog)
    from deppy_tpu_torch.optimize import Planner
    from deppy_tpu_torch.profile import report
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sched import Scheduler

    t_phase = time.perf_counter()
    card = card_line()
    print(f"optimize timings on {card}", flush=True)
    numbers = {}
    launches = {k: 0 for k in engine.KERNELS}
    scripted = dict(failures=0, host_routed=0)
    reg = telemetry.default_registry()
    sink_dir = tempfile.mkdtemp(prefix="deppy-optimize-")
    sink = os.path.join(sink_dir, "sink.jsonl")
    prev_sink = reg.sink_path
    env_keys = ("DEPPY_GPU_BREAKER_THRESHOLD",)
    env0 = {k: os.environ.get(k) for k in env_keys}
    dumps = lambda x: _json.dumps(x, sort_keys=True)  # noqa: E731

    def window(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after; the launches add to the path's."""
        torch.cuda.synchronize()
        engine.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = engine.launch_counts()
        for k in engine.KERNELS:
            launches[k] += counts[k]
        return out, counts

    def planner_clients(sched, docs, tenant, records, prefix="opt"):
        """One thread a document through ``Planner(sched).handle``; each
        record is (response or the error raised, seconds)."""
        def run(i):
            t0 = time.perf_counter()
            try:
                out = Planner(sched).handle(docs[i], tenant=tenant)
            except BaseException as e:  # noqa: BLE001 — raised by join
                out = e
            records[i] = (out, time.perf_counter() - t0)

        return [threading.Thread(target=run, args=(i,),
                                 name=f"{prefix}-client-{i}")
                for i in range(len(docs))]

    def join(threads, records):
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            fail("optimize: a client thread never returned")
        for r in records:
            if isinstance(r[0], BaseException):
                raise RuntimeError("chip_smoke: optimize: a Planner "
                                   "raised") from r[0]

    def oracle_check(label, docs, got, want):
        """Every card response byte-equal to the host scheduler's, every
        ``selected`` set a solution of its catalog."""
        from deppy_tpu_torch import io

        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if dumps(a) != dumps(b)]
        if bad or len(got) != len(want):
            fail(f"optimize {label}: {len(bad)} of {len(want)} responses "
                 f"differ from the host scheduler's (first: "
                 f"{got[bad[0]] if bad else None} against "
                 f"{want[bad[0]] if bad else None})")
        for doc, out in zip(docs, got):
            if out.get("status") != "optimal":
                fail(f"optimize {label}: status {out.get('status')}")
            variables = [io.variable_from_dict(v) for v in doc["variables"]]
            chosen = set(out["selected"])
            check_solution(variables, {v.identifier: v.identifier in chosen
                                       for v in variables})

    soft = soft_docs()
    host = Scheduler(backend="host", incremental="off", cache_size=0,
                     registry=telemetry.Registry())
    host.start()
    reg.configure_sink(sink)
    try:
        with profile.override("on", 1.0), ProfileLog() as plog, \
                SpecLog() as slog:
            # The oracle: the same documents on the host scheduler.
            want_soft = [Planner(host).handle(d, tenant="host-soft")
                         for d in soft]
            if not all(o["proof"] == "unsat_probe" and o["objective"] == 1
                       for o in want_soft):
                fail(f"optimize: the soft documents' host answers "
                     f"{[(o['objective'], o['proof']) for o in want_soft]}"
                     f" are not optimum 1 by an UNSAT probe")
            sched = Scheduler(device="cuda", incremental="off",
                              cache_size=0, registry=telemetry.Registry())
            sched.start()
            try:
                # Workload 1: the soft documents from 8 clients at once.
                records = [None] * len(soft)
                cap = RaceCapture(INC_KERNELS, thread=SCHED_LOOP)
                mark = plog.mark()

                def workload1():
                    threads = planner_clients(sched, soft, "soft", records)
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    join(threads, records)
                    return time.perf_counter() - t0

                with cap, DispatchLog() as dlog:
                    wall, counts = window(workload1)
                _loop_only("optimize soft", dlog.calls, counts)
                got = [r[0] for r in records]
                oracle_check("1 soft", soft, got, want_soft)
                drains = slog.check("optimize 1 soft", sched)
                if len(dlog.calls) != len(drains):
                    fail(f"optimize 1 soft: {len(drains)} idle flushes, "
                         f"{len(dlog.calls)} card dispatches")
                if counts["core"] <= 0:
                    fail("optimize 1 soft: no UNSAT proof reached kernel 5")
                probes = [e for e in plog.since(mark, "optimize")
                          if e["tenant"] == "soft"]
                lanes = [d["lanes"] for d in drains]
                row = dict(
                    wall_s=wall, launches=counts, flushes=len(drains),
                    lanes_per_flush=lanes,
                    probes_per_doc=[o["iterations"] for o in got],
                    us_per_probe=statistics.mean(
                        e["dur_s"] for e in probes) * 1e6,
                    latency_s=[r[1] for r in records])
                numbers["1 soft"] = row
                print(f"optimize 1 soft: {len(soft)} documents from "
                      f"{OPT_CLIENTS} clients in {wall:.3f} s; probes a "
                      f"document {row['probes_per_doc']}, "
                      f"{row['us_per_probe']:.1f} us a probe; "
                      f"{len(drains)} idle flushes (lanes "
                      f"{min(lanes)}-{max(lanes)}, mean "
                      f"{statistics.mean(lanes):.2f}), every one with no "
                      f"live lane queued; responses equal the host "
                      f"scheduler's, every proof an UNSAT probe; launches "
                      + " ".join(f"{k}={counts[k]}" for k in engine.KERNELS)
                      + f" [{card}]", flush=True)
                cap.submit(plain, "optimize idle flush")

                # Workload 2: the upgrade replay, cold then warm.
                docs = round_docs(*OPT_UPGRADE)
                mark = plog.mark()
                for warm in (False, True):
                    tenant = "warm" if warm else "cold"
                    mine, theirs = [], []

                    def replay():
                        t0 = time.perf_counter()
                        p = Planner(sched)
                        for d in docs:
                            mine.append(p.handle({**d, "warm": warm},
                                                 tenant=tenant))
                        return time.perf_counter() - t0

                    wall, counts = window(replay)
                    ph = Planner(host)
                    for d in docs:
                        theirs.append(ph.handle({**d, "warm": warm},
                                                tenant=f"host-{tenant}"))
                    oracle_check(f"2 upgrade {tenant}", docs, mine, theirs)
                    numbers[f"2 upgrade {tenant}"] = dict(
                        wall_s=wall, launches=counts,
                        iterations=[o["iterations"] for o in mine],
                        objectives=[o["objective"] for o in mine])
                stats = probe_stats(plog.since(mark, "optimize"))
                numbers["2 probes"] = stats
                w, c = stats.get("warm:warm"), stats.get("cold:cold")
                if not w or not c:
                    fail(f"optimize 2 upgrade: probes {stats}")
                print(f"optimize 2 upgrade: {OPT_UPGRADE[0]} packages x "
                      f"{OPT_UPGRADE[1]} versions, {OPT_UPGRADE[2]} rounds "
                      f"of {OPT_UPGRADE[3]} releases; cold pass "
                      f"{numbers['2 upgrade cold']['wall_s']:.3f} s, "
                      f"{c['probes']} probes, {c['us_per_probe']:.1f} us a "
                      f"probe; warm pass "
                      f"{numbers['2 upgrade warm']['wall_s']:.3f} s, "
                      f"{w['probes']} probes, {w['us_per_probe']:.1f} us a "
                      f"probe (cold/warm "
                      f"{c['us_per_probe'] / w['us_per_probe']:.2f}); "
                      f"objectives "
                      f"{numbers['2 upgrade warm']['objectives']}; "
                      f"responses equal the host scheduler's [{card}]",
                      flush=True)

                # Workload 3: workload 1 beside a live burst.
                n_req = max(4, int(OPT_LIVE[0] * scale))
                jobs = [("L", [gvk_conflict_catalog(
                    20, 4, 10, seed=OPT_LIVE[1] * i + j)
                    for j in range(OPT_LIVE[1])]) for i in range(n_req)]
                want_live = unscheduled(jobs)

                def live_submit(request, st):
                    return sched.submit(request, stats=st)

                def check_live(label, recs):
                    bad = sum([render(r) for r in rec["answers"]] != a
                              or rec["stats"]["steps"] != s
                              for rec, (a, s, _) in zip(recs, want_live))
                    if bad:
                        fail(f"optimize 3 {label}: {bad} live requests "
                             f"differ from their unscheduled solves")
                    return [r["latency_s"] for r in recs]

                _, recs = run_clients(OPT_LIVE_CLIENTS, jobs, live_submit)
                alone = check_live("alone", recs)
                waits = []

                def note_wait(ev):
                    if (ev.get("kind") == "span"
                            and ev.get("name") == "sched.queue_wait"
                            and threading.current_thread().name.startswith(
                                "opt3-")):
                        waits.append(ev["dur_s"])

                records = [None] * len(soft)
                reg.add_forwarder(note_wait)
                n_drains = len(slog.drains)
                try:
                    def workload3():
                        threads = planner_clients(sched, soft, "soft3",
                                                  records, prefix="opt3")
                        for t in threads:
                            t.start()
                        out = run_clients(OPT_LIVE_CLIENTS, jobs,
                                          live_submit)
                        join(threads, records)
                        return out

                    (_, recs), counts = window(workload3)
                finally:
                    reg.remove_forwarder(note_wait)
                loaded = check_live("with optimize load", recs)
                oracle_check("3 soft under load", soft,
                             [r[0] for r in records], want_soft)
                slog.check("optimize 3 preemption", sched)
                row = dict(
                    live_p50_ms=(_pct(alone, 0.5) * 1e3,
                                 _pct(loaded, 0.5) * 1e3),
                    live_p99_ms=(_pct(alone, 0.99) * 1e3,
                                 _pct(loaded, 0.99) * 1e3),
                    probe_wait_p50_ms=_pct(waits, 0.5) * 1e3,
                    probe_wait_p99_ms=_pct(waits, 0.99) * 1e3,
                    probe_waits=len(waits),
                    idle_flushes=len(slog.drains) - n_drains,
                    launches=counts)
                numbers["3 preemption"] = row
                print(f"optimize 3 preemption: {n_req} live requests x "
                      f"{OPT_LIVE[1]} states from {OPT_LIVE_CLIENTS} "
                      f"clients: p50 {row['live_p50_ms'][0]:.3f} ms alone, "
                      f"{row['live_p50_ms'][1]:.3f} ms with the optimize "
                      f"load; p99 {row['live_p99_ms'][0]:.3f} / "
                      f"{row['live_p99_ms'][1]:.3f} ms; the probes' "
                      f"sched.queue_wait p50 {row['probe_wait_p50_ms']:.3f}"
                      f" ms p99 {row['probe_wait_p99_ms']:.3f} ms over "
                      f"{len(waits)} probes; {row['idle_flushes']} idle "
                      f"flushes, none with a live lane queued; live answers "
                      f"and steps equal the unscheduled solves, responses "
                      f"the host scheduler's [{card}]", flush=True)
            finally:
                sched.stop()
            numbers["sites"] = plog.check_sites("workloads",
                                                (0, 0, {}, {}, 0))

            # The profiler's sites, armed, each event held.
            mark = plog.mark()
            fleet = [gvk_conflict_catalog(20, 4, 10, seed=i)
                     for i in range(max(COMPARE_LANES, int(OPT_GVK * scale)))]
            tenants = [pinned_tenant_catalog(seed=i) for i in
                       range(max(COMPARE_LANES,
                                 int(OPT_TENANTS * scale)))]
            walls = {"on": [], "off": []}
            held = []

            def resolve(states, label, mode=None):
                m = plog.mark()
                resolver = BatchResolver(device="cuda")
                t0 = time.perf_counter()
                if mode is None:
                    answers = resolver.solve(states)
                else:
                    with profile.override(mode, 1.0):
                        answers = resolver.solve(states)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check_answers(f"optimize profile {label}", states, answers)
                evs = plog.since(m, thread="MainThread")
                return wall, resolver.last_report, evs, plog.ledgers[m[1]:]

            def profiled():
                for mode in ("off", "on", "on", "off"):
                    wall, rep, evs, _ = resolve(fleet, "gvk_fleet", mode)
                    walls[mode].append(wall)
                    if len(evs) != int(mode == "on"):
                        fail(f"optimize profile: {len(evs)} events with "
                             f"the profiler {mode}")
                for label, states in (("gvk_fleet", fleet),
                                      ("pinned_tenant", tenants)):
                    _, rep, evs, ledgers = resolve(states, label)
                    ledger_sums(label, rep, evs)
                    held.append((label, ledgers, evs, "auto"))
                core.set_bcp_impl("blockwise")
                try:
                    cats = [encode(operatorhub_catalog(250, 8, seed=i))
                            for i in range(OPT_BLOCKWISE)]
                    m = plog.mark()
                    bcap = RaceCapture(["blockwise_fixpoint"],
                                       thread="MainThread")
                    with bcap:
                        batch = driver.solve_problems(cats, device="cuda")
                    rep = telemetry.last_report()
                    evs = plog.since(m, thread="MainThread")
                    ledger_sums("blockwise", rep, evs)
                    bcap.submit(plain, "optimize blockwise",
                                need=["blockwise_fixpoint"])
                    # The CPU hold of a blockwise event: the first catalog
                    # dispatched alone (its plain solve on the CPU takes
                    # minutes on one core; all 8 would take the pool's
                    # every core for as long).  Its steps equal its lane's
                    # in the batch: a lane's steps do not depend on its
                    # batchmates.
                    m = plog.mark()
                    (one,) = driver.solve_problems(cats[:1], device="cuda")
                    evs1 = plog.since(m, thread="MainThread")
                    ledger_sums("blockwise alone", telemetry.last_report(),
                                evs1)
                    if int(one.steps) != int(batch[0].steps):
                        fail(f"optimize profile blockwise: the catalog's "
                             f"steps alone {int(one.steps)} != in the batch "
                             f"{int(batch[0].steps)}")
                    held.append(("blockwise", plog.ledgers[m[1]:], evs1,
                                 "blockwise"))
                finally:
                    core.set_bcp_impl("auto")
                # The host site: one host flush of one tenant.
                hs = Scheduler(backend="host", cache_size=0,
                               registry=telemetry.Registry())
                m = plog.mark()
                hs.submit(fleet[:16], tenant="solo")
                evs = plog.since(m)
                if [(e["backend"], e.get("tenant"), e["lanes"])
                        for e in evs] != [("host", "solo", 16)]:
                    fail(f"optimize profile host: events {evs}")
                # The warm site: a churn replay's warm flushes.
                ws = Scheduler(device="cuda", registry=telemetry.Registry())
                ws.start()
                try:
                    reqs = churn_requests()
                    lo = 0
                    for n in OPT_CHURN:
                        ws.submit(reqs[lo:lo + n], tenant="churn")
                        lo += n
                finally:
                    ws.stop()
                # The hostpool site: one scripted dead-card fallback.
                os.environ["DEPPY_GPU_BREAKER_THRESHOLD"] = "1000"
                faults.set_default_breaker(None)
                before = _fault_snapshot()
                faults.configure_plan(faults.plan_from_spec(
                    '[{"point": "driver.dispatch", "times": -1}]'))
                try:
                    out = driver.solve_problems([encode(fleet[0])],
                                                device="cuda")
                finally:
                    faults.configure_plan(None)
                d = _delta(before, _fault_snapshot())
                scripted["failures"] += d["fault_failures"]
                scripted["host_routed"] += d["fault_host_routed"]
                if d["fault_host_routed"] != 1 or out[0].outcome != core.SAT:
                    fail(f"optimize profile hostpool: {d}")
                return None

            _, counts = window(profiled)
            sites = plog.check_sites("profiler", mark)
            # The sampling check's warm scheduler, seeded at rate 1.0 so
            # that each site below sees exactly 4 dispatches.
            ws = Scheduler(device="cuda", registry=telemetry.Registry())
            reqs = churn_requests()
            ws.submit(reqs[:1])
            numbers["profile"] = dict(
                walls=walls, sites=sites, launches=counts,
                armed_over_disarmed=(statistics.median(walls["on"])
                                     / statistics.median(walls["off"])))
            # The blockwise catalogs' CPU solves are the longest pool
            # tasks: first in the queue.
            held.sort(key=lambda h: h[3] != "blockwise")
            for label, ledgers, evs, impl in held:
                if len(ledgers) != len(evs):
                    fail(f"optimize profile {label}: {len(ledgers)} ledgers "
                         f"for {len(evs)} events")
                for lg, ev in zip(ledgers, evs):
                    hold_ledger(plain, label, lg, ev, impl)
            print(f"optimize profile: the {len(fleet)}-lane gvk_fleet wall "
                  f"disarmed {walls['off'][0]:.4f}, {walls['off'][1]:.4f} s, "
                  f"armed {walls['on'][0]:.4f}, {walls['on'][1]:.4f} s "
                  f"(armed/disarmed medians "
                  f"{numbers['profile']['armed_over_disarmed']:.4f}); "
                  f"sites [calls, sampled, events] {sites}; the reports' "
                  f"ledger fields equal their events' sums; launches "
                  + " ".join(f"{k}={counts[k]}" for k in engine.KERNELS)
                  + f" [{card}]", flush=True)

            # Sampling: 4 dispatches a site at 0.25, exactly 1 profiled.
            mark = plog.mark()

            def sampling():
                with profile.override("on", OPT_SAMPLE):
                    for _ in range(4):
                        driver.solve_problems(
                            [encode(s) for s in fleet[:4]], device="cuda")
                    hs = Scheduler(backend="host", cache_size=0,
                                   registry=telemetry.Registry())
                    for i in range(4):
                        hs.submit(fleet[4 * i:4 * i + 4])
                    for r in reqs[1:5]:
                        ws.submit([r])
                    before = _fault_snapshot()
                    faults.configure_plan(faults.plan_from_spec(
                        '[{"point": "driver.dispatch", "times": -1}]'))
                    try:
                        for i in range(4):
                            driver.solve_problems([encode(fleet[i])],
                                                  device="cuda")
                    finally:
                        faults.configure_plan(None)
                    d = _delta(before, _fault_snapshot())
                    scripted["failures"] += d["fault_failures"]
                    scripted["host_routed"] += d["fault_host_routed"]

            _, counts = window(sampling)
            sample = plog.check_sites("sampling", mark)
            for site, (calls, sampled, _) in sample.items():
                if calls != 4 or sampled != 1:
                    fail(f"optimize sampling: {site} sampled {sampled} of "
                         f"{calls} at {OPT_SAMPLE}")
            numbers["sampling"] = sample
            print(f"optimize sampling at {OPT_SAMPLE}: [calls, sampled, "
                  f"events] {sample} [{card}]", flush=True)
    finally:
        reg.configure_sink(prev_sink)
        host.stop()
        faults.configure_plan(None)
        core.set_bcp_impl("auto")
        _restore_env(env0, env_keys)
        faults.set_default_breaker(None)
    # The sink read back through the port's report: every event the
    # phase emitted is there.
    summary = report.summarize(sink)
    shutil.rmtree(sink_dir, ignore_errors=True)
    numbers["summary"] = summary
    print("optimize profile report:\n" + report.render_text(summary, sink),
          flush=True)
    evs = [ev for _, ev in plog.events]
    want = (sum(e["kind"] == "profile" for e in evs),
            sum(e["kind"] == "profile" and "trips" in e for e in evs),
            sum(e["kind"] == "optimize" for e in evs))
    got = (summary["profile_events"], summary["device_dispatches"],
           sum(a["probes"] for a in summary["optimize"].values()))
    if got != want:
        fail(f"optimize: the sink's report counts (profile events, device "
             f"dispatches, probes) {got}, the phase emitted {want}")
    if faults.default_breaker().state() != "closed":
        fail("optimize: the breaker is not closed after the phase")
    seconds = time.perf_counter() - t_phase
    numbers.update(seconds=seconds, scripted=dict(scripted))
    print(f"optimize path: {seconds:.1f} s; scripted failures "
          f"{scripted['failures']}, host-routed lanes "
          f"{scripted['host_routed']}; launches {launches}", flush=True)
    return launches, numbers, scripted


SPEC_WORKLOAD = (16, 5, 8, 16)  # families, rounds, bundles, bundle size: the reference's defaults
SPEC_PASSES = 2                 # passes A (off) and B (on), each; the lower p99 is kept
SPEC_FANOUT = 256               # pass C: families, 2**8 (every distinct fingerprint)
SPEC_LIVE_ROUND = 2             # pass C: the live request rides round 3's drain
SPEC_SETTLE_S = 0.25            # pass B: the settle beat after the backlog empties
SPEC_DRAIN_TIMEOUT_S = 60.0


def spec_drained(sched) -> bool:
    """No pre-solve queued and none dequeued but not yet stored (a
    dispatch releases its lanes' in-flight keys after it stores them)."""
    with sched._cv:
        return not (sched._spec_depth or sched._spec_keys)


def spec_wait(sched, stored: bool) -> float:
    """Seconds until the backlog empties (``stored``: until every
    pre-solve is stored as well); fails past the timeout."""
    t0 = time.perf_counter()
    done = (lambda: spec_drained(sched)) if stored else (
        lambda: sched.speculative_depth() == 0)
    while not done():
        if time.perf_counter() - t0 > SPEC_DRAIN_TIMEOUT_S:
            fail(f"speculate: the backlog did not drain in "
                 f"{SPEC_DRAIN_TIMEOUT_S} s")
        time.sleep(0.002)
    return time.perf_counter() - t0


def spec_metrics(label: str, reg, published) -> dict:
    """The speculation families of one scheduler's registry, held
    against the ``publish()`` returns: the backlog gauge 0, presolves
    the queued sum, dropped the dropped sum."""
    snap = reg.snapshot()
    got = {k: snap.get(f"deppy_speculate_{k}", 0)
           for k in ("backlog", "presolves_total", "dropped_total",
                     "publishes_total", "affected_total")}
    want = dict(backlog=0,
                presolves_total=sum(o["queued"] for o in published),
                dropped_total=sum(o["dropped"] for o in published),
                publishes_total=len(published),
                affected_total=sum(o["affected"] for o in published))
    if got != want:
        fail(f"speculate {label}: the registry holds {got}, the publishes "
             f"returned {want}")
    return got


def spec_replay(phase: str, speculate: bool) -> dict:
    """The reference's publish-churn pass (``deppy_tpu/benchmarks/
    publish.py:102-153``) on ``Scheduler(device="cuda")`` with the
    incremental tier on: warm-up queries, then rounds of publish (on
    only: then the backlog empties and a settle beat), every family
    re-asking its post-publish problem through ``submit``."""
    from deppy_tpu_torch import io, telemetry
    from deppy_tpu_torch.models import catalog_family, round_delta
    from deppy_tpu_torch.sched import Scheduler

    n_fam, rounds, n_bundles, size = SPEC_WORKLOAD
    reg = telemetry.Registry()
    sched = Scheduler(device="cuda", speculate="on" if speculate else "off",
                      registry=reg)
    sched.start()
    try:
        families = [catalog_family(phase, f, n_bundles, size)
                    for f in range(n_fam)]
        for fam in families:
            sched.submit([fam])
        latencies, rendered, published = [], [], []
        hits, drain_s = 0, 0.0
        t_pass = time.perf_counter()
        for rnd in range(rounds):
            delta = round_delta(phase, rnd, n_bundles, size)
            if speculate:
                published.append(sched.speculate.publish(delta))
                drain_s += spec_wait(sched, stored=False)
                time.sleep(SPEC_SETTLE_S)
                drain_s += SPEC_SETTLE_S
                if reg.snapshot()["deppy_speculate_backlog"] != 0:
                    fail(f"speculate {phase}: the backlog gauge is not 0 "
                         f"after the drain")
            for f in range(n_fam):
                applied = delta.apply(families[f])
                if applied is not None:
                    families[f] = list(applied)
                st: dict = {}
                t0 = time.perf_counter()
                (res,) = sched.submit([families[f]], stats=st)
                latencies.append(time.perf_counter() - t0)
                hits += st["steps"] == 0 and st["report"] is None
                if isinstance(res, dict):
                    check_solution(families[f], res)
                else:
                    fail(f"speculate {phase}: a re-ask answered {res!r}")
                rendered.append(io.result_to_dict(res))
        wall = time.perf_counter() - t_pass
        if speculate:
            spec_metrics(phase, reg, published)
        elif sched.speculate is not None:
            fail("speculate: speculate=\"off\" built a manager")
    finally:
        sched.stop()
    return dict(
        queries=len(latencies), p50_ms=_pct(latencies, 0.5) * 1e3,
        p99_ms=_pct(latencies, 0.99) * 1e3,
        hit_ratio=hits / max(len(latencies), 1), wall_s=wall,
        drain_wait_s=drain_s, published=published,
        normalized=json.dumps(rendered, sort_keys=True).replace(
            f"{phase}.", ""))


def run_speculate_path(scale: float, plain: "PlainPool"):
    """Speculative pre-resolution on the card (the module docstring's
    phase 4j): the reference's publish-churn replay with the tier off
    (A) and on (B), then the fan-out on the card (C).  Runs at its full
    size at every ``scale``.  Returns the path's launches and its
    numbers."""
    import torch

    from deppy_tpu_torch import engine, faults, io, telemetry
    from deppy_tpu_torch.models import catalog_family, round_delta
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat.encode import encode
    from deppy_tpu_torch.sat.errors import NotSatisfiable
    from deppy_tpu_torch.sched import Scheduler, fingerprint
    from deppy_tpu_torch.speculate import PublishDelta

    t_phase = time.perf_counter()
    card = card_line()
    print(f"speculate timings on {card}", flush=True)
    numbers = {}
    torch.cuda.synchronize()
    engine.reset_launch_counts()

    # A and B: the replay, off then on, two passes each.
    with SpecLog() as slog:
        passes = {"off": [], "on": []}
        for mode in ("off", "on"):
            for p in range(SPEC_PASSES):
                passes[mode].append(spec_replay(f"{mode}{p}", mode == "on"))
        b_flushes = len(slog.check("speculate B", None))
    norms = {r["normalized"] for rs in passes.values() for r in rs}
    if len(norms) != 1:
        fail("speculate A/B: the rendered responses differ between the "
             "passes with the tier off and on")
    best = {m: min(rs, key=lambda r: r["p99_ms"]) for m, rs in passes.items()}
    if best["on"]["hit_ratio"] < 0.9:
        fail(f"speculate B: hit ratio {best['on']['hit_ratio']} < 0.9")
    ratio = best["off"]["p99_ms"] / max(best["on"]["p99_ms"], 1e-9)
    for m, rs in passes.items():
        numbers[m] = [{k: v for k, v in r.items() if k != "normalized"}
                      for r in rs]
    numbers["vs_baseline"] = ratio
    n_fam, rounds, n_bundles, size = SPEC_WORKLOAD
    print(f"speculate A/B: {n_fam} families x {rounds} rounds of "
          f"catalog_family(., f, {n_bundles}, {size}) re-asks "
          f"({best['on']['queries']} a pass), {SPEC_PASSES} passes each: "
          f"off p50 {best['off']['p50_ms']:.3f} ms p99 "
          f"{best['off']['p99_ms']:.3f} ms (passes "
          + ", ".join(f"{r['p99_ms']:.3f}" for r in passes["off"])
          + f"); on p50 {best['on']['p50_ms']:.3f} ms p99 "
          f"{best['on']['p99_ms']:.3f} ms (passes "
          + ", ".join(f"{r['p99_ms']:.3f}" for r in passes["on"])
          + f"); off/on p99 {ratio:.3f}; on hit ratio "
          f"{best['on']['hit_ratio']:.4f} (passes "
          + ", ".join(f"{r['hit_ratio']:.4f}" for r in passes["on"])
          + f"), drain wait {best['on']['drain_wait_s']:.3f} s "
          f"({SPEC_SETTLE_S} s settle a round included); {b_flushes} idle "
          f"flushes, none with a live lane queued; responses equal off and "
          f"on [{card}]", flush=True)

    # C: the fan-out on the card, every pre-solve a cold dispatch.
    reg = telemetry.Registry()
    sched = Scheduler(device="cuda", speculate="on", incremental="off",
                      registry=reg)
    sched.start()
    rounds_c, published, live, live_key = [], [], {}, None
    fams = [catalog_family("fan", f, n_bundles, size)
            for f in range(SPEC_FANOUT)]
    deltas = [round_delta("fan", r, n_bundles, size) for r in range(rounds)]
    deltas.append(PublishDelta.from_doc({"removed": ["fan.b0v1"]}))
    want_core = None
    try:
        sched.submit(fams)
        cap = RaceCapture(INC_KERNELS, thread=SCHED_LOOP)
        with SpecLog() as slog, cap, DispatchLog() as dlog:
            for rnd, delta in enumerate(deltas):
                t0 = time.perf_counter()
                out = sched.speculate.publish(delta)
                published.append(out)
                if rnd == SPEC_LIVE_ROUND:
                    live["in_flight"] = not spec_drained(sched)
                    req = catalog_family("live", 1, n_bundles, size)
                    live_key = fingerprint(encode(req))
                    t1 = time.perf_counter()
                    (res,) = sched.submit([req])
                    live["latency_s"] = time.perf_counter() - t1
                    check_solution(req, res)
                spec_wait(sched, stored=True)
                wall = time.perf_counter() - t0
                if reg.snapshot()["deppy_speculate_backlog"] != 0:
                    fail("speculate C: the backlog gauge is not 0 after "
                         "the drain")
                got = []
                for f in range(SPEC_FANOUT):
                    applied = delta.apply(fams[f])
                    if applied is not None:
                        fams[f] = list(applied)
                    st: dict = {}
                    (res,) = sched.submit([fams[f]], stats=st)
                    if st["steps"] != 0 or st["report"] is not None:
                        fail(f"speculate C round {rnd + 1}: a re-ask took "
                             f"{st['steps']} steps (report "
                             f"{st['report'] is not None})")
                    got.append(res)
                cold = BatchResolver(device="cuda").solve(fams)
                dumps = [json.dumps(io.result_to_dict(r), sort_keys=True)
                         for r in got]
                bad = sum(a != json.dumps(io.result_to_dict(b),
                                          sort_keys=True)
                          for a, b in zip(dumps, cold))
                if bad:
                    fail(f"speculate C round {rnd + 1}: {bad} re-asks "
                         f"differ from the cold card solve")
                unsat = 0
                for vs, res in zip(fams, got):
                    if isinstance(res, dict):
                        check_solution(vs, res)
                    elif isinstance(res, NotSatisfiable):
                        unsat += 1
                        core = sorted(str(ac) for ac in res.constraints)
                        idents = {ac.variable.identifier
                                  for ac in res.constraints}
                        if (len(core) != 3
                                or idents != {"fan.b0v0", "fan.b0v1"}):
                            fail(f"speculate C round {rnd + 1}: core {core}")
                        want_core = core
                    else:
                        fail(f"speculate C round {rnd + 1}: {res!r}")
                withdrawal = rnd == len(deltas) - 1
                if unsat != (SPEC_FANOUT if withdrawal else 0):
                    fail(f"speculate C round {rnd + 1}: {unsat} UNSAT "
                         f"re-asks")
                rounds_c.append(dict(wall_s=wall, unsat=unsat, **out))
        drains = slog.check("speculate C", sched)
        spec_metrics("C", reg, published)
        if any(o["dropped"] for o in published):
            fail(f"speculate C: pre-solves dropped under the "
                 f"{sched.spec_max_backlog}-lane cap: "
                 f"{[o['dropped'] for o in published]}")
    finally:
        sched.stop()
    torch.cuda.synchronize()
    launches = dict(engine.launch_counts())
    # The loop's card dispatches of C's window, the live request's
    # aside: the idle flushes.
    idle = [c for c in dlog.calls if c["thread"] == SCHED_LOOP
            and live_key not in c["keys"]]
    by_kernel = {k: sum(c["launches"][k] for c in idle)
                 for k in engine.KERNELS}
    missing = [k for k in INC_KERNELS if by_kernel[k] <= 0]
    if missing:
        fail(f"speculate C: the idle flushes never launched {missing}")
    if len(idle) != len(drains):
        fail(f"speculate C: {len(drains)} idle flushes, {len(idle)} card "
             f"dispatches of pre-solves")
    cap.submit(plain, "speculate idle flush")
    if faults.default_breaker().state() != "closed":
        fail("speculate: the breaker is not closed after the phase")
    lanes = [d["lanes"] for d in drains]
    numbers["C"] = dict(rounds=rounds_c, idle_flushes=len(drains),
                        lanes_per_flush=lanes, launches_idle=by_kernel,
                        live=live, core=want_core)
    print(f"speculate C: {SPEC_FANOUT} families, {rounds} rounds and a "
          f"withdrawal of fan.b0v1, tier incremental off: queued a round "
          f"{[r['queued'] for r in rounds_c]}, dropped "
          f"{[r['dropped'] for r in rounds_c]}; publish-to-drained wall "
          f"a round (s) {[round(r['wall_s'], 4) for r in rounds_c]}; "
          f"{len(drains)} idle flushes, lanes {lanes}, none with a live "
          f"lane queued; idle-flush launches " + " ".join(
              f"{k}={by_kernel[k]}" for k in engine.KERNELS)
          + f"; every re-ask a cache hit (0 steps, no report) equal to the "
          f"cold card solve, the withdrawal's cores {want_core}; a live "
          f"request during round {SPEC_LIVE_ROUND + 1}'s drain (pre-solves "
          f"in flight: {live.get('in_flight')}) took "
          f"{live.get('latency_s', 0.0) * 1e3:.3f} ms [{card}]",
          flush=True)
    seconds = time.perf_counter() - t_phase
    numbers["seconds"] = seconds
    print(f"speculate path: {seconds:.1f} s; launches {launches} "
          f"[{card}]", flush=True)
    return launches, numbers


def _stage1_budget(groups, max_share: float) -> int:
    """The smallest stage-1 budget (a step count of the baseline) that
    strands at most ``max_share`` of every group's lanes, and some lanes
    of one: the compacted redo.  Fails when the steps allow none."""
    for c in sorted({x for g in groups for x in g}):
        out = [sum(x > c for x in g) for g in groups]
        if all(k <= max_share * len(g) for k, g in zip(out, groups)):
            if not any(out):
                break
            return c
    fail("faults 8: no stage-1 budget strands a few lanes of a group")


def _restore_env(env0: dict, keys) -> None:
    for k in keys:
        if env0[k] is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = env0[k]


def doc_size(doc) -> str:
    """'N variables, M constraints' of a document."""
    vs = doc["variables"]
    return (f"{len(vs)} variables, "
            f"{sum(len(v.get('constraints') or ()) for v in vs)} constraints")


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
        resolver = BatchResolver(device="cuda")
        resolver.solve(pool)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        split = driver_split(resolver.last_report)
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
    print(f"  driver split (unprofiled run): {_split_text(split)}; device "
          f"busy {device_ms:.3f} ms (profiled run)", flush=True)
    for key, ms, n in rows[:8]:
        print(f"  device {ms:9.3f} ms  x{n:<5d} {key[:90]}", flush=True)
    return dict(family=name, impl=impl, problems=len(pool), wall_ms=wall_ms,
                device_ms=device_ms, split_ms=split,
                top=[dict(kernel=k[:90], ms=ms, calls=n)
                     for k, ms, n in rows[:8]])


def profile_chunk(scale: float, impl: str = "auto") -> dict:
    """One main-path chunk (512 problems) of the headline fleet."""
    name, count, make = families(scale)[0]
    return profile_solve(name, [make(i) for i in range(min(count, 512))],
                         impl=impl)


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
    kernel's launches, so a pass's time is over the launches it kept,
    and passes are added, up to three times as many, while it has kept
    none), and the whole wrapper call (the host work that prepares the launch
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
    # Up to 3x the passes while the profiler has kept no launch at all.
    while len(kept) < TIMED_PASSES or (not passes
                                       and len(kept) < 3 * TIMED_PASSES):
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


def _plain_work() -> dict:
    """The plain versions' work so far in this process: propagation
    rounds (``core.plain_rounds``) and the watched fixpoint's pops, the
    live rows they visited, those rows' live literals and the AtMost
    entries of its true pops (``clause_bank.plain_work``)."""
    from deppy_tpu_torch.engine import clause_bank, core

    return dict(rounds=core.plain_rounds, **clause_bank.plain_work)


def _work_since(w0: dict) -> dict:
    return {k: v - w0[k] for k, v in _plain_work().items()}


def _plain_task(module: str, fn: str, args, kwargs):
    """Run one plain version on CPU tensors in a worker process: its
    outputs, the work it did (:func:`_plain_work`) and the seconds it
    took."""
    import importlib

    import torch

    torch.set_num_threads(1)
    mod = importlib.import_module(f"deppy_tpu_torch.engine.{module}")
    w0 = _plain_work()
    t0 = time.perf_counter()
    out = [x.numpy() for x in getattr(mod, fn)(*args, **kwargs)]
    return out, _work_since(w0), time.perf_counter() - t0


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
        # Checks of other pool work (``pool.submit`` futures), run by
        # :meth:`check` after the comparisons.
        self.calls = []
        # Per checked job: the plain version's work (:func:`_plain_work`)
        # and ms, summed over its tasks, each on one CPU core.
        self.stats = {}

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

        for label, got, futures in self.jobs:
            parts = [f.result() for f in futures]
            want = [torch.from_numpy(np.concatenate(o))
                    for o in zip(*[p[0] for p in parts])]
            _same(*label, got, want)
            self.stats[label] = dict(
                {k: sum(p[1][k] for p in parts) for k in parts[0][1]},
                plain_ms=sum(p[2] for p in parts) * 1e3)
        n = len(self.jobs) + len(self.calls)
        for done in self.calls:
            done()
        self.jobs, self.calls = [], []
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


# The lanes of a big family the arms are compared on, and the step budget
# of its phases there (their plain versions run in the pool, one CPU core
# a task: some 0.3-1 s a dense entry round on the giant).
ARM_BIG_LANES = 8
ARM_BIG_BUDGET = 12

# The kernels whose block kernels carry the arms, and the phase wrappers'
# names.
ARM_KERNELS = ("bcp_fixpoint", "search", "minimize", "core")


def arm_batch(probs, d, B: int, impl: str):
    """``B`` lanes of a family on the card, padded to its main-path dims
    ``d``, with what both sides of a comparison read under ``impl``: the
    dense planes of both spaces (the plain versions' entry rounds) and,
    under watched, the banks of both spaces as the driver derives them
    (every family of the path gets real banks, or this fails)."""
    import torch

    from deppy_tpu_torch.engine import core, driver

    pts = driver._upload(driver.pad_stack(probs[:B], d, B),
                         torch.device("cuda"))
    pts = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=True, full=True)
    if impl == "watched":
        if d.Ob > driver._bank_cap(d):
            fail(f"a bank of width {d.Ob} passes its cap "
                 f"{driver._bank_cap(d)}")
        pts = driver._derive_banks(pts, d, red=True, full=True)
    return pts


def arm_bcp_inputs(pts, d, impl: str, en):
    """Kernel 1's arguments as phase 1's baseline gives them under
    ``impl`` (the reduced space under watched, else the full one), and
    the arm it runs."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_search

    if impl == "watched":
        return (bcp_inputs(pts, d.NV, d.Wr, en),
                cuda_search.launch_arm(pts, impl, True, d.Wr))
    B = en.shape[0]
    V = d.NV + d.NCON
    base = core._apply_anchors(pts, core._base_assignment(pts, V, d.NCON), V)
    zero = torch.zeros((B, d.Wv), dtype=torch.int32, device=en.device)
    args = (pts.pos_bits, pts.neg_bits, pts.card_member_bits,
            cuda_search.full_activity(pts, base).to(torch.int32),
            pts.card_n, zero, zero[:, 0].contiguous(),
            core.pack_mask(base == core.TRUE, d.Wv),
            core.pack_mask(base == core.FALSE, d.Wv), en.to(torch.int32))
    return args, cuda_search.launch_arm(pts, impl, False, d.Wv)


def _arm_rows(arm, W: int):
    """The compact rows of an arm's space: the entry round's (watched, on
    the card) or built here (the gather rounds' full space)."""
    from deppy_tpu_torch.engine import cuda_blockwise

    return arm.rows or cuda_blockwise.compact_rows(
        arm.clauses, arm.card_ids, W, arm.n_vars if arm.red else None)


def _arm_bytes(arm, dense, W: int, work: dict) -> int:
    """Bytes of its clause set that a launch under ``arm`` must move: the
    dense planes ``dense`` without an arm; with one, the clause set of its
    space once in its smaller form (the planes or the compact rows and
    members) and ``n_vars``, and under watched the bank entries its pops
    visited (``work``, the plain version's count over every lane: each
    live occurrence row and AtMost entry once), at most the whole bank."""
    if arm is None:
        return _nbytes(*dense)
    rows = _arm_rows(arm, W)
    need = (min(_nbytes(*dense), _nbytes(rows.lits, rows.mlits))
            + _nbytes(arm.n_vars))
    if arm.impl == "watched":
        need += min(_nbytes(arm.occ_pos, arm.occ_neg, arm.card_occ),
                    4 * (work["rows"] + work["cards"]))
    return need


def _arm_ops(arm, C: int, NA: int, W: int, work: dict) -> int:
    """32-bit operations of the fixpoints the plain version counted
    (``work``, over every lane): a dense round as :func:`_ops_per_round`;
    a gather round ~8 per live raw literal and AtMost member and ~10 per
    assignment word; a watched entry round ~8 per live compact literal and
    member and ~10 per word, and a pop ~8 per live literal of the rows it
    visited, ~4 per AtMost entry it counted and ~2 per word (the
    find-first over the pending planes)."""
    rounds = work["rounds"]
    if arm is None:
        return rounds * _ops_per_round(C, NA, W)
    B = arm.n_vars.shape[0]
    if arm.impl == "gather":
        slots = (int((arm.clauses != 0).sum())
                 + int((arm.card_ids >= 0).sum())) / B
        return int(rounds * (8 * slots + 10 * W))
    rows = _arm_rows(arm, W)
    lits = (int((rows.lits != 0).sum()) + int((rows.mlits != 0).sum())) / B
    return int(rounds * (8 * lits + 10 * W) + 8 * work["lits"]
               + 4 * work["cards"] + 2 * W * work["pops"])


def _need(arm, dense, W: int, C: int, NA: int, *tensors):
    """The function (plain version's work) -> (bytes, operations) of a
    launch under ``arm``: :func:`_arm_bytes` plus the bytes of
    ``tensors`` (its other inputs and its outputs), and
    :func:`_arm_ops`."""
    fixed = _nbytes(*tensors)
    return lambda work: (_arm_bytes(arm, dense, W, work) + fixed,
                         _arm_ops(arm, C, NA, W, work))


def compare_impls(scale: float, launches: dict, plain: PlainPool):
    """Each of kernels 1, 3, 4 and 5 under each arm of :data:`IMPL_ARMS`
    against its plain version on the same inputs, on 32 lanes of the
    small families (kernel 1's plain version on the card, the phases' in
    the pool) and :data:`ARM_BIG_LANES` of the big ones (the phases at
    :data:`ARM_BIG_BUDGET` steps, their plain versions in the pool; the
    giant not under pallas); each timed by the profiler.  Returns
    ({(kernel, impl): row}, the pool labels whose plain numbers complete
    the rows, see :func:`finish_impl_rows`)."""
    import torch

    from deppy_tpu_torch.engine import core, cuda_bcp, cuda_search, driver
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.sat.encode import encode

    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    rows, pending, jobs = {}, {}, []
    t_all = time.perf_counter()

    def submit(*args, **kwargs):
        jobs.append((args, kwargs))
    print(f"clocks before the arms' timings: {clock_line()}", flush=True)
    small = families(scale) + [
        ("forced_extras", COMPARE_LANES, forced_extras),
        ("operatorhub", COMPARE_LANES, operatorhub_lanes)]
    big = [("operatorhub_batch", ARM_BIG_LANES,
            lambda i: operatorhub_catalog(*BATCH, seed=i)),
           ("giant", 1, lambda i: operatorhub_catalog(*GIANT, seed=0))]
    for name, count, make in small + big:
        is_big = name in {n for n, _, _ in big}
        probs = [encode(make(i)) for i in range(min(count, driver.MAX_LANES))]
        d = driver._Dims(probs, len(probs))
        B = min(len(probs), ARM_BIG_LANES if is_big else COMPARE_LANES)
        en = torch.ones(B, dtype=torch.bool, device=dev)
        for impl in IMPL_ARMS:
            if impl == "pallas" and name == "giant":
                print("kernels under pallas on giant: not compared (the "
                      "dense rounds on 8,192 x 768-word planes)", flush=True)
                continue
            pts = arm_batch(probs, d, B, impl)
            red = impl == "watched"
            W = d.Wr if red else d.Wv
            kw = dict(impl=impl, NCON=d.NCON)
            print(f"compare {impl} {name}: {B} lanes, C {d.C} K {d.K} NA "
                  f"{d.NA} NV {d.NV} NCON {d.NCON} W {W} Ob {d.Ob} Oc "
                  f"{d.Oc}", flush=True)

            def record(kernel, got, timing, pl, need):
                """One arm's time and comparison; ``pl`` (plain ms, its
                work, its outputs) or None when the pool's numbers
                complete it (:func:`finish_impl_rows`); ``need`` as
                :func:`_need` gives it."""
                row = rows.setdefault((kernel, impl),
                                      dict(max_abs_err=0, families={}))
                fam = dict(ms=timing[0], wrapper_ms=timing[1],
                           launches=launches[impl][kernel], need=need)
                row["families"][name] = fam
                print(f"kernel {kernel} under {impl} on {name}: timed at "
                      f"{time.perf_counter() - t_all:.1f} s", flush=True)
                if pl is not None:
                    pms, work, want = pl
                    bad, err = _mismatch(got, want)
                    if bad:
                        fail(f"kernel {kernel} under {impl} disagrees with "
                             f"its plain version on {name} ({bad} elements)")
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    _arm_bound(fam, work, pms, "cuda")
                    print(f"kernel {kernel} under {impl} on {name}: "
                          f"launches {fam['launches']} ms {fam['ms']:.4f} "
                          f"wrapper_ms {fam['wrapper_ms']:.4f} plain_ms "
                          f"{pms:.3f} mismatches {bad} max_abs_err {err} "
                          f"{_work_line(fam)}", flush=True)
                return fam

            # Kernel 1: phase 1's baseline fixpoint, plain on the card.
            k1, arm = arm_bcp_inputs(pts, d, impl, en)
            C, NA = d.C, d.NA
            got, *timing = _timed(
                lambda: cuda_bcp.bcp_fixpoint(*k1, impl=impl, arm=arm),
                "bcp_fixpoint", TIMED_REPS)
            w0 = _plain_work()
            want, pms, _ = _timed_plain(
                lambda: cuda_bcp.bcp_fixpoint_plain(*k1, arm=arm))
            record("bcp_fixpoint", got, timing,
                   (pms, _work_since(w0), want),
                   _need(arm, k1[:3], W, C, NA, *k1[3:], *got))

            # Kernels 3-5: full budget on the small families (timed, the
            # plain versions in the pool); on the big ones the search timed
            # once at the full budget, then every phase at a cut budget
            # against the pool.
            arm3 = cuda_search.launch_arm(pts, impl, red, W)
            arm5 = cuda_search.launch_arm(pts, impl, False, d.Wv)
            dense = ((pts.pos_bits_r, pts.neg_bits_r,
                      pts.card_member_bits_r) if red else
                     (pts.pos_bits, pts.neg_bits, pts.card_member_bits))
            dense5 = (pts.pos_bits, pts.neg_bits, pts.card_member_bits)
            ins3 = (pts.card_n, pts.choice_cand, pts.var_choices,
                    pts.anchors)
            ins5 = (pts.card_n, pts.card_act, pts.n_cons)
            if is_big:
                srch, ms, wrap = _timed_once(
                    lambda: cuda_search.batched_search_fused(pts, budget, en,
                                                             **kw), "search")
                steps = int(srch[3].sum())
                rows.setdefault(("search", impl), dict(
                    max_abs_err=0, families={}))["families"][name] = dict(
                        ms=ms, wrapper_ms=wrap, steps=steps,
                        ms_per_step=ms / max(steps, 1),
                        launches=launches[impl]["search"])
                print(f"kernel search under {impl} on {name}: ms {ms:.3f} "
                      f"wrapper_ms {wrap:.3f} steps {steps} ms per step "
                      f"{ms / max(steps, 1):.6f} (at "
                      f"{time.perf_counter() - t_all:.1f} s)", flush=True)
                what = f"{impl}, {B} lanes, budget {ARM_BIG_BUDGET}"
                s_args = (pts, ARM_BIG_BUDGET, en)
                got = cuda_search.batched_search_fused(*s_args, **kw)
                submit(("search", name, what), got, "cuda_search",
                             "batched_search_plain", s_args, kw, B, chunk=1)
                result, guessed, model = srch[:3]
                zero = torch.zeros(B, dtype=torch.int32, device=dev)
                m_args = (pts, result, model, guessed, ARM_BIG_BUDGET,
                          zero, en)
                got = cuda_search.batched_minimize_fused(*m_args, **kw)
                submit(("minimize", name, what), got, "cuda_search",
                             "batched_minimize_plain", m_args, kw, B, chunk=1)
                en_c = en & (result == core.UNSAT)
                if bool(en_c.any()):
                    c_args = (pts, ARM_BIG_BUDGET, zero, en_c)
                    got = cuda_search.batched_core_fused(*c_args, **kw)
                    submit(("core", name, what), got, "cuda_search",
                                 "batched_core_plain", c_args, kw, B, chunk=1)
                continue
            what = f"{impl}, {B} lanes, full budget"
            s_args = (pts, budget, en)
            got, *timing = _timed(
                lambda: cuda_search.batched_search_fused(*s_args, **kw),
                "search", TIMED_REPS)
            label = ("search", name, what)
            submit(label, got, "cuda_search", "batched_search_plain",
                         s_args, kw, B)
            pending[label] = record("search", got, timing, None,
                                    _need(arm3, dense, W, C, NA, *ins3, *got))
            result, guessed, model, steps = got[:4]
            m_args = (pts, result, model, guessed, budget, steps, en)
            got, *timing = _timed(
                lambda: cuda_search.batched_minimize_fused(*m_args, **kw),
                "minimize", TIMED_REPS)
            label = ("minimize", name, what)
            submit(label, got, "cuda_search", "batched_minimize_plain",
                         m_args, kw, B)
            pending[label] = record("minimize", got, timing, None, _need(
                arm3, dense, W, C, NA, *ins3, result, model, guessed, steps,
                *got))
            en_pad = en.clone()
            en_pad[-max(1, B // 4):] = False
            tight = (pts, 17, en_pad)
            submit(("search", name, f"{impl}, budget 17, padding "
                          f"lanes"), cuda_search.batched_search_fused(
                              *tight, **kw), "cuda_search",
                         "batched_search_plain", tight, kw, B)
            en_c = en & (result == core.UNSAT)
            if not bool(en_c.any()):
                print(f"kernel core under {impl} on {name}: no UNSAT lane",
                      flush=True)
                continue
            c_args = (pts, budget, steps, en_c)
            got, *timing = _timed(
                lambda: cuda_search.batched_core_fused(*c_args, **kw),
                "core", TIMED_REPS)
            label = ("core", name, what)
            submit(label, got, "cuda_search", "batched_core_plain",
                         c_args, kw, B)
            pending[label] = record("core", got, timing, None, _need(
                arm5, dense5, d.Wv, C, NA, *ins5, steps, en_c, *got))
    torch.cuda.synchronize()
    for args, kwargs in jobs:
        plain.submit(*args, **kwargs)
    print(f"arms on the card done in {time.perf_counter() - t_all:.1f} s; "
          f"{len(jobs)} plain jobs to the pool", flush=True)
    return rows, pending


def _arm_bound(fam: dict, work: dict, plain_ms: float, plain_on: str):
    """Complete an arm's row ``fam`` with its plain version's ms and work
    and the bound of the work it counted (``fam``'s ``need``)."""
    fam.update(plain_ms=plain_ms, plain_on=plain_on, **{
        k: work[k] for k in ("rounds", "pops", "rows", "lits", "cards")})
    fam["bytes"], ops = fam.pop("need")(work)
    fam["bound_ms"], fam["bound_by"] = _bound(fam["bytes"], ops)


def _work_line(fam: dict) -> str:
    return (f"rounds {fam['rounds']} pops {fam['pops']} visited rows "
            f"{fam['rows']} lits {fam['lits']} cards {fam['cards']} bytes "
            f"{fam['bytes']} bound_ms {fam['bound_ms']:.8f} "
            f"({fam['bound_by']})")


def finish_impl_rows(rows: dict, pending: dict, plain: PlainPool) -> None:
    """Complete the phase kernels' rows with their plain versions'
    numbers from the pool (checked by ``plain.check``): plain ms (CPU
    seconds summed over the tasks), the work and the bound."""
    for (kernel, family, what), fam in pending.items():
        st = plain.stats[(kernel, family, what)]
        _arm_bound(fam, st, st["plain_ms"], "cpu")
        print(f"kernel {kernel} ({what.split(',')[0]}) on {family}: "
              f"launches {fam['launches']} ms {fam['ms']:.4f} wrapper_ms "
              f"{fam['wrapper_ms']:.4f} plain_ms {st['plain_ms']:.1f} (cpu) "
              f"{_work_line(fam)}", flush=True)


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
    **{impl: ARM_KERNELS for impl in IMPL_ARMS},
    "tracing": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
                "core"),
    "sched": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
              "core"),
    "race": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
             "core"),
    "incremental": ("bcp_fixpoint", "search", "minimize", "core"),
    "sessions": ("bcp_fixpoint", "search", "minimize", "core"),
    "faults": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
               "core"),
    "optimize": ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
                 "core"),
    "speculate": INC_KERNELS,
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

        by_path, bits_keys = {}, {}
        by_path["bits"], per_family, main_answers = run_main_path(
            args.scale, bits_keys)
        stamp("bits path")
        (by_path["blockwise"], per_family_bw,
         bw_answers) = run_blockwise_path(args.scale, bits_keys)
        stamp("blockwise path")
        by_path["surface"], per_family["surface"] = run_surface_path(
            main_answers, bw_answers)
        del main_answers, bw_answers
        stamp("surface path")
        by_impl, per_family["impls"] = run_impls_path(args.scale, bits_keys)
        by_path.update(by_impl)
        del bits_keys
        stamp("impls path")
        by_path["tracing"], per_family["tracing"] = run_tracing_path()
        per_family["telemetry_sink"] = check_telemetry_sink(args.scale)
        stamp("tracing path")
        by_path["sched"], per_family["sched"] = run_sched_path(args.scale)
        stamp("sched path")
        by_path["race"], per_family["race"] = run_race_path(args.scale,
                                                            plain)
        stamp("race path")
        by_path["incremental"], per_family["incremental"] = \
            run_incremental_path(args.scale, plain)
        stamp("incremental path")
        by_path["sessions"], per_family["sessions"] = run_sessions_path(
            args.scale, plain)
        stamp("sessions path")
        by_path["faults"], per_family["faults"], scripted = run_faults_path(
            args.scale, plain)
        stamp("faults path")
        by_path["optimize"], per_family["optimize"], opt_scripted = \
            run_optimize_path(args.scale, plain)
        scripted = {k: v + opt_scripted[k] for k, v in scripted.items()}
        stamp("optimize path")
        by_path["speculate"], per_family["speculate"] = run_speculate_path(
            args.scale, plain)
        stamp("speculate path")
        per_family["profile"] = bits = profile_chunk(args.scale)
        per_family["profile_watched"] = watched = profile_chunk(
            args.scale, impl="watched")
        print(f"busy share of the {bits['problems']}-problem gvk_fleet "
              f"chunk: bits {bits['device_ms'] / bits['wall_ms']:.4f}, "
              f"watched {watched['device_ms'] / watched['wall_ms']:.4f}",
              flush=True)
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
        arm_rows, pending = compare_impls(args.scale, by_impl, plain)
        stamp("arms compared")
        trace_times = compare_trace_kernel(plain)
        stamp("trace kernel compared")
        t0 = time.perf_counter()
        n = plain.check()
        print(f"{n} comparisons against plain versions in the pool checked "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        finish_impl_rows(arm_rows, pending, plain)
        stamp("pool comparisons")
    finally:
        plain.close()
        from deppy_tpu_torch import hostpool
        from deppy_tpu_torch.sched import scheduler as sched_mod

        sched_mod._join_race_threads()
        hostpool.shutdown_default_pool()

    # The faults gate at the end of the run: the driver failures and
    # host-routed lanes of the whole run are exactly those the faults and
    # optimize phases scripted (a real launch failure anywhere fails the
    # run, even though the envelope answered it).
    snap = _fault_snapshot()
    seen = dict(failures=snap["deppy_fault_failures_total"],
                host_routed=snap["deppy_fault_host_routed_total"])
    print(f"faults gate: driver failures {seen['failures']}, host-routed "
          f"lanes {seen['host_routed']} in the run; scripted {scripted}",
          flush=True)
    if seen != scripted:
        fail(f"faults gate: the run counted {seen}, the faults and "
             f"optimize phases scripted {scripted}")

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

    for impl in IMPL_ARMS:
        missing = [k for k in ARM_KERNELS if (k, impl) not in arm_rows]
        if missing:
            fail(f"arms never compared under {impl}: {missing}")
    print("kernels (arms): " + " ".join(
        f"{k}/{impl}={by_path[impl][k]}" for impl in IMPL_ARMS
        for k in ARM_KERNELS), flush=True)

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
            **({"teams": rows[k]["teams"]} if "teams" in rows[k] else {}),
            **({"trace_ms": trace_times} if k == "search" else {})))
    for impl in IMPL_ARMS:
        for k in ARM_KERNELS:
            row = arm_rows[(k, impl)]
            m = row["families"][SUMMARY_FAMILY[k]]
            src, replaces = SOURCES[k]
            summary.append(dict(
                name=f"{k} ({impl})", route="cuda",
                source=(src if impl == "pallas"
                        else "deppy_tpu_torch/engine/csrc/watched.cuh"),
                replaces=replaces, launches=by_path[impl][k],
                max_abs_err=row["max_abs_err"], ms=m["ms"],
                wrapper_ms=m["wrapper_ms"], plain_ms=m["plain_ms"],
                plain_on=m.get("plain_on", "cuda"), bound_ms=m["bound_ms"],
                bound_by=m["bound_by"], library_ms=None,
                family=SUMMARY_FAMILY[k], by_family=row["families"]))
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
