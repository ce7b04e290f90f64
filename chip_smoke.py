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
   ``Solver(operatorhub_catalog(1000, 8)).solve()`` (the giant catalog,
   48 MiB of full-space clause planes), ``BatchResolver`` over 64
   ``operatorhub_catalog(250, 8)`` catalogs and 256 pinned-tenant states,
   and one 803-constraint UNSAT problem whose core the host engine
   extracts.  Each family of both paths prints its wall time, problems
   per second, outcome counts and the launches of each kernel (counts set
   to 0 just before it runs and read just after);
4. the answers: every solution satisfies every constraint of its
   problem, every unsat core is non-empty, no result is Incomplete; the
   first problems of each bits family give the same answers on
   ``device="cpu"`` (the kernels' plain versions), the blockwise answers
   equal the bits path's on the same problems, and the 803-constraint
   problem's core is its three conflicting constraints;
5. one 512-problem chunk of the headline fleet, and the 64-catalog batch
   under blockwise, under ``torch.profiler``: device time by kernel and
   the card's busy share;
6. each kernel against its plain version on the same inputs, 32 lanes of
   each family padded to the family's main-path dims, plus 32 lanes of a
   small family whose minimization probes do run: every output must be
   equal (integers, tolerance 0).  Kernels 1, 3, 4 and 5 are timed on
   the bits path's dims, the blockwise kernel on the giant catalog's
   baseline fixpoint (and held against kernel 1 there).  The phase
   kernels under blockwise are held against their plain versions at
   tiles of 1 and 7 rows, the plain versions running on CPU copies of
   the inputs in a pool of worker processes.  Each kernel's time is its
   own device time from ``torch.profiler``; the wrapper's time (CUDA
   events, the host work that prepares a launch included) and the plain
   version's time stand beside it, with a bound from bytes and
   operations;
7. the ``kernels:`` line and the JSON summary of every kernel.

The last line is ``{"ok": true, "device": {...}}``.  Without a card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
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
TIMED_REPS = 5

# The blockwise path: the repo's over-VMEM case, one giant catalog
# (deppy_tpu/benchmarks/pallas_case.py:129-133), and a batch at that
# benchmark's default size (:126-127).
GIANT = (1000, 8)
BATCH = (250, 8)
BATCH_LANES = 64
TENANT_LANES = 256
# Tile heights the phase kernels are held at under blockwise, and the
# lanes of gvk_fleet compared at 1-row tiles (its plain version at that
# height is the slowest comparison of the run).
SMALL_TILES = (1, 7)
GVK_TILE1_LANES = 8


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def solve_one(variables):
    """``Solver(variables, device="cuda").solve()`` as a solution dict, or
    the NotSatisfiable it raised."""
    from deppy_tpu_torch.sat import NotSatisfiable, Solver

    try:
        installed = Solver(variables, device="cuda").solve()
    except NotSatisfiable as e:
        return e
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
        n_sat = sum(isinstance(r, dict) for r in results)
        n_unsat = sum(isinstance(r, NotSatisfiable) for r in results)
        n_inc = sum(isinstance(r, Incomplete) for r in results)
        print(f"main path {name}: {count} problems in {wall:.3f} s "
              f"({count / wall:.1f} problems/s); sat {n_sat} unsat "
              f"{n_unsat} incomplete {n_inc}; launches {counts}; host "
              f"encode alone {t_encode:.3f} s", flush=True)
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

    variables = operatorhub_catalog(40, 5)
    engine.reset_launch_counts()
    t0 = time.perf_counter()
    answer = solve_one(variables)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = engine.launch_counts()
    for k in launches:
        launches[k] += counts[k]
    print(f"main path operatorhub: 1 problem in {wall:.3f} s; "
          f"{render(answer)[0]}; launches {counts}", flush=True)
    per_family["operatorhub"] = dict(problems=1, wall_s=wall,
                                     launches=counts,
                                     outcome=render(answer)[0])
    if isinstance(answer, dict):
        check_solution(variables, answer)
    elif not answer.constraints:
        fail("operatorhub: empty unsat core")
    samples["operatorhub"] = ([variables], [answer])
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
    return launches, per_family


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
    work = [("giant", [giant], lambda: [solve_one(giant)]),
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
    return launches, per_family


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


# Each kernel's symbol, as the profiler names its device activity.
KERNEL_SYMBOLS = {"bcp_fixpoint": "bcp_kernel",
                  "blockwise_fixpoint": "blockwise_kernel",
                  "search": "search_kernel", "minimize": "minimize_kernel",
                  "core": "core_kernel"}


def _device_ms(prof, symbol: str) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if symbol in e.key) / 1e3


def _timed(fn, kernel: str, reps: int):
    """(result, kernel ms, wrapper ms) per call: the kernel's own device
    time from ``torch.profiler``, and the whole wrapper call (the host
    work that prepares the launch included) by CUDA events."""
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
    ms = 0.0
    for _ in range(3):  # the profiler now and then drops a short kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = _device_ms(prof, KERNEL_SYMBOLS[kernel]) / reps
        if ms > 0:
            break
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
    from deppy_tpu_torch.sat.encode import encode

    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    rows = {}

    def record(kernel, family, got, want, timing, plain_ms, rounds, nbytes,
               C, NA, W):
        ms, wrapper_ms = timing
        bad, err = _mismatch(got, want)
        ops = rounds * _ops_per_round(C, NA, W)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        print(f"kernel {kernel} on {family}: main-path launches "
              f"{launches[kernel]} ms {ms:.4f} wrapper_ms "
              f"{wrapper_ms:.4f} plain_ms "
              f"{plain_ms:.3f} mismatches {bad} max_abs_err {err} "
              f"rounds {rounds} bytes {nbytes}", flush=True)
        if bad:
            fail(f"kernel {kernel} disagrees with its plain version on "
                 f"{family} ({bad} elements)")
        row = rows.setdefault(kernel, dict(max_abs_err=0, families={}))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["families"][family] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")

    for name, count, make in families(scale) + [
            ("forced_extras", COMPARE_LANES, forced_extras)]:
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

        # Kernel 1: the baseline fixpoint under the anchors.
        pv = torch.arange(d.NV, device=dev) < red.n_vars.unsqueeze(-1)
        bcp_in = (red.pos_bits_r, red.neg_bits_r, red.card_member_bits_r,
                  red.card_valid, red.card_n,
                  torch.zeros((B, d.Wr), dtype=torch.int32, device=dev),
                  torch.zeros(B, dtype=torch.int32, device=dev),
                  core.pack_mask(core._anchor_mask(red, d.NV), d.Wr),
                  core.pack_mask(~pv, d.Wr), en.to(torch.int32))
        got, *timing = _timed(lambda: cuda_bcp.bcp_fixpoint(*bcp_in),
                              "bcp_fixpoint", TIMED_REPS)
        want, pms, rounds = _timed_plain(
            lambda: cuda_bcp.bcp_fixpoint_plain(*bcp_in))
        record("bcp_fixpoint", name, got, want, timing, pms, rounds,
               _nbytes(*bcp_in, *got), d.C, d.NA, d.Wr)

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

        # Kernel 4: phase 2 on the SAT lanes.
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
            _same("minimize", name, f"budget {tight + 2}, padding lanes",
                  cuda_search.batched_minimize_fused(*tight_args),
                  cuda_search.batched_minimize_plain(*tight_args))

        # Kernel 5: phase 3 on the UNSAT lanes, full plane space.
        en_c = en & (result == core.UNSAT)
        if not bool(en_c.any()):
            print(f"kernel core on {name}: no UNSAT lane, not compared",
                  flush=True)
            continue
        tight_args = (full, 25, steps, en_c & en_pad)
        _same("core", name, "budget 25, padding lanes",
              cuda_search.batched_core_fused(*tight_args, NCON=d.NCON),
              cuda_search.batched_core_plain(*tight_args, NCON=d.NCON))
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
    return rows


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


def _bound_blockwise(nbytes: int, rounds: int, sweeps: int, tile: int,
                     NA: int, W: int):
    """(bound ms, bound_by) of blockwise fixpoints: the bytes read and
    written once, and the operations of ``rounds`` tile rounds plus the
    AtMost rows of one tile-0 round per sweep."""
    ops = rounds * (12 * tile * W + 8 * W) + sweeps * 7 * NA * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_blockwise(scale: float, launches: dict, plain: PlainPool):
    """Phase 6 for the blockwise impl: the blockwise kernel against its
    plain version on every family (timed at the natural tile, held at
    tiles of 1 and 7 rows), and against kernel 1 on the giant catalog's
    baseline fixpoint; the phase kernels under blockwise against their
    plain versions at tiles of 1 and 7 rows."""
    import torch

    from deppy_tpu_torch.engine import (core, cuda_bcp, cuda_blockwise,
                                        cuda_search, driver)
    from deppy_tpu_torch.models import operatorhub_catalog
    from deppy_tpu_torch.sat.encode import encode

    dev = torch.device("cuda")
    budget = driver.DEFAULT_MAX_STEPS
    row = dict(max_abs_err=0, families={})
    small = families(scale) + [("forced_extras", COMPARE_LANES,
                                forced_extras)]
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
        full = core.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
        en = torch.ones(B, dtype=torch.bool, device=dev)
        tile = cuda_blockwise.tile_rows(cuda_blockwise.BLOCK_ROWS, d.C, d.Wv,
                                        d.NA)
        print(f"compare blockwise {name}: {B} lanes, C {d.C} NA {d.NA} NV "
              f"{d.NV} NCON {d.NCON} Wv {d.Wv}, tile rows {tile}", flush=True)

        # Kernel 2: the baseline fixpoint of phase 1 under blockwise.
        V = d.NV + d.NCON
        base = core._apply_anchors(
            full, core._base_assignment(full, V, d.NCON), V)
        t_in = core.pack_mask(base == core.TRUE, d.Wv)
        f_in = core.pack_mask(base == core.FALSE, d.Wv)
        act = ((full.card_act_bits & t_in.unsqueeze(1)) != 0).any(-1)
        fp_in = (full.pos_bits, full.neg_bits, full.card_member_bits,
                 act.to(torch.int32), full.card_n,
                 torch.zeros((B, d.Wv), dtype=torch.int32, device=dev),
                 torch.zeros(B, dtype=torch.int32, device=dev), t_in, f_in,
                 en.to(torch.int32))
        got, *timing = _timed(
            lambda: cuda_blockwise.bcp_fixpoint(*fp_in, block_rows=tile),
            "blockwise_fixpoint", TIMED_REPS)
        s0 = core.plain_sweeps
        want, pms, rounds = _timed_plain(
            lambda: cuda_blockwise.bcp_fixpoint_plain(*fp_in,
                                                      block_rows=tile))
        sweeps = core.plain_sweeps - s0
        bad, err = _mismatch(got, want)
        ms, wrapper_ms = timing
        bound_ms, bound_by = _bound_blockwise(_nbytes(*fp_in, *got), rounds,
                                              sweeps, tile, d.NA, d.Wv)
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
                   sweeps_per_fixpoint=sweeps / B, rounds=rounds)
        # Kernel 1 on the same inputs: the same conflict flags, and the
        # same planes wherever there is no conflict.
        bits, bcp_ms, _ = _timed(lambda: cuda_bcp.bcp_fixpoint(*fp_in),
                                 "bcp_fixpoint", TIMED_REPS)
        ok = got[0] == 0
        bad = (int((bits[0] != got[0]).sum())
               + int((bits[1] != got[1])[ok].sum())
               + int((bits[2] != got[2])[ok].sum()))
        print(f"kernel blockwise_fixpoint on {name}: against kernel 1 "
              f"(bcp_fixpoint ms {bcp_ms:.4f}) mismatches {bad}", flush=True)
        if bad:
            fail(f"kernel blockwise_fixpoint disagrees with kernel 1 on "
                 f"{name} ({bad} elements)")
        fam["bcp_fixpoint_ms"] = bcp_ms
        row["families"][name] = fam
        if name in big_names:
            continue

        # Tiles of 1 and 7 rows: kernel 2 and the phase kernels, plain
        # versions in the pool.
        for br in SMALL_TILES:
            nb = GVK_TILE1_LANES if (name == "gvk_fleet" and br == 1) else B
            sub = core.ProblemTensors(*[f[:nb] for f in full])
            en_b = en[:nb]
            kw = dict(impl="blockwise", block_rows=br, NCON=d.NCON)
            what = f"tile {br}, {nb} lanes"
            got = cuda_blockwise.bcp_fixpoint(*[x[:nb] for x in fp_in],
                                              block_rows=br)
            plain.submit(("blockwise_fixpoint", name, what), got,
                         "cuda_blockwise", "bcp_fixpoint_plain",
                         [x[:nb] for x in fp_in],
                         dict(block_rows=cuda_blockwise.tile_rows(
                             br, d.C, d.Wv, d.NA)), nb)
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
    return row


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
# baseline fixpoint, blockwise_fixpoint the blockwise path's).
PATH_KERNELS = {
    "bits": ("bcp_fixpoint", "search", "minimize", "core"),
    "blockwise": ("blockwise_fixpoint", "search", "minimize", "core"),
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

        by_path = {}
        by_path["bits"], per_family = run_main_path(args.scale)
        by_path["blockwise"], per_family_bw = run_blockwise_path(args.scale)
        per_family["profile"] = profile_chunk(args.scale)
        per_family["profile_blockwise"] = profile_solve(
            "operatorhub_batch", operatorhub_batch(args.scale),
            impl="blockwise")
        rows = compare_kernels(args.scale, by_path["bits"])
        rows["blockwise_fixpoint"] = compare_blockwise(
            args.scale, by_path["blockwise"], plain)
        t0 = time.perf_counter()
        n = plain.check()
        print(f"{n} comparisons at small tiles checked in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
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
            by_family=rows[k]["families"]))
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
