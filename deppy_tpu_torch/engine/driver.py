"""Pad, batch, dispatch and decode (port of ``deppy_tpu/engine/driver.py:58-2188``, without the mesh).

One batched resolve, as the reference's ``solve_problems`` runs it
without a mesh:

1. :func:`partition_buckets` splits a heterogeneous batch along the
   shared size-class ladder;
2. each bucket runs through :func:`_solve_escalating` (the budget
   escalation ladder, off while :data:`STAGE1_STEPS` is 0) and, inside
   it, :func:`_recovering` (the fault envelope) around the three-phase
   path :func:`_solve_split`;
3. :func:`pad_stack` pads the bucket to common power-of-two dims on the
   host and the compact tensors go to the device once;
4. per chunk of at most :data:`MAX_LANES` lanes the planes of phases
   1-2 are derived on the device where the kernels read them (the
   reduced space under ``bits`` and ``watched``, the full space under
   ``pallas``, ``blockwise`` and ``gather``, as ``_derive_planes`` does),
   then phase 1 (search) and phase 2 (minimization, SAT lanes) run there;
5. the UNSAT lanes get their unsat core: the cores of giant problems
   (more than :data:`HOST_CORE_NCONS` applied constraints) from the host
   spec engine, the rest gathered into chunks of their own, their
   full-space planes derived, and phase 3 run on the device — routed
   exactly as the reference routes them (:func:`_core_routes`);
6. :func:`decode_results` maps lanes back to variables.

The fault envelope (driver.py:1330-1516): every dispatch attempt passes
the fault point ``driver.dispatch`` (and ``driver.device_put`` inside
the upload); a failed attempt charges the process breaker
(:func:`faults.default_breaker`), is retried with backoff
(:class:`faults.RetryPolicy`, read on every dispatch), then its group is
halved while the breaker allows, then solved on the host engine
(:func:`_fault_results_host`, device-shaped results; counted in
``deppy_fault_host_routed_total`` and ``SolveReport.fault_host_routed``).
An open breaker host-routes a group without an attempt, an expired
batch deadline (:func:`faults.ambient_deadline`) degrades it to
Incomplete, and an attempt past ``chunk_deadline_s`` keeps its result
but charges the breaker.  Semantic outcomes pass through, and so do the
defects of the tree (:data:`TREE_DEFECTS`: a kernel that does not build,
a launch it cannot take, a shape a wrapper refuses, a card that is not
there), where the reference routes every other error to the host:
routing those would hide a broken kernel behind correct answers.

:func:`warm_screen` (driver.py:2155-2188) is the incremental tier's
batched warm-prefix screen: pad, one elementwise
:func:`core.warm_check_phase` pass per chunk, one ``bool[n]`` back.

Tracing: ``trace_cap`` > 0 gives phase 1 a backtrack trace buffer of that
depth (kernel 3 writes it on the card); :func:`solve_one` with a
``tracer`` replays its rows into ``Tracer.trace`` calls
(:func:`_replay_trace`).

Telemetry (:mod:`deppy_tpu_torch.telemetry`): every call runs under a
``driver.solve`` span and fills the thread's :class:`SolveReport`
(``begin_report``/``end_report``; ``stats["report"]``): the spans
``driver.escalation``, ``driver.pad_pack``, ``driver.device_put``,
``driver.fault_host_fallback`` and ``driver.decode`` (and
``driver.encode`` in :func:`solve_batch`), the padding counters of
:func:`_telem_record_pad`, the host-core routing counter,
``deppy_escalation_total`` and the ``deppy_solve_seconds`` histogram.
The spans time the host wall and synchronize nothing: the driver's
``.cpu()`` fetches are where the card's work lands, inside
``driver.solve``.

Under ``blockwise`` on the card the kernels read compact rows, built once
per bucket (``cuda_blockwise.compact_rows``) and cut per chunk, and no
full-space plane is derived: only the plain versions (``device="cpu"``)
read those.  Under ``watched`` the bucket's clause banks are derived on
the device once (``clause_bank.derive_banks``; the full-space ones only
when phase 3 runs there) and cut per chunk, unless the bucket's largest
literal occurrence ``Ob`` passes its cap (:func:`_bank_cap`): then it keeps
dummy banks and every fixpoint runs the dense rounds, as in the
reference.  On the card a real bank's kernels read compact rows (the
entry round's, reduced for phases 1-2), the raw rows and the banks, and
no dense plane; under ``gather`` the raw rows alone, there and in the
plain versions.

``device="cuda"`` (the default) runs the CUDA kernels and raises when
there is no card; ``device="cpu"`` runs their plain versions.  The BCP
impl is ``core.resolved_impl()``, the blockwise tile height
``cuda_blockwise.BLOCK_ROWS`` and the bank cap :data:`BANK_OCC_CAP`, all
read when a solve starts.
"""

from __future__ import annotations

import functools
import os
import time
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import faults
from .. import size_classes as _size_classes
from .. import telemetry
from ..size_classes import bucket as _bucket
from ..sat.constraints import Variable
from ..sat.encode import Problem, encode
from ..sat.errors import Incomplete, InternalSolverError, NotSatisfiable
from ..sat.host import HostEngine
from . import _build, clause_bank, core, cuda_blockwise, cuda_search

# Default step budget when the caller sets none (driver.py:55).
DEFAULT_MAX_STEPS = 1 << 24

# Per-dispatch lane cap (driver.py:978).
MAX_LANES = 512

# Size-class partitioning (driver.py:1210-1214).
MAX_BUCKETS = 4
MIN_BUCKET = 16
SPLIT_RATIO = _size_classes.SPLIT_RATIO

# Core extraction for UNSAT problems above this many applied constraints
# routes to the host spec engine (driver.py:613-624): its single-drop
# probes beat a device deletion loop on giant problems, and the answer is
# the same core.
HOST_CORE_NCONS = int(os.environ.get("DEPPY_GPU_HOST_CORE_NCONS", "768"))

# Watched-bank occurrence-width cap (driver.py:425-430; 0 = the bucket's
# size-class OCC cap): a bucket whose largest per-literal clause count
# passes it would pay a V x Ob bank mostly for one popular literal, so it
# keeps dummy banks and runs the dense rounds.
BANK_OCC_CAP = int(os.environ.get("DEPPY_GPU_BANK_OCC_CAP", "0"))


# Progressive budget escalation (driver.py:1296-1313): stage 1 runs every
# lane at this small step budget and the few lanes still running
# re-dispatch compacted at the full budget (or, past
# STAGE1_MAX_STRAGGLERS, the whole group re-runs).  0 disables it, as in
# the reference's default; tests and chip_smoke.py's faults phase set the
# attribute.
STAGE1_STEPS = 0
STAGE1_MAX_STRAGGLERS = 0.25
# Groups below this size are not worth a two-stage run.
STAGE1_MIN_BATCH = 64


class NoDeviceError(RuntimeError):
    """``device="cuda"`` was asked for and ``torch.cuda.is_available()``
    is False.  Nothing routes around it: it is one of
    :data:`TREE_DEFECTS`."""


# The errors of a defect of the tree or of the call, not of the card: a
# kernel that does not build, a launch the kernel cannot take, a shape or
# argument a kernel wrapper refuses, and a card asked for on a machine
# that has none.  The fault envelope re-raises them untouched (no retry,
# no breaker charge, no host route), and so do the portfolio racer and
# the warm screen.
TREE_DEFECTS = (_build.KernelBuildError, _build.KernelLaunchError,
                NoDeviceError, ValueError, TypeError)


# Trace-buffer depth when a tracer is attached and the caller sets none
# (driver.py:1974-1978): truncation warns, and shows as
# stats["backtracks"] > trace calls.
DEFAULT_TRACE_CAP = 256


def resolve_device(device) -> torch.device:
    """The torch device a solve runs on.  ``cuda`` without a card raises:
    nothing falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the kernels' plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class _Dims:
    """Common padded dimensions for a batch of problems (driver.py:117)."""

    def __init__(self, problems: Sequence[Problem], batch: int,
                 batch_multiple: int = 1):
        self.C = _bucket(max((p.clauses.shape[0] for p in problems), default=1))
        self.K = _bucket(max((p.clauses.shape[1] for p in problems), default=1), 2)
        self.NA = _bucket(max((p.card_ids.shape[0] for p in problems), default=1))
        self.M = _bucket(max((p.card_ids.shape[1] for p in problems), default=1))
        self.A = _bucket(max((p.anchors.shape[0] for p in problems), default=1))
        self.NC = _bucket(max((p.choice_cand.shape[0] for p in problems), default=1))
        self.Kc = _bucket(max((p.choice_cand.shape[1] for p in problems), default=1))
        self.NV = _bucket(max((p.n_vars for p in problems), default=1))
        self.W = _bucket(max((p.var_choices.shape[1] for p in problems), default=1))
        self.NCON = _bucket(max((p.n_cons for p in problems), default=1))
        self.V = self.NV + self.NCON
        self.Wv = -(-self.V // core.WORD)
        self.Wr = -(-self.NV // core.WORD)
        b = _bucket(batch)
        if b % batch_multiple:
            b *= batch_multiple // np.gcd(b, batch_multiple)
        self.B = b
        # The clause bank's widths (driver.py:140-169) are data-dependent
        # and only the watched impl reads them: computed on first use.
        self._problems = list(problems)

    @functools.cached_property
    def Ob(self) -> int:
        """Bucketed literal-occurrence width of the watched clause bank."""
        return _bucket(max((clause_bank.max_occurrence(p.clauses)
                            for p in self._problems), default=0))

    @functools.cached_property
    def Oc(self) -> int:
        """Bucketed member→AtMost-row width of the watched bank."""
        return _bucket(max((clause_bank.max_card_membership(p.card_ids)
                            for p in self._problems), default=0))


def _telem_record_pad(problems: Sequence[Problem], total: int, d: _Dims,
                      n_chunks: int, dur_s: float) -> None:
    """One bucket's padding economics (driver.py:68-94): live vs padded
    lanes, and live vs padded clause-matrix cells."""
    reg = telemetry.default_registry()
    n = len(problems)
    live_cells = int(sum(p.clauses.size for p in problems))
    pad_cells = int(total) * d.C * d.K
    reg.histogram(
        "deppy_batch_fill_ratio",
        "Live problems per dispatched batch lane (1.0 = no lane padding).",
        buckets=telemetry.RATIO_BUCKETS,
    ).observe(n / total if total else 1.0)
    reg.counter("deppy_pad_cells_total",
                "Clause-matrix cells dispatched, including padding."
                ).inc(pad_cells)
    reg.counter("deppy_live_cells_total",
                "Clause-matrix cells carrying live problem data."
                ).inc(live_cells)
    reg.counter("deppy_chunks_total",
                "Device dispatch chunks issued.").inc(n_chunks)
    rep = telemetry.current_report()
    if rep is not None:
        rep.record_batch(live_lanes=n, batch_lanes=int(total),
                         live_cells=live_cells, pad_cells=pad_cells,
                         n_chunks=n_chunks)
        rep.add_wall("pad_pack", dur_s)


def _bank_cap(d: _Dims) -> int:
    """The bucket's occurrence-width cap (driver.py:445-449)."""
    if BANK_OCC_CAP > 0:
        return BANK_OCC_CAP
    name = _size_classes.class_of_cost((d.C + 2 * d.NV) * d.Wv)
    return _size_classes.occ_cap(name)


def _derive_banks(pts: core.ProblemTensors, d: _Dims, red: bool,
                  full: bool) -> core.ProblemTensors:
    """``pts`` with the banks of the spaces asked for, and ``card_occ``,
    derived on its device (driver.py:452-462, 506-524); the others are
    kept."""
    occ_pos, occ_neg, occ_pos_r, occ_neg_r, card_occ = \
        clause_bank.derive_banks(pts.clauses, pts.card_ids, pts.n_vars,
                                 V=d.V, NV=d.NV, Ob=d.Ob, Oc=d.Oc, red=red,
                                 full=full)
    pts = pts._replace(card_occ=card_occ)
    if full:
        pts = pts._replace(occ_pos=occ_pos, occ_neg=occ_neg)
    if red:
        pts = pts._replace(occ_pos_r=occ_pos_r, occ_neg_r=occ_neg_r)
    return pts


def pad_stack(problems: Sequence[Problem], d: _Dims,
              total: int) -> core.ProblemTensors:
    """Pad and stack problems to [total, ...] host numpy arrays
    (driver.py:308, ``pack=False``): lanes past ``len(problems)`` are
    empty problems and every plane field is a ``[total, rows, 1]`` zero
    placeholder and every bank field a ``[total, 1, 1]`` dummy of -1 —
    the device derives the planes and the banks."""
    clauses = np.zeros((total, d.C, d.K), np.int32)
    card_ids = np.full((total, d.NA, d.M), -1, np.int32)
    card_n = np.zeros((total, d.NA), np.int32)
    card_act = np.full((total, d.NA), -1, np.int32)
    anchors = np.full((total, d.A), -1, np.int32)
    choice_cand = np.full((total, d.NC, d.Kc), -1, np.int32)
    var_choices = np.full((total, d.NV, d.W), -1, np.int32)
    n_vars = np.zeros(total, np.int32)
    n_cons = np.zeros(total, np.int32)
    for i, p in enumerate(problems):
        c = p.clauses
        clauses[i, : c.shape[0], : c.shape[1]] = c
        ci = p.card_ids
        card_ids[i, : ci.shape[0], : ci.shape[1]] = ci
        card_n[i, : p.card_n.shape[0]] = p.card_n
        card_act[i, : p.card_act.shape[0]] = p.card_act
        anchors[i, : p.anchors.shape[0]] = p.anchors
        cc = p.choice_cand
        choice_cand[i, : cc.shape[0], : cc.shape[1]] = cc
        vc = p.var_choices
        var_choices[i, : vc.shape[0], : vc.shape[1]] = vc
        n_vars[i] = p.n_vars
        n_cons[i] = p.n_cons
    rows_c = np.zeros((total, d.C, 1), np.int32)
    rows_a = np.zeros((total, d.NA, 1), np.int32)
    bank = np.full((total, 1, 1), -1, np.int32)
    return core.ProblemTensors(
        clauses=clauses, card_ids=card_ids, card_n=card_n, card_act=card_act,
        anchors=anchors, choice_cand=choice_cand, var_choices=var_choices,
        n_vars=n_vars, n_cons=n_cons,
        pos_bits=rows_c, neg_bits=rows_c, card_member_bits=rows_a,
        card_act_bits=rows_a, pos_bits_r=rows_c, neg_bits_r=rows_c,
        card_member_bits_r=rows_a,
        card_valid=(card_act >= 0).astype(np.int32),
        occ_pos=bank, occ_neg=bank, occ_pos_r=bank, occ_neg_r=bank,
        card_occ=bank,
    )


def _budget(max_steps: Optional[int]) -> int:
    return int(min(max_steps if max_steps is not None else DEFAULT_MAX_STEPS,
                   np.iinfo(np.int32).max - 1))


def _cost_proxy(p: Problem) -> int:
    return _size_classes.cost_proxy(p.clauses.shape[0], p.n_vars, p.n_cons)


def padded_class(problems: Sequence[Problem]) -> str:
    """The ladder class of a dispatch group's PADDED batch dims
    (driver.py:845-860): cost over the bucketed C/NV/NCON maxima, the
    classification :func:`_bank_cap` applies to the same dispatch.  The
    max of per-problem cost proxies is not such a function (a
    wide-clause problem and a wide-var problem can trade maxima)."""
    C = _bucket(max((p.clauses.shape[0] for p in problems), default=1))
    NV = _bucket(max((p.n_vars for p in problems), default=1))
    NCON = _bucket(max((p.n_cons for p in problems), default=1))
    Wv = -(-(NV + NCON) // _size_classes.WORD)
    return _size_classes.class_of_cost((C + 2 * NV) * Wv)


def _merge_small(buckets: List[List[int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for idxs in buckets:
        if merged and (len(idxs) < MIN_BUCKET
                       or len(merged[-1]) < MIN_BUCKET):
            merged[-1].extend(idxs)
        else:
            merged.append(idxs)
    return merged


def _jump_splits(costs: np.ndarray, order: np.ndarray,
                 max_buckets: int) -> List[List[int]]:
    n = order.size
    sc = costs[order]
    ratios = sc[1:] / np.maximum(sc[:-1], 1)
    cand = np.nonzero(ratios >= SPLIT_RATIO)[0]
    cand = cand[np.argsort(ratios[cand])[::-1][: max_buckets - 1]]
    splits = sorted(int(i) + 1 for i in cand)
    bounds = [0] + splits + [n]
    return [order[lo:hi].tolist()
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def partition_buckets(problems: Sequence[Problem]) -> List[List[int]]:
    """Problem indices split at the size-class ladder's boundaries, then at
    large cost jumps within a class; small buckets merge into their
    neighbour (driver.py:1266-1294)."""
    n = len(problems)
    if n < 2 * MIN_BUCKET:
        return [list(range(n))]
    costs = np.array([_cost_proxy(p) for p in problems], dtype=np.int64)
    order = np.argsort(costs, kind="stable")
    buckets: List[List[int]] = []
    run: List[int] = []
    cur: Optional[str] = None
    for i in order.tolist():
        name = _size_classes.class_of_cost(int(costs[i]))
        if name != cur and run:
            buckets += _jump_splits(costs, np.array(run), MAX_BUCKETS)
            run = []
        cur = name
        run.append(i)
    if run:
        buckets += _jump_splits(costs, np.array(run), MAX_BUCKETS)
    return _merge_small(buckets)


def _upload(pts_np: core.ProblemTensors, dev) -> core.ProblemTensors:
    return core.ProblemTensors(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                 for a in pts_np])


def _rows(pts: core.ProblemTensors, sel) -> core.ProblemTensors:
    if isinstance(sel, slice):
        return core.ProblemTensors(*[x[sel] for x in pts])
    return core.ProblemTensors(*[x.index_select(0, sel) for x in pts])


def _host_core_rows(problems: Sequence[Problem], idx: np.ndarray,
                    NCON: int, budget: int,
                    spent: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-engine cores for the lanes ``idx`` (driver.py:765-826, without
    the speculative stage, which the reference leaves off unmeasured).
    Returns (cores bool[len(idx), NCON], steps int64[len(idx)]): steps to
    ADD to each lane's count.  Each lane's engine gets only the budget
    left after its device search (``spent``); a lane with nothing left
    takes one step, and an engine that runs out takes ``remaining + 1``,
    so the caller's ``steps > budget`` check turns the lane Incomplete
    exactly as the device core phase would.  Every lane routed here counts
    (driver.py:793-799)."""
    telemetry.default_registry().counter(
        "deppy_host_fallback_rows_total",
        "UNSAT rows whose core extraction routed to the host spec engine.",
    ).inc(len(idx))
    rep = telemetry.current_report()
    if rep is not None:
        rep.host_fallback_rows += len(idx)
    cores = np.zeros((len(idx), NCON), bool)
    steps = np.zeros(len(idx), np.int64)
    for r, i in enumerate(idx):
        remaining = int(budget) - int(spent[r])
        if remaining <= 0:
            steps[r] = 1
            continue
        eng = HostEngine(problems[i], max_steps=remaining)
        try:
            cores[r, : problems[i].n_cons] = eng.unsat_core_mask()
            steps[r] = eng.steps
        except Incomplete:
            steps[r] = remaining + 1
    return cores, steps


def _core_routes(problems: Sequence[Problem], unsat_idx: np.ndarray,
                 total: int, monolith: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(device lanes, host lanes) of the UNSAT lanes, as the reference
    routes them.  A call with one problem takes its monolith path
    (driver.py:897, :939-942): every UNSAT lane goes to the host when any
    problem has more than :data:`HOST_CORE_NCONS` constraints.  A batch
    takes its split path (driver.py:1076-1105): when UNSAT lanes are more
    than half of the ``total`` chunk-padded lanes, every one stays on the
    device; otherwise the lanes past the threshold go to the host."""
    if monolith:
        if any(p.n_cons > HOST_CORE_NCONS for p in problems):
            return unsat_idx[:0], unsat_idx
        return unsat_idx, unsat_idx[:0]
    if unsat_idx.size > total // 2:
        return unsat_idx, unsat_idx[:0]
    big = np.array([problems[i].n_cons > HOST_CORE_NCONS
                    for i in unsat_idx], bool)
    return unsat_idx[~big], unsat_idx[big]


def _solve_split(problems: Sequence[Problem], budget: int,
                 dev: torch.device, monolith: bool,
                 trace_cap: int = 0) -> List[core.SolveResult]:
    """The three-phase path over one bucket (driver.py:992-1191), with
    the core routing of :func:`_core_routes`; ``trace_cap`` is phase 1's
    trace depth ``T``."""
    n = len(problems)
    d = _Dims(problems, min(max(n, 1), MAX_LANES))
    CH = d.B
    n_chunks = max(1, -(-n // CH))
    total = n_chunks * CH
    impl = core.resolved_impl()
    red = core.phases_reduced()
    cuda = dev.type == "cuda"
    kw = dict(impl=impl, block_rows=cuda_blockwise.BLOCK_ROWS)
    reg = telemetry.default_registry()
    rep = telemetry.current_report()
    with reg.span("driver.pad_pack", problems=n, lanes=total,
                  chunks=n_chunks) as sp:
        pts_np = pad_stack(problems, d, total)
    _telem_record_pad(problems, total, d, n_chunks=n_chunks, dur_s=sp.dur_s)
    # The compact tensors cross to the device once, and the bucket's
    # clause banks and compact rows are derived there.
    with reg.span("driver.device_put", lanes=total, chunks=n_chunks) as sp:
        faults.inject("driver.device_put")
        pts_all = _upload(pts_np, dev)
        en_all = torch.arange(total, device=dev) < n
        banks = impl == "watched" and d.Ob <= _bank_cap(d)
        if banks:
            pts_all = _derive_banks(pts_all, d, red=True, full=False)
        # The compact rows the kernels read, once per bucket: the
        # blockwise tiles, or the watched entry round's (reduced for
        # phases 1-2).
        rows_all = core_rows_all = None
        if cuda and impl == "blockwise":
            rows_all = core_rows_all = cuda_blockwise.compact_rows(
                pts_all.clauses, pts_all.card_ids, d.Wv)
        elif cuda and banks:
            rows_all = cuda_blockwise.compact_rows(
                pts_all.clauses, pts_all.card_ids, d.Wr,
                n_vars=pts_all.n_vars)
    if rep is not None:
        rep.add_wall("device_put", sp.dur_s)
    dense = cuda_search.reads_planes(impl, dev.type, banks)

    def rows(sel):
        return None if rows_all is None else rows_all.take(sel)

    def core_rows(sel):
        return None if core_rows_all is None else core_rows_all.take(sel)

    # Phases 1 and 2 on the same resident chunks.
    res1, st1, trs, trn, inst, found, st2 = [], [], [], [], [], [], []
    for lo in range(0, total, CH):
        sl = slice(lo, lo + CH)
        pts = core.with_planes(_rows(pts_all, sl), Wv=d.Wv, Wr=d.Wr,
                               red=red and dense, full=not red and dense)
        en = en_all[sl]
        r, guessed, model, steps, tr, tr_n = cuda_search.batched_search_fused(
            pts, budget, en, NCON=d.NCON, rows=rows(sl), T=trace_cap, **kw)
        i2, f2, s2 = cuda_search.batched_minimize_fused(
            pts, r, model, guessed, budget, steps, en, NCON=d.NCON,
            rows=rows(sl), **kw)
        res1.append(r)
        st1.append(steps)
        trs.append(tr)
        trn.append(tr_n)
        inst.append(i2)
        found.append(f2)
        st2.append(s2)
    result = torch.cat(res1).cpu().numpy()
    steps = torch.cat(st1).cpu().numpy().astype(np.int64)
    trace_n = torch.cat(trn).cpu().numpy()
    trace_stack = (torch.cat(trs).cpu().numpy() if trace_cap > 0
                   else np.zeros((total, 0, d.NC + 1), np.int32))
    installed = torch.cat(inst).cpu().numpy()
    min_found = torch.cat(found).cpu().numpy()
    st_min = torch.cat(st2).cpu().numpy()
    en_np = np.arange(total) < n
    sat_mask = en_np & (result == core.SAT)
    installed[~sat_mask] = False
    min_found &= sat_mask
    steps[sat_mask] = st_min[sat_mask]

    # Phase 3: device lanes gathered into chunks of their own, full plane
    # space; host lanes through the spec engine.
    cores = np.zeros((total, d.NCON), bool)
    unsat_idx = np.nonzero(en_np & (result == core.UNSAT))[0]
    dev_idx, host_idx = _core_routes(problems, unsat_idx, total, monolith)
    if dev_idx.size and banks:
        # Full-space banks and entry rows for the core phase; the reduced
        # banks stay.
        pts_all = _derive_banks(pts_all, d, red=False, full=True)
        if cuda:
            core_rows_all = cuda_blockwise.compact_rows(
                pts_all.clauses, pts_all.card_ids, d.Wv)
    for lo in range(0, dev_idx.size, CH):
        idx = dev_idx[lo: lo + CH]
        sel = torch.from_numpy(idx).to(dev)
        pts = core.with_planes(_rows(pts_all, sel), Wv=d.Wv, Wr=d.Wr,
                               red=False, full=dense)
        c, s = cuda_search.batched_core_fused(
            pts, budget, torch.from_numpy(steps[idx].astype(np.int32)).to(dev),
            torch.ones(idx.size, dtype=torch.bool, device=dev), NCON=d.NCON,
            rows=core_rows(sel), **kw)
        cores[idx] = c.cpu().numpy()
        steps[idx] = s.cpu().numpy()
    if host_idx.size:
        hc, hs = _host_core_rows(problems, host_idx, d.NCON, budget,
                                 steps[host_idx])
        cores[host_idx] = hc
        steps[host_idx] += hs

    incomplete = ((steps > budget) | (result == core.RUNNING)
                  | ((result == core.SAT) & ~min_found))
    outcome = np.where(incomplete, core.RUNNING, result).astype(np.int32)
    return [
        core.SolveResult(int(outcome[i]), torch.from_numpy(installed[i]),
                         torch.from_numpy(cores[i]), int(steps[i]),
                         torch.from_numpy(trace_stack[i]), int(trace_n[i]))
        for i in range(n)
    ]


def _record_escalation(stage: int) -> None:
    """The escalation stage a dispatch group reached (driver.py:1316-1327):
    0 = single stage, 1 = stage 1 resolved every lane, 2 = stage 2."""
    telemetry.default_registry().counter(
        "deppy_escalation_total",
        "Dispatch groups by the budget-escalation stage reached.",
        labelname="stage",
    ).inc(1, label=str(stage))
    rep = telemetry.current_report()
    if rep is not None:
        rep.note_escalation(stage)


def _fault_results_host(problems: Sequence[Problem], budget: int,
                        reason: str) -> List[core.SolveResult]:
    """Solve one dispatch group on the host engine (driver.py:1341-1400):
    the device dispatch failed or the breaker is open.  Lanes run through
    the host path's entry (:func:`hostpool.solve_host_problems`: the
    worker pool, or inline), each under the ambient batch deadline.
    Results are device-shaped — installed and core masks padded to the
    group's dims — and the step budget carries over, so a lane that runs
    out reads Incomplete (RUNNING), as does one not started before the
    deadline (one counted expiry for the group)."""
    from .. import hostpool

    faults.inject("driver.host_fallback")
    reg = telemetry.default_registry()
    faults.fault_counter("deppy_fault_host_routed_total").inc(len(problems))
    reg.event("fault", fault="host_fallback", reason=reason,
              problems=len(problems))
    rep = telemetry.current_report()
    if rep is not None:
        rep.fault_host_routed += len(problems)
    d = _Dims(problems, max(len(problems), 1))
    out: List[core.SolveResult] = []
    dl = faults.current_deadline()
    with reg.span("driver.fault_host_fallback", problems=len(problems),
                  reason=reason):
        lanes = hostpool.solve_host_problems(
            problems, max_steps=int(budget),
            deadlines=[dl] * len(problems))
        n_degraded = sum(1 for r in lanes if r.degraded)
        if n_degraded:
            faults.note_deadline_exceeded("driver.host_fallback",
                                          n_degraded)
        for lane in lanes:
            installed = torch.zeros(d.NV, dtype=torch.bool)
            cmask = torch.zeros(d.NCON, dtype=torch.bool)
            if lane.outcome == "sat":
                installed[lane.installed_idx] = True
                outcome = core.SAT
            elif lane.outcome == "unsat":
                cmask[lane.core_idx] = True
                outcome = core.UNSAT
            else:
                outcome = core.RUNNING
            out.append(core.SolveResult(
                outcome, installed, cmask, lane.steps,
                torch.zeros((0, d.NC + 1), dtype=torch.int32),
                lane.backtracks))
    return out


def _deadline_results(problems: Sequence[Problem]) -> List[core.SolveResult]:
    """Incomplete results for a group whose batch deadline expired before
    it could dispatch (driver.py:1403-1413): completed batchmates keep
    their answers, these lanes report what a budget-exhausted solve
    would."""
    d = _Dims(problems, max(len(problems), 1))
    return [
        core.SolveResult(core.RUNNING, torch.zeros(d.NV, dtype=torch.bool),
                         torch.zeros(d.NCON, dtype=torch.bool), 0,
                         torch.zeros((0, d.NC + 1), dtype=torch.int32), 0)
        for _ in problems
    ]


def _recovering(impl, point: str = "driver.dispatch"):
    """Wrap a dispatch-group impl ``impl(problems, budget, trace_cap)``
    with the fault-domain policy (driver.py:1416-1516).

    In order: an expired batch deadline degrades the group
    (:func:`_deadline_results`); an open breaker host-routes it without an
    attempt; otherwise each attempt passes the fault point ``point``, then
    runs ``impl``.  A semantic outcome (``InternalSolverError``,
    ``NotSatisfiable``, ``Incomplete``, ``DeadlineExceeded``) and a
    defect of the tree (:data:`TREE_DEFECTS`) hand back a claimed
    half-open probe slot and re-raise.  Any other failure is a device
    fault: it charges the breaker and is retried up to
    ``RetryPolicy.max_attempts`` with backoff (capped at the deadline's
    remainder); a group that keeps failing is halved while the breaker
    allows (a poison problem isolates in log2 steps), and what is left
    goes to the host engine.  An attempt that overruns
    ``chunk_deadline_s`` keeps its result, counts
    ``deppy_deadline_exceeded{driver.chunk}`` and charges the breaker."""

    def run(problems, budget, trace_cap):
        policy = faults.RetryPolicy.from_env()
        breaker = faults.default_breaker()
        reg = telemetry.default_registry()
        dl = faults.current_deadline()
        if dl is not None and dl.expired():
            faults.note_deadline_exceeded(point, len(problems))
            return _deadline_results(problems)
        if not breaker.allow():
            return _fault_results_host(problems, budget,
                                       reason="breaker_open")
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                faults.inject(point)
                results = impl(problems, budget, trace_cap)
            except (InternalSolverError, NotSatisfiable, Incomplete,
                    faults.DeadlineExceeded) + TREE_DEFECTS:
                # Not a device verdict: if this attempt was the breaker's
                # half-open probe, hand the slot back.
                breaker.abandon_probe()
                raise
            except Exception as e:  # noqa: BLE001 — a device fault
                attempt += 1
                breaker.record_failure()
                faults.fault_counter("deppy_fault_failures_total").inc()
                reg.event("fault", fault="dispatch_failed",
                          error=type(e).__name__, attempt=attempt,
                          problems=len(problems), breaker=breaker.state())
                if dl is not None and dl.expired():
                    faults.note_deadline_exceeded(point, len(problems))
                    return _deadline_results(problems)
                if (attempt < policy.max_attempts
                        and not breaker.blocks_device()):
                    faults.fault_counter("deppy_fault_retries").inc()
                    back = policy.backoff_s(attempt)
                    if dl is not None:
                        back = min(back, max(dl.remaining(), 0.0))
                    if back > 0:
                        time.sleep(back)
                    continue
                if (len(problems) > 1 and policy.split_failed_groups
                        and not breaker.blocks_device()):
                    reg.event("fault", fault="group_split",
                              problems=len(problems))
                    mid = (len(problems) + 1) // 2
                    return (run(list(problems[:mid]), budget, trace_cap)
                            + run(list(problems[mid:]), budget, trace_cap))
                return _fault_results_host(problems, budget,
                                           reason=type(e).__name__)
            else:
                dur = time.monotonic() - t0
                if (policy.chunk_deadline_s > 0
                        and dur > policy.chunk_deadline_s):
                    faults.note_deadline_exceeded("driver.chunk",
                                                  len(problems))
                    breaker.record_failure()
                else:
                    breaker.record_success()
                return results

    return run


def _solve_escalating(impl, problems: Sequence[Problem], budget: int,
                      trace_cap: int) -> List[core.SolveResult]:
    """Run ``impl`` in two budget stages when profitable
    (driver.py:1519-1586), every call under :func:`_recovering`.  The
    ladder is off while :data:`STAGE1_STEPS` is 0, and tracing, a group
    below :data:`STAGE1_MIN_BATCH`, a budget below 8 stage-1 budgets and
    a problem whose core goes to the host each disable it.  Otherwise
    stage 1 runs every lane at ``STAGE1_STEPS``; if more than
    :data:`STAGE1_MAX_STRAGGLERS` of the lanes are still running, the
    whole group re-runs at the full budget (a lane the redo left
    undecided keeps its stage-1 decision), else the stragglers re-run
    compacted.  Each lane reports the steps of the run that produced its
    result, so answers and steps equal the single-stage solve's."""
    impl = _recovering(impl)
    reg = telemetry.default_registry()
    if (
        STAGE1_STEPS <= 0
        or trace_cap > 0
        or len(problems) < STAGE1_MIN_BATCH
        or int(budget) < 8 * STAGE1_STEPS
        or any(p.n_cons > HOST_CORE_NCONS for p in problems)
    ):
        with reg.span("driver.escalation", problems=len(problems),
                      stage=0):
            results = impl(problems, budget, trace_cap)
        _record_escalation(0)
        return results
    with reg.span("driver.escalation", problems=len(problems)) as sp:
        results = impl(problems, STAGE1_STEPS, 0)
        stragglers = [i for i, r in enumerate(results)
                      if r.outcome == core.RUNNING]
        sp.set(stragglers=len(stragglers))
        if not stragglers:
            sp["stage"] = 1
            _record_escalation(1)
            return results
        sp["stage"] = 2
        _record_escalation(2)
        dl = faults.current_deadline()
        if dl is not None and dl.expired():
            # The redo would only degrade the same lanes again.
            return results
        if len(stragglers) > STAGE1_MAX_STRAGGLERS * len(problems):
            redo = impl(problems, budget, trace_cap)
            return [
                r1 if (r2.outcome == core.RUNNING
                       and r1.outcome != core.RUNNING) else r2
                for r1, r2 in zip(results, redo)
            ]
        sub = impl([problems[i] for i in stragglers], budget, 0)
        for i, r in zip(stragglers, sub):
            results[i] = r
        return results


def solve_problems(problems: Sequence[Problem],
                   max_steps: Optional[int] = None,
                   device="cuda", trace_cap: int = 0
                   ) -> List[core.SolveResult]:
    """Solve lowered problems as device batches; one
    :class:`core.SolveResult` per problem, on the host.  ``trace_cap`` >
    0 keeps a backtrack trace of that depth per problem
    (``SolveResult.trace_stack``).

    The call runs under the ambient batch deadline (the caller's
    ``deadline_scope``, else ``DEPPY_GPU_BATCH_DEADLINE_S``) and a
    ``driver.solve`` span, and fills the thread's active
    :class:`telemetry.SolveReport`, made here when none is active (a
    nested call merges into the enclosing one; driver.py:1883-1943);
    read it afterwards with :func:`telemetry.last_report`.  Whether the
    core phase routes as one problem's (``monolith``) is decided once
    per call, from its size: a split half or a straggler sub-group keeps
    it."""
    for p in problems:
        if p.errors:
            raise InternalSolverError(p.errors)
    dev = resolve_device(device)
    budget = _budget(max_steps)
    n = len(problems)
    monolith = n == 1

    def impl(group, group_budget, group_trace_cap):
        return _solve_split(group, group_budget, dev, monolith,
                            trace_cap=group_trace_cap)

    rep, owns = telemetry.begin_report(backend="device", n_problems=n)
    reg = telemetry.default_registry()
    t0 = time.perf_counter()
    try:
        with faults.ambient_deadline(), \
                reg.span("driver.solve", problems=n):
            results: List[Optional[core.SolveResult]] = [None] * n
            for idxs in (partition_buckets(problems) if n > 1
                         else [list(range(n))]):
                sub = _solve_escalating(impl, [problems[i] for i in idxs],
                                        budget, trace_cap)
                for i, r in zip(idxs, sub):
                    results[i] = r
        for r in results:
            rep.count_outcome("sat" if r.outcome == core.SAT
                              else "unsat" if r.outcome == core.UNSAT
                              else "incomplete")
            rep.steps += r.steps
            rep.backtracks += r.trace_n
        reg.histogram(
            "deppy_solve_seconds",
            "Wall-clock seconds per driver solve call (pad through "
            "decode).",
        ).observe(time.perf_counter() - t0)
    finally:
        rep.add_wall("solve", time.perf_counter() - t0)
        if owns:
            telemetry.end_report(rep, owns)
    return results  # type: ignore[return-value]


def _decode_installed(p: Problem, installed) -> List[Variable]:
    flags = installed[: p.n_vars].tolist()
    return [v for v, on in zip(p.variables, flags) if on]


def _decode_core(p: Problem, active) -> NotSatisfiable:
    flags = active[: p.n_cons].tolist()
    return NotSatisfiable([c for c, on in zip(p.applied, flags) if on])


class _LazyReplayPosition:
    """``SearchPosition`` whose conflict set is rebuilt on demand
    (driver.py:1981-2002).  The assumption stack comes off the trace
    buffer; the conflicts need a host-engine replay, run only when a
    tracer calls ``conflicts()``, so a stats-only tracer costs no host
    solve."""

    def __init__(self, variables, compute_conflicts):
        self._variables = variables
        self._compute = compute_conflicts
        self._conflicts = None

    def variables(self):
        return self._variables

    def conflicts(self):
        if self._conflicts is None:
            self._conflicts = self._compute()
        return self._conflicts


def _replay_trace(problem: Problem, res: core.SolveResult, tracer) -> None:
    """The trace buffer's rows as ``Tracer.trace`` calls
    (driver.py:2005-2056).  Each row is the guess-variable stack at one
    backtrack; its conflicts come, lazily, from one host-engine Test
    under those guesses (``HostEngine._test``, ``last_conflicts``).  BCP
    is confluent, so a backtrack from a propagation conflict replays to
    the same conflicts; one from an exhausted leaf DPLL replays to none,
    and reports an empty list.  A buffer that overflowed warns
    (``RuntimeWarning``) and replays the rows it holds."""
    total = int(res.trace_n)
    rows = min(total, res.trace_stack.shape[0])
    if rows == 0:
        return
    if total > rows:
        warnings.warn(
            f"search backtracked {total} times but the trace buffer holds "
            f"{rows}; trailing events are dropped — raise trace_cap "
            f"(solve_one) to capture them",
            RuntimeWarning,
            stacklevel=3,
        )
    eng_box: list = []

    def _conflicts_for(gv):
        def compute():
            from ..sat.host import UNSAT as HOST_UNSAT

            if not eng_box:
                eng_box.append(HostEngine(problem))
            eng = eng_box[0]
            outcome, _ = eng._test(guessed=tuple(gv))
            return list(eng.last_conflicts) if outcome == HOST_UNSAT else []

        return compute

    stack = res.trace_stack[:rows].tolist()
    for row in stack:
        gv = [v for v in row if v >= 0]
        tracer.trace(_LazyReplayPosition(
            [problem.variables[v] for v in gv], _conflicts_for(gv)))


def solve_one(problem: Problem, max_steps: Optional[int] = None,
              stats: Optional[dict] = None, device="cuda", tracer=None,
              trace_cap: Optional[int] = None) -> List[Variable]:
    """Single-problem entry used by :class:`deppy_tpu_torch.sat.Solver`
    (driver.py:2059-2085): the installed variables, or raises
    :class:`NotSatisfiable` / :class:`Incomplete`.  ``stats`` receives
    ``steps``, ``backtracks`` and the call's ``report``.  A ``tracer``
    receives one ``trace`` call per search backtrack, like the host
    engine (tracer.go:13-15); ``trace_cap`` sizes the trace buffer
    (default :data:`DEFAULT_TRACE_CAP` with a tracer, else 0)."""
    if trace_cap is None:
        trace_cap = DEFAULT_TRACE_CAP if tracer is not None else 0
    (res,) = solve_problems([problem], max_steps=max_steps, device=device,
                            trace_cap=trace_cap)
    if stats is not None:
        stats["steps"] = res.steps
        stats["backtracks"] = res.trace_n
        stats["report"] = telemetry.last_report()
    if tracer is not None:
        _replay_trace(problem, res, tracer)
    if res.outcome == core.SAT:
        return _decode_installed(problem, res.installed)
    if res.outcome == core.UNSAT:
        raise _decode_core(problem, res.core)
    raise Incomplete()


def solve_batch(problem_vars: Sequence[Sequence[Variable]],
                max_steps: Optional[int] = None,
                stats: Optional[dict] = None, device="cuda",
                checkpoint_dir: Optional[str] = None):
    """Batch entry used by :class:`deppy_tpu_torch.resolution.BatchResolver`
    (driver.py:2088-2123): per problem a solution dict, its
    :class:`NotSatisfiable`, or an :class:`Incomplete` marker.  ``stats``
    receives the summed ``steps`` and the batch's ``report``.  The encode
    runs under a ``driver.encode`` span, its wall the report's
    ``encode`` (the reference times no encode).  ``checkpoint_dir``
    solves group by group with resume
    (:func:`deppy_tpu_torch.engine.checkpoint.solve_problems_checkpointed`),
    every group's driver call merging into this batch's report."""
    rep, owns = telemetry.begin_report(backend="device")
    try:
        with telemetry.default_registry().span(
                "driver.encode", problems=len(problem_vars)) as sp:
            problems = [encode(vs) for vs in problem_vars]
        rep.add_wall("encode", sp.dur_s)
        if checkpoint_dir is not None:
            from .checkpoint import solve_problems_checkpointed

            results = solve_problems_checkpointed(
                problems, checkpoint_dir, max_steps=max_steps,
                device=device)
        else:
            results = solve_problems(problems, max_steps=max_steps,
                                     device=device)
    finally:
        telemetry.end_report(rep, owns)
    if stats is not None:
        stats["steps"] = int(sum(r.steps for r in results))
        stats["report"] = telemetry.last_report()
    return decode_results(problems, results)


def decode_results(problems: Sequence[Problem],
                   results: Sequence[core.SolveResult]
                   ) -> List[Union[dict, NotSatisfiable, Incomplete]]:
    """Lanes back to the facade vocabulary (driver.py:2126-2152), under
    a ``driver.decode`` span."""
    out: List[Union[dict, NotSatisfiable, Incomplete]] = []
    with telemetry.default_registry().span("driver.decode",
                                           problems=len(problems)):
        for p, res in zip(problems, results):
            if res.outcome == core.SAT:
                solution = {v.identifier: False for v in p.variables}
                for v in _decode_installed(p, res.installed):
                    solution[v.identifier] = True
                out.append(solution)
            elif res.outcome == core.UNSAT:
                out.append(_decode_core(p, res.core))
            else:
                out.append(Incomplete())
    return out


def warm_screen(problems: Sequence[Problem], models, cones, *,
                device="cuda") -> np.ndarray:
    """Batched warm-prefix screen (driver.py:2155-2188): the device lane
    variant of the incremental tier.  Each lane's assignment is
    initialized from its cached ``model`` (bool[n_vars]) with the
    ``cone`` variables left open, and one :func:`core.warm_check_phase`
    pass per chunk of at most :data:`MAX_LANES` lanes flags lanes whose
    warm prefix already conflicts — those cold-solve without paying a
    host warm attempt.  Runs on ``device`` (``"cuda"`` by default, which
    raises without a card) under a ``driver.warm_screen`` span; the one
    device-to-host copy is the returned ``bool[n]``.  Router only:
    results never depend on this screen."""
    dev = resolve_device(device)
    n = len(problems)
    d = _Dims(problems, min(max(n, 1), MAX_LANES))
    CH = d.B
    total = max(1, -(-n // CH)) * CH
    pts = pad_stack(problems, d, total)
    assign = np.zeros((total, d.NV), np.int32)
    for i, (m, c) in enumerate(zip(models, cones)):
        a = np.where(np.asarray(m, dtype=bool), 1, -1).astype(np.int32)
        a[np.asarray(c, dtype=bool)] = 0
        assign[i, : a.shape[0]] = a
    with telemetry.default_registry().span("driver.warm_screen", lanes=n):
        t = [torch.from_numpy(x).to(dev)
             for x in (pts.clauses, pts.card_ids, pts.card_n,
                       pts.card_valid, pts.n_vars, assign)]
        ok = torch.cat([
            core.warm_check_phase(*(x[lo: lo + CH] for x in t), NV=d.NV)
            for lo in range(0, total, CH)]).cpu().numpy()
    return ok[:n]
