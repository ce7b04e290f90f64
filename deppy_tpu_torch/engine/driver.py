"""Pad, batch, dispatch and decode (port of ``deppy_tpu/engine/driver.py:117-2152``, the three-phase split path).

One batched resolve, as the reference's ``solve_problems`` runs it
without a mesh, tracing, faults or budget escalation:

1. :func:`partition_buckets` splits a heterogeneous batch along the
   shared size-class ladder;
2. :func:`pad_stack` pads each bucket to common power-of-two dims on the
   host and the compact tensors go to the device once;
3. per chunk of at most :data:`MAX_LANES` lanes the reduced planes are
   derived on the device, then phase 1 (search) and phase 2
   (minimization, SAT lanes) run there;
4. the UNSAT lanes are gathered into chunks of their own, their
   full-space planes derived, and phase 3 (the unsat core) runs;
5. :func:`decode_results` maps lanes back to variables.

Every UNSAT lane goes to the core kernel: the reference's host-routed
giant cores (``HOST_CORE_NCONS``) are not part of this package yet.
``device="cuda"`` (the default) runs the CUDA kernels and raises when
there is no card; ``device="cpu"`` runs their plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import size_classes as _size_classes
from ..size_classes import bucket as _bucket
from ..sat.constraints import Variable
from ..sat.encode import Problem, encode
from ..sat.errors import Incomplete, InternalSolverError, NotSatisfiable
from . import core, cuda_search

# Default step budget when the caller sets none (driver.py:55).
DEFAULT_MAX_STEPS = 1 << 24

# Per-dispatch lane cap (driver.py:978).
MAX_LANES = 512

# Size-class partitioning (driver.py:1210-1214).
MAX_BUCKETS = 4
MIN_BUCKET = 16
SPLIT_RATIO = _size_classes.SPLIT_RATIO


def resolve_device(device) -> torch.device:
    """The torch device a solve runs on.  ``cuda`` without a card raises:
    nothing falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
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


def pad_stack(problems: Sequence[Problem], d: _Dims,
              total: int) -> core.ProblemTensors:
    """Pad and stack problems to [total, ...] host numpy arrays
    (driver.py:308, ``pack=False``): lanes past ``len(problems)`` are
    empty problems and every plane field is a ``[total, rows, 1]`` zero
    placeholder — the device derives the planes."""
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
    return core.ProblemTensors(
        clauses=clauses, card_ids=card_ids, card_n=card_n, card_act=card_act,
        anchors=anchors, choice_cand=choice_cand, var_choices=var_choices,
        n_vars=n_vars, n_cons=n_cons,
        pos_bits=rows_c, neg_bits=rows_c, card_member_bits=rows_a,
        card_act_bits=rows_a, pos_bits_r=rows_c, neg_bits_r=rows_c,
        card_member_bits_r=rows_a,
        card_valid=(card_act >= 0).astype(np.int32),
    )


def _budget(max_steps: Optional[int]) -> int:
    return int(min(max_steps if max_steps is not None else DEFAULT_MAX_STEPS,
                   np.iinfo(np.int32).max - 1))


def _cost_proxy(p: Problem) -> int:
    return _size_classes.cost_proxy(p.clauses.shape[0], p.n_vars, p.n_cons)


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


def _solve_split(problems: Sequence[Problem], budget: int,
                 dev: torch.device) -> List[core.SolveResult]:
    """The three-phase path over one bucket (driver.py:992-1191)."""
    n = len(problems)
    d = _Dims(problems, min(max(n, 1), MAX_LANES))
    CH = d.B
    total = max(1, -(-n // CH)) * CH
    pts_all = _upload(pad_stack(problems, d, total), dev)
    en_all = torch.arange(total, device=dev) < n

    # Phases 1 and 2 on the same resident chunks, reduced plane space.
    res1, st1, trn, inst, found, st2 = [], [], [], [], [], []
    for lo in range(0, total, CH):
        sl = slice(lo, lo + CH)
        pts = core.with_planes(_rows(pts_all, sl), Wv=d.Wv, Wr=d.Wr,
                               red=True, full=False)
        en = en_all[sl]
        r, guessed, model, steps, _, tr_n = cuda_search.batched_search_fused(
            pts, budget, en)
        i2, f2, s2 = cuda_search.batched_minimize_fused(
            pts, r, model, guessed, budget, steps, en)
        res1.append(r)
        st1.append(steps)
        trn.append(tr_n)
        inst.append(i2)
        found.append(f2)
        st2.append(s2)
    result = torch.cat(res1).cpu().numpy()
    steps = torch.cat(st1).cpu().numpy().astype(np.int64)
    trace_n = torch.cat(trn).cpu().numpy()
    installed = torch.cat(inst).cpu().numpy()
    min_found = torch.cat(found).cpu().numpy()
    st_min = torch.cat(st2).cpu().numpy()
    en_np = np.arange(total) < n
    sat_mask = en_np & (result == core.SAT)
    installed[~sat_mask] = False
    min_found &= sat_mask
    steps[sat_mask] = st_min[sat_mask]

    # Phase 3 on the UNSAT lanes, gathered, full plane space.
    cores = np.zeros((total, d.NCON), bool)
    unsat_idx = np.nonzero(en_np & (result == core.UNSAT))[0]
    for lo in range(0, unsat_idx.size, CH):
        idx = unsat_idx[lo: lo + CH]
        sel = torch.from_numpy(idx).to(dev)
        pts = core.with_planes(_rows(pts_all, sel), Wv=d.Wv, Wr=d.Wr,
                               red=False, full=True)
        c, s = cuda_search.batched_core_fused(
            pts, budget, torch.from_numpy(steps[idx].astype(np.int32)).to(dev),
            torch.ones(idx.size, dtype=torch.bool, device=dev), NCON=d.NCON)
        cores[idx] = c.cpu().numpy()
        steps[idx] = s.cpu().numpy()

    incomplete = ((steps > budget) | (result == core.RUNNING)
                  | ((result == core.SAT) & ~min_found))
    outcome = np.where(incomplete, core.RUNNING, result).astype(np.int32)
    return [
        core.SolveResult(int(outcome[i]), torch.from_numpy(installed[i]),
                         torch.from_numpy(cores[i]), int(steps[i]),
                         int(trace_n[i]))
        for i in range(n)
    ]


def solve_problems(problems: Sequence[Problem],
                   max_steps: Optional[int] = None,
                   device="cuda") -> List[core.SolveResult]:
    """Solve lowered problems as device batches; one
    :class:`core.SolveResult` per problem, on the host."""
    for p in problems:
        if p.errors:
            raise InternalSolverError(p.errors)
    dev = resolve_device(device)
    budget = _budget(max_steps)
    n = len(problems)
    results: List[Optional[core.SolveResult]] = [None] * n
    for idxs in (partition_buckets(problems) if n > 1 else [list(range(n))]):
        sub = _solve_split([problems[i] for i in idxs], budget, dev)
        for i, r in zip(idxs, sub):
            results[i] = r
    return results  # type: ignore[return-value]


def _decode_installed(p: Problem, installed) -> List[Variable]:
    flags = installed[: p.n_vars].tolist()
    return [v for v, on in zip(p.variables, flags) if on]


def _decode_core(p: Problem, active) -> NotSatisfiable:
    flags = active[: p.n_cons].tolist()
    return NotSatisfiable([c for c, on in zip(p.applied, flags) if on])


def solve_one(problem: Problem, max_steps: Optional[int] = None,
              stats: Optional[dict] = None, device="cuda") -> List[Variable]:
    """Single-problem entry used by :class:`deppy_tpu_torch.sat.Solver`
    (driver.py:2057): the installed variables, or raises
    :class:`NotSatisfiable` / :class:`Incomplete`."""
    (res,) = solve_problems([problem], max_steps=max_steps, device=device)
    if stats is not None:
        stats["steps"] = res.steps
        stats["backtracks"] = res.trace_n
    if res.outcome == core.SAT:
        return _decode_installed(problem, res.installed)
    if res.outcome == core.UNSAT:
        raise _decode_core(problem, res.core)
    raise Incomplete()


def solve_batch(problem_vars: Sequence[Sequence[Variable]],
                max_steps: Optional[int] = None,
                stats: Optional[dict] = None, device="cuda"):
    """Batch entry used by :class:`deppy_tpu_torch.resolution.BatchResolver`
    (driver.py:2088): per problem a solution dict, its
    :class:`NotSatisfiable`, or an :class:`Incomplete` marker."""
    problems = [encode(vs) for vs in problem_vars]
    results = solve_problems(problems, max_steps=max_steps, device=device)
    if stats is not None:
        stats["steps"] = int(sum(r.steps for r in results))
    return decode_results(problems, results)


def decode_results(problems: Sequence[Problem],
                   results: Sequence[core.SolveResult]
                   ) -> List[Union[dict, NotSatisfiable, Incomplete]]:
    """Lanes back to the facade vocabulary (driver.py:2126-2152)."""
    out: List[Union[dict, NotSatisfiable, Incomplete]] = []
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
