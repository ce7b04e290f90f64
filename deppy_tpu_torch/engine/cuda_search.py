"""The three phase kernels: CUDA wrappers and plain versions (port of ``deppy_tpu/engine/pallas_search.py:520-926``).

* :func:`batched_search_fused` — phase 1 (``pallas_search._kernel``): the
  baseline fixpoint under the anchors (kernel 1, ``csrc/bcp.cu``, or
  kernel 2, ``csrc/blockwise.cu``), then the preference-ordered guess
  search with DPLL leaves (``csrc/search.cu``);
* :func:`batched_minimize_fused` — phase 2 (``_min_kernel``,
  ``csrc/minimize.cu``): extras-only cardinality minimization;
* :func:`batched_core_fused` — phase 3 (``_core_kernel``,
  ``csrc/core.cu``): the deletion unsat core in the full plane space.

Each takes and returns what its Pallas entry does, as torch tensors.  A
CUDA batch launches the kernel (one thread block per problem); a CPU batch
runs the plain version (``batched_*_plain``), which loops the one-problem
phases of :mod:`deppy_tpu_torch.engine.core` over the lanes.  The plain
versions run on any device, which is how the kernels are held against them
on the card.

Teams.  Kernel 1 (phase 1's baseline fixpoint on the bits path,
``cuda_bcp.bcp_fixpoint``) and phases 2 and 3 have a block team (one
thread block per problem) and a warp team (one warp per problem), picked
per launch by the shape rule of :mod:`.teams`; ``_team="block"|"warp"``
forces one, for ``chip_smoke.py``'s measurement only.  The rule's names
stay here too (:data:`WARPS`, :func:`team`, :func:`problem_budget`,
:func:`warp_smem_bytes`, ``_plan``), and setting ``WARPS`` here sets
``teams.WARPS``.

``impl`` picks the BCP impl (``core.set_bcp_impl``), and with it the
space of phases 1-2 and the fixpoint of every phase:

* ``bits``: the reduced planes (``*_bits_r``), the dense rounds;
* ``watched``: the reduced space, every fixpoint the watched arm on the
  batch's clause bank (``occ_pos_r``/``occ_neg_r``/``card_occ``; phase 3
  the full-space ``occ_pos``/``occ_neg``), its entry round on compact rows
  (``rows``, else built here: in the reduced space without the literals
  past ``n_vars``); on dummy banks the dense rounds, as in the reference;
* ``blockwise``: the full space (``V = NV + NCON``, so they take the
  batch's ``NCON``), every fixpoint a sweep over tiles of ``block_rows``
  clause rows (default ``cuda_blockwise.BLOCK_ROWS``;
  ``cuda_blockwise.tile_rows`` caps it to what shared memory holds, for
  the kernel and the plain version alike) of the compact rows (``rows``,
  else built from ``pts.clauses`` and ``pts.card_ids`` once per call);
* ``pallas``: the full space, the dense rounds (kernel 1's fixpoint);
* ``gather``: the full space, Jacobi rounds over the raw rows.

On the card the watched, blockwise and gather kernels read no dense
plane; the plain versions read the dense planes of their space (gather
none), and so do the bits and pallas kernels.  :func:`launch_arm` gives
the :class:`cuda_bcp.Arm` a launch runs.  Every launch counts under its
impl and team (:mod:`.counts`).
"""

from __future__ import annotations

import ctypes
import sys
import types
from typing import Optional

import torch

from . import _build, clause_bank, core, counts, cuda_bcp, cuda_blockwise
from . import teams
from .cuda_bcp import _check_args
from .teams import plan as _plan
from .teams import problem_budget, team, warp_smem_bytes  # noqa: F401

THREADS = 128

_I32 = torch.int32


def _check_pts(pts: core.ProblemTensors, shapes: dict) -> torch.device:
    """Check the named fields of ``pts`` (see :func:`_check_args`)."""
    return _check_args({n: getattr(pts, n) for n in shapes}, shapes)


def _check_mask(x: torch.Tensor, shape, dev, name: str) -> None:
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.bool
            or tuple(x.shape) != shape or x.device != dev):
        raise ValueError(f"{name} must be bool{list(shape)} on {dev}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _reduced(impl: str) -> bool:
    """Whether phases 1-2 of ``impl`` run in the reduced plane space."""
    if impl in ("bits", "watched"):
        return True
    if impl in ("blockwise", "pallas", "gather"):
        return False
    raise ValueError(f"the phase kernels run impl 'bits', 'watched', "
                     f"'blockwise', 'pallas' or 'gather', not {impl!r}")


def _tile(impl: str, block_rows: Optional[int], pts: core.ProblemTensors,
          W: int) -> int:
    """Rows per blockwise tile, or 0 for the other fixpoints."""
    if impl != "blockwise":
        return 0
    C, K = pts.clauses.shape[1:]
    NA, M = pts.card_ids.shape[1:]
    return cuda_blockwise.tile_rows(block_rows or cuda_blockwise.BLOCK_ROWS,
                                    C, K, M, W, NA)


def _threads(impl: str, arm: Optional[cuda_bcp.Arm]) -> int:
    if arm is not None:
        return cuda_bcp.ARM_THREADS
    return cuda_blockwise.THREADS if impl == "blockwise" else THREADS


def _full_words(pts: core.ProblemTensors, NCON: Optional[int]) -> int:
    """Words of the full plane space ``V = NV + NCON``."""
    if NCON is None:
        raise ValueError("the full plane space needs the batch's NCON")
    return -(-(pts.var_choices.shape[1] + NCON) // core.WORD)


def _phase_planes(pts: core.ProblemTensors, red: bool, NCON: Optional[int]):
    """(pos, neg, mem, V, W) of phases 1-2 in their plane space; the dense
    planes may be ``[B, rows, 1]`` placeholders where the kernels read
    none (:func:`_dense`)."""
    NV = pts.var_choices.shape[1]
    if red:
        return (pts.pos_bits_r, pts.neg_bits_r, pts.card_member_bits_r, NV,
                -(-NV // core.WORD))
    W = _full_words(pts, NCON)
    return pts.pos_bits, pts.neg_bits, pts.card_member_bits, NV + NCON, W


def launch_arm(pts: core.ProblemTensors, impl: str, red: bool, W: int,
               rows: Optional[cuda_blockwise.Compact] = None
               ) -> Optional[cuda_bcp.Arm]:
    """The arm a launch of ``impl`` runs on the batch ``pts`` in its space
    (``red``, ``W`` words): the gather rounds; the watched arm when the
    space's bank is real, its entry round on ``rows`` (on the card: built
    here when not given, checked against the batch when given); or None
    (the dense rounds, also those of a watched launch on dummy banks, or
    the blockwise sweeps)."""
    if impl == "gather":
        return cuda_bcp.Arm("gather", pts.clauses, pts.card_ids, pts.n_vars)
    if impl != "watched":
        return None
    occ_p, occ_n = ((pts.occ_pos_r, pts.occ_neg_r) if red
                    else (pts.occ_pos, pts.occ_neg))
    if not clause_bank.bank_ready(occ_p):
        return None
    if pts.n_vars.device.type == "cuda":
        rows = cuda_blockwise.rows_for(pts.clauses, pts.card_ids, W, rows,
                                       n_vars=pts.n_vars if red else None)
    return cuda_bcp.Arm("watched", pts.clauses, pts.card_ids, pts.n_vars,
                        occ_p, occ_n, pts.card_occ, rows, red)


def _phase_shapes(pts: core.ProblemTensors, red: bool, W: int,
                  dense: bool) -> dict:
    """The row fields a phase reads, with their shapes: the compact
    tensors and the AtMost activity sources, and the dense planes of the
    space when ``dense``."""
    B = pts.n_vars.shape[0]
    C, K = pts.clauses.shape[1:]
    NA, M = pts.card_ids.shape[1:]
    shapes = dict(clauses=(B, C, K), card_ids=(B, NA, M), card_act=(B, NA),
                  card_valid=(B, NA))
    if dense and red:
        shapes.update(pos_bits_r=(B, C, W), neg_bits_r=(B, C, W),
                      card_member_bits_r=(B, NA, W))
    elif dense:
        shapes.update(pos_bits=(B, C, W), neg_bits=(B, C, W),
                      card_member_bits=(B, NA, W), card_act_bits=(B, NA, W))
    return shapes


def reads_planes(impl: str, device_type: str, real_bank: bool) -> bool:
    """Whether a call under ``impl`` reads the dense planes of its space:
    the plain versions (on the CPU) of every impl but gather, and on the
    card the dense rounds (bits, pallas, and watched on dummy banks)."""
    if impl == "gather":
        return False
    return device_type == "cpu" or impl in ("bits", "pallas") or (
        impl == "watched" and not real_bank)


def _dense(pts: core.ProblemTensors, impl: str,
           arm: Optional[cuda_bcp.Arm]) -> bool:
    return reads_planes(impl, pts.n_vars.device.type, arm is not None)


def _check_phase(pts: core.ProblemTensors, shapes: dict,
                 arm: Optional[cuda_bcp.Arm], C: int, NA: int,
                 W: int) -> torch.device:
    """Check the named fields of ``pts`` (see :func:`_check_args`), and
    the arm's tensors (the bank's shapes among them)."""
    dev = _check_pts(pts, shapes)
    if arm is not None and arm.check(pts.n_vars.shape[0], C, NA, W) != dev:
        raise ValueError("the arm's tensors must lie on the batch's device")
    return dev


def _row_args(pts: core.ProblemTensors, planes, red: bool, W: int,
              tile: int, rows: Optional[cuda_blockwise.Compact],
              arm: Optional[cuda_bcp.Arm]):
    """The row arguments of a phase-kernel launch: (pos, neg, mem,
    card_valid, card_act, lits, mlits) pointers, then (K, M, lit_bytes,
    tile_rows, resident), then the :class:`cuda_bcp.ArmArgs` (or None).
    The dense rounds read the dense ``planes``; the blockwise sweeps the
    compact ``rows``; the arms their own tensors (no plane: null
    pointers).  The reduced space's AtMost activity is card_valid, the
    full space's card_act."""
    valid = pts.card_valid.data_ptr() if red else None
    act = None if red else pts.card_act.data_ptr()
    if arm is not None:
        return ([None, None, None, valid, act, None, None], [1, 1, 4, 0, 0],
                arm.args())
    if not tile:
        pos, neg, mem = planes
        return ([pos.data_ptr(), neg.data_ptr(), mem.data_ptr(), valid, act,
                 None, None], [1, 1, 4, 0, 0], None)
    la = cuda_blockwise.launch_args(rows, W, tile)
    return [None, None, None, valid, act, *la[:2]], list(la[2:]), None


def _arm_ptr(a: Optional[cuda_bcp.ArmArgs]) -> Optional[int]:
    return None if a is None else ctypes.addressof(a)


def _launch_rows(pts: core.ProblemTensors, W: int, tile: int,
                 rows: Optional[cuda_blockwise.Compact]):
    """The compact rows of a blockwise launch (None for the others)."""
    if not tile:
        return None
    return cuda_blockwise.rows_for(pts.clauses, pts.card_ids, W, rows)


# --------------------------------------------------------------------------
# phase 1


def full_activity(pts: core.ProblemTensors, assign: torch.Tensor):
    """bool[B, NA]: the AtMost rows whose activation variable
    (``card_act``, -1 on padded rows) is true in the full-space
    ``assign`` [B, V]; what ``card_act_bits & t`` gives on dense planes."""
    on = torch.gather(assign == core.TRUE, 1,
                      pts.card_act.clamp(min=0).long())
    return (pts.card_act >= 0) & on


def _baseline_fixpoint(pts: core.ProblemTensors, planes, card_active,
                       t0, f0, en, tile: int, rows, impl: str,
                       arm: Optional[cuda_bcp.Arm]):
    """Batched ``core.planes_fixpoint`` with no extras bound, as kernel 1
    (the dense rounds on the ``planes``, or ``arm``) or kernel 2 on the
    compact ``rows`` (``tile`` > 0): a lane whose entry state sets a
    variable both ways is a conflict and runs no round.  ``en`` is
    bool[B].  Returns (conflict bool[B], t, f)."""
    B, W = t0.shape
    pre = en & ((t0 & f0) != 0).any(-1)
    args = (card_active, pts.card_n,
            torch.zeros((B, W), dtype=_I32, device=t0.device),
            torch.zeros(B, dtype=_I32, device=t0.device), t0, f0,
            (en & ~pre).to(_I32))
    if tile:
        conflict, t, f = cuda_blockwise.bcp_fixpoint(
            pts.clauses, pts.card_ids, *args, block_rows=tile, rows=rows)
    else:
        conflict, t, f = cuda_bcp.bcp_fixpoint(*planes, *args, impl=impl,
                                               arm=arm)
    return (conflict != 0) | pre, t, f


def batched_search_fused(pts: core.ProblemTensors, budget, en: torch.Tensor,
                         *, impl: str = "bits",
                         block_rows: Optional[int] = None,
                         NCON: Optional[int] = None,
                         rows: Optional[cuda_blockwise.Compact] = None,
                         T: int = 0):
    """Phase 1 over a batch.  ``en`` bool[B] gates padding lanes; ``T``
    is the trace capacity (``core.search``).  Returns (result int32[B],
    guessed bool[B, NV], model int32[B, NV], steps int32[B], tr_stack
    int32[B, T, NC+1], tr_n int32[B]).  The trace buffer is allocated,
    filled with -1, only when ``T`` > 0; kernel 3 writes a lane's rows
    at its backtracks, and a lane that never searches keeps -1 rows and
    ``tr_n`` 0."""
    red = _reduced(impl)
    B, NC, Kc = pts.choice_cand.shape
    NV, Wch = pts.var_choices.shape[1:]
    pos, neg, mem, V, W = _phase_planes(pts, red, NCON)
    C, NA = pts.clauses.shape[1], pts.card_ids.shape[1]
    A = pts.anchors.shape[1]
    tile = _tile(impl, block_rows, pts, W)
    arm = launch_arm(pts, impl, red, W, rows)
    shapes = dict(_phase_shapes(pts, red, W, _dense(pts, impl, arm)),
                  card_n=(B, NA), choice_cand=(B, NC, Kc),
                  var_choices=(B, NV, Wch), anchors=(B, A), n_vars=(B,),
                  n_cons=(B,))
    dev = _check_phase(pts, shapes, arm, C, NA, W)
    _check_mask(en, (B,), dev, "en")
    if T < 0:
        raise ValueError(f"trace capacity T must be >= 0, not {T}")
    if dev.type == "cpu":
        return batched_search_plain(pts, budget, en, impl=impl,
                                    block_rows=tile, NCON=NCON, T=T)
    lib = _build.load()
    rows = _launch_rows(pts, W, tile, rows)
    pv_mask = torch.arange(V, device=dev) < pts.n_vars.unsqueeze(-1)
    anchor_mask = core._anchor_mask(pts, V)
    base = core._apply_anchors(pts, core._phase_base(pts, red, V, NCON), V)
    t_in = core.pack_mask(base == core.TRUE, W)
    f_in = core.pack_mask(base == core.FALSE, W)
    pvb = core.pack_mask(pv_mask, W)
    # Baseline Test under the anchors (solve.go:74-79).
    active = pts.card_valid if red else full_activity(pts, base)
    conflict0, t0, f0 = _baseline_fixpoint(
        pts, (pos, neg, mem), active.to(_I32), t_in, f_in, en, tile, rows,
        impl, arm)
    unassigned = (core._to_u(pvb) & ~(core._to_u(t0) | core._to_u(f0))) != 0
    outcome0 = torch.where(
        conflict0, core.UNSAT,
        torch.where(unassigned.any(-1), core.RUNNING, core.SAT)).to(_I32)
    need_search = en & (outcome0 == core.RUNNING)
    na = (pts.anchors >= 0).sum(-1).to(_I32)
    words = lib.deppy_search_scratch_words(NC, NV, W)
    scratch = torch.empty((B, words), dtype=_I32, device=dev)
    result_s = torch.empty(B, dtype=_I32, device=dev)
    steps = torch.empty(B, dtype=_I32, device=dev)
    tr_n = torch.empty(B, dtype=_I32, device=dev)
    # The trace buffer (empty, nothing filled, at T = 0).
    tr_stack = torch.full((B, T, NC + 1), -1, dtype=_I32, device=dev)
    asm = torch.empty((B, W), dtype=_I32, device=dev)
    m_t = torch.empty((B, W), dtype=_I32, device=dev)
    m_f = torch.empty((B, W), dtype=_I32, device=dev)
    ns = need_search.to(_I32)
    ptrs, dims, a = _row_args(pts, (pos, neg, mem), red, W, tile, rows, arm)
    rc = lib.deppy_search(
        *ptrs[:3], pts.card_n.data_ptr(), *ptrs[3:],
        pts.choice_cand.data_ptr(), pts.var_choices.data_ptr(),
        t0.data_ptr(), f0.data_ptr(), pvb.data_ptr(), outcome0.data_ptr(),
        ns.data_ptr(), na.data_ptr(), int(budget), scratch.data_ptr(),
        result_s.data_ptr(), steps.data_ptr(), tr_n.data_ptr(),
        tr_stack.data_ptr() if T else None, T, asm.data_ptr(),
        m_t.data_ptr(), m_f.data_ptr(), B, C, NA, W, NC, Kc, NV, Wch, *dims, _threads(impl, arm), _arm_ptr(a), _stream(dev))
    counts.count("search", impl, "block", arm)
    _build.check(rc, f"search ({impl})")
    a0 = core.planes_to_assign(t0, f0, NV)
    s_model = core.planes_to_assign(m_t, m_f, NV)
    s_guessed = core.unpack_mask(asm, NV)
    ns2 = need_search.unsqueeze(-1)
    result = torch.where(need_search, result_s, outcome0)
    result = torch.where(en, result, core.RUNNING).to(_I32)
    guessed = torch.where(ns2, s_guessed, anchor_mask[:, :NV])
    model = torch.where(ns2, s_model, a0)
    return result, guessed, model, steps, tr_stack, tr_n


def batched_search_plain(pts: core.ProblemTensors, budget, en: torch.Tensor,
                         *, impl: str = "bits",
                         block_rows: Optional[int] = None,
                         NCON: Optional[int] = None, T: int = 0):
    """Plain version of :func:`batched_search_fused`, on any device."""
    red = _reduced(impl)
    B, NC, _ = pts.choice_cand.shape
    NV = pts.var_choices.shape[1]
    W = _phase_planes(pts, red, NCON)[4]
    tile = _tile(impl, block_rows, pts, W)
    dev = pts.n_vars.device
    result = torch.zeros(B, dtype=_I32, device=dev)
    steps = torch.zeros(B, dtype=_I32, device=dev)
    tr_n = torch.zeros(B, dtype=_I32, device=dev)
    guessed = torch.zeros((B, NV), dtype=torch.bool, device=dev)
    model = torch.zeros((B, NV), dtype=_I32, device=dev)
    tr_stack = torch.full((B, T, NC + 1), -1, dtype=_I32, device=dev)
    for b in range(B):
        r, g, m, s, ts, t = core.search_phase(
            core.lane(pts, b), int(budget), bool(en[b]), red=red, NCON=NCON,
            block_rows=tile, impl=impl, T=T)
        result[b], guessed[b], model[b], steps[b], tr_n[b] = r, g, m, s, t
        tr_stack[b] = ts
    return result, guessed, model, steps, tr_stack, tr_n


# --------------------------------------------------------------------------
# phase 2


def _minimize_inputs(pts, result, model, guessed, en_lanes, red, NCON):
    _, _, _, V, W = _phase_planes(pts, red, NCON)
    en = en_lanes & (result == core.SAT)
    model = core._to_space(model, V)
    guessed = core._to_space(guessed, V)
    pv_mask = torch.arange(V, device=model.device) < pts.n_vars.unsqueeze(-1)
    extras = (model == core.TRUE) & ~guessed & pv_mask
    excluded = (model != core.TRUE) & ~guessed & pv_mask
    m_init = core._apply_anchors(pts, core._phase_base(pts, red, V, NCON), V)
    m_init = torch.where(guessed, core.TRUE, m_init)
    m_init = torch.where(excluded, core.FALSE, m_init)
    n_extras = torch.where(en, extras.sum(-1), 0).to(_I32)
    return dict(
        en=en, pv_mask=pv_mask, n_extras=n_extras,
        m_init_t=core.pack_mask(m_init == core.TRUE, W),
        m_init_f=core.pack_mask(m_init == core.FALSE, W),
        extras=core.pack_mask(extras, W),
        m2t0=core.pack_mask(model == core.TRUE, W),
        pvb=core.pack_mask(pv_mask, W))


def batched_minimize_fused(pts: core.ProblemTensors, result, model, guessed,
                           budget, steps, en_lanes, *, impl: str = "bits",
                           block_rows: Optional[int] = None,
                           NCON: Optional[int] = None,
                           rows: Optional[cuda_blockwise.Compact] = None,
                           _team: Optional[str] = None):
    """Phase 2 over a batch, gated to SAT lanes (``en_lanes & result ==
    SAT``); ``model``/``guessed`` are phase 1's [B, NV] outputs.  Returns
    (installed bool[B, NV], min_found bool[B], steps int32[B]).  ``_team``
    forces a team (measurement only, see :func:`team`)."""
    red = _reduced(impl)
    pos, neg, mem, _, W = _phase_planes(pts, red, NCON)
    B, C = pts.clauses.shape[:2]
    NV = pts.var_choices.shape[1]
    NA = pts.card_ids.shape[1]
    tile = _tile(impl, block_rows, pts, W)
    arm = launch_arm(pts, impl, red, W, rows)
    chosen, snaps = _plan("minimize", tile, C, NA, W, NV, 0, _team, impl)
    shapes = dict(_phase_shapes(pts, red, W, _dense(pts, impl, arm)),
                  card_n=(B, NA), n_vars=(B,), n_cons=(B,),
                  anchors=pts.anchors.shape)
    dev = _check_phase(pts, shapes, arm, C, NA, W)
    if _check_args(dict(result=result, model=model, steps=steps),
                   dict(result=(B,), model=(B, NV), steps=(B,))) != dev:
        raise ValueError("phase-1 outputs must lie on the batch's device")
    _check_mask(guessed, (B, NV), dev, "guessed")
    _check_mask(en_lanes, (B,), dev, "en")
    if dev.type == "cpu":
        return batched_minimize_plain(pts, result, model, guessed, budget,
                                      steps, en_lanes, impl=impl,
                                      block_rows=tile, NCON=NCON)
    lib = _build.load()
    rows = _launch_rows(pts, W, tile, rows)
    x = _minimize_inputs(pts, result, model, guessed, en_lanes, red, NCON)
    en = x["en"]
    words = 1 if snaps else lib.deppy_minimize_scratch_words(NV, W)
    scratch = torch.empty((B, words), dtype=_I32, device=dev)
    found = torch.empty(B, dtype=_I32, device=dev)
    steps_out = torch.empty(B, dtype=_I32, device=dev)
    m2_t = torch.empty((B, W), dtype=_I32, device=dev)
    en32 = en.to(_I32)
    ptrs, dims, a = _row_args(pts, (pos, neg, mem), red, W, tile, rows, arm)
    ins = (x["m_init_t"].data_ptr(), x["m_init_f"].data_ptr(),
           x["extras"].data_ptr(), x["m2t0"].data_ptr(), x["pvb"].data_ptr(),
           en32.data_ptr(), x["n_extras"].data_ptr(), steps.data_ptr(),
           int(budget), scratch.data_ptr(), found.data_ptr(),
           steps_out.data_ptr(), m2_t.data_ptr(), B, C, NA, W, NV)
    if chosen == "warp":
        teams.check_slice(lib, "minimize", C, NA, W, NV, 0, snaps)
        rc = lib.deppy_minimize_warp(
            *ptrs[:3], pts.card_n.data_ptr(), *ptrs[3:5], *ins, teams.WARPS,
            int(snaps), _stream(dev))
    else:
        rc = lib.deppy_minimize(
            *ptrs[:3], pts.card_n.data_ptr(), *ptrs[3:], *ins, *dims,
            _threads(impl, arm), _arm_ptr(a), _stream(dev))
    counts.count("minimize", impl, chosen, arm)
    _build.check(rc, f"minimize ({chosen} team, {impl})")
    min_found = found != 0
    installed = (core.unpack_mask(m2_t, NV) & x["pv_mask"][:, :NV]
                 & min_found.unsqueeze(-1) & en.unsqueeze(-1))
    return installed, min_found, steps_out


def batched_minimize_plain(pts, result, model, guessed, budget, steps,
                           en_lanes, *, impl: str = "bits",
                           block_rows: Optional[int] = None,
                           NCON: Optional[int] = None):
    """Plain version of :func:`batched_minimize_fused`, on any device."""
    red = _reduced(impl)
    W = _phase_planes(pts, red, NCON)[4]
    tile = _tile(impl, block_rows, pts, W)
    B, NV = model.shape
    dev = model.device
    installed = torch.zeros((B, NV), dtype=torch.bool, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    steps_out = steps.clone()
    for b in range(B):
        en = bool(en_lanes[b]) and int(result[b]) == core.SAT
        inst, fnd, s = core.minimize_phase(
            core.lane(pts, b), model[b], guessed[b], int(budget),
            int(steps[b]), en, red=red, NCON=NCON, block_rows=tile,
            impl=impl)
        installed[b], found[b], steps_out[b] = inst, fnd, s
    return installed, found, steps_out


# --------------------------------------------------------------------------
# phase 3


def _core_inputs(pts, NCON):
    NV = pts.var_choices.shape[1]
    W = _full_words(pts, NCON)
    V = NV + NCON
    init = core._base_assignment(pts, V, NCON)
    idx = torch.arange(V, device=init.device)
    return dict(base_t=core.pack_mask(init == core.TRUE, W),
                base_f=core.pack_mask(init == core.FALSE, W),
                pvb=core.pack_mask(idx < pts.n_vars.unsqueeze(-1), W))


def batched_core_fused(pts: core.ProblemTensors, budget, steps, en, *,
                       NCON: int, impl: str = "bits",
                       block_rows: Optional[int] = None,
                       rows: Optional[cuda_blockwise.Compact] = None,
                       _team: Optional[str] = None):
    """Phase 3 over a batch in the full plane space (``V = NV + NCON``).
    ``en`` bool[B]; ``steps`` int32[B] carries each lane's phase-1 count;
    ``rows`` the full-space compact rows.  Returns (core bool[B, NCON],
    steps int32[B]).  ``_team`` forces a team (measurement only, see
    :func:`team`)."""
    _reduced(impl)
    B, C = pts.clauses.shape[:2]
    NV = pts.var_choices.shape[1]
    NA = pts.card_ids.shape[1]
    W = _full_words(pts, NCON)
    tile = _tile(impl, block_rows, pts, W)
    arm = launch_arm(pts, impl, False, W, rows)
    chosen, snaps = _plan("core", tile, C, NA, W, NV, NCON, _team, impl)
    shapes = dict(_phase_shapes(pts, False, W, _dense(pts, impl, arm)),
                  card_n=(B, NA), n_vars=(B,), n_cons=(B,))
    dev = _check_phase(pts, shapes, arm, C, NA, W)
    if _check_args(dict(steps=steps), dict(steps=(B,))) != dev:
        raise ValueError("steps must lie on the batch's device")
    _check_mask(en, (B,), dev, "en")
    if dev.type == "cpu":
        return batched_core_plain(pts, budget, steps, en, NCON=NCON,
                                  impl=impl, block_rows=tile)
    lib = _build.load()
    rows = _launch_rows(pts, W, tile, rows)
    G = min(core.CORE_CHUNK, max(NCON, 1))
    x = _core_inputs(pts, NCON)
    words = 1 if snaps else lib.deppy_core_scratch_words(NV, W)
    scratch = torch.empty((B, words), dtype=_I32, device=dev)
    core_out = torch.empty((B, NCON), dtype=_I32, device=dev)
    steps_out = torch.empty(B, dtype=_I32, device=dev)
    en32 = en.to(_I32)
    ptrs, dims, a = _row_args(
        pts, (pts.pos_bits, pts.neg_bits, pts.card_member_bits), False, W,
        tile, rows, arm)
    ins = (x["pvb"].data_ptr(), x["base_t"].data_ptr(),
           x["base_f"].data_ptr(), en32.data_ptr(), pts.n_cons.data_ptr(),
           pts.n_vars.data_ptr(), steps.data_ptr(), int(budget),
           scratch.data_ptr(), core_out.data_ptr(), steps_out.data_ptr(), B,
           C, NA, W, NV, NCON, G)
    if chosen == "warp":
        teams.check_slice(lib, "core", C, NA, W, NV, NCON, snaps)
        rc = lib.deppy_core_warp(*ptrs[:3], pts.card_n.data_ptr(), ptrs[4],
                                 *ins, teams.WARPS, int(snaps), _stream(dev))
    else:
        rc = lib.deppy_core(*ptrs[:3], pts.card_n.data_ptr(), *ptrs[4:],
                            *ins, *dims, _threads(impl, arm), _arm_ptr(a),
                            _stream(dev))
    counts.count("core", impl, chosen, arm)
    _build.check(rc, f"core ({chosen} team, {impl})")
    return core_out != 0, steps_out


def batched_core_plain(pts, budget, steps, en, *, NCON: int,
                       impl: str = "bits", block_rows: Optional[int] = None):
    """Plain version of :func:`batched_core_fused`, on any device."""
    _reduced(impl)
    tile = _tile(impl, block_rows, pts, _full_words(pts, NCON))
    B = steps.shape[0]
    dev = steps.device
    cores = torch.zeros((B, NCON), dtype=torch.bool, device=dev)
    steps_out = steps.clone()
    for b in range(B):
        c, s = core.core_phase(core.lane(pts, b), int(budget), int(steps[b]),
                               bool(en[b]), NCON=NCON, block_rows=tile,
                               impl=impl)
        cores[b], steps_out[b] = c, s
    return cores, steps_out


class _Module(types.ModuleType):
    """This module, with ``WARPS`` read from and set on :mod:`.teams`."""

    @property
    def WARPS(self) -> int:
        return teams.WARPS

    @WARPS.setter
    def WARPS(self, warps: int) -> None:
        teams.WARPS = warps


sys.modules[__name__].__class__ = _Module
