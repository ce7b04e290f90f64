"""The three phase kernels: CUDA wrappers and plain versions (port of ``deppy_tpu/engine/pallas_search.py:520-926``).

* :func:`batched_search_fused` — phase 1 (``pallas_search._kernel``): the
  baseline fixpoint under the anchors (kernel 1, ``csrc/bcp.cu``), then
  the preference-ordered guess search with DPLL leaves
  (``csrc/search.cu``);
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
"""

from __future__ import annotations

import torch

from . import _build, core, cuda_bcp
from .cuda_bcp import _check_args

THREADS = 128

# Kernel launches since the counts were last reset (one per launch).
search_launches = 0
minimize_launches = 0
core_launches = 0

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


# --------------------------------------------------------------------------
# phase 1


def batched_search_fused(pts: core.ProblemTensors, budget, en: torch.Tensor):
    """Phase 1 over a batch in the reduced plane space.  ``en`` bool[B]
    gates padding lanes.  Returns (result int32[B], guessed bool[B, NV],
    model int32[B, NV], steps int32[B], tr_stack int32[B, 0, NC+1],
    tr_n int32[B])."""
    global search_launches
    B, NC, Kc = pts.choice_cand.shape
    NV, Wch = pts.var_choices.shape[1:]
    C, W = pts.pos_bits_r.shape[1:]
    NA = pts.card_member_bits_r.shape[1]
    A = pts.anchors.shape[1]
    shapes = dict(pos_bits_r=(B, C, W), neg_bits_r=(B, C, W),
                  card_member_bits_r=(B, NA, W), card_n=(B, NA),
                  card_valid=(B, NA), choice_cand=(B, NC, Kc),
                  var_choices=(B, NV, Wch), anchors=(B, A), n_vars=(B,))
    dev = _check_pts(pts, shapes)
    _check_mask(en, (B,), dev, "en")
    if dev.type == "cpu":
        return batched_search_plain(pts, budget, en)
    lib = _build.load()
    idx = torch.arange(NV, device=dev)
    pv_mask = idx < pts.n_vars.unsqueeze(-1)
    anchor_mask = core._anchor_mask(pts, NV)
    pvb = core.pack_mask(pv_mask, W)
    # Baseline Test under the anchors (solve.go:74-79): kernel 1.
    conflict0, t0, f0 = cuda_bcp.planes_fixpoint(
        pts.pos_bits_r, pts.neg_bits_r, pts.card_member_bits_r,
        pts.card_valid, pts.card_n, core.pack_mask(anchor_mask, W),
        core.pack_mask(~pv_mask, W), en)
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
    asm = torch.empty((B, W), dtype=_I32, device=dev)
    m_t = torch.empty((B, W), dtype=_I32, device=dev)
    m_f = torch.empty((B, W), dtype=_I32, device=dev)
    ns = need_search.to(_I32)
    rc = lib.deppy_search(
        pts.pos_bits_r.data_ptr(), pts.neg_bits_r.data_ptr(),
        pts.card_member_bits_r.data_ptr(), pts.card_n.data_ptr(),
        pts.card_valid.data_ptr(), pts.choice_cand.data_ptr(),
        pts.var_choices.data_ptr(), t0.data_ptr(), f0.data_ptr(),
        pvb.data_ptr(), outcome0.data_ptr(), ns.data_ptr(), na.data_ptr(),
        int(budget), scratch.data_ptr(), result_s.data_ptr(),
        steps.data_ptr(), tr_n.data_ptr(), asm.data_ptr(), m_t.data_ptr(),
        m_f.data_ptr(), B, C, NA, W, NC, Kc, NV, Wch, THREADS, _stream(dev))
    search_launches += 1
    _build.check(rc, "search")
    a0 = core.planes_to_assign(t0, f0, NV)
    s_model = core.planes_to_assign(m_t, m_f, NV)
    s_guessed = core.unpack_mask(asm, NV)
    ns2 = need_search.unsqueeze(-1)
    result = torch.where(need_search, result_s, outcome0)
    result = torch.where(en, result, core.RUNNING).to(_I32)
    guessed = torch.where(ns2, s_guessed, anchor_mask)
    model = torch.where(ns2, s_model, a0)
    tr_stack = torch.full((B, 0, NC + 1), -1, dtype=_I32, device=dev)
    return result, guessed, model, steps, tr_stack, tr_n


def batched_search_plain(pts: core.ProblemTensors, budget, en: torch.Tensor):
    """Plain version of :func:`batched_search_fused`, on any device."""
    B, NC, _ = pts.choice_cand.shape
    NV = pts.var_choices.shape[1]
    dev = pts.n_vars.device
    result = torch.zeros(B, dtype=_I32, device=dev)
    steps = torch.zeros(B, dtype=_I32, device=dev)
    tr_n = torch.zeros(B, dtype=_I32, device=dev)
    guessed = torch.zeros((B, NV), dtype=torch.bool, device=dev)
    model = torch.zeros((B, NV), dtype=_I32, device=dev)
    for b in range(B):
        r, g, m, s, t = core.search_phase(core.lane(pts, b), int(budget),
                                          bool(en[b]))
        result[b], guessed[b], model[b], steps[b], tr_n[b] = r, g, m, s, t
    tr_stack = torch.full((B, 0, NC + 1), -1, dtype=_I32, device=dev)
    return result, guessed, model, steps, tr_stack, tr_n


# --------------------------------------------------------------------------
# phase 2


def _minimize_inputs(pts, result, model, guessed, en_lanes):
    NV = pts.var_choices.shape[1]
    W = pts.pos_bits_r.shape[2]
    en = en_lanes & (result == core.SAT)
    pv_mask = torch.arange(NV, device=model.device) < pts.n_vars.unsqueeze(-1)
    extras = (model == core.TRUE) & ~guessed & pv_mask
    excluded = (model != core.TRUE) & ~guessed & pv_mask
    m_init = core._apply_anchors(pts, core._base_assignment_red(pts, NV), NV)
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
                           budget, steps, en_lanes):
    """Phase 2 over a batch, gated to SAT lanes (``en_lanes & result ==
    SAT``).  Returns (installed bool[B, NV], min_found bool[B],
    steps int32[B])."""
    global minimize_launches
    B, C, W = pts.pos_bits_r.shape
    NV = pts.var_choices.shape[1]
    NA = pts.card_member_bits_r.shape[1]
    shapes = dict(pos_bits_r=(B, C, W), neg_bits_r=(B, C, W),
                  card_member_bits_r=(B, NA, W), card_n=(B, NA),
                  card_valid=(B, NA), n_vars=(B,), anchors=pts.anchors.shape)
    dev = _check_pts(pts, shapes)
    if _check_args(dict(result=result, model=model, steps=steps),
                   dict(result=(B,), model=(B, NV), steps=(B,))) != dev:
        raise ValueError("phase-1 outputs must lie on the batch's device")
    _check_mask(guessed, (B, NV), dev, "guessed")
    _check_mask(en_lanes, (B,), dev, "en")
    if dev.type == "cpu":
        return batched_minimize_plain(pts, result, model, guessed, budget,
                                      steps, en_lanes)
    lib = _build.load()
    x = _minimize_inputs(pts, result, model, guessed, en_lanes)
    en = x["en"]
    words = lib.deppy_minimize_scratch_words(NV, W)
    scratch = torch.empty((B, words), dtype=_I32, device=dev)
    found = torch.empty(B, dtype=_I32, device=dev)
    steps_out = torch.empty(B, dtype=_I32, device=dev)
    m2_t = torch.empty((B, W), dtype=_I32, device=dev)
    en32 = en.to(_I32)
    rc = lib.deppy_minimize(
        pts.pos_bits_r.data_ptr(), pts.neg_bits_r.data_ptr(),
        pts.card_member_bits_r.data_ptr(), pts.card_n.data_ptr(),
        pts.card_valid.data_ptr(), x["m_init_t"].data_ptr(),
        x["m_init_f"].data_ptr(), x["extras"].data_ptr(),
        x["m2t0"].data_ptr(), x["pvb"].data_ptr(), en32.data_ptr(),
        x["n_extras"].data_ptr(), steps.data_ptr(), int(budget),
        scratch.data_ptr(), found.data_ptr(), steps_out.data_ptr(),
        m2_t.data_ptr(), B, C, NA, W, NV, THREADS, _stream(dev))
    minimize_launches += 1
    _build.check(rc, "minimize")
    min_found = found != 0
    installed = (core.unpack_mask(m2_t, NV) & x["pv_mask"]
                 & min_found.unsqueeze(-1) & en.unsqueeze(-1))
    return installed, min_found, steps_out


def batched_minimize_plain(pts, result, model, guessed, budget, steps,
                           en_lanes):
    """Plain version of :func:`batched_minimize_fused`, on any device."""
    B, NV = model.shape
    dev = model.device
    installed = torch.zeros((B, NV), dtype=torch.bool, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    steps_out = steps.clone()
    for b in range(B):
        en = bool(en_lanes[b]) and int(result[b]) == core.SAT
        inst, fnd, s = core.minimize_phase(core.lane(pts, b), model[b],
                                           guessed[b], int(budget),
                                           int(steps[b]), en)
        installed[b], found[b], steps_out[b] = inst, fnd, s
    return installed, found, steps_out


# --------------------------------------------------------------------------
# phase 3


def _core_inputs(pts, NCON):
    NV = pts.var_choices.shape[1]
    W = pts.pos_bits.shape[2]
    V = NV + NCON
    init = core._base_assignment(pts, V, NCON)
    idx = torch.arange(V, device=init.device)
    return dict(base_t=core.pack_mask(init == core.TRUE, W),
                base_f=core.pack_mask(init == core.FALSE, W),
                pvb=core.pack_mask(idx < pts.n_vars.unsqueeze(-1), W))


def batched_core_fused(pts: core.ProblemTensors, budget, steps, en, *,
                       NCON: int):
    """Phase 3 over a batch in the full plane space (``V = NV + NCON``).
    ``en`` bool[B]; ``steps`` int32[B] carries each lane's phase-1 count.
    Returns (core bool[B, NCON], steps int32[B])."""
    global core_launches
    B, C, W = pts.pos_bits.shape
    NV = pts.var_choices.shape[1]
    NA = pts.card_member_bits.shape[1]
    if W * core.WORD < NV + NCON:
        raise ValueError(f"full-space planes of {W} words cannot hold "
                         f"NV + NCON = {NV + NCON} variables")
    shapes = dict(pos_bits=(B, C, W), neg_bits=(B, C, W),
                  card_member_bits=(B, NA, W), card_act_bits=(B, NA, W),
                  card_n=(B, NA), n_vars=(B,), n_cons=(B,))
    dev = _check_pts(pts, shapes)
    if _check_args(dict(steps=steps), dict(steps=(B,))) != dev:
        raise ValueError("steps must lie on the batch's device")
    _check_mask(en, (B,), dev, "en")
    if dev.type == "cpu":
        return batched_core_plain(pts, budget, steps, en, NCON=NCON)
    lib = _build.load()
    G = min(core.CORE_CHUNK, max(NCON, 1))
    x = _core_inputs(pts, NCON)
    words = lib.deppy_core_scratch_words(NV, W)
    scratch = torch.empty((B, words), dtype=_I32, device=dev)
    core_out = torch.empty((B, NCON), dtype=_I32, device=dev)
    steps_out = torch.empty(B, dtype=_I32, device=dev)
    en32 = en.to(_I32)
    rc = lib.deppy_core(
        pts.pos_bits.data_ptr(), pts.neg_bits.data_ptr(),
        pts.card_member_bits.data_ptr(), pts.card_n.data_ptr(),
        pts.card_act_bits.data_ptr(), x["pvb"].data_ptr(),
        x["base_t"].data_ptr(), x["base_f"].data_ptr(), en32.data_ptr(),
        pts.n_cons.data_ptr(), pts.n_vars.data_ptr(), steps.data_ptr(),
        int(budget), scratch.data_ptr(), core_out.data_ptr(),
        steps_out.data_ptr(), B, C, NA, W, NV, NCON, G, THREADS, _stream(dev))
    core_launches += 1
    _build.check(rc, "core")
    return core_out != 0, steps_out


def batched_core_plain(pts, budget, steps, en, *, NCON: int):
    """Plain version of :func:`batched_core_fused`, on any device."""
    B = steps.shape[0]
    dev = steps.device
    cores = torch.zeros((B, NCON), dtype=torch.bool, device=dev)
    steps_out = steps.clone()
    for b in range(B):
        c, s = core.core_phase(core.lane(pts, b), int(budget), int(steps[b]),
                               bool(en[b]), NCON=NCON)
        cores[b], steps_out[b] = c, s
    return cores, steps_out
