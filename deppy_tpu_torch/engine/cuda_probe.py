"""Kernels 7 and 8, the speculative core's probes: CUDA wrappers (counterpart: ``deppy_tpu/engine/core.py:1754-1808``, vmapped XLA with no ``pallas_call`` site).

* :func:`batched_probe_fixpoint` — stage 1 (``csrc/probe.cu``
  ``probe_fixpoint_kernel``): one fixpoint per single-drop probe;
* :func:`batched_probe` — stage 2 and the verification probe
  (``probe_dpll_kernel``): one DPLL per activation subset.

Both take ONE problem's tensors ``pt`` (no batch axis), shared by every
lane, as ``core.batched_probe_fixpoint`` and ``core.batched_probe`` do,
and keep their signatures.  A CUDA lane axis launches the kernel (one
thread block a lane, the problem read in place by every block: it is
never copied per lane); a CPU one runs the plain version
(:func:`.core.probe_fixpoint_lanes`, :func:`.core.probe_lanes`).  The
driver calls ``core.batched_probe_fixpoint`` and ``core.batched_probe``,
which send a CUDA tensor here.  The problem's planes are those of the
full space (``V = NV + NCON``) under every impl, as in the core phase: dense planes
for the dense rounds, compact rows (``rows``, else built here) under
``blockwise`` and for the watched arm's entry round, the full-space bank
under ``watched`` and the raw rows under ``gather``
(:func:`.cuda_search.launch_arm`).  Every launch counts once in
:mod:`.counts`, on the block team.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, core, counts, cuda_blockwise, cuda_search

_I32 = torch.int32


def _shared(pt: core.ProblemTensors) -> core.ProblemTensors:
    """``pt`` as a batch of one (views: nothing is copied)."""
    return core.ProblemTensors(*[x.unsqueeze(0) for x in pt])


def _setup(pt: core.ProblemTensors, NCON: int, impl: str,
           block_rows: Optional[int],
           rows: Optional[cuda_blockwise.Compact]):
    """Check ``pt`` and give (pts, dev, W, tile, arm) of a launch."""
    if not isinstance(pt, core.ProblemTensors) or pt.n_vars.dim() != 0:
        raise ValueError("pt must be one problem's ProblemTensors (no "
                         "batch axis)")
    cuda_search._reduced(impl)
    pts = _shared(pt)
    C, NA = pts.clauses.shape[1], pts.card_ids.shape[1]
    W = cuda_search._full_words(pts, NCON)
    tile = cuda_search._tile(impl, block_rows, pts, W)
    arm = cuda_search.launch_arm(pts, impl, False, W, rows)
    shapes = dict(cuda_search._phase_shapes(
        pts, False, W, cuda_search._dense(pts, impl, arm)),
        card_n=(1, NA), n_vars=(1,), n_cons=(1,))
    dev = cuda_search._check_phase(pts, shapes, arm, C, NA, W)
    return pts, dev, W, tile, arm


def _launch(pts, W: int, tile: int, rows, arm):
    """The row pointers, compact dims and arm of a launch on ``pts``."""
    rows = cuda_search._launch_rows(pts, W, tile, rows)
    ptrs, dims, a = cuda_search._row_args(
        pts, (pts.pos_bits, pts.neg_bits, pts.card_member_bits), False, W,
        tile, rows, arm)
    return ptrs, dims, a


def batched_probe_fixpoint(pt: core.ProblemTensors, drops: torch.Tensor, *,
                           NCON: int, block_rows: Optional[int] = None,
                           impl: str = "bits",
                           rows: Optional[cuda_blockwise.Compact] = None
                           ) -> torch.Tensor:
    """Stage 1: ``drops`` int32[P] on ``pt``'s device.  Returns conflict
    bool[P] (see ``core.batched_probe_fixpoint``)."""
    pts, dev, W, tile, arm = _setup(pt, NCON, impl, block_rows, rows)
    if cuda_search._check_args(dict(drops=drops),
                               dict(drops=(drops.shape[0],))) != dev:
        raise ValueError("drops must lie on the problem's device")
    if dev.type == "cpu":
        return core.probe_fixpoint_lanes(pt, drops, NCON=NCON,
                                         block_rows=tile, impl=impl)
    lib = _build.load()
    P = drops.shape[0]
    NV = pts.var_choices.shape[1]
    ptrs, dims, a = _launch(pts, W, tile, rows, arm)
    conflict = torch.empty(P, dtype=_I32, device=dev)
    rc = lib.deppy_probe_fixpoint(
        *ptrs[:3], pts.card_n.data_ptr(), *ptrs[4:],
        pts.n_vars.data_ptr(), pts.n_cons.data_ptr(), drops.data_ptr(),
        conflict.data_ptr(), P, pts.clauses.shape[1], pts.card_ids.shape[1],
        W, NV + NCON, *dims, cuda_search._threads(impl, arm),
        cuda_search._arm_ptr(a), cuda_search._stream(dev))
    counts.count("probe_fixpoint", impl, "block", arm)
    _build.check(rc, f"probe_fixpoint ({impl})")
    return conflict != 0


def batched_probe(pt: core.ProblemTensors, masks: torch.Tensor, budget, *,
                  NCON: int, block_rows: Optional[int] = None,
                  impl: str = "bits",
                  rows: Optional[cuda_blockwise.Compact] = None):
    """Stage 2 and the verification probe: ``masks`` bool[Q, NCON] on
    ``pt``'s device, one ``budget``.  Returns (status int32[Q], steps
    int32[Q]) (see ``core.batched_probe``)."""
    pts, dev, W, tile, arm = _setup(pt, NCON, impl, block_rows, rows)
    cuda_search._check_mask(masks, (masks.shape[0], NCON), dev, "masks")
    if dev.type == "cpu":
        return core.probe_lanes(pt, masks, budget, NCON=NCON,
                                block_rows=tile, impl=impl)
    lib = _build.load()
    Q = masks.shape[0]
    NV = pts.var_choices.shape[1]
    ptrs, dims, a = _launch(pts, W, tile, rows, arm)
    words = -(-NCON // core.WORD)
    packed = core.pack_mask(masks, words)
    scratch = torch.empty((Q, lib.deppy_probe_scratch_words(NV, W)),
                          dtype=_I32, device=dev)
    status = torch.empty(Q, dtype=_I32, device=dev)
    steps = torch.empty(Q, dtype=_I32, device=dev)
    rc = lib.deppy_probe_dpll(
        *ptrs[:3], pts.card_n.data_ptr(), *ptrs[4:],
        pts.n_vars.data_ptr(), pts.n_cons.data_ptr(), packed.data_ptr(),
        words, int(budget), scratch.data_ptr(), status.data_ptr(),
        steps.data_ptr(), Q, pts.clauses.shape[1], pts.card_ids.shape[1], W,
        NV + NCON, NV, *dims, cuda_search._threads(impl, arm),
        cuda_search._arm_ptr(a), cuda_search._stream(dev))
    counts.count("probe_dpll", impl, "block", arm)
    _build.check(rc, f"probe_dpll ({impl})")
    return status, steps
