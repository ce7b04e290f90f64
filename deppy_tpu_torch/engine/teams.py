"""The shape rule that picks the team of kernels 1, 4 and 5.

Kernel 1 (the baseline fixpoint, ``cuda_bcp.bcp_fixpoint``) and phases 2
and 3 (``cuda_search.batched_minimize_fused`` and ``batched_core_fused``)
have two kernels each: the block team (one thread block per problem,
``bcp_kernel`` / ``minimize_kernel`` / ``core_kernel``) and the warp team
(one warp per problem, :data:`WARPS` problems per block, the problem's
planes, working words and, where they fit, DPLL snapshots in the warp's
slice of shared memory: ``bcp_warp_kernel`` / ``minimize_warp_kernel`` /
``core_warp_kernel`` on ``csrc/warp.cuh``).  Both compute the same
function.  :func:`team` picks one per launch from the impl and the shape
alone: the warp team for the dense rounds (the ``bits`` and ``pallas``
impls, tile 0) at ``W <= 32`` words whose slice fits the per-problem
budget (:func:`problem_budget`), which is every bits-path launch of the
main path's families; the block team otherwise: every ``blockwise``
launch, every ``watched`` and ``gather`` launch (their arms,
``csrc/watched.cuh``, are block-wide; a watched launch on dummy banks
too), and kernel 1 on the full-space planes of a big catalog.
``_team="block"|"warp"`` on the wrappers forces one, for
``chip_smoke.py``'s measurement only; a forced warp team on a launch the
rule refuses raises (:func:`plan`).

``cuda_search.WARPS`` reads and sets :data:`WARPS`, so either name
governs every team.
"""

from __future__ import annotations

from typing import Optional

from . import core
from ._build import KernelLaunchError

# The opt-in shared memory of one thread block on the H100.
SMEM_BYTES = 232448

# Problems (warps) per thread block of the warp team, picked by
# chip_smoke.py's measurement on the H100 (PERF.md §6).
WARPS = 4


def warp_smem_bytes(kernel: str, C: int, NA: int, W: int, NV: int,
                    NCON: int, snapshots: bool) -> int:
    """Shared bytes of one problem's warp slice for ``kernel`` (``"bcp"``,
    ``"minimize"`` or ``"core"``; ``deppy_{bcp,minimize,core}_warp_smem_
    bytes`` of the kernel library, which :func:`check_slice` holds this
    against): the pos/neg/AtMost planes and the AtMost bounds, activity
    source and activity (``warp_work_words``), the core kernel's
    ``active`` [NCON], and the DPLL snapshots and decision arrays when
    ``snapshots`` (kernel 1 runs no DPLL and has none); 16-byte
    aligned."""
    if kernel not in ("bcp", "minimize", "core"):
        raise ValueError(f"no warp team for kernel {kernel!r}")
    if kernel == "bcp" and snapshots:
        raise ValueError("kernel 1 keeps no DPLL snapshots")
    words = (2 * C + NA) * W + 3 * NA
    if kernel == "core":
        words += NCON
    if snapshots:
        words += 2 * (NV + 1) * W + 2 * NV
    return (4 * words + 15) & ~15


def problem_budget() -> int:
    """Shared bytes one problem's slice may take: a block's opt-in shared
    memory split over :data:`WARPS` problems."""
    return SMEM_BYTES // WARPS // 16 * 16


# The impls whose fixpoint is the dense rounds, which the warp team runs.
WARP_IMPLS = ("bits", "pallas")


def team(tile: int, W: int, smem: int, impl: str = "bits") -> str:
    """The team of a launch of kernel 1, 4 or 5: ``"warp"`` for the dense
    rounds (``impl`` in :data:`WARP_IMPLS`, ``tile`` 0) over at most 32
    plane words (one a lane) whose warp slice without snapshots, ``smem``
    bytes (:func:`warp_smem_bytes`), fits :func:`problem_budget`;
    ``"block"`` otherwise."""
    if (impl in WARP_IMPLS and tile == 0 and W <= core.WORD
            and smem <= problem_budget()):
        return "warp"
    return "block"


def plan(kernel: str, tile: int, C: int, NA: int, W: int, NV: int,
         NCON: int, forced: Optional[str], impl: str = "bits"):
    """(team, snapshots in the slice) of one launch: :func:`team`, or the
    measurement's ``forced`` team, which raises where the rule refuses
    the warp team.  The warp team keeps the DPLL snapshots in each warp's
    slice where they fit the budget too, else in global scratch."""
    lean = warp_smem_bytes(kernel, C, NA, W, NV, NCON, False)
    picked = team(tile, W, lean, impl)
    if forced not in (None, "block", "warp"):
        raise ValueError(f"unknown team {forced!r}")
    if forced == "warp" and picked != "warp":
        raise ValueError(
            f"the warp team does not take this {kernel} launch: impl "
            f"{impl!r}, tile {tile}, W {W}, {lean} shared bytes a problem "
            f"against a budget of {problem_budget()} ({WARPS} warps a "
            f"block)")
    chosen = forced or picked
    snaps = (chosen == "warp" and kernel != "bcp" and warp_smem_bytes(
        kernel, C, NA, W, NV, NCON, True) <= problem_budget())
    return chosen, snaps


def check_slice(lib, kernel: str, C: int, NA: int, W: int, NV: int,
                NCON: int, snaps: bool) -> None:
    """Raise unless the kernel library's slice size is
    :func:`warp_smem_bytes`."""
    if kernel == "bcp":
        got = lib.deppy_bcp_warp_smem_bytes(C, NA, W)
    elif kernel == "core":
        got = lib.deppy_core_warp_smem_bytes(C, NA, W, NV, NCON, int(snaps))
    else:
        got = lib.deppy_minimize_warp_smem_bytes(C, NA, W, NV, int(snaps))
    want = warp_smem_bytes(kernel, C, NA, W, NV, NCON, snaps)
    if got != want:
        raise KernelLaunchError(
            f"{kernel} warp slice: the kernel library counts {got} bytes, "
            f"warp_smem_bytes {want}")
