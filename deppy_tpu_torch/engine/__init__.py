"""The tensor engine (counterpart: ``deppy_tpu/engine/__init__.py``).

:mod:`.core` holds the data model, the BCP impl selection and the plain
versions of the kernels, :mod:`.clause_bank` the watched impl's clause
bank and its plain fixpoint, :mod:`.cuda_bcp`, :mod:`.cuda_blockwise` and
:mod:`.cuda_search` the kernel wrappers of the fused phases,
:mod:`.cuda_shard` that of the clause-sharded round, :mod:`.counts`
their launch counts, :mod:`.teams` the shape rule that picks the team of
kernels 1, 4 and 5, and :mod:`.driver` the batched resolve path.
"""

from . import (counts, cuda_bcp, cuda_blockwise, cuda_search,  # noqa: F401
               cuda_shard)

KERNELS = ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
           "core", "shard_round")


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the counts were last reset."""
    return {k: counts.total(k) for k in KERNELS}


def warp_launch_counts() -> dict:
    """Launches of kernels 1, 4 and 5 (the baseline fixpoint and phases 2
    and 3) that went to the warp team, of those :func:`launch_counts`
    counts."""
    return {k: counts.total(k, team="warp")
            for k in ("bcp_fixpoint", "minimize", "core")}


def impl_launch_counts() -> dict:
    """Launches of each CUDA kernel by the BCP impl they ran under (the
    fixpoint arm: ``bits`` and ``pallas`` the dense rounds, ``blockwise``
    the sweeps, ``watched`` and ``gather`` theirs), since the counts were
    last reset: {kernel: {impl: launches}}, impls with none left out."""
    with counts._LOCK:
        impls = sorted({i for _, i, _, _ in counts.launches})
    return {k: {i: n for i in impls if (n := counts.total(k, impl=i))}
            for k in KERNELS}


def bank_launch_counts() -> dict:
    """The watched launches of each kernel that read a real clause bank
    (``"real"``) and those that ran the dense rounds on dummy banks
    (``"dummy"``), since the counts were last reset."""
    return {k: {b: counts.total(k, impl="watched", bank=b)
                for b in ("real", "dummy")} for k in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    counts.reset()
