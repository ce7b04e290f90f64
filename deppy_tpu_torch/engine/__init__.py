"""The tensor engine (counterpart: ``deppy_tpu/engine/__init__.py``).

:mod:`.core` holds the data model, the BCP impl selection and the plain
versions of the kernels, :mod:`.cuda_bcp`, :mod:`.cuda_blockwise` and
:mod:`.cuda_search` the kernel wrappers, :mod:`.teams` the shape rule
that picks the team of kernels 1, 4 and 5, and :mod:`.driver` the batched
resolve path.
"""

from . import cuda_bcp, cuda_blockwise, cuda_search

KERNELS = ("bcp_fixpoint", "blockwise_fixpoint", "search", "minimize",
           "core")


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the counts were last reset."""
    return {
        "bcp_fixpoint": cuda_bcp.launches,
        "blockwise_fixpoint": cuda_blockwise.launches,
        "search": cuda_search.search_launches,
        "minimize": cuda_search.minimize_launches,
        "core": cuda_search.core_launches,
    }


def warp_launch_counts() -> dict:
    """Launches of kernels 1, 4 and 5 (the baseline fixpoint and phases 2
    and 3) that went to the warp team, of those :func:`launch_counts`
    counts."""
    return {"bcp_fixpoint": cuda_bcp.warp_launches,
            "minimize": cuda_search.minimize_warp_launches,
            "core": cuda_search.core_warp_launches}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    cuda_bcp.launches = 0
    cuda_bcp.warp_launches = 0
    cuda_blockwise.launches = 0
    cuda_search.search_launches = 0
    cuda_search.minimize_launches = 0
    cuda_search.core_launches = 0
    cuda_search.minimize_warp_launches = 0
    cuda_search.core_warp_launches = 0
