"""The tensor engine (counterpart: ``deppy_tpu/engine/__init__.py``).

:mod:`.core` holds the data model and the plain versions of the kernels,
:mod:`.cuda_bcp` and :mod:`.cuda_search` the kernel wrappers, and
:mod:`.driver` the batched resolve path.
"""

from . import cuda_bcp, cuda_search

KERNELS = ("bcp_fixpoint", "search", "minimize", "core")


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the counts were last reset."""
    return {
        "bcp_fixpoint": cuda_bcp.launches,
        "search": cuda_search.search_launches,
        "minimize": cuda_search.minimize_launches,
        "core": cuda_search.core_launches,
    }


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    cuda_bcp.launches = 0
    cuda_search.search_launches = 0
    cuda_search.minimize_launches = 0
    cuda_search.core_launches = 0
