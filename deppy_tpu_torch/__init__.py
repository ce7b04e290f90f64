"""PyTorch/CUDA port of :mod:`deppy_tpu` (counterpart: ``deppy_tpu/__init__.py``).

The batched resolve path runs on an NVIDIA H100 through CUDA kernels
written by hand (``engine/csrc``): the BCP fixpoint, the blockwise BCP
fixpoint (``engine.core.set_bcp_impl("blockwise")``) and the three phase
kernels of ``deppy_tpu.engine.pallas_search``.  Entry points default to
``device="cuda"`` and raise when no card is present; ``device="cpu"``
runs each kernel's plain PyTorch version instead.  Nothing here imports
JAX or any module of ``deppy_tpu``.
"""
