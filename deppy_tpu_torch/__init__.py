"""PyTorch/CUDA port of :mod:`deppy_tpu` (counterpart: ``deppy_tpu/__init__.py``).

Layers, bottom-up:
  * :mod:`deppy_tpu_torch.config` — the typed registry of every
    ``DEPPY_GPU_*`` knob, which every module reads through;
  * :mod:`deppy_tpu_torch.sat` — constraint vocabulary, tensor lowering,
    the host spec engine and the :class:`~deppy_tpu_torch.sat.Solver`
    facade with its assumption scopes;
  * :mod:`deppy_tpu_torch.engine` — the batched tensor engine, whose
    kernels are CUDA written by hand (``engine/csrc``): the BCP fixpoint,
    the blockwise BCP fixpoint
    (``engine.core.set_bcp_impl("blockwise")``) and the three phase
    kernels of ``deppy_tpu.engine.pallas_search``;
  * :mod:`deppy_tpu_torch.entity` — entities and entity sources;
  * :mod:`deppy_tpu_torch.resolution` — constraint generators, the
    ``Resolver`` and the ``BatchResolver``;
  * :mod:`deppy_tpu_torch.io` — the JSON problem codec;
  * :mod:`deppy_tpu_torch.models` — the workload families;
  * :mod:`deppy_tpu_torch.telemetry` — the span/counter/histogram
    registry and the per-batch ``SolveReport`` the driver fills;
  * :mod:`deppy_tpu_torch.parallel` — the mesh whose slots the driver's
    sharded entry deals a batch over.

Entry points default to ``backend="device"`` on ``device="cuda"`` and
raise when no card is present; ``device="cpu"`` runs each kernel's plain
PyTorch version, ``backend="host"`` the host engine.  Nothing here imports
JAX or any module of ``deppy_tpu``.
"""

from . import entity, models, resolution, sat, telemetry

__all__ = ["entity", "models", "resolution", "sat", "telemetry"]
