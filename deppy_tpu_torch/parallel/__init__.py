"""Device-mesh scale-out on the batch axis (counterpart:
``deppy_tpu/parallel/__init__.py``).

  * **Batch axis** (:mod:`.mesh`) — N independent problems dealt over the
    slots of a :class:`Mesh`, each slot bound to a ``torch.device``; the
    driver's sharded entry (``engine.driver.solve_problems_sharded``) runs
    one worker thread and one fault domain a slot.  No collective is
    needed: problems are independent and the results come back to the
    host.
  * **Clause axis** — ONE problem's clause rows sharded over devices, and
    the process groups that span hosts: ROADMAP A6b
    (:func:`initialize_distributed` raises until then).  The reference's
    ``_compat`` (JAX's ``shard_map`` shim) has no counterpart.
"""

from .mesh import (BATCH_AXIS, Mesh, default_mesh, initialize_distributed,
                   mesh_devices_from_env, serving_mesh, shard_batch)

__all__ = [
    "BATCH_AXIS", "Mesh", "default_mesh", "initialize_distributed",
    "mesh_devices_from_env", "serving_mesh", "shard_batch",
]
