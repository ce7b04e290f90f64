"""Device-mesh scale-out: batch sharding and clause sharding (counterpart:
``deppy_tpu/parallel/__init__.py``).

  * **Batch axis** (:mod:`.mesh`) — N independent problems dealt over the
    slots of a :class:`Mesh`, each slot bound to a ``torch.device``; the
    driver's sharded entry (``engine.driver.solve_problems_sharded``) runs
    one worker thread and one fault domain a slot.  No collective is
    needed: problems are independent and the results come back to the
    host (:func:`replicate` gathers them across ranks).
  * **Clause axis** (:mod:`.clause_shard`) — ONE problem's clause rows
    cut over the slots of a clause mesh, the control on the host, one OR
    exchange of forced-literal masks a propagation round (over gloo
    between ranks).  The giant-problem path.

Both span processes after :func:`initialize_distributed` (a
``torch.distributed`` group over gloo).  The reference's ``_compat``
(JAX's ``shard_map`` shim) has no counterpart.
"""

from .clause_shard import clause_mesh, solve_one_sharded, solve_sharded
from .mesh import (BATCH_AXIS, Mesh, default_mesh, initialize_distributed,
                   mesh_devices_from_env, replicate, serving_mesh,
                   shard_batch)

__all__ = [
    "BATCH_AXIS", "Mesh", "default_mesh", "initialize_distributed",
    "mesh_devices_from_env", "replicate", "serving_mesh", "shard_batch",
    "clause_mesh", "solve_one_sharded", "solve_sharded",
]
