"""Mesh construction and batch-axis sharding (port of
``deppy_tpu/parallel/mesh.py:1-167``).

One 1-D logical axis, ``"batch"``: a :class:`Mesh` is an ordered tuple of
shard slots, each bound to a ``torch.device``.  The driver's sharded entry
(``engine.driver.solve_problems_sharded``) deals a batch's lanes over the
slots and runs each slot's share on a worker thread of its own, on its
slot's device, under a fault domain of its own.  No collective is needed:
problems are independent, and each slot's results come back to the host.

An explicit device list may name one device more than once.  That is the
port's counterpart of the virtual CPU devices the reference's tests run
on: ``default_mesh([torch.device("cpu")] * 4)`` drives the per-slot path
on the CPU, and ``default_mesh([torch.device("cuda", 0)] * 4)`` on one
card, where the slots share the card's stream and their launches
serialize.  :func:`serving_mesh` counts distinct devices only, so on a
one-card machine it returns None, as the reference's does under two
devices.

Process groups (mesh.py:104-167).  :func:`initialize_distributed` joins
this process to a ``torch.distributed`` group over gloo (the reference's
``jax.distributed.initialize``).  After it, a mesh built by
:func:`default_mesh` or ``clause_mesh`` spans every rank, as the
reference's ``jax.devices()`` spans the fleet: ``devices`` are this
rank's slots, ``shards`` = ranks x slots, and rank *r* owns shards
``r*size ... r*size + size - 1``.  :func:`shard_batch` on such a mesh
returns only this rank's slices, and :func:`replicate` gathers every
rank's results in shard order, the counterpart of the reference's
replicated output sharding.  Gloo and not NCCL: the exchanged buffers
live on the host beside the control, NCCL refuses two ranks on one card,
and it has no bitwise-OR reduce.

Left out: ``batch_sharding`` and ``replicated_sharding`` return JAX
``NamedSharding`` objects, which PyTorch has no counterpart of — a slot's
tensors are placed by :func:`shard_batch` and results gathered by
:func:`replicate` instead.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import List, Optional, Sequence

import torch

from .. import config

BATCH_AXIS = "batch"


class Mesh:
    """An ordered tuple of shard slots, each bound to a ``torch.device``.
    ``size`` is this process's slot count (a device named twice is two
    slots).  A mesh that spans ``ranks`` processes of a process group has
    ``size`` slots on each; this process is rank ``rank``."""

    def __init__(self, devices: Sequence, ranks: int = 1, rank: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if ranks < 1 or not 0 <= rank < ranks:
            raise ValueError(f"rank {rank} of {ranks} ranks")
        self.ranks = ranks
        self.rank = rank

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shards(self) -> int:
        """The slots of every rank: the mesh's global size."""
        return self.ranks * self.size

    @property
    def first_shard(self) -> int:
        """The global index of this rank's first slot."""
        return self.rank * self.size

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in slot order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and (self.ranks, self.rank) == (other.ranks, other.rank))

    def __hash__(self) -> int:
        return hash((self.devices, self.ranks, self.rank))

    def __repr__(self) -> str:
        if self.ranks == 1:
            return f"Mesh({[str(d) for d in self.devices]})"
        return (f"Mesh({[str(d) for d in self.devices]}, rank {self.rank} "
                f"of {self.ranks})")


def spanning(devices: Sequence) -> Mesh:
    """A mesh of ``devices`` (this rank's slots) over every rank of the
    default process group, or of this process alone without one.  Every
    rank must give as many slots (no collective checks it, so that a
    rank may build a mesh alone)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devices)
    return Mesh(devices, ranks=dist.get_world_size(), rank=dist.get_rank())


def _card(index: int) -> torch.device:
    return torch.device("cuda", index)


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA device)
    with the single ``"batch"`` axis, spanning every rank after
    :func:`initialize_distributed` (``devices`` are then this rank's
    slots).  A CUDA device without a card raises, as every entry point
    of the port does."""
    from ..engine.driver import resolve_device

    if devices is None:
        resolve_device("cuda")
        devices = [_card(i) for i in range(torch.cuda.device_count())]
    return spanning([resolve_device(d) for d in devices])


def mesh_devices_from_env() -> Optional[int]:
    """Parse ``DEPPY_GPU_MESH_DEVICES`` (mesh.py:40-67): ``all`` or
    ``-1`` → -1 (every visible card), a positive integer → that many,
    unset/empty/``0``/``1`` → None (mesh serving off — single-device
    dispatch).  Malformed values warn and degrade to off."""
    raw = (config.env_raw("DEPPY_GPU_MESH_DEVICES") or "").strip().lower()
    if not raw or raw in ("0", "1", "off", "none"):
        return None
    if raw == "all":
        return -1
    try:
        n = int(raw)
    except ValueError:
        n = None
    if n == -1:
        return -1
    if n is None or n < 0:
        print(f"[deppy] ignoring malformed DEPPY_GPU_MESH_DEVICES={raw!r} "
              f"(want an integer or 'all'); mesh serving stays off",
              file=sys.stderr, flush=True)
        return None
    return n if n > 1 else None


def _local_devices(device) -> List[torch.device]:
    """The distinct devices of ``device``'s type: every visible card for
    CUDA, the one CPU device for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [_card(i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def serving_mesh(n_devices: Optional[int] = None,
                 device="cuda") -> Optional[Mesh]:
    """The batch-axis mesh the scheduler's sharded drain dispatches over
    (mesh.py:70-99), or None when mesh serving is off.  ``n_devices`` -1
    (or ``DEPPY_GPU_MESH_DEVICES=all``) takes every distinct device of
    ``device``'s type; a count above that total clamps with a warning
    rather than failing serving, and under two devices there is no
    mesh."""
    if n_devices is None:
        n_devices = mesh_devices_from_env()
    if n_devices is None:
        return None
    devs = _local_devices(device)
    if n_devices == -1:
        n_devices = len(devs)
    if n_devices > len(devs):
        print(f"[deppy] mesh-devices={n_devices} > {len(devs)} local "
              f"devices; clamping to {len(devs)}", file=sys.stderr,
              flush=True)
        n_devices = len(devs)
    if n_devices < 2:
        return None
    return default_mesh(devs[:n_devices])


def shard_batch(mesh: Mesh, tree):
    """Per-slot copies of a stacked batch: every tensor leaf of ``tree`` (a
    tensor or array, a named tuple, a list or tuple, or a dict of them)
    is cut on its leading (batch) axis into ``mesh.shards`` equal
    contiguous shards, and this rank's ``mesh.size`` of them come back,
    shard ``first_shard + i`` on slot *i*'s device.  Returns a list with
    one tree of the same structure per slot of this rank.  The batch size
    must divide evenly (mesh.py:104-125: every rank holds the whole host
    batch and keeps its own slices)."""

    def split(leaf) -> list:
        x = torch.as_tensor(leaf)
        n = int(x.shape[0]) if x.dim() else 0
        if x.dim() == 0 or n % mesh.shards:
            raise ValueError(
                f"a batch of {n} does not split evenly over "
                f"{mesh.shards} slots")
        per = n // mesh.shards
        lo = mesh.first_shard * per
        return [x[lo + i * per:lo + (i + 1) * per].to(dev)
                for i, dev in enumerate(mesh.devices)]

    def walk(node) -> list:
        if isinstance(node, dict):
            parts = {k: walk(v) for k, v in node.items()}
            return [{k: p[i] for k, p in parts.items()}
                    for i in range(mesh.size)]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            parts = [walk(v) for v in node]
            return [type(node)(*(p[i] for p in parts))
                    for i in range(mesh.size)]
        if isinstance(node, (list, tuple)):
            parts = [walk(v) for v in node]
            return [type(node)(p[i] for p in parts)
                    for i in range(mesh.size)]
        return split(node)

    return walk(tree)


def replicate(mesh: Mesh, local_results) -> list:
    """Every rank's results in shard order, on every rank (the
    counterpart of ``replicated_sharding``, mesh.py:128-133: the
    reference's solve gathers its outputs to every process).
    ``local_results`` is this rank's list, its shards' results in order;
    its items travel pickled over the default process group.  On a mesh
    of one rank it is returned as a list."""
    local = list(local_results)
    if mesh.ranks == 1:
        return local
    import torch.distributed as dist

    parts = [None] * mesh.ranks
    dist.all_gather_object(parts, local)
    return [r for part in parts for r in part]


# The torchrun environment: with any of it set, a launcher configured a
# process group and initialize_distributed() joins it.
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry (mesh.py:136-167): join this process to a
    ``torch.distributed`` process group over gloo, so that
    :func:`default_mesh` and ``clause_mesh`` span every rank.  Call once
    per process before building a mesh.

    With no kwargs and no torchrun environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) it is a no-op, so launch scripts can
    call it unconditionally; with that environment it joins through
    ``env://``; with ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` (and ``initialization_timeout``
    in seconds, JAX's name) it joins through ``tcp://``.  Failures
    propagate: silently staying single-process in a configured cluster
    would make every process solve the whole batch."""
    import torch.distributed as dist

    if not kwargs:
        if not any(os.environ.get(k) for k in _TORCHRUN_ENV):
            return
        dist.init_process_group("gloo", init_method="env://")
        return
    extra = set(kwargs) - {"coordinator_address", "num_processes",
                           "process_id", "initialization_timeout"}
    if extra:
        raise TypeError(f"unexpected arguments {sorted(extra)}")
    timeout = kwargs.get("initialization_timeout")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{kwargs['coordinator_address']}",
        world_size=int(kwargs["num_processes"]),
        rank=int(kwargs["process_id"]),
        **({} if timeout is None else
           {"timeout": datetime.timedelta(seconds=float(timeout))}))
