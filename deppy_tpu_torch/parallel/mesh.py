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

Left out: ``batch_sharding`` and ``replicated_sharding`` return JAX
``NamedSharding`` objects, which PyTorch has no counterpart of — a slot's
tensors are placed by :func:`shard_batch` instead; and
:func:`initialize_distributed` (process groups across hosts) comes with
ROADMAP A6b.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch

from .. import config

BATCH_AXIS = "batch"


class Mesh:
    """An ordered tuple of shard slots, each bound to a ``torch.device``.
    ``size`` is the slot count (a device named twice is two slots)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in slot order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _card(index: int) -> torch.device:
    return torch.device("cuda", index)


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA device)
    with the single ``"batch"`` axis.  A CUDA device without a card
    raises, as every entry point of the port does."""
    from ..engine.driver import resolve_device

    if devices is None:
        resolve_device("cuda")
        devices = [_card(i) for i in range(torch.cuda.device_count())]
    return Mesh([resolve_device(d) for d in devices])


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
    is cut on its leading (batch) axis into ``mesh.size`` equal
    contiguous shards, shard *i* on slot *i*'s device.  Returns a list
    with one tree of the same structure per slot.  The batch size must
    divide evenly (mesh.py:104-112)."""

    def split(leaf) -> list:
        x = torch.as_tensor(leaf)
        n = int(x.shape[0]) if x.dim() else 0
        if x.dim() == 0 or n % mesh.size:
            raise ValueError(
                f"a batch of {n} does not split evenly over "
                f"{mesh.size} slots")
        per = n // mesh.size
        return [x[i * per:(i + 1) * per].to(dev)
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


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry (mesh.py:125-167): the reference initializes the
    JAX distributed runtime here.  The port's process groups and clause
    sharding are ROADMAP A6b."""
    raise NotImplementedError(
        "initialize_distributed is not ported yet: ROADMAP A6b (clause "
        "sharding and process groups)")
