"""The measured-defaults registry (copy of ``deppy_tpu/engine/defaults_store.py``, with ``measured_default`` and ``reload_measured_defaults`` of ``deppy_tpu/engine/core.py:649-705``).

A measured default is a row a measurement wrote: ``{platform: {key:
value, ..., "evidence": {key: stamp}}}`` in one JSON file.  The file is
``DEPPY_GPU_MEASURED_DEFAULTS`` when set, else ``measured_defaults.json``
beside this module; the port ships none, so every row is absent until a
measurement writes one, and a reader treats a missing or corrupt file
as no rows.

Rows are keyed by platform: ``"gpu"`` for ``device="cuda"`` and
``"cpu"`` for ``device="cpu"`` (:func:`platform_of`), where the reference
keys them by ``jax.default_backend()``.  The port reads the ``portfolio``
rows (``portfolio.<class>`` and ``portfolio``: the engine registry's
ranking, :mod:`.registry`); per-class BCP routing (``bcp.*`` rows) is
ROADMAP A7, and so are the store's writers (the reference's flock-guarded
``merge_rows`` and its ``provenance`` stamps, whose callers are the
measurement ladders and the route learner).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

_CACHE: Optional[dict] = None
_CACHE_LOCK = threading.Lock()


def registry_path(path: Optional[str] = None) -> str:
    """The registry's path: ``path``, else ``DEPPY_GPU_MEASURED_DEFAULTS``,
    else the package-local file."""
    if path:
        return path
    return os.environ.get(
        "DEPPY_GPU_MEASURED_DEFAULTS",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "measured_defaults.json"))


def platform_of(device) -> str:
    """The registry's platform key of a torch device (a string or a
    ``torch.device``): ``"gpu"`` for CUDA, the device type otherwise."""
    kind = str(device).split(":")[0]
    return "gpu" if kind == "cuda" else kind


def read_rows(path: Optional[str] = None) -> dict:
    """The whole registry document ({} when absent or corrupt: a missing
    registry is the normal cold state, never an error)."""
    try:
        with open(registry_path(path)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def measured_default(key: str, device="cuda") -> Optional[str]:
    """The measured default recorded for ``key`` on ``device``'s
    platform, or None when no measured row exists.  The file is read
    once and memoized until :func:`reload_measured_defaults`."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = read_rows()
        doc = _CACHE
    entry = doc.get(platform_of(device))
    val = entry.get(key) if isinstance(entry, dict) else None
    return val if isinstance(val, str) else None


def reload_measured_defaults() -> None:
    """Drop the memoized registry: the next read sees the file (and
    ``DEPPY_GPU_MEASURED_DEFAULTS``) as they are then."""
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = None
