"""The measured-defaults registry (copy of ``deppy_tpu/engine/defaults_store.py:1-115``, with ``measured_default`` and ``reload_measured_defaults`` of ``deppy_tpu/engine/core.py:649-705``).

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
ROADMAP A7.2.

The one writer is :func:`merge_rows`: the whole read-merge-write runs
under an ``flock`` on a sibling ``.lock`` file, so concurrent writers (a
measurement script and a serving process persisting a learned route row)
compose instead of dropping each other's rows; the write is atomic
(``.tmp`` + ``os.replace``); and every written key gets a provenance
stamp under its platform's ``evidence`` map (``ts``, ``box`` and the
caller's fields) while sibling keys keep theirs.  :func:`provenance`
reads one stamp back; the route plane's staleness watcher
(:mod:`deppy_tpu_torch.routes.staleness`) grades rows by them.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, Optional

from .. import config

_CACHE: Optional[dict] = None
_CACHE_LOCK = threading.Lock()


def registry_path(path: Optional[str] = None) -> str:
    """The registry's path: ``path``, else ``DEPPY_GPU_MEASURED_DEFAULTS``,
    else the package-local file."""
    if path:
        return path
    return config.env_raw(
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


def provenance(backend: str, key: str,
               path: Optional[str] = None,
               doc: Optional[dict] = None) -> Optional[dict]:
    """The evidence stamp recorded for one ``backend``/``key`` row (None
    when the row was never measured, or predates evidence)."""
    if doc is None:
        doc = read_rows(path)
    entry = doc.get(backend)
    if not isinstance(entry, dict):
        return None
    ev = entry.get("evidence")
    if not isinstance(ev, dict):
        return None
    stamp = ev.get(key)
    return stamp if isinstance(stamp, dict) else None


def merge_rows(backend: str, updates: Dict[str, object],
               evidence: Optional[dict] = None,
               path: Optional[str] = None) -> str:
    """Merge ``updates`` into ``backend``'s rows under the registry
    flock; other platforms' rows and this platform's other keys survive.
    Each updated key's evidence stamp is replaced with the caller's
    ``evidence`` fields plus ``ts`` and ``box``: provenance belongs to
    the run that measured the row, so unmeasured siblings keep theirs.
    Returns the path written.  The memoized read of
    :func:`measured_default` is not dropped (the caller reloads)."""
    import fcntl

    target = registry_path(path)
    stamp = dict(evidence or {})
    stamp.setdefault("ts", round(time.time(), 1))
    stamp.setdefault("box", socket.gethostname())
    with open(target + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            data = read_rows(target)
            entry = data.get(backend)
            if not isinstance(entry, dict):
                entry = {}
            entry.update(updates)
            ev = entry.get("evidence")
            if not isinstance(ev, dict):
                ev = {}
            for key in updates:
                ev[key] = dict(stamp)
            entry["evidence"] = ev
            data[backend] = entry
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, target)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return target


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
