"""The measured-defaults staleness watcher (copy of
``deppy_tpu/routes/staleness.py:1-152``).

A frozen ``portfolio`` row is only as good as the box, platform and
traffic mix it was measured on.  The defaults store
(:mod:`deppy_tpu_torch.engine.defaults`) stamps every row it writes with
provenance — ``ts``, ``box``, optional ``platform`` / ``samples`` — and
this watcher grades each size class *actually observed in live traffic*
against it:

  * ``missing``        — no ``portfolio.<class>`` / ``portfolio`` row
    exists for the serving platform at all (the static order serves);
  * ``no_provenance``  — a row exists but carries no stamp (unageable:
    treated as stale);
  * ``stale``          — the row's ``ts`` is older than
    ``DEPPY_GPU_ROUTE_MAX_AGE_S`` (default 7 days);
  * ``foreign_box``    — the row was measured on a different host.

One ``route_stale`` event fires per crossing (a flapping class does not
spam the sink), and the set of currently-flagged live classes backs the
``deppy_route_stale_classes`` gauge.  A learned-row adoption marks the
class fresh: the adopted row is a measurement from this box, now.

The platform is the registry's key of the serving device
(:func:`deppy_tpu_torch.engine.defaults.platform_of`: ``"gpu"`` for
``"cuda"``, ``"cpu"`` for ``"cpu"``), where the reference reads
``jax.default_backend()``; unnamed, it is the default device's, ``"gpu"``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Optional

DEFAULT_MAX_AGE_S = 7 * 24 * 3600.0


class StalenessWatcher:
    def __init__(self, max_age_s: Optional[float] = None,
                 platform: Optional[str] = None,
                 replica: Optional[str] = None,
                 registry=None, rows_doc: Optional[dict] = None,
                 box: Optional[str] = None):
        from .. import faults, telemetry
        from ..engine import defaults

        if max_age_s is None:
            max_age_s = faults.env_float("DEPPY_GPU_ROUTE_MAX_AGE_S",
                                         DEFAULT_MAX_AGE_S)
        self.max_age_s = float(max_age_s)
        if platform is None:
            platform = defaults.platform_of("cuda")
        self.platform = platform
        self.box = box if box is not None else socket.gethostname()
        self.replica = replica
        self._registry = (registry if registry is not None
                          else telemetry.default_registry())
        self._doc = (rows_doc if rows_doc is not None
                     else defaults.read_rows())
        self._lock = threading.Lock()
        self._live: set = set()
        self._flagged: Dict[str, dict] = {}  # class -> verdict fields
        self._fresh: set = set()  # learned-row adoptions override

    # ------------------------------------------------------------ grade

    def _grade(self, cls: str) -> Optional[dict]:
        """The staleness verdict for one class (None = fresh)."""
        entry = self._doc.get(self.platform)
        entry = entry if isinstance(entry, dict) else {}
        key = f"portfolio.{cls}"
        if not entry.get(key):
            key = "portfolio"
        row = entry.get(key)
        if not isinstance(row, str) or not row:
            return {"reason": "missing", "key": f"portfolio.{cls}"}
        ev = entry.get("evidence")
        stamp = ev.get(key) if isinstance(ev, dict) else None
        ts = stamp.get("ts") if isinstance(stamp, dict) else None
        if not isinstance(ts, (int, float)):
            return {"reason": "no_provenance", "key": key, "row": row}
        age = time.time() - float(ts)
        if age > self.max_age_s:
            return {"reason": "stale", "key": key, "row": row,
                    "age_s": round(age, 1)}
        box = stamp.get("box")
        if isinstance(box, str) and box and self.box and box != self.box:
            return {"reason": "foreign_box", "key": key, "row": row,
                    "box": box}
        return None

    def observe(self, cls: str) -> Optional[str]:
        """Note one live flush of ``cls``; returns the current
        staleness reason (None = fresh — no shadow probing needed)."""
        alert = None
        with self._lock:
            self._live.add(cls)
            if cls in self._fresh:
                self._flagged.pop(cls, None)
                return None
            verdict = self._grade(cls)
            if verdict is None:
                self._flagged.pop(cls, None)
                return None
            already = self._flagged.get(cls)
            self._flagged[cls] = verdict
            if already is None or already.get("reason") != \
                    verdict.get("reason"):
                alert = dict(verdict)
            reason = verdict["reason"]
        if alert is not None:
            fields = dict(alert, size_class_name=cls,
                          platform=self.platform)
            if self.replica:
                fields["replica"] = self.replica
            self._registry.event("route_stale", **fields)
        return reason

    def mark_fresh(self, cls: str) -> None:
        """A learned row was adopted for ``cls`` — it is measured, on
        this box, now."""
        with self._lock:
            self._fresh.add(cls)
            self._flagged.pop(cls, None)

    def reload(self, rows_doc: Optional[dict] = None) -> None:
        """Re-read the defaults registry (tests; post-persist)."""
        from ..engine import defaults

        doc = (rows_doc if rows_doc is not None
               else defaults.read_rows())
        with self._lock:
            self._doc = doc

    # --------------------------------------------------------- snapshot

    def status(self) -> Dict[str, dict]:
        with self._lock:
            return {cls: dict(v) for cls, v in self._flagged.items()}

    def stale_count(self) -> int:
        with self._lock:
            return len(self._flagged)

    def render_metric_lines(self, replica: Optional[str] = None) -> list:
        rep = f'{{replica="{replica}"}}' if replica else ""
        return [
            "# HELP deppy_route_stale_classes Live-observed size "
            "classes whose measured routing row is currently flagged "
            "stale, missing, unprovenanced, or foreign.",
            "# TYPE deppy_route_stale_classes gauge",
            f"deppy_route_stale_classes{rep} {self.stale_count()}",
        ]
