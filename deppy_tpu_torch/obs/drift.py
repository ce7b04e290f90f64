"""Cost-model drift watchdog (copy of ``deppy_tpu/obs/drift.py:1-217``):
live µs/trip vs the baseline.

The profiler's trip ledger emits one ``profile`` event per sampled
device dispatch carrying ``trips`` and ``solve_s``.  The
:class:`CostModelWatchdog` registers as a registry event forwarder and
folds those samples into a bounded window per size class, computing
the **effective µs/trip** — ``1e6 * Σ solve_s / Σ trips`` over the
window.  The ratio-of-sums is deliberately used instead of the OLS
slope the profile report fits: a *constant* per-dispatch overhead
regression (the classic deploy bug — extra sync, extra host hop) moves
only the regression intercept and would be invisible to the slope,
while it inflates the effective per-trip cost exactly in proportion to
the damage done.

The live figure is compared against a baseline artifact (a
``BENCH_rNN.json``-shaped file with a ``costmodel`` section, a bare
costmodel object, or a :func:`deppy_tpu_torch.profile.report.summarize`
report — the ``deppy profile --json`` shape).  Past the relative band
(``DEPPY_GPU_OBS_DRIFT_BAND``, 0.5) the watchdog emits one
``costmodel_drift`` event per crossing and the
``deppy_costmodel_drift_ratio{size_class,replica}`` gauge sits past
the band until the window recovers.  A class enters the ratio only
after ``DEPPY_GPU_OBS_DRIFT_MIN`` (8) windowed samples.

No baseline = no watchdog object = byte-identical pipeline.  The lock
is a plain ``threading`` lock where the reference takes a lockdep-named
one.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, Optional

WINDOW = 64  # samples retained per size class
# A size class's first dispatches pay the kernels' first-call costs
# inside their measured wall clock (driver.py: the first launch of a
# class lies inside the ``dispatch_t0`` window) — seconds against a
# sub-millisecond steady state.  One such sample would dominate the
# ratio-of-sums for a full window and read as drift on a perfectly
# healthy replica, so the watchdog discards each class's first samples
# as warm-up before windowing begins.
WARMUP_SAMPLES = 2


def load_baseline(path: str) -> Optional[Dict[str, float]]:
    """Per-size-class baseline µs/trip from a committed artifact.

    Accepted shapes (first match wins per field):

      * ``BENCH_rNN.json`` — ``{"costmodel": {"us_per_trip": g,
        "size_classes": {cls: {"us_per_trip": x}}}}``;
      * a bare costmodel object of the same shape;
      * a ``deppy profile --json`` report — per-class µs/trip derived
        from each class's ``solve_s``/``trips``, global fallback from
        ``trip_overhead.us_per_trip``.

    Returns ``{size_class: us_per_trip}`` with the global fallback
    under ``"*"``; None when the file is unreadable or carries no
    usable figure (the watchdog then stays disarmed)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    cm = doc.get("costmodel")
    if isinstance(cm, dict):
        doc = cm
    out: Dict[str, float] = {}
    classes = doc.get("size_classes")
    if isinstance(classes, dict):
        for cls, row in classes.items():
            if not isinstance(row, dict):
                continue
            us = row.get("us_per_trip")
            if us is None and row.get("trips") and row.get("solve_s"):
                us = float(row["solve_s"]) * 1e6 / float(row["trips"])
            if isinstance(us, (int, float)) and us > 0:
                out[str(cls)] = float(us)
    glob = doc.get("us_per_trip")
    if glob is None and isinstance(doc.get("trip_overhead"), dict):
        glob = doc["trip_overhead"].get("us_per_trip")
    if isinstance(glob, (int, float)) and glob > 0:
        out["*"] = float(glob)
    return out or None


class CostModelWatchdog:
    """Registry forwarder comparing live effective µs/trip per size
    class against a committed baseline."""

    def __init__(self, baseline: Dict[str, float],
                 band: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 replica: Optional[str] = None,
                 registry=None):
        from .. import config, telemetry
        from ..profile import sanitize_replica

        if band is None:
            band = config.env_float("DEPPY_GPU_OBS_DRIFT_BAND", 0.5,
                                    strict=False)
        if min_samples is None:
            min_samples = config.env_int("DEPPY_GPU_OBS_DRIFT_MIN", 8,
                                         strict=False)
        self.baseline = dict(baseline)
        self.band = float(band)
        self.min_samples = max(int(min_samples), 2)
        self.replica = sanitize_replica(replica)
        self._registry = (registry if registry is not None
                          else telemetry.default_registry())
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {}
        self._warmup: Dict[str, int] = {}
        self._ratios: Dict[str, dict] = {}
        self._alerted: set = set()

    @classmethod
    def from_baseline(cls, path: str, replica: Optional[str] = None,
                      **kw) -> Optional["CostModelWatchdog"]:
        baseline = load_baseline(path)
        if baseline is None:
            return None
        return cls(baseline, replica=replica, **kw)

    def install(self) -> None:
        self._registry.add_forwarder(self)

    def close(self) -> None:
        self._registry.remove_forwarder(self)

    # --------------------------------------------------------- event side

    def __call__(self, event: dict) -> None:
        if event.get("kind") != "profile":
            return
        trips = event.get("trips")
        solve_s = event.get("solve_s")
        if not trips or not solve_s:
            return
        cls = str(event.get("size_class_name")
                  or event.get("size_class") or "?")
        base = self.baseline.get(cls, self.baseline.get("*"))
        if base is None:
            return
        alert = None
        with self._lock:
            seen = self._warmup.get(cls, 0)
            if seen < WARMUP_SAMPLES:
                self._warmup[cls] = seen + 1
                return
            window = self._windows.get(cls)
            if window is None:
                window = self._windows[cls] = deque(maxlen=WINDOW)
            window.append((float(trips), float(solve_s)))
            if len(window) < self.min_samples:
                return
            sum_trips = sum(t for t, _ in window)
            if sum_trips <= 0:
                return
            live = 1e6 * sum(s for _, s in window) / sum_trips
            ratio = live / base
            drifted = abs(ratio - 1.0) > self.band
            self._ratios[cls] = {
                "live_us_per_trip": round(live, 3),
                "baseline_us_per_trip": round(base, 3),
                "ratio": round(ratio, 4),
                "samples": len(window),
                "drift": drifted,
            }
            if drifted and cls not in self._alerted:
                self._alerted.add(cls)
                alert = self._ratios[cls]
            elif not drifted:
                self._alerted.discard(cls)
        if alert is not None:
            fields = dict(alert, size_class=cls, band=self.band)
            fields.pop("drift", None)
            if self.replica:
                fields["replica"] = self.replica
            self._registry.event("costmodel_drift", **fields)

    # ------------------------------------------------------------- render

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {cls: dict(row)
                    for cls, row in self._ratios.items()}

    def render_metric_lines(self) -> list:
        with self._lock:
            rows = sorted(self._ratios.items())
        if not rows:
            return []
        rep = (f',replica="{self.replica}"' if self.replica else "")
        lines = [
            "# HELP deppy_costmodel_drift_ratio Live effective us/trip "
            "over the committed baseline per size class (1.0 = "
            "on-model; past the band = drift).",
            "# TYPE deppy_costmodel_drift_ratio gauge",
        ]
        for cls, row in rows:
            lines.append(
                f'deppy_costmodel_drift_ratio{{size_class="{cls}"{rep}}} '
                f"{row['ratio']}")
        lines += [
            "# HELP deppy_costmodel_us_per_trip Live effective us/trip "
            "per size class (windowed ratio of sums from sampled "
            "profile events).",
            "# TYPE deppy_costmodel_us_per_trip gauge",
        ]
        for cls, row in rows:
            lines.append(
                f'deppy_costmodel_us_per_trip{{size_class="{cls}"{rep}}} '
                f"{row['live_us_per_trip']}")
        return lines
