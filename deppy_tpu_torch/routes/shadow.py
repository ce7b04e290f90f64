"""The shadow-race sampler (copy of ``deppy_tpu/routes/shadow.py:1-73``).

For size classes whose measured routing row is stale or missing, a
deterministic 1-in-N sampler duplicates an already-coalesced live flush
to ONE candidate backend that is *not* serving it, through the
scheduler's idle-priority queue — live traffic preempts every shadow
dispatch at the flush boundary, and the probe's answers are discarded
(its wall clock feeds the regret ledger and the online registry through
a ``route`` sink event, never a response).

A per-class flush counter (not an RNG) decides which flushes probe, so
replaying a workload replays its shadow schedule, and the candidate
rotates per class, so repeated probes sweep the whole non-serving field.
The rate knob is ``DEPPY_GPU_ROUTE_SHADOW_RATE`` (default 1 in 16); the
candidates are ranked for the serving ``device`` (the engine registry's
rows are per platform).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

DEFAULT_SHADOW_RATE = 0.0625  # 1-in-16 flushes of a flagged class


class ShadowSampler:
    def __init__(self, rate: Optional[float] = None, device="cuda"):
        from .. import faults

        if rate is None:
            rate = faults.env_float("DEPPY_GPU_ROUTE_SHADOW_RATE",
                                    DEFAULT_SHADOW_RATE)
        rate = max(float(rate), 0.0)
        self.interval = (int(round(1.0 / min(rate, 1.0)))
                         if rate > 0 else 0)
        self.device = device
        self._lock = threading.Lock()
        self._count: Dict[str, int] = {}
        self._rotate: Dict[str, int] = {}

    def candidates(self, cls: str, exclude: Sequence[str],
                   cardinality: bool = False,
                   device_ok: bool = True) -> List[str]:
        """Non-serving raceable backends for one class, in ranked
        order (the registry's capability/availability filter minus the
        backends the live race already measures)."""
        from ..engine import registry as engine_registry

        names, _ = engine_registry.candidates(
            cls, k=len(engine_registry.specs()), device_ok=device_ok,
            cardinality=cardinality, device=self.device)
        drop = set(exclude)
        return [n for n in names if n not in drop]

    def pick(self, cls: str, exclude: Sequence[str],
             cardinality: bool = False,
             device_ok: bool = True) -> Optional[str]:
        """The backend to shadow-probe for THIS flush of a flagged
        class, or None (off-sample, rate 0, or nothing to probe)."""
        if self.interval == 0:
            return None
        with self._lock:
            c = self._count.get(cls, 0)
            self._count[cls] = c + 1
            if c % self.interval:
                return None
            cands = self.candidates(cls, exclude,
                                    cardinality=cardinality,
                                    device_ok=device_ok)
            if not cands:
                return None
            i = self._rotate.get(cls, 0)
            self._rotate[cls] = i + 1
            return cands[i % len(cands)]
