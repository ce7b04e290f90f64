"""The regret ledger (copy of ``deppy_tpu/routes/ledger.py:1-253``): wall
time lost to the frozen routing default, measured from the racer's own
exhaust.

Every ``race`` sink event carries the counterfactual the ledger needs:
the winner's wall clock, plus one ``losers`` entry per non-winning
entrant with its wall clock and a ``censored`` flag (a cancelled loser's
partial wall measures when the cancel landed, not how fast the backend
solves, so it never feeds a speed estimate).  The ledger folds those,
plus ``route`` events from shadow probes, into:

  * decayed per-(size-class, backend) **wall estimates** — an EWMA of
    µs-per-lane over uncensored observations, the figure the online
    route registry ranks by;
  * per-class **win shares** (``deppy_route_win_share``);
  * a per-class **regret total** (``deppy_route_regret_seconds_total``)
    charged to the frozen default backend: each race where the ranked
    head (the event's ``default``) did not win adds the wall the default
    burned (observed uncensored, else its decayed estimate) minus the
    winner's wall.

The same :meth:`RegretLedger.fold` drives the live forwarder and the
offline reconstruction (:mod:`.report`).  The decay knob is
``DEPPY_GPU_ROUTE_DECAY`` (the reference's ``DEPPY_TPU_ROUTE_DECAY``),
read by the route plane; the lock is a plain ``threading.Lock``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

DEFAULT_DECAY = 0.2


class RegretLedger:
    """Fold ``race``/``route`` events into per-class route-health
    state.  Thread-safe (the live path calls :meth:`fold` from racer
    and dispatch-loop threads concurrently)."""

    def __init__(self, decay: Optional[float] = None):
        self.decay = DEFAULT_DECAY if decay is None else float(decay)
        self.decay = min(max(self.decay, 0.01), 1.0)
        self._lock = threading.Lock()
        # (class, backend) -> {"us_per_lane": ewma, "samples": n}
        self._est: Dict[Tuple[str, str], dict] = {}
        # (class, backend) -> censored-loser observations (cancels).
        self._censored: Dict[Tuple[str, str], int] = {}
        self._wins: Dict[str, Dict[str, int]] = {}
        self._races: Dict[str, int] = {}
        self._no_winner: Dict[str, int] = {}
        # (class, backend) -> accumulated regret seconds charged to the
        # frozen default backend.
        self._regret: Dict[Tuple[str, str], float] = {}
        self._default: Dict[str, str] = {}  # latest default per class
        self._shadow: Dict[str, int] = {}  # backend -> shadow dispatches
        self._shadow_failed: Dict[str, int] = {}

    # ------------------------------------------------------------- fold

    def _observe(self, cls: str, backend: str, wall_s: float,
                 lanes: int) -> None:
        us = 1e6 * float(wall_s) / max(int(lanes or 1), 1)
        row = self._est.get((cls, backend))
        if row is None:
            self._est[(cls, backend)] = {"us_per_lane": us, "samples": 1}
            return
        a = self.decay
        row["us_per_lane"] = (1.0 - a) * row["us_per_lane"] + a * us
        row["samples"] += 1

    def fold(self, event: dict) -> None:
        kind = event.get("kind")
        if kind == "race":
            self._fold_race(event)
        elif kind == "route" and event.get("phase") == "shadow":
            self._fold_shadow(event)

    def _fold_race(self, ev: dict) -> None:
        cls = ev.get("size_class_name")
        if not cls:
            return
        cls = str(cls)
        winner = ev.get("winner")
        default = ev.get("default")
        lanes = ev.get("lanes") or 1
        wall = ev.get("wall_s")
        losers = ev.get("losers")
        with self._lock:
            if winner is None:
                # No definitive finisher (or a straggler-triage marker
                # event): nothing raced to a usable wall clock.
                if ev.get("entrants"):
                    self._no_winner[cls] = self._no_winner.get(cls, 0) + 1
                return
            self._races[cls] = self._races.get(cls, 0) + 1
            wins = self._wins.setdefault(cls, {})
            wins[winner] = wins.get(winner, 0) + 1
            if isinstance(default, str):
                self._default[cls] = default
            if isinstance(wall, (int, float)):
                self._observe(cls, str(winner), wall, lanes)
            default_wall = None
            if isinstance(losers, list):
                for loser in losers:
                    if not isinstance(loser, dict):
                        continue
                    b = loser.get("backend")
                    lw = loser.get("wall_s")
                    if not isinstance(b, str):
                        continue
                    if loser.get("censored") or not isinstance(
                            lw, (int, float)):
                        self._censored[(cls, b)] = self._censored.get(
                            (cls, b), 0) + 1
                        continue
                    self._observe(cls, b, lw, lanes)
                    if b == default:
                        default_wall = float(lw)
            # Regret: the default backend did not win this race — charge
            # it the wall it burned beyond the winner's.  Censored
            # defaults fall back to the decayed estimate (a cancel means
            # "at least this slow"; the estimate is the unbiased floor).
            if (isinstance(default, str) and default != winner
                    and isinstance(wall, (int, float))):
                if default_wall is None:
                    est = self._est.get((cls, default))
                    if est is not None:
                        default_wall = (est["us_per_lane"]
                                        * max(int(lanes or 1), 1) / 1e6)
                if default_wall is not None:
                    inc = max(default_wall - float(wall), 0.0)
                    key = (cls, default)
                    self._regret[key] = self._regret.get(key, 0.0) + inc

    def _fold_shadow(self, ev: dict) -> None:
        cls = ev.get("size_class_name")
        backend = ev.get("backend")
        if not cls or not isinstance(backend, str):
            return
        cls = str(cls)
        with self._lock:
            self._shadow[backend] = self._shadow.get(backend, 0) + 1
            if not ev.get("ok"):
                self._shadow_failed[backend] = \
                    self._shadow_failed.get(backend, 0) + 1
                return
            wall = ev.get("wall_s")
            if isinstance(wall, (int, float)):
                self._observe(cls, backend, wall, ev.get("lanes") or 1)

    # ---------------------------------------------------------- snapshot

    def estimates(self) -> Dict[str, Dict[str, dict]]:
        """{class: {backend: {"us_per_lane", "samples", "censored"}}}"""
        with self._lock:
            out: Dict[str, Dict[str, dict]] = {}
            for (cls, backend), row in self._est.items():
                out.setdefault(cls, {})[backend] = {
                    "us_per_lane": round(row["us_per_lane"], 3),
                    "samples": row["samples"],
                    "censored": self._censored.get((cls, backend), 0),
                }
            for (cls, backend), n in self._censored.items():
                out.setdefault(cls, {}).setdefault(backend, {
                    "us_per_lane": None, "samples": 0, "censored": n})
            return out

    def snapshot(self) -> Dict[str, dict]:
        """Per-class route-health rows (the offline report's live
        twin)."""
        with self._lock:
            classes = (set(self._races) | set(self._no_winner)
                       | {c for c, _ in self._est})
            out: Dict[str, dict] = {}
            for cls in sorted(classes):
                races = self._races.get(cls, 0)
                wins = dict(self._wins.get(cls, {}))
                regret = {b: round(s, 6)
                          for (c, b), s in self._regret.items()
                          if c == cls}
                out[cls] = {
                    "races": races,
                    "no_winner": self._no_winner.get(cls, 0),
                    "default": self._default.get(cls),
                    "wins": wins,
                    "win_share": {b: round(n / races, 4)
                                  for b, n in sorted(wins.items())}
                    if races else {},
                    "regret_s": regret,
                    "censored": {b: n
                                 for (c, b), n in self._censored.items()
                                 if c == cls},
                }
            return out

    def shadow_counts(self) -> Dict[str, dict]:
        with self._lock:
            return {b: {"dispatches": n,
                        "failed": self._shadow_failed.get(b, 0)}
                    for b, n in sorted(self._shadow.items())}

    # ------------------------------------------------------------- render

    def render_metric_lines(self, replica: Optional[str] = None) -> List[str]:
        rep = f',replica="{replica}"' if replica else ""
        with self._lock:
            regret = sorted(self._regret.items())
            shares: List[Tuple[str, str, float]] = []
            for cls in sorted(self._races):
                races = self._races[cls]
                if not races:
                    continue
                for b, n in sorted(self._wins.get(cls, {}).items()):
                    shares.append((cls, b, round(n / races, 6)))
            shadow = sorted(self._shadow.items())
        lines: List[str] = []
        if regret:
            lines += [
                "# HELP deppy_route_regret_seconds_total Wall-clock "
                "seconds the frozen default backend burned beyond the "
                "observed race winner, per size class (censored "
                "cancels fall back to the decayed estimate).",
                "# TYPE deppy_route_regret_seconds_total counter",
            ]
            for (cls, b), s in regret:
                lines.append(
                    f'deppy_route_regret_seconds_total{{'
                    f'size_class="{cls}",backend="{b}"{rep}}} '
                    f"{round(s, 6)}")
        if shares:
            lines += [
                "# HELP deppy_route_win_share Fraction of this size "
                "class's portfolio races won per backend.",
                "# TYPE deppy_route_win_share gauge",
            ]
            for cls, b, share in shares:
                lines.append(
                    f'deppy_route_win_share{{size_class="{cls}",'
                    f'backend="{b}"{rep}}} {share}')
        if shadow:
            lines += [
                "# HELP deppy_route_shadow_dispatches_total Shadow "
                "route probes dispatched at idle priority, by "
                "candidate backend.",
                "# TYPE deppy_route_shadow_dispatches_total counter",
            ]
            for b, n in shadow:
                lines.append(
                    f'deppy_route_shadow_dispatches_total{{'
                    f'backend="{b}"{rep}}} {n}')
        return lines
