"""Structured per-batch solve reports (copy of ``deppy_tpu/telemetry/report.py:1-325``).

A :class:`SolveReport` is the per-batch observability record the whole
pipeline contributes to: the engine driver fills in padding/packing
economics, device-transfer and solve wall-clock, and host-fallback
routing; the SAT facades add outcome/step/decision counters.  Its
``backend`` is the port's backend name, ``"device"`` or ``"host"``.  The
driver fills ``escalation_stage`` (its budget escalation ladder) and
``fault_host_routed`` (groups its fault envelope solved on the host
engine), and the trip profiler (:mod:`deppy_tpu_torch.profile`) fills the
ledger fields (``profiled_dispatches``, ``ledger_*``) of each device
dispatch it samples; disarmed, they stay 0.

The active report travels through the driver on a thread-local rather
than through function signatures: the driver's internal phase functions
(``_solve_split`` et al.) are monkeypatched by tests and their
signatures are pinned.  ``begin_report``/``end_report`` bracket one
batch; nested ``solve_problems`` calls (the checkpointed group loop)
merge into the enclosing report instead of starting their own.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class SolveReport:
    """One batch's pipeline telemetry.

    ``escalation_stage``: 0 = single-stage dispatch (escalation disabled
    or not profitable), 1 = the stage-1 small budget resolved every
    lane, 2 = stage-2 (straggler redo or full-budget rerun) was needed.
    A multi-bucket batch reports the maximum stage any bucket reached.
    """

    backend: str = "device"
    n_problems: int = 0
    outcomes: Dict[str, int] = field(
        default_factory=lambda: {"sat": 0, "unsat": 0, "incomplete": 0}
    )
    # Engine iteration counters.  ``decisions`` / ``propagation_rounds``
    # are exact on the host engine (StatsTracer); the tensor engine
    # reports ``steps`` (tests + DPLL iterations) and ``backtracks``
    # (SolveResult.trace_n, counted even with tracing off).
    steps: int = 0
    backtracks: int = 0
    decisions: int = 0
    propagation_rounds: int = 0
    # Padding economics: lanes dispatched vs live
    # problems, and padded clause-matrix cells vs live cells.
    batch_lanes: int = 0
    live_lanes: int = 0
    pad_cells: int = 0
    live_cells: int = 0
    n_chunks: int = 0
    n_buckets: int = 0
    escalation_stage: int = 0
    # Rows whose unsat-core extraction routed to the host spec engine
    # (driver.HOST_CORE_NCONS) — the "silent host fallback" made loud.
    host_fallback_rows: int = 0
    # Problems the FAULT layer solved on the host engine (device dispatch
    # failed or the breaker was open) — distinct from the
    # core-extraction routing above, mirroring the
    # deppy_fault_host_routed_total counter.
    fault_host_routed: int = 0
    # Trip-ledger fields: filled only for dispatches the reference's
    # profiler sampled, zero otherwise.  All four are sums, so they merge exactly like the
    # other sequential-stage counters (mesh shards, checkpoint groups,
    # mixed cold/warm submits): ledger_trips sums per-chunk lockstep
    # while-trips (max lane steps per chunk), ledger_trip_slots sums
    # trips x chunk lanes (the lockstep lane-step slots paid),
    # ledger_lane_steps sums live lanes' useful iterations, and
    # ledger_p99_trips sums per-chunk p99 lane work (the straggler
    # numerator).  The derived ratios below are what the bench
    # economics columns carry.
    profiled_dispatches: int = 0
    ledger_trips: int = 0
    ledger_trip_slots: int = 0
    ledger_lane_steps: int = 0
    ledger_p99_trips: int = 0
    # Wall-clock per pipeline stage, seconds: pad_pack, device_put,
    # solve (whole driver call), plus anything a caller adds.
    wall: Dict[str, float] = field(default_factory=dict)

    # ----------------------------------------------------------- recording

    def add_wall(self, stage: str, seconds: float) -> None:
        self.wall[stage] = self.wall.get(stage, 0.0) + seconds

    def record_batch(self, live_lanes: int, batch_lanes: int,
                     live_cells: int, pad_cells: int,
                     n_chunks: int = 1) -> None:
        """One dispatched bucket's padding economics (accumulates across
        buckets and checkpoint groups)."""
        self.live_lanes += live_lanes
        self.batch_lanes += batch_lanes
        self.live_cells += live_cells
        self.pad_cells += pad_cells
        self.n_chunks += n_chunks
        self.n_buckets += 1

    def note_escalation(self, stage: int) -> None:
        self.escalation_stage = max(self.escalation_stage, stage)

    def record_ledger(self, trips: int, trip_slots: int, lane_steps: int,
                      p99_trips: int) -> None:
        """One sampled dispatch's trip ledger (accumulates
        across buckets, chunks, shards, and checkpoint groups)."""
        self.profiled_dispatches += 1
        self.ledger_trips += trips
        self.ledger_trip_slots += trip_slots
        self.ledger_lane_steps += lane_steps
        self.ledger_p99_trips += p99_trips

    def merge(self, other: "SolveReport") -> None:
        """Fold a sub-report into this one — the mesh-serving path runs
        one pipeline per device on worker threads, each filling its own
        thread-local report (the driver internals find their report via
        ``current_report()``, so shards cannot share the parent's
        without racing its unlocked ``+=`` counters); the parent merges
        them after the join.  Counters add, the escalation stage keeps
        its max (same convention as multi-bucket batches), wall clock
        sums per stage (threads overlap, so merged wall is cumulative
        device-time, not elapsed — same reading as multi-chunk rows)."""
        self.n_problems += other.n_problems
        for k, v in other.outcomes.items():
            self.outcomes[k] = self.outcomes.get(k, 0) + v
        for field_name in ("steps", "backtracks", "decisions",
                           "propagation_rounds", "batch_lanes",
                           "live_lanes", "pad_cells", "live_cells",
                           "n_chunks", "n_buckets", "host_fallback_rows",
                           "fault_host_routed", "profiled_dispatches",
                           "ledger_trips", "ledger_trip_slots",
                           "ledger_lane_steps", "ledger_p99_trips"):
            setattr(self, field_name,
                    getattr(self, field_name) + getattr(other, field_name))
        self.escalation_stage = max(self.escalation_stage,
                                    other.escalation_stage)
        for k, v in other.wall.items():
            self.add_wall(k, v)

    def count_outcome(self, outcome: str, n: int = 1) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + n

    # ------------------------------------------------------------- derived

    @property
    def batch_fill_ratio(self) -> float:
        """Live lanes / dispatched lanes — 1.0 means no lane padding."""
        if self.batch_lanes <= 0:
            return 1.0
        return self.live_lanes / self.batch_lanes

    @property
    def pad_waste_ratio(self) -> float:
        """Fraction of padded clause-matrix cells that carry no data."""
        if self.pad_cells <= 0:
            return 0.0
        return 1.0 - self.live_cells / self.pad_cells

    @property
    def useful_work_ratio(self) -> float:
        """Useful lane steps / lockstep trip-lane slots over the
        profiled dispatches (0.0 when nothing was sampled).
        Low means while-trips were spent idling behind padding and
        stragglers — the quantity the watched-literal rewrite must
        raise."""
        if self.ledger_trip_slots <= 0:
            return 0.0
        return self.ledger_lane_steps / self.ledger_trip_slots

    @property
    def straggler_p99_ratio(self) -> float:
        """p99 lane work / batch trips over the profiled dispatches
        (trips-weighted; 0.0 when nothing was sampled).  Low means the
        slowest lane — past even the p99 lane — drove the batch's trip
        count alone."""
        if self.ledger_trips <= 0:
            return 0.0
        return self.ledger_p99_trips / self.ledger_trips

    @classmethod
    def from_dict(cls, d: dict) -> "SolveReport":
        """Rebuild a report from its :meth:`to_dict` JSON form (the
        ``report`` events in a telemetry sink), tolerating missing keys
        so older sink files keep parsing.  Derived ratios are recomputed
        from the raw lane/cell counts."""
        rep = cls(backend=d.get("backend", "?"),
                  n_problems=int(d.get("n_problems", 0) or 0))
        outcomes = d.get("outcomes")
        if isinstance(outcomes, dict):
            rep.outcomes = {str(k): int(v) for k, v in outcomes.items()}
        for field_name in ("steps", "backtracks", "decisions",
                           "propagation_rounds", "batch_lanes",
                           "live_lanes", "pad_cells", "live_cells",
                           "n_chunks", "n_buckets", "escalation_stage",
                           "host_fallback_rows", "fault_host_routed",
                           "profiled_dispatches", "ledger_trips",
                           "ledger_trip_slots", "ledger_lane_steps",
                           "ledger_p99_trips"):
            setattr(rep, field_name, int(d.get(field_name, 0) or 0))
        walls = d.get("wall_s")
        if isinstance(walls, dict):
            rep.wall = {str(k): float(v) for k, v in walls.items()}
        return rep

    def to_dict(self) -> dict:
        return {
            "backend": self.backend,
            "n_problems": self.n_problems,
            "outcomes": dict(self.outcomes),
            "steps": self.steps,
            "backtracks": self.backtracks,
            "decisions": self.decisions,
            "propagation_rounds": self.propagation_rounds,
            "batch_lanes": self.batch_lanes,
            "live_lanes": self.live_lanes,
            "batch_fill_ratio": round(self.batch_fill_ratio, 4),
            "pad_cells": self.pad_cells,
            "live_cells": self.live_cells,
            "pad_waste_ratio": round(self.pad_waste_ratio, 4),
            "n_chunks": self.n_chunks,
            "n_buckets": self.n_buckets,
            "escalation_stage": self.escalation_stage,
            "host_fallback_rows": self.host_fallback_rows,
            "fault_host_routed": self.fault_host_routed,
            "profiled_dispatches": self.profiled_dispatches,
            "ledger_trips": self.ledger_trips,
            "ledger_trip_slots": self.ledger_trip_slots,
            "ledger_lane_steps": self.ledger_lane_steps,
            "ledger_p99_trips": self.ledger_p99_trips,
            "useful_work_ratio": round(self.useful_work_ratio, 4),
            "straggler_p99_ratio": round(self.straggler_p99_ratio, 4),
            "wall_s": {k: round(v, 6) for k, v in self.wall.items()},
        }

    def format_table(self) -> str:
        """Human-readable report (the `deppy stats` / bench rendering)."""
        d = self.to_dict()
        lines = [
            f"solve report ({d['backend']} backend, "
            f"{d['n_problems']} problems)",
            "  outcomes:          "
            + " ".join(f"{k}={v}" for k, v in d["outcomes"].items()),
            f"  steps:             {d['steps']}"
            f"  (backtracks {d['backtracks']}, decisions {d['decisions']},"
            f" propagation rounds {d['propagation_rounds']})",
            f"  batch fill:        {d['batch_fill_ratio']:.3f}"
            f"  ({d['live_lanes']}/{d['batch_lanes']} lanes,"
            f" {d['n_buckets']} buckets, {d['n_chunks']} chunks)",
            f"  padding waste:     {d['pad_waste_ratio']:.3f}"
            f"  ({d['live_cells']}/{d['pad_cells']} clause cells live)",
            f"  escalation stage:  {d['escalation_stage']}",
            f"  host fallback:     {d['host_fallback_rows']} rows"
            f"  (fault-routed problems: {d['fault_host_routed']})",
        ]
        if d["profiled_dispatches"]:
            lines.append(
                f"  trip ledger:       useful {d['useful_work_ratio']:.3f}"
                f"  straggler-p99 {d['straggler_p99_ratio']:.3f}"
                f"  ({d['ledger_trips']} trips over "
                f"{d['profiled_dispatches']} sampled dispatches)")
        if d["wall_s"]:
            walls = "  ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in sorted(d["wall_s"].items())
            )
            lines.append(f"  wall:              {walls}")
        return "\n".join(lines)


_TLS = threading.local()


def current_report() -> Optional[SolveReport]:
    """The report the pipeline is currently filling on this thread."""
    return getattr(_TLS, "active", None)


def last_report() -> Optional[SolveReport]:
    """The most recently finished report on this thread."""
    return getattr(_TLS, "last", None)


def begin_report(backend: str = "device",
                 n_problems: int = 0) -> "tuple[SolveReport, bool]":
    """Make a report active for this thread.  Returns ``(report, owns)``
    — when a report is already active (nested solve, e.g. checkpoint
    groups), the existing one is returned with ``owns=False`` and the
    nested call merges into it instead of finishing it."""
    active = current_report()
    if active is not None:
        active.n_problems += n_problems
        return active, False
    rep = SolveReport(backend=backend, n_problems=n_problems)
    _TLS.active = rep
    return rep, True


def detach_report(rep: SolveReport, owns: bool) -> None:
    """End an owned report WITHOUT publishing it (no ``last_report``,
    no sink event): the mesh shard workers bracket their per-thread
    reports with ``begin_report``/``detach_report`` and hand them back
    for the parent batch's report to :meth:`SolveReport.merge` — eight
    shards must not emit eight ``report`` sink events for one batch.
    No-op for non-owning (nested) callers, like :func:`end_report`."""
    if owns and current_report() is rep:
        _TLS.active = None


def end_report(rep: SolveReport, owns: bool) -> None:
    """Finish an owned report: clears the active slot, publishes it as
    ``last_report()``, and emits it as a ``report`` event on the default
    registry's JSONL sink.  No-op for non-owning (nested) callers."""
    if not owns:
        return
    _TLS.active = None
    _TLS.last = rep
    from .registry import default_registry

    reg = default_registry()
    if reg.sink_path is not None:
        import time

        reg.emit({"ts": round(time.time(), 3), "kind": "report",
                  "report": rep.to_dict()})
