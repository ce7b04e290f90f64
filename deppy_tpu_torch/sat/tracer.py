"""Search observability hooks (copy of ``deppy_tpu/sat/tracer.py:1-92``).

A ``Tracer`` is invoked at every backtrack with the current search position:
the stack of guessed variables and the constraints implicated in the
conflict that forced the backtrack (tracer.go:13-15, search.go:172-173).
"""

from __future__ import annotations

from typing import IO, List, Protocol

from .constraints import AppliedConstraint, Variable


class SearchPosition(Protocol):
    """Snapshot of the search at a backtrack point (tracer.go:8-11)."""

    def variables(self) -> List[Variable]: ...

    def conflicts(self) -> List[AppliedConstraint]: ...


class Tracer(Protocol):
    def trace(self, position: SearchPosition) -> None: ...


class DefaultTracer:
    """No-op tracer (tracer.go:17-20)."""

    def trace(self, position: SearchPosition) -> None:
        pass


class LoggingTracer:
    """Writes a human-readable transcript of each backtrack
    (tracer.go:22-35)."""

    def __init__(self, writer: IO[str]):
        self.writer = writer

    def trace(self, position: SearchPosition) -> None:
        self.writer.write("---\nAssumptions:\n")
        for v in position.variables():
            self.writer.write(f"- {v.identifier}\n")
        self.writer.write("Conflicts:\n")
        for c in position.conflicts():
            self.writer.write(f"- {c}\n")


class StatsTracer:
    """Counts backtracks, decisions, and propagation rounds — the cheap
    always-on statistics channel matching the tensor engine's counters
    (SolveResult.steps / trace_n), so host-routed solves contribute to the
    same statistics as device solves.

    ``trace`` (the base Tracer protocol) counts search backtracks;
    ``count_decision`` / ``count_propagation`` are optional hook methods
    the host engine invokes when its tracer defines them.

    ``wants_position = False`` tells the engine this tracer never reads
    the position argument, so the per-backtrack position snapshot is
    skipped."""

    wants_position = False

    def __init__(self) -> None:
        self.backtracks = 0
        self.decisions = 0
        self.propagation_rounds = 0

    def trace(self, position: SearchPosition) -> None:
        self.backtracks += 1

    def count_decision(self, n: int = 1) -> None:
        """One search/DPLL decision (a variable guessed, either by the
        preference-ordered search or the leaf DPLL)."""
        self.decisions += n

    def count_propagation(self, rounds: int = 1) -> None:
        """``rounds`` BCP fixpoint iterations completed."""
        self.propagation_rounds += rounds

    def as_dict(self) -> dict:
        return {
            "backtracks": self.backtracks,
            "decisions": self.decisions,
            "propagation_rounds": self.propagation_rounds,
        }
