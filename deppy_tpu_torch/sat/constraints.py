"""Constraint vocabulary (copy of ``deppy_tpu/sat/constraints.py:1-183``).

Mirrors the five constraint types of the reference framework
(upstream deppy's ``pkg/sat/constraints.go:54-204``) with idiomatic Python
dataclasses instead of interface implementations.  A constraint limits the
circumstances under which a particular variable may appear in a solution.

Each constraint knows how to:
  * render itself as a human-readable string for a subject identifier
    (used by unsat-core error messages), and
  * report its preference ``order`` (non-empty only for ``Dependency``,
    reference constraints.go:125-127) and whether it ``anchors`` its subject
    into the search seed set (true only for ``Mandatory``,
    reference constraints.go:68-70).

Unlike the reference, constraints do not encode themselves into a logic
circuit; lowering to dense clause/cardinality tensors happens in
:mod:`deppy_tpu_torch.sat.encode`, which is the tensor-friendly equivalent of
lit_mapping.go's two-pass construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

# An Identifier uniquely names a Variable within one solve
# (reference pkg/sat/variable.go:5-17).  Plain ``str`` is idiomatic here.
Identifier = str


@dataclass(frozen=True)
class Mandatory:
    """Only solutions containing the subject variable are permitted
    (reference constraints.go:54-76)."""

    def string(self, subject: Identifier) -> str:
        return f"{subject} is mandatory"

    def order(self) -> Tuple[Identifier, ...]:
        return ()

    def anchor(self) -> bool:
        return True


@dataclass(frozen=True)
class Prohibited:
    """Any solution containing the subject variable is rejected
    (reference constraints.go:78-102)."""

    def string(self, subject: Identifier) -> str:
        return f"{subject} is prohibited"

    def order(self) -> Tuple[Identifier, ...]:
        return ()

    def anchor(self) -> bool:
        return False


@dataclass(frozen=True)
class Dependency:
    """The subject may appear only if at least one of ``ids`` also appears.
    Identifiers earlier in ``ids`` are preferred over later ones
    (reference constraints.go:104-140)."""

    ids: Tuple[Identifier, ...]

    def string(self, subject: Identifier) -> str:
        if not self.ids:
            return f"{subject} has a dependency without any candidates to satisfy it"
        return f"{subject} requires at least one of {', '.join(self.ids)}"

    def order(self) -> Tuple[Identifier, ...]:
        return self.ids

    def anchor(self) -> bool:
        return False


@dataclass(frozen=True)
class Conflict:
    """The subject and ``id`` may not both appear in a solution
    (reference constraints.go:142-165)."""

    id: Identifier

    def string(self, subject: Identifier) -> str:
        return f"{subject} conflicts with {self.id}"

    def order(self) -> Tuple[Identifier, ...]:
        return ()

    def anchor(self) -> bool:
        return False


@dataclass(frozen=True)
class AtMost:
    """At most ``n`` of ``ids`` may appear in a solution
    (reference constraints.go:167-204).

    The reference lowers this through a sorting-network cardinality circuit
    (gini ``logic.CardSort``); here it lowers to a native cardinality row
    propagated directly by the tensor engine (see encode.py), which avoids
    the pointer-heavy network entirely.

    Deliberate divergence for degenerate input: duplicate ``ids`` are
    counted once ("at most n *distinct* members"), whereas gini's CardSort
    counts occurrences.  Set semantics keeps every engine path (host,
    gather, bitplane) in exact agreement; no reference behavior or test
    depends on multiset counting.
    """

    n: int
    ids: Tuple[Identifier, ...]

    def string(self, subject: Identifier) -> str:
        return f"{subject} permits at most {self.n} of {', '.join(self.ids)}"

    def order(self) -> Tuple[Identifier, ...]:
        return ()

    def anchor(self) -> bool:
        return False


Constraint = Union[Mandatory, Prohibited, Dependency, Conflict, AtMost]


def mandatory() -> Mandatory:
    """Constraint permitting only solutions that contain the subject."""
    return Mandatory()


def prohibited() -> Prohibited:
    """Constraint rejecting any solution that contains the subject."""
    return Prohibited()


def dependency(*ids: Identifier) -> Dependency:
    """Constraint requiring at least one of ``ids`` alongside the subject;
    earlier arguments are preferred (reference constraints.go:133-140)."""
    return Dependency(tuple(ids))


def conflict(id: Identifier) -> Conflict:
    """Constraint permitting the subject or ``id`` but not both."""
    return Conflict(id)


def at_most(n: int, *ids: Identifier) -> AtMost:
    """Constraint forbidding solutions with more than ``n`` of ``ids``."""
    return AtMost(n, tuple(ids))


@dataclass(frozen=True)
class Variable:
    """A problem variable: an identifier plus the constraints that apply to
    it (reference pkg/sat/variable.go:19-29).  Instances are immutable; use
    :func:`variable` to build one."""

    identifier: Identifier
    constraints: Tuple[Constraint, ...] = field(default_factory=tuple)


def variable(identifier: Identifier, *constraints: Constraint) -> Variable:
    """Convenience constructor mirroring the reference test helper
    (solve_test.go:32-37) and pkg/constraints/variable.go:25-30."""
    return Variable(identifier, tuple(constraints))


@dataclass(frozen=True)
class AppliedConstraint:
    """A constraint paired with the variable it applies to, used in
    unsat-core reporting (reference constraints.go:41-52)."""

    variable: Variable
    constraint: Constraint

    def __str__(self) -> str:
        return self.constraint.string(self.variable.identifier)
