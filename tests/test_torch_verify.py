"""The port's independent solution checker (``deppy_tpu_torch/utils/
verify.py``) against the reference's (``deppy_tpu/utils/verify.py``).

Both oracles judge the same answers: the SAT answers of both packages'
host engines on the same instances, each constraint type's violation on a
hand-built problem, and answers corrupted on purpose, which both must
reject alike (the same violated constraints, in the same order)."""

from __future__ import annotations

import pytest

from deppy_tpu import sat as jsat
from deppy_tpu.models import operatorhub_catalog as joperatorhub
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.models import version_pinned_chains as jchains
from deppy_tpu.utils.verify import check_solution as jcheck
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.utils.verify import check_solution as tcheck


def _judged(check, variables, installed):
    return [(ac.variable.identifier, str(ac))
            for ac in check(variables, installed)]


def _both(jvars, installed):
    """Each oracle's verdict on ``installed``, on its own package's
    variables; they must agree."""
    tvars = variables_from_objects(jvars)
    ref = _judged(jcheck, jvars, installed)
    port = _judged(tcheck, tvars, installed)
    assert port == ref
    return port


def _instances():
    return ([("random", s, jrandom(length=24, seed=s)) for s in range(6)]
            + [("operatorhub", 0, joperatorhub(8, 3, seed=0)),
               ("chains", 0, jchains(6, 2, seed=0))])


@pytest.mark.parametrize("family,seed,jvars", _instances(),
                         ids=[f"{f}-{s}" for f, s, _ in _instances()])
def test_sat_answers_of_both_packages_pass(family, seed, jvars):
    tvars = variables_from_objects(jvars)
    try:
        ref = sorted(v.identifier for v in
                     jsat.Solver(jvars, backend="host").solve())
    except jsat.NotSatisfiable:
        ref = None
    try:
        port = sorted(v.identifier for v in
                      tsat.Solver(tvars, backend="host").solve())
    except tsat.NotSatisfiable:
        port = None
    assert port == ref
    if ref is None:
        pytest.skip("UNSAT instance: no answer to judge")
    assert _both(jvars, ref) == []
    assert _both(jvars, port) == []


@pytest.mark.parametrize("family,seed,jvars", _instances(),
                         ids=[f"{f}-{s}" for f, s, _ in _instances()])
def test_corrupted_answers_are_rejected_alike(family, seed, jvars):
    """Each answer with one variable flipped: both oracles name the same
    violations (possibly none, when the flip keeps every constraint)."""
    try:
        answer = {v.identifier for v in
                  jsat.Solver(jvars, backend="host").solve()}
    except jsat.NotSatisfiable:
        answer = set()
    ids = [v.identifier for v in jvars]
    rejected = 0
    for ident in ids:
        flipped = answer ^ {ident}
        rejected += bool(_both(jvars, flipped))
    assert rejected > 0
    # Everything installed and nothing installed.
    _both(jvars, ids)
    _both(jvars, [])


def test_each_constraint_type():
    v = jsat.variable
    jvars = [
        v("m", jsat.mandatory()),
        v("p", jsat.prohibited()),
        v("d", jsat.dependency("x", "y")),
        v("c", jsat.conflict("x")),
        v("a", jsat.at_most(1, "x", "y", "z")),
        v("x"), v("y"), v("z"),
    ]
    assert _both(jvars, ["m", "d", "x", "a"]) == []
    assert _both(jvars, ["p", "d", "c", "x", "y", "a"]) == [
        ("m", "m is mandatory"),
        ("p", "p is prohibited"),
        ("c", "c conflicts with x"),
        ("a", "a permits at most 1 of x, y, z"),
    ]
    assert [ident for ident, _ in _both(jvars, ["d"])] == ["m", "d"]
