"""deppy's own surface in the port against the JAX package: entities, generators, ``Resolver``, ``BatchResolver`` and the JSON codec.

The entity and resolution tests of ``tests/test_entity.py`` and
``tests/test_resolution.py`` run here on ``deppy_tpu_torch`` (the three
tests of the reference's ``auto`` probe stay there: the port has no
``auto``).  Then the port against the reference on the same inputs, with
tolerance 0: ``Resolver(device="cpu")`` (the kernels' plain versions)
against the reference's host backend and, on one small shape, its tensor
backend under ``JAX_PLATFORMS=cpu``; the host batch; the codec's round
trips, error messages and result documents; and the operatorhub entity
catalog, whose generators give ``operatorhub_catalog``'s exact list.
"""

from __future__ import annotations

import json
import time

import pytest

from deppy_tpu import entity as jentity
from deppy_tpu import io as jio
from deppy_tpu import sat as jsat
from deppy_tpu.models import operatorhub_catalog as joperatorhub
from deppy_tpu.models import pinned_tenant_catalog as jtenants
from deppy_tpu.resolution import BatchResolver as JBatchResolver
from deppy_tpu.resolution import Resolver as JResolver
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine.convert import (entities_from_objects,
                                            variables_from_objects)
from deppy_tpu_torch.entity import (CacheQuerier, Entity,
                                    EntityPropertyNotFoundError, Group,
                                    NoContentSource, and_, collect_ids, not_,
                                    or_)
from deppy_tpu_torch.models import (operatorhub_catalog, operatorhub_entities,
                                    operatorhub_generators,
                                    pinned_tenant_catalog)
from deppy_tpu_torch.resolution import (BatchResolver, ConstraintAggregator,
                                        ConstraintGenerator, Resolver)
from deppy_tpu_torch.resolution.facade import _to_solution
from deppy_tpu_torch.sat import (NotSatisfiable, at_most, conflict,
                                 dependency, mandatory, variable)

# ----------------------------------------------------------------- entity


def test_entity_properties():
    e = Entity("id", {"prop": "value"})
    assert e.id == "id"
    assert e.get_property("prop") == "value"


def test_entity_property_not_found():
    e = Entity("id", {"foo": "value"})
    with pytest.raises(EntityPropertyNotFoundError) as exc:
        e.get_property("bar")
    assert str(exc.value) == "Property '(bar)' Not Found"


@pytest.fixture
def querier() -> CacheQuerier:
    return CacheQuerier.from_entities(
        [
            Entity("a", {"package": "p1", "version": "1.0"}),
            Entity("b", {"package": "p1", "version": "2.0"}),
            Entity("c", {"package": "p2", "version": "1.0"}),
        ]
    )


def test_cache_get(querier):
    assert querier.get("a").get_property("version") == "1.0"
    assert querier.get("missing") is None


def test_cache_filter(querier):
    p1 = querier.filter(lambda e: e.get_property("package") == "p1")
    assert collect_ids(p1) == ["a", "b"]


def test_cache_group_by(querier):
    groups = querier.group_by(lambda e: [e.get_property("package")])
    assert collect_ids(groups["p1"]) == ["a", "b"]
    assert collect_ids(groups["p2"]) == ["c"]


def test_cache_iterate(querier):
    assert collect_ids(querier.iterate()) == ["a", "b", "c"]


def test_predicates(querier):
    is_p1 = lambda e: e.get_property("package") == "p1"  # noqa: E731
    is_v1 = lambda e: e.get_property("version") == "1.0"  # noqa: E731
    assert collect_ids(querier.filter(and_(is_p1, is_v1))) == ["a"]
    assert collect_ids(querier.filter(or_(not_(is_p1), is_v1))) == ["a", "c"]
    assert collect_ids(querier.filter(not_(and_(is_p1, is_v1)))) == ["b", "c"]


def test_group_multiplexing(querier):
    class ContentSource(CacheQuerier):
        def __init__(self, entities, content):
            super().__init__({e.id: e for e in entities})
            self._content = content

        def get_content(self, id):
            return self._content.get(id)

    s2 = ContentSource([Entity("d", {"package": "p3"})], {"d": b"payload"})
    g = Group(querier, s2)
    assert g.get("a").id == "a"
    assert g.get("d").id == "d"
    assert g.get("zzz") is None
    assert collect_ids(g.iterate()) == ["a", "b", "c", "d"]
    assert collect_ids(g.filter(lambda e: True)) == ["a", "b", "c", "d"]
    groups = g.group_by(lambda e: [e.get_property("package")])
    assert set(groups) == {"p1", "p2", "p3"}
    # First-hit content; sources without get_content are skipped.
    assert g.get_content("d") == b"payload"
    assert g.get_content("a") is None


def test_no_content_source():
    assert NoContentSource().get_content("anything") is None


# ------------------------------------------------------------- resolution

CATALOG = [
    ("pkgA.v2", {"package": "pkgA", "version": "2.0", "requires": "pkgB"}),
    ("pkgA.v1", {"package": "pkgA", "version": "1.0", "requires": "pkgB"}),
    ("pkgB.v1", {"package": "pkgB", "version": "1.0"}),
    ("pkgC.v1", {"package": "pkgC", "version": "1.0"}),
]


def _catalog(E, Q):
    return Q.from_entities([E(i, dict(p)) for i, p in CATALOG])


@pytest.fixture
def catalog() -> CacheQuerier:
    return _catalog(Entity, CacheQuerier)


def _generators(S):
    """The three generators of ``tests/test_resolution.py`` over the
    constraint vocabulary ``S`` (either package's ``sat``)."""

    def required_package(name):
        def gen(querier):
            versions = querier.filter(
                lambda e: e.get_property("package") == name)
            versions.sort(key=lambda e: e.get_property("version"),
                          reverse=True)
            ids = [e.id for e in versions]
            return [S.variable(f"required/{name}", S.mandatory(),
                               S.dependency(*ids))]

        return gen

    def bundles_and_deps(querier):
        out = []
        for e in querier.iterate():
            cons = []
            req = e.properties.get("requires")
            if req:
                versions = querier.filter(
                    lambda x: x.get_property("package") == req)
                versions.sort(key=lambda x: x.get_property("version"),
                              reverse=True)
                cons.append(S.dependency(*[x.id for x in versions]))
            out.append(S.variable(e.id, *cons))
        return out

    def version_uniqueness(querier):
        out = []
        groups = querier.group_by(lambda e: [e.get_property("package")])
        for pkg in sorted(groups):
            ids = [e.id for e in groups[pkg]]
            out.append(S.variable(f"unique/{pkg}", S.at_most(1, *ids)))
        return out

    return required_package("pkgA"), bundles_and_deps, version_uniqueness


@pytest.mark.parametrize("kw", [dict(backend="host"), dict(device="cpu")],
                         ids=["host", "device-cpu"])
def test_resolver_end_to_end(catalog, kw):
    solution = Resolver(catalog, *_generators(tsat), **kw).solve()
    # Newest pkgA version preferred, its dependency pulled in, pkgC untouched.
    assert solution["pkgA.v2"] is True
    assert solution["pkgA.v1"] is False
    assert solution["pkgB.v1"] is True
    assert solution["pkgC.v1"] is False
    # Every input variable appears in the solution map (solver.go:52-62).
    assert solution["required/pkgA"] is True
    assert "unique/pkgA" in solution


@pytest.mark.parametrize("kw", [dict(backend="host"), dict(device="cpu")],
                         ids=["host", "device-cpu"])
def test_resolver_unsat_surfaces_core(catalog, kw):
    def impossible(querier):
        return [
            variable("x", mandatory()),
            variable("y", mandatory(), at_most(0, "x")),
        ]

    with pytest.raises(NotSatisfiable) as exc:
        Resolver(catalog, impossible, **kw).solve()
    assert "constraints not satisfiable" in str(exc.value)


def test_batch_resolver_host_path():
    problems = [
        [variable("a", mandatory())],
        [
            variable("b", mandatory(), conflict("b2")),
            variable("b2", mandatory()),
        ],
        [variable("c"), variable("d", mandatory(), dependency("c"))],
    ]
    results = BatchResolver(backend="host").solve(problems)
    assert results[0] == {"a": True}
    assert isinstance(results[1], NotSatisfiable)
    assert "b conflicts with b2" in str(results[1])
    assert results[2] == {"c": True, "d": True}


@pytest.mark.parametrize("backend", ["auto", "tpu", "hsot"])
def test_unknown_backends_raise(backend):
    """The port serves "device" and "host" only: the reference's "auto"
    (which picks the host engine for one problem) and "tpu" raise, like
    any unknown name."""
    with pytest.raises(tsat.InternalSolverError,
                       match=f"unknown backend '{backend}'"):
        BatchResolver(backend=backend).solve([[variable("a")]])
    with pytest.raises(tsat.InternalSolverError):
        tsat.Solver([variable("a")], backend=backend)
    with pytest.raises(tsat.InternalSolverError):
        Resolver(CacheQuerier({}), backend=backend)


def test_aggregator_order_and_parallelism(catalog):
    agg = ConstraintAggregator(
        lambda q: [variable("g1")],
        lambda q: [variable("g2a"), variable("g2b")],
        lambda q: [variable("g3")],
    )
    got = [v.identifier for v in agg.get_variables(catalog)]
    assert got == ["g1", "g2a", "g2b", "g3"]


def test_parallel_generators_join_in_registration_order(catalog):
    """Threads that finish in reverse order still give the registration
    order, and a ConstraintGenerator object is accepted beside plain
    functions."""
    done = []

    def slow(name, delay):
        def gen(q):
            time.sleep(delay)
            done.append(name)
            return [variable(name)]

        return gen

    class Obj:
        def get_variables(self, q):
            done.append("obj")
            return [variable("obj")]

    assert isinstance(Obj(), ConstraintGenerator)
    agg = ConstraintAggregator(slow("first", 0.3), slow("second", 0.1),
                               Obj(), parallel=True)
    got = [v.identifier for v in agg.get_variables(catalog)]
    assert got == ["first", "second", "obj"]
    assert done[-1] == "first"


@pytest.mark.parametrize("kw", [dict(backend="host"), dict(device="cpu")],
                         ids=["host", "device-cpu"])
def test_duplicate_identifiers_across_generators_raise(catalog, kw):
    gens = (lambda q: [variable("x")], lambda q: [variable("x")])
    with pytest.raises(tsat.DuplicateIdentifier):
        Resolver(catalog, *gens, **kw).solve()
    with pytest.raises(jsat.DuplicateIdentifier):
        JResolver(_catalog(jentity.Entity, jentity.CacheQuerier),
                  lambda q: [jsat.variable("x")],
                  lambda q: [jsat.variable("x")], backend="host").solve()


def test_pinned_tenant_catalog_unsat_core_shape():
    """The UNSAT-heavy fleet generator's core: the same small core on the
    host engine and on the device backend's plain versions."""
    vs = None
    for seed in range(10):
        cand = pinned_tenant_catalog(seed=seed)
        try:
            tsat.Solver(cand, backend="host").solve()
        except NotSatisfiable:
            vs = cand
            break
    assert vs is not None, "no UNSAT seed in 0..9 — generator changed?"
    cores = {}
    for kw in (dict(backend="host"), dict(device="cpu")):
        with pytest.raises(NotSatisfiable) as ei:
            tsat.Solver(vs, **kw).solve()
        cores[kw.get("backend", "device")] = str(ei.value)
    assert cores["host"] == cores["device"]
    msg = cores["host"]
    assert "is mandatory" in msg and "conflicts with" in msg
    assert msg.count(",") <= 6


def test_tracer_needs_the_host_backend(catalog):
    with pytest.raises(NotImplementedError, match="A4"):
        tsat.Solver([variable("a")], tracer=tsat.DefaultTracer())
    tracer = tsat.StatsTracer()
    Resolver(catalog, *_generators(tsat), backend="host",
             tracer=tracer).solve()
    assert tracer.decisions > 0


# ------------------------------------------------- against the reference


def _jquerier(tquerier):
    return jentity.CacheQuerier.from_entities(
        [jentity.Entity(e.id, dict(e.properties))
         for e in tquerier.iterate()])


def _jgen(tgen):
    """A port generator as a reference generator: the same variables in
    the reference's vocabulary (the port generator reads the reference
    querier by duck typing)."""

    def gen(querier):
        return [jsat.variable(v.identifier, *[
            _jcon(c) for c in v.constraints]) for v in tgen(querier)]

    return gen


def _jcon(c):
    kind = type(c).__name__
    if kind == "Dependency":
        return jsat.dependency(*c.ids)
    if kind == "Conflict":
        return jsat.conflict(c.id)
    if kind == "AtMost":
        return jsat.at_most(c.n, *c.ids)
    return jsat.mandatory() if kind == "Mandatory" else jsat.prohibited()


def _answer(solve):
    try:
        return ("sat", solve())
    except (NotSatisfiable, jsat.NotSatisfiable) as e:
        return ("unsat", [str(c) for c in e.constraints])


def test_resolver_matches_the_reference_host_backend(catalog):
    want = _answer(JResolver(_catalog(jentity.Entity, jentity.CacheQuerier),
                             *_generators(jsat), backend="host").solve)
    assert _answer(Resolver(catalog, *_generators(tsat),
                            device="cpu").solve) == want
    assert _answer(Resolver(catalog, *_generators(tsat),
                            backend="host").solve) == want


def test_operatorhub_entity_catalog_matches_the_reference():
    """At (12, 3): the generators give ``operatorhub_catalog``'s exact
    list, and the port's Resolver on the CPU (both backends, serial and
    parallel generators) equals the reference's host Resolver."""
    q = CacheQuerier.from_entities(operatorhub_entities(12, 3, seed=0))
    gens = operatorhub_generators(q)
    assert ConstraintAggregator(*gens).get_variables(q) == \
        operatorhub_catalog(12, 3, seed=0)
    assert variables_from_objects(joperatorhub(12, 3, seed=0)) == \
        operatorhub_catalog(12, 3, seed=0)
    jq = _jquerier(q)
    assert entities_from_objects(jq.iterate()) == list(q.iterate())
    want = _answer(JResolver(jq, *map(_jgen, gens), backend="host").solve)
    assert want[0] == "sat"
    for kw in (dict(device="cpu"), dict(backend="host"),
               dict(device="cpu", parallel_generators=True)):
        assert _answer(Resolver(q, *gens, **kw).solve) == want


@pytest.mark.parametrize("size", [(40, 5), (250, 8)])
def test_operatorhub_entities_give_the_catalog(size):
    q = CacheQuerier.from_entities(operatorhub_entities(*size, seed=0))
    assert len(list(q.iterate())) == size[0] * size[1]
    assert ConstraintAggregator(*operatorhub_generators(q)).get_variables(q) \
        == operatorhub_catalog(*size, seed=0)


def test_resolver_matches_the_reference_tensor_backend(catalog):
    """The reference's tensor engine (JAX on the CPU), on one small shape:
    each JAX shape compiles."""
    want = _answer(JResolver(_catalog(jentity.Entity, jentity.CacheQuerier),
                             *_generators(jsat), backend="tpu").solve)
    assert _answer(Resolver(catalog, *_generators(tsat),
                            device="cpu").solve) == want


def _tenant_lanes():
    return [jtenants(seed=s) for s in range(24)] + [
        [jsat.variable("a", jsat.mandatory(), jsat.dependency("b", "c")),
         jsat.variable("b", jsat.conflict("c")), jsat.variable("c")]]


@pytest.mark.parametrize("max_steps", [None, 3])
def test_host_batch_matches_the_reference(max_steps):
    jprobs = _tenant_lanes()
    tprobs = [variables_from_objects(p) for p in jprobs]
    jr = JBatchResolver(backend="host", max_steps=max_steps)
    tr = BatchResolver(backend="host", max_steps=max_steps)
    want = [jio.result_to_dict(r) for r in jr.solve(jprobs)]
    got = [tio.result_to_dict(r) for r in tr.solve(tprobs)]
    assert got == want
    assert tr.last_steps == jr.last_steps
    if max_steps is not None:
        assert any(d["status"] == "incomplete" for d in got)
    else:
        assert {d["status"] for d in got} == {"sat", "unsat"}


def test_device_batch_on_cpu_matches_the_host_batch():
    probs = [variables_from_objects(p) for p in _tenant_lanes()]
    host = [tio.result_to_dict(r)
            for r in BatchResolver(backend="host").solve(probs)]
    dev = [tio.result_to_dict(r)
           for r in BatchResolver(device="cpu").solve(probs)]
    assert dev == host


# ------------------------------------------------------------------- codec

ALL_KINDS = [
    {"id": "a", "constraints": [
        {"type": "mandatory"},
        {"type": "dependency", "ids": ["b", "c"]},
        {"type": "conflict", "id": "d"},
        {"type": "atMost", "n": 1, "ids": ["b", "c"]},
    ]},
    {"id": "b", "constraints": [{"type": "prohibited"}]},
    {"id": "c"},
    {"id": "d", "constraints": [{"type": "dependency", "ids": []}]},
]


def test_codec_round_trips_every_constraint_kind():
    doc = {"variables": ALL_KINDS}
    (tvars,), tbatch = tio.parse_document(doc)
    (jvars,), jbatch = jio.parse_document(doc)
    assert (tbatch, jbatch) == (False, False)
    assert [tio.variable_to_dict(v) for v in tvars] == ALL_KINDS
    assert tvars == variables_from_objects(jvars)
    assert [tio.variable_to_dict(v) for v in tvars] == [
        jio.variable_to_dict(v) for v in jvars]
    batch = {"problems": [doc, {"variables": ALL_KINDS[2:]}]}
    text = json.dumps(batch)
    assert tio.problems_from_document(json.loads(text)) == [
        variables_from_objects(p)
        for p in jio.problems_from_document(json.loads(text))]
    for v in tvars:
        for c in v.constraints:
            assert tio.constraint_from_dict(tio.constraint_to_dict(c)) == c


MALFORMED = [
    [],
    {"variables": 3},
    {"problems": {}},
    {"problems": [3]},
    {"variables": [3]},
    {"variables": [{"id": 3}]},
    {"variables": [{"id": "a", "constraints": {}}]},
    {"variables": [{"id": "a", "constraints": [3]}]},
    {"variables": [{"id": "a", "constraints": [{"type": "nope"}]}]},
    {"variables": [{"id": "a", "constraints": [{"type": "dependency"}]}]},
    {"variables": [{"id": "a", "constraints": [
        {"type": "dependency", "ids": [1]}]}]},
    {"variables": [{"id": "a", "constraints": [{"type": "conflict"}]}]},
    {"variables": [{"id": "a", "constraints": [
        {"type": "atMost", "n": -1, "ids": []}]}]},
    {"variables": [{"id": "a", "constraints": [
        {"type": "atMost", "n": True, "ids": []}]}]},
    {"variables": [{"id": "a", "constraints": [
        {"type": "atMost", "n": 1, "ids": "b"}]}]},
]


@pytest.mark.parametrize("doc", MALFORMED, ids=range(len(MALFORMED)))
def test_codec_errors_match_the_reference(doc):
    with pytest.raises(jio.ProblemFormatError) as want:
        jio.parse_document(doc)
    with pytest.raises(tio.ProblemFormatError) as got:
        tio.parse_document(doc)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_load_document_matches_the_reference(tmp_path):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"problems": [{"variables": ALL_KINDS}]}))
    probs, is_batch = tio.load_document(str(good))
    jprobs, jbatch = jio.load_document(str(good))
    assert is_batch and jbatch
    assert probs == [variables_from_objects(p) for p in jprobs]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(jio.ProblemFormatError) as want:
        jio.load_document(str(bad))
    with pytest.raises(tio.ProblemFormatError) as got:
        tio.load_document(str(bad))
    assert str(got.value) == str(want.value)
    with pytest.raises(tio.ProblemFormatError):
        tio.constraint_to_dict(object())


def test_result_to_dict_matches_the_reference():
    """SAT, UNSAT and Incomplete results of one batch, rendered by each
    package's codec."""
    jprobs = [
        [jsat.variable("a", jsat.mandatory(), jsat.dependency("b")),
         jsat.variable("b")],
        [jsat.variable("a", jsat.mandatory(), jsat.conflict("b")),
         jsat.variable("b", jsat.mandatory())],
        jtenants(seed=1),
    ]
    tprobs = [variables_from_objects(p) for p in jprobs]
    want = [jio.result_to_dict(r) for r in
            JBatchResolver(backend="host", max_steps=6).solve(jprobs)]
    for kw in (dict(backend="host"), dict(device="cpu")):
        got = [tio.result_to_dict(r) for r in
               BatchResolver(max_steps=6, **kw).solve(tprobs)]
        assert got == want
    assert [d["status"] for d in want] == ["sat", "unsat", "incomplete"]


def test_to_solution_marks_every_variable():
    vs = [variable("a"), variable("b")]
    assert _to_solution(vs, vs[1:]) == {"a": False, "b": True}
