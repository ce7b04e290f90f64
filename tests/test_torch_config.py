"""The port's typed knob registry (``deppy_tpu_torch/config.py``).

  * the reference's accessor error paths (``tests/test_config.py::
    TestAccessorErrorPaths``) on ``DEPPY_GPU_*`` names;
  * an AST scan of ``deppy_tpu_torch/`` and ``chip_smoke.py``: no
    ``DEPPY_GPU_*`` name is read from the environment except through
    ``config``, every name the code names is declared, and every
    declared name is read by the package;
  * each knob whose read moved into the registry gives, on a malformed
    value, the result, exception and warning it gave before the move
    (one row a knob, read through the module that consumes it);
  * ``deppy_tpu_torch/configuration.md`` is ``render_markdown()``, and
    ``python -m deppy_tpu_torch.config`` prints it.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from deppy_tpu_torch import config

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deppy_tpu_torch"
SCANNED = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
NAME = re.compile(r"DEPPY_GPU_[A-Z0-9_]*[A-Z0-9]")


# ------------------------------------------------------------ accessors


class TestAccessorErrorPaths:
    def test_undeclared_name_raises_on_every_accessor(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_NO_SUCH_KNOB", "1")
        for fn in (config.env_raw, config.env_str, config.env_int,
                   config.env_float, config.env_bool):
            with pytest.raises(config.UndeclaredEnvVar):
                fn("DEPPY_GPU_NO_SUCH_KNOB")

    def test_undeclared_raises_even_when_unset(self):
        with pytest.raises(config.UndeclaredEnvVar):
            config.env_raw("DEPPY_GPU_ALSO_NOT_DECLARED")

    def test_foreign_prefix_is_not_enforced(self):
        """``require`` owns only the ``DEPPY_GPU_`` namespace: the
        reference's names and other variables pass through."""
        assert config.require("DEPPY_TPU_MAX_LANES") is None
        assert config.require("JAX_PLATFORMS") is None

    def test_malformed_int_strict_raises_lenient_degrades(
            self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_HOST_CORE_NCONS", "not-a-number")
        with pytest.raises(ValueError):
            config.env_int("DEPPY_GPU_HOST_CORE_NCONS")
        assert config.env_int("DEPPY_GPU_HOST_CORE_NCONS", 768,
                              strict=False) == 768

    def test_malformed_float_strict_raises_lenient_degrades(
            self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_REPROBE", "soon")
        with pytest.raises(ValueError):
            config.env_float("DEPPY_GPU_REPROBE")
        assert config.env_float("DEPPY_GPU_REPROBE", 600.0,
                                strict=False) == 600.0

    def test_blank_value_is_unset(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_FLEET_VNODES", "   ")
        assert config.env_int("DEPPY_GPU_FLEET_VNODES", 7) == 7
        monkeypatch.setenv("DEPPY_GPU_BCP", "  ")
        assert config.env_str("DEPPY_GPU_BCP", "auto") == "auto"

    def test_bool_tokens_and_garbage(self, monkeypatch):
        for raw, want in (("1", True), ("true", True), ("YES", True),
                          ("on", True), ("0", False), ("off", False),
                          ("", False), ("no", False)):
            monkeypatch.setenv("DEPPY_GPU_SPECULATE", raw)
            assert config.env_bool("DEPPY_GPU_SPECULATE") is want
        monkeypatch.setenv("DEPPY_GPU_SPECULATE", "maybe")
        assert config.env_bool("DEPPY_GPU_SPECULATE") is False
        assert config.env_bool("DEPPY_GPU_SPECULATE", True) is True


def _reference_mirrors() -> dict:
    """The reference's (flag, config_key) a knob, under the port's name."""
    from deppy_tpu import config as ref

    return {v.name.replace("DEPPY_TPU_", "DEPPY_GPU_"): (v.flag, v.config_key)
            for v in ref.REGISTRY.values()}


def test_declarations():
    """Every declaration has a type, a help text, a consumer that is a
    module of the port, and the CLI mirrors of the reference's knob of
    the same name (none where the reference has none or no such knob)."""
    assert config.REGISTRY
    mirrors = _reference_mirrors()
    for name, v in config.REGISTRY.items():
        assert name == v.name and name.startswith("DEPPY_GPU_")
        assert v.type in ("int", "float", "str", "bool", "path"), name
        assert v.help.strip(), name
        assert (v.flag, v.config_key) == mirrors.get(name, (None, None)), \
            name
        parts = v.consumer.split(".")
        assert parts[0] == "deppy_tpu_torch", name
        base = PACKAGE.joinpath(*parts[1:])
        assert base.with_suffix(".py").exists() or \
            (base / "__init__.py").exists(), (name, v.consumer)


def test_mirror_declarations_match_cli():
    """Every declared flag and config-key mirror exists in the port's
    ``cli.py`` (the port's ``tests/test_config.py:96-110``)."""
    cli_text = (PACKAGE / "cli.py").read_text(encoding="utf-8")
    mirrored = [v for v in config.REGISTRY.values()
                if v.flag or v.config_key]
    assert len(mirrored) == 46
    for v in mirrored:
        if v.flag:
            assert f'"{v.flag}"' in cli_text, (v.name, v.flag)
        if v.config_key:
            assert f'"{v.config_key}"' in cli_text, (v.name, v.config_key)


def test_every_reference_mirror_of_a_ported_knob_is_declared():
    """A reference knob that the port has and that declares a mirror
    declares the same mirror here, and the parser and the serve config
    accept it."""
    from deppy_tpu_torch import cli

    keys = set(cli._CONFIG_KEYS)
    flags = {a for act in _parser_actions(cli._build_parser())
             for a in act.option_strings}
    for name, (flag, key) in _reference_mirrors().items():
        if (flag or key) and name in config.REGISTRY:
            v = config.REGISTRY[name]
            assert (v.flag, v.config_key) == (flag, key), name
            assert flag is None or flag in flags, (name, flag)
            assert key is None or key in keys, (name, key)


def _parser_actions(parser):
    """Every action of ``parser`` and of its subparsers, recursively."""
    import argparse

    for act in parser._actions:
        yield act
        if isinstance(act, argparse._SubParsersAction):
            for sub in act.choices.values():
                yield from _parser_actions(sub)


# ------------------------------------------------------------ the AST scan


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                out.add(id(body[0].value))
    return out


def _is_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _knob(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and NAME.fullmatch(node.value) is not None)


def _scan(path: Path):
    """(names the code names, direct environment reads of them)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    docs = _docstrings(tree)
    names, reads = set(), []
    for node in ast.walk(tree):
        if _knob(node) and id(node) not in docs:
            names.add(node.value)
        if isinstance(node, ast.Call) and node.args and _knob(node.args[0]):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "get"
                    and _is_environ(f.value)) or (
                    isinstance(f, ast.Attribute) and f.attr == "getenv"):
                reads.append((node.lineno, node.args[0].value))
        if (isinstance(node, ast.Subscript) and _is_environ(node.value)
                and isinstance(node.ctx, ast.Load) and _knob(node.slice)):
            reads.append((node.lineno, node.slice.value))
        if (isinstance(node, ast.Compare) and _knob(node.left)
                and any(_is_environ(c) for c in node.comparators)):
            reads.append((node.lineno, node.left.value))
    return names, reads


SCANS = {path: _scan(path) for path in SCANNED}


def _rel(path: Path) -> str:
    return str(path.relative_to(ROOT))


@pytest.mark.parametrize("path", SCANNED, ids=[_rel(p) for p in SCANNED])
def test_no_read_bypasses_the_registry(path):
    """Outside ``config.py`` no module reads a ``DEPPY_GPU_*`` name from
    ``os.environ`` (setting one, as ``chip_smoke.py`` does, is no read)."""
    _, reads = SCANS[path]
    if path == PACKAGE / "config.py":
        return
    assert reads == [], f"{_rel(path)} reads around config: {reads}"


def test_every_named_knob_is_declared():
    undeclared = {(_rel(p), n) for p, (names, _) in SCANS.items()
                  for n in names if n not in config.REGISTRY}
    assert undeclared == set()


def test_every_declared_knob_is_read():
    named = set()
    for path, (names, _) in SCANS.items():
        if path.is_relative_to(PACKAGE) and path != PACKAGE / "config.py":
            named |= names
    assert set(config.REGISTRY) - named == set()


def test_the_scan_finds_reads(tmp_path):
    """The scan is not vacuous: each spelling of a direct read counts."""
    src = tmp_path / "m.py"
    src.write_text('"""DEPPY_GPU_IN_A_DOCSTRING"""\nimport os\n'
                   'os.environ.get("DEPPY_GPU_A")\n'
                   'os.getenv("DEPPY_GPU_B", "1")\n'
                   'os.environ["DEPPY_GPU_C"]\n'
                   '"DEPPY_GPU_D" in os.environ\n'
                   'os.environ["DEPPY_GPU_E"] = "1"\n')
    names, reads = _scan(src)
    assert names == {"DEPPY_GPU_A", "DEPPY_GPU_B", "DEPPY_GPU_C",
                     "DEPPY_GPU_D", "DEPPY_GPU_E"}
    assert [n for _, n in reads] == ["DEPPY_GPU_A", "DEPPY_GPU_B",
                                     "DEPPY_GPU_C", "DEPPY_GPU_D"]


# ------------------------------------------------------ the generated doc


def test_checked_in_doc_is_generated():
    doc = (PACKAGE / "configuration.md").read_text(encoding="utf-8")
    assert doc == config.render_markdown()
    for name in config.REGISTRY:
        assert f"| `{name}` |" in doc


def test_python_m_renders_the_doc():
    out = subprocess.run([sys.executable, "-m", "deppy_tpu_torch.config"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == (PACKAGE / "configuration.md").read_text(
        encoding="utf-8")


# ------------------------------------------- malformed values, site by site
#
# Each row: the knob, a malformed (or blank) value, a reader that goes
# through the module consuming the knob, and what the read gave before the
# knob moved into the registry: a value, or the exception it raised.
# ``warn`` is the stderr line the read prints (None: it prints no
# "ignoring" line).


def _sched(**kw):
    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.sched import Scheduler

    return Scheduler(device="cpu", registry=telemetry.Registry(), **kw)


def _server(read):
    from deppy_tpu_torch.service import Server

    srv = Server(bind_address="127.0.0.1:0", probe_address="127.0.0.1:0",
                 backend="host", device="cpu")
    try:
        return read(srv)
    finally:
        srv.shutdown()


def _router(read, replicas=("127.0.0.1:9",)):
    from deppy_tpu_torch.fleet.router import Router

    r = Router(bind_address="127.0.0.1:0",
               replicas=list(replicas) if replicas else None)
    try:
        return read(r)
    finally:
        r.shutdown()


def _profile(read):
    from deppy_tpu_torch.profile import ledger

    with ledger._LOCK:
        ledger._ARMED = ledger._INTERVAL = None
        ledger._resolve_locked()
        out = read(ledger)
        ledger._ARMED = ledger._INTERVAL = None
    return out


def _telemetry_file(mp):
    from deppy_tpu_torch.telemetry import registry

    mp.setattr(registry, "_DEFAULT", None)
    return registry.default_registry().sink_path


def _recorder(attr):
    from deppy_tpu_torch.telemetry.trace import FlightRecorder

    return getattr(FlightRecorder(), attr)


def _policy(attr):
    from deppy_tpu_torch import faults

    return getattr(faults.RetryPolicy.from_env(), attr)


def _ambient():
    from deppy_tpu_torch import faults

    with faults.ambient_deadline() as dl:
        return dl


def _breaker(attr):
    from deppy_tpu_torch.faults import breaker

    return getattr(breaker._breaker_from_env(), attr)


def _pool(read):
    from deppy_tpu_torch.hostpool import pool

    return read(pool)


def _streamer(attr):
    from deppy_tpu_torch.obs.stream import TelemetryStreamer

    return getattr(TelemetryStreamer("127.0.0.1:9"), attr)


def _watchdog(attr):
    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.obs.drift import CostModelWatchdog

    return getattr(CostModelWatchdog({}, registry=telemetry.Registry()),
                   attr)


def _plane(read):
    from deppy_tpu_torch import routes, telemetry

    return read(routes.RoutePlane(mode="on", registry=telemetry.Registry()))


def _planner(attr):
    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.optimize import Planner

    return getattr(Planner(None, metrics=telemetry.Registry()), attr)


def _store(attr):
    from deppy_tpu_torch import telemetry
    from deppy_tpu_torch.sessions import SessionStore

    store = SessionStore(None, metrics=telemetry.Registry())
    try:
        return getattr(store, attr)
    finally:
        store.stop()


def _elector(mp, attr):
    from deppy_tpu_torch.utils.lease import elector_from_env

    mp.setenv("DEPPY_GPU_HA_LEASE", "deppy-leader")
    mp.setenv("DEPPY_GPU_HA_API", "http://127.0.0.1:9")
    return getattr(elector_from_env().config, attr)


def _import_fails(module):
    """Importing ``module`` in a fresh process (the knob is read at
    import): the exception's type name, or None when it imports."""
    out = subprocess.run(
        [sys.executable, "-c", f"import {module}"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    if out.returncode == 0:
        return None
    return out.stderr.strip().splitlines()[-1].split(":")[0]


def _nonnum(name, raw="x1"):
    return f"ignoring non-numeric {name}={raw!r}"


ROWS = [
    # telemetry
    ("DEPPY_GPU_TELEMETRY_FILE", "", lambda mp: _telemetry_file(mp),
     None, None),
    ("DEPPY_GPU_TRACE_RING", "x1", lambda mp: _recorder("capacity"),
     64, None),
    ("DEPPY_GPU_TRACE_ERROR_RING", "x1",
     lambda mp: _recorder("error_capacity"), 256, None),
    # profiler / SLO
    ("DEPPY_GPU_PROFILE", "maybe", lambda mp: _profile(
        lambda m: m.armed()), False, None),
    ("DEPPY_GPU_PROFILE_SAMPLE", "x1", lambda mp: _profile(
        lambda m: m._INTERVAL), 1, None),
    ("DEPPY_GPU_SLO", "{bad", lambda mp: __import__(
        "deppy_tpu_torch.profile", fromlist=["x"]).slo_config_from_env(),
     ValueError, None),
    # faults
    ("DEPPY_GPU_FAULT_PLAN", "{bad", lambda mp: __import__(
        "deppy_tpu_torch.faults", fromlist=["x"]).plan_from_env(),
     ValueError, None),
    ("DEPPY_GPU_FAULT_RETRIES", "x1", lambda mp: _policy("max_attempts"),
     2, None),
    ("DEPPY_GPU_FAULT_BACKOFF_S", "x1",
     lambda mp: _policy("base_backoff_s"), 0.05, None),
    ("DEPPY_GPU_FAULT_BACKOFF_MAX_S", "x1",
     lambda mp: _policy("max_backoff_s"), 2.0, None),
    ("DEPPY_GPU_CHUNK_DEADLINE_S", "x1",
     lambda mp: _policy("chunk_deadline_s"), 0.0, None),
    ("DEPPY_GPU_BATCH_DEADLINE_S", "x1", lambda mp: _ambient(), None,
     _nonnum("DEPPY_GPU_BATCH_DEADLINE_S")),
    ("DEPPY_GPU_BREAKER_THRESHOLD", "x1",
     lambda mp: _breaker("failure_threshold"), 3, None),
    ("DEPPY_GPU_BREAKER_RESET_S", "x1",
     lambda mp: _breaker("reset_after_s"), 30.0, None),
    # scheduler
    ("DEPPY_GPU_SCHED_MAX_WAIT_MS", "x1", lambda mp: _sched().max_wait_s,
     0.005, _nonnum("DEPPY_GPU_SCHED_MAX_WAIT_MS")),
    ("DEPPY_GPU_SCHED_MAX_FILL", "x1", lambda mp: _sched().max_fill, 256,
     _nonnum("DEPPY_GPU_SCHED_MAX_FILL")),
    ("DEPPY_GPU_SCHED_MAX_FILL", "2.5", lambda mp: _sched().max_fill, 2,
     None),
    ("DEPPY_GPU_SCHED_MAX_DEPTH", "x1", lambda mp: _sched().max_depth,
     4096, _nonnum("DEPPY_GPU_SCHED_MAX_DEPTH")),
    ("DEPPY_GPU_SCHED_LANES_PER_DEVICE", "x1",
     lambda mp: _sched().lanes_per_device, 256,
     _nonnum("DEPPY_GPU_SCHED_LANES_PER_DEVICE")),
    ("DEPPY_GPU_CACHE_SIZE", "x1", lambda mp: _sched().cache.capacity,
     1024, _nonnum("DEPPY_GPU_CACHE_SIZE")),
    ("DEPPY_GPU_INCREMENTAL", "maybe",
     lambda mp: _sched().incremental is not None, True, None),
    ("DEPPY_GPU_INCREMENTAL_MAX_DELTA", "x1",
     lambda mp: _sched().incremental.max_delta_ratio, 0.25,
     _nonnum("DEPPY_GPU_INCREMENTAL_MAX_DELTA")),
    ("DEPPY_GPU_INCREMENTAL_INDEX_SIZE", "x1",
     lambda mp: _sched().incremental.capacity, 512,
     _nonnum("DEPPY_GPU_INCREMENTAL_INDEX_SIZE")),
    ("DEPPY_GPU_PORTFOLIO", "maybe", lambda mp: _sched()._racer.mode,
     "auto", None),
    ("DEPPY_GPU_PORTFOLIO_K", "x1", lambda mp: _sched()._racer.k, 2,
     _nonnum("DEPPY_GPU_PORTFOLIO_K")),
    ("DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK", "x1",
     lambda mp: _sched()._racer._check_interval, 16,
     _nonnum("DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK")),
    ("DEPPY_GPU_SPECULATE", "maybe",
     lambda mp: _sched().speculate is not None, True, None),
    ("DEPPY_GPU_SPECULATE_MAX_BACKLOG", "x1",
     lambda mp: _sched().spec_max_backlog, 2048,
     _nonnum("DEPPY_GPU_SPECULATE_MAX_BACKLOG")),
    ("DEPPY_GPU_SCHED_FAIR", "maybe", lambda mp: _sched().fair, True,
     None),
    ("DEPPY_GPU_SCHED_TENANT_WEIGHTS", "{bad", lambda mp: _sched(),
     ValueError, None),
    # service
    ("DEPPY_GPU_SCHED", "maybe",
     lambda mp: _server(lambda s: s.scheduler is not None), True, None),
    ("DEPPY_GPU_OPT", "maybe",
     lambda mp: _server(lambda s: s.optimizer is not None), True, None),
    ("DEPPY_GPU_SESSIONS", "maybe",
     lambda mp: _server(lambda s: s.sessions is not None), True, None),
    ("DEPPY_GPU_REPLICA", "  ", lambda mp: _server(lambda s: s.replica),
     None, None),
    ("DEPPY_GPU_OBS_STREAM", "  ",
     lambda mp: _server(lambda s: s._obs_armed), False, None),
    ("DEPPY_GPU_OBS_BASELINE", "  ",
     lambda mp: _server(lambda s: s._obs_armed), False, None),
    ("DEPPY_GPU_FLEET_ROUTER", "  ",
     lambda mp: _server(lambda s: s.fleet_router), None, None),
    ("DEPPY_GPU_FLEET_ADVERTISE", "  ",
     lambda mp: _server(lambda s: s.fleet_advertise), None, None),
    ("DEPPY_GPU_REQUEST_DEADLINE_S", "x1",
     lambda mp: _server(lambda s: s.request_deadline_s), None,
     _nonnum("DEPPY_GPU_REQUEST_DEADLINE_S")),
    ("DEPPY_GPU_DRAIN_S", "x1", lambda mp: _server(lambda s: s._drain_s),
     10.0, _nonnum("DEPPY_GPU_DRAIN_S")),
    ("DEPPY_GPU_REPROBE", "x1", lambda mp: _server(lambda s: s._reprobe_s),
     600.0, "[service] ignoring non-numeric DEPPY_GPU_REPROBE='x1'; "
     "using 600"),
    ("DEPPY_GPU_REPROBE", "x1", lambda mp: _sched()._reprobe_s, 600.0,
     _nonnum("DEPPY_GPU_REPROBE")),
    # HA lease
    ("DEPPY_GPU_HA_LEASE", "  ", lambda mp: __import__(
        "deppy_tpu_torch.utils.lease", fromlist=["x"]).elector_from_env(),
     None, None),
    ("DEPPY_GPU_HA_LEASE_SECONDS", "x1",
     lambda mp: _elector(mp, "lease_seconds"), 15, None),
    ("DEPPY_GPU_HA_API", "http://127.0.0.1:9",
     lambda mp: _elector(mp, "api_base"), "http://127.0.0.1:9", None),
    ("DEPPY_GPU_HA_NAMESPACE", "  ", lambda mp: _elector(mp, "namespace"),
     "deppy-tpu-system", None),
    # host pool
    ("DEPPY_GPU_HOST_WORKERS", "x1", lambda mp: _pool(
        lambda m: m.pool_workers()), 0, _nonnum("DEPPY_GPU_HOST_WORKERS")),
    ("DEPPY_GPU_HOST_WORKER_RECYCLE", "x1", lambda mp: _pool(
        lambda m: m.HostPool(workers=0).recycle_after), 256,
     _nonnum("DEPPY_GPU_HOST_WORKER_RECYCLE")),
    ("DEPPY_GPU_HOSTPOOL_SPAWN_TIMEOUT_S", "x1", lambda mp: _pool(
        lambda m: m.HostPool(workers=0).spawn_timeout_s), 30.0,
     _nonnum("DEPPY_GPU_HOSTPOOL_SPAWN_TIMEOUT_S")),
    # fleet
    ("DEPPY_GPU_FLEET", "maybe", lambda mp: __import__(
        "deppy_tpu_torch.fleet.membership",
        fromlist=["x"]).membership_mode(), ValueError, None),
    ("DEPPY_GPU_FLEET_REPLICAS", "  ", lambda mp: _router(
        lambda r: r, replicas=None), ValueError, None),
    ("DEPPY_GPU_FLEET_VNODES", "x1", lambda mp: _router(
        lambda r: r.ring.vnodes), 64, None),
    ("DEPPY_GPU_FLEET_PROBE_INTERVAL_S", "x1", lambda mp: _router(
        lambda r: r.probe_interval_s), 2.0,
     _nonnum("DEPPY_GPU_FLEET_PROBE_INTERVAL_S")),
    ("DEPPY_GPU_FLEET_PROBE_FAILURES", "x1", lambda mp: _router(
        lambda r: r.probe_failures), 3, None),
    ("DEPPY_GPU_FLEET_PEERS", "  ", lambda mp: _router(lambda r: r.peers),
     [], None),
    ("DEPPY_GPU_FLEET_SYNC_INTERVAL_S", "x1", lambda mp: _router(
        lambda r: r.sync_interval_s), 2.0,
     _nonnum("DEPPY_GPU_FLEET_SYNC_INTERVAL_S")),
    ("DEPPY_GPU_FLEET_PROBE_JITTER", "x1", lambda mp: _router(
        lambda r: r.probe_jitter), 0.2,
     _nonnum("DEPPY_GPU_FLEET_PROBE_JITTER")),
    ("DEPPY_GPU_OBS_SINK", "  ", lambda mp: _router(
        lambda r: r.aggregator), None, None),
    # obs
    ("DEPPY_GPU_OBS_QUEUE", "x1", lambda mp: _streamer("_cap"), 4096,
     None),
    ("DEPPY_GPU_OBS_BATCH", "x1", lambda mp: _streamer("_batch"), 256,
     None),
    ("DEPPY_GPU_OBS_FLUSH_MS", "x1", lambda mp: _streamer("_flush_s"),
     0.2, None),
    ("DEPPY_GPU_OBS_BACKOFF_MAX_S", "x1",
     lambda mp: _streamer("_backoff_max_s"), 5.0, None),
    ("DEPPY_GPU_OBS_DRIFT_BAND", "x1", lambda mp: _watchdog("band"), 0.5,
     None),
    ("DEPPY_GPU_OBS_DRIFT_MIN", "x1", lambda mp: _watchdog("min_samples"),
     8, None),
    # routes
    ("DEPPY_GPU_ROUTE_LEARN", "maybe", lambda mp: __import__(
        "deppy_tpu_torch.routes", fromlist=["x"]).resolve_mode(),
     "observe", None),
    ("DEPPY_GPU_ROUTE_DECAY", "x1", lambda mp: _plane(
        lambda p: p.ledger.decay), 0.2, None),
    ("DEPPY_GPU_ROUTE_MAX_AGE_S", "x1", lambda mp: _plane(
        lambda p: p.watcher.max_age_s), 604800.0, None),
    ("DEPPY_GPU_ROUTE_SHADOW_RATE", "x1", lambda mp: _plane(
        lambda p: p.sampler.interval), 16, None),
    ("DEPPY_GPU_ROUTE_MIN_SAMPLES", "x1", lambda mp: _plane(
        lambda p: p.learner.min_samples), 8, None),
    ("DEPPY_GPU_ROUTE_REGISTRY", "  ", lambda mp: _plane(
        lambda p: p.learner.registry_path), None, None),
    # optimize
    ("DEPPY_GPU_OPT_MAX_ITERATIONS", "x1",
     lambda mp: _planner("max_iterations"), 64, None),
    ("DEPPY_GPU_OPT_ITER_BUDGET", "x1", lambda mp: _planner("iter_budget"),
     1048576, None),
    ("DEPPY_GPU_OPT_MAX_WEIGHT", "x1", lambda mp: _planner("max_weight"),
     64, None),
    # sessions
    ("DEPPY_GPU_SESSION_LEASE_S", "x1", lambda mp: _store("lease_s"),
     300.0, None),
    ("DEPPY_GPU_SESSION_MAX", "x1", lambda mp: _store("max_sessions"),
     256, None),
    ("DEPPY_GPU_SESSION_MAX_PER_TENANT", "x1",
     lambda mp: _store("max_per_tenant"), 64, None),
    # engine: the import-time knobs stay strict
    ("DEPPY_GPU_HOST_CORE_NCONS", "x1", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.driver"), "ValueError", None),
    ("DEPPY_GPU_BANK_OCC_CAP", "x1", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.driver"), "ValueError", None),
    ("DEPPY_GPU_PROBE_LANES", "x1", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.driver"), "ValueError", None),
    ("DEPPY_GPU_SPEC_CORE_CAP", "x1", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.driver"), "ValueError", None),
    # Only "1" and "auto" mean anything: another value reads as off.
    ("DEPPY_GPU_SPEC_CORE", "maybe", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.driver as d; "
        "assert d.SPEC_CORE == 'maybe' and not d._spec_core_enabled()"),
     None, None),
    ("DEPPY_GPU_BLOCK_ROWS", "x1", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.cuda_blockwise"), "ValueError", None),
    ("DEPPY_GPU_BCP", "maybe", lambda mp: _import_fails(
        "deppy_tpu_torch.engine.core; "
        "deppy_tpu_torch.engine.core.resolved_impl()"), "ValueError",
     None),
    ("DEPPY_GPU_MEASURED_DEFAULTS", "", lambda mp: __import__(
        "deppy_tpu_torch.engine.defaults", fromlist=["x"]).registry_path(),
     "", None),
    # mesh
    ("DEPPY_GPU_MESH_DEVICES", "x1", lambda mp: __import__(
        "deppy_tpu_torch.parallel", fromlist=["x"]).mesh_devices_from_env(),
     None, "ignoring malformed DEPPY_GPU_MESH_DEVICES='x1'"),
]
# The knobs whose reads sit deep in a flow (a join's stream, a policy
# evaluation over live scrapes) are held on the site's own call.
DEEP = [
    ("DEPPY_GPU_FLEET_JOIN_CHUNK", "fleet.membership", "join_replica",
     "config.env_int(\n        \"DEPPY_GPU_FLEET_JOIN_CHUNK\", "
     "DEFAULT_JOIN_CHUNK, strict=False)"),
    ("DEPPY_GPU_FLEET_JOIN_RETRIES", "fleet.membership", "join_replica",
     "config.env_int(\n        \"DEPPY_GPU_FLEET_JOIN_RETRIES\", "
     "DEFAULT_JOIN_RETRIES, strict=False)"),
    ("DEPPY_GPU_FLEET_BURN_UP", "fleet.policy", "evaluate",
     "faults.env_float(\"DEPPY_GPU_FLEET_BURN_UP\",\n"
     "                               DEFAULT_BURN_UP, warn=True)"),
    ("DEPPY_GPU_FLEET_BURN_DOWN", "fleet.policy", "evaluate",
     "faults.env_float(\"DEPPY_GPU_FLEET_BURN_DOWN\",\n"
     "                                 DEFAULT_BURN_DOWN, warn=True)"),
]


def test_rows_cover_every_knob():
    covered = {r[0] for r in ROWS} | {d[0] for d in DEEP}
    assert covered == set(config.REGISTRY)


@pytest.mark.parametrize(
    "name,raw,read,want,warn", ROWS,
    ids=[f"{r[0]}={r[1]!r}" for r in ROWS])
def test_malformed_value_reads_as_before(name, raw, read, want, warn,
                                         monkeypatch, capsys):
    monkeypatch.setenv(name, raw)
    if isinstance(want, type) and issubclass(want, BaseException):
        with pytest.raises(want):
            read(monkeypatch)
    else:
        got = read(monkeypatch)
        assert got == want
    err = capsys.readouterr().err
    if warn is None:
        assert "ignoring" not in err, err
    else:
        assert warn in err, err


@pytest.mark.parametrize("name,module,fn,call", DEEP,
                         ids=[d[0] for d in DEEP])
def test_deep_reads_keep_their_parse(name, module, fn, call, monkeypatch,
                                     capsys):
    """The site reads the knob with the lenient parse it had (a malformed
    value reads the default; the burn thresholds warn)."""
    import importlib

    mod = importlib.import_module(f"deppy_tpu_torch.{module}")
    src = Path(mod.__file__).read_text(encoding="utf-8")
    assert call in src
    monkeypatch.setenv(name, "x1")
    default = {"JOIN_CHUNK": mod.__dict__.get("DEFAULT_JOIN_CHUNK"),
               "JOIN_RETRIES": mod.__dict__.get("DEFAULT_JOIN_RETRIES"),
               "BURN_UP": mod.__dict__.get("DEFAULT_BURN_UP"),
               "BURN_DOWN": mod.__dict__.get("DEFAULT_BURN_DOWN")}[
        name[len("DEPPY_GPU_FLEET_"):]]
    got = eval(call, {"config": config,
                      "faults": importlib.import_module(
                          "deppy_tpu_torch.faults"),
                      **mod.__dict__})
    assert got == default
    err = capsys.readouterr().err
    assert ("ignoring non-numeric" in err) == ("BURN" in name)
