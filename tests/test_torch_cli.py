"""The port's CLI (``deppy_tpu_torch/cli.py``) against the reference's
(``deppy_tpu/cli.py``) on the CPU.

Each case runs the reference's ``main`` and the port's on the same argv
(``--backend tpu`` becomes ``--backend device --device cpu``) and the
same file, and holds the exit code, stdout and stderr equal:

  * ``tests/test_cli.py``'s ``TestResolveCommand`` and ``TestServeConfig``
    cases, and a batch of seeded catalogs written by the port's codec;
  * the client verbs (``publish``, ``optimize``, ``explain``) against a
    port server, ``fleet policy`` / ``scale`` and ``top --once`` against a
    stub router, and ``route``'s usage errors;
  * ``serve`` in a subprocess: one ``/v1/resolve`` equal to ``resolve
    --output json``, and SIGTERM giving exit 0.

Cases of the port alone: ``--backend tpu`` is a usage error, the deferred
verbs exit 2 naming their ROADMAP item, ``--device cuda`` without a card
prints no answer, and ``fleet scale --apply`` spawns the port.  The sink
verbs are ``tests/test_torch_cli_sinks.py``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from deppy_tpu import cli as ref_cli
from deppy_tpu_torch import cli as port_cli
from deppy_tpu_torch import io as port_io
from deppy_tpu_torch.models import (gvk_conflict_catalog, operatorhub_catalog,
                                    pinned_tenant_catalog, random_instance)

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "config" / "manager" / "resolver_config.yaml"
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def inline_host_lanes(monkeypatch):
    """Host lanes run inline in both packages: no worker pool to start."""
    monkeypatch.setenv("DEPPY_TPU_HOST_WORKERS", "0")
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")


def port_argv(argv):
    """``argv`` with the reference's ``--backend tpu`` in the port's
    spelling."""
    out = list(argv)
    for i, a in enumerate(argv[:-1]):
        if a == "--backend" and argv[i + 1] == "tpu":
            out[i + 1:i + 2] = ["device", "--device", "cpu"]
    return out


def run(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def both(capsys, argv):
    """(reference, port): each (exit code, stdout, stderr)."""
    return (run(capsys, ref_cli.main, argv),
            run(capsys, port_cli.main, port_argv(argv)))


def write_doc(tmp_path, doc, name="problem.json"):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def _doc(states) -> dict:
    return {"problems": [{"variables": [port_io.variable_to_dict(v)
                                        for v in vs]} for vs in states]}


def seeded_batch() -> dict:
    """A batch the port's codec writes: catalogs from the port's
    generators at seeds drawn with numpy."""
    seeds = [int(s) for s in np.random.default_rng(24).integers(0, 10**4, 7)]
    states = ([random_instance(length=12, seed=s) for s in seeds[:3]]
              + [gvk_conflict_catalog(20, 4, 10, seed=seeds[3]),
                 pinned_tenant_catalog(seed=seeds[4]),
                 pinned_tenant_catalog(seed=seeds[6]),
                 operatorhub_catalog(6, 2, seed=seeds[5])])
    return _doc(states)


# tests/test_cli.py's documents, by case: (document, extra flags, exit code).
RESOLVE_CASES = {
    "sat": ({"variables": [
        {"id": "a", "constraints": [
            {"type": "mandatory"}, {"type": "dependency", "ids": ["c"]}]},
        {"id": "b", "constraints": [
            {"type": "mandatory"}, {"type": "dependency", "ids": ["d"]}]},
        {"id": "c"}, {"id": "d"}]}, [], 0),
    "unsat": ({"variables": [{"id": "a", "constraints": [
        {"type": "mandatory"}, {"type": "prohibited"}]}]}, [], 1),
    "preference": ({"variables": [
        {"id": "a", "constraints": [
            {"type": "mandatory"},
            {"type": "dependency", "ids": ["b", "c"]}]},
        {"id": "b"}, {"id": "c"}]}, [], 0),
    "batch": ({"problems": [
        {"variables": [{"id": "a", "constraints": [{"type": "mandatory"}]}]},
        {"variables": [{"id": "b", "constraints": [
            {"type": "mandatory"}, {"type": "prohibited"}]}]}]}, [], 1),
    "one_problem_batch": ({"problems": [
        {"variables": [{"id": "a", "constraints": [
            {"type": "mandatory"}]}]}]}, [], 0),
    "incomplete": ({"variables": [
        {"id": "a", "constraints": [
            {"type": "mandatory"},
            {"type": "dependency", "ids": ["b", "c"]}]},
        {"id": "b", "constraints": [{"type": "dependency", "ids": ["d"]}]},
        {"id": "c"},
        {"id": "d", "constraints": [{"type": "conflict", "id": "c"}]}]},
        ["--max-steps", "1"], 3),
    "duplicate_identifier": ({"variables": [{"id": "a"}, {"id": "a"}]},
                             [], 2),
    "seeded_batch": (seeded_batch(), [], 1),
}


class TestResolveCommand:
    @pytest.mark.parametrize("backend", ["host", "tpu"])
    @pytest.mark.parametrize("output", ["text", "json"])
    @pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
    def test_matches_reference(self, tmp_path, capsys, case, output,
                               backend):
        doc, extra, want_rc = RESOLVE_CASES[case]
        path = write_doc(tmp_path, doc)
        ref, got = both(capsys, ["resolve", path, "--backend", backend,
                                 "--output", output] + extra)
        assert ref[0] == want_rc, ref
        assert got == ref

    @pytest.mark.parametrize("case", ["missing_file", "invalid_json"])
    def test_bad_input_matches_reference(self, tmp_path, capsys, case):
        path = tmp_path / "bad.json"
        if case == "invalid_json":
            path.write_text("{nope")
        ref, got = both(capsys, ["resolve", str(path)])
        assert ref[0] == 2 and ("no such file" in ref[2]
                                or "invalid JSON" in ref[2])
        assert got == ref

    def test_checkpoint_dir_resume(self, tmp_path, capsys):
        path = write_doc(tmp_path, RESOLVE_CASES["batch"][0])
        outs = {}
        for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
            ck = str(tmp_path / f"ck_{name}")
            argv = ["resolve", path, "--backend", "tpu", "--output", "json",
                    "--checkpoint-dir", ck]
            if name == "port":
                argv = port_argv(argv)
            first = run(capsys, main, argv)
            second = run(capsys, main, argv)
            assert first[:2] == second[:2] and first[0] == 1
            assert any(n.endswith(".npz") for n in os.listdir(ck))
            outs[name] = (first, second[2].replace(ck, "CK"))
        assert outs["ref"][1] == "[checkpoint] resumed 2/2 problems from CK\n"
        assert outs["port"] == outs["ref"]

    def test_host_workers_and_telemetry_flags(self, tmp_path, capsys):
        """``--host-workers`` and ``--telemetry-file`` take effect in both
        and leave the answers unchanged."""
        from deppy_tpu import hostpool as ref_pool
        from deppy_tpu_torch import hostpool as port_pool

        path = write_doc(tmp_path, seeded_batch())
        try:
            ref = run(capsys, ref_cli.main, [
                "resolve", path, "--backend", "host", "--host-workers", "0",
                "--telemetry-file", str(tmp_path / "ref.jsonl")])
            got = run(capsys, port_cli.main, [
                "resolve", path, "--backend", "host", "--host-workers", "0",
                "--telemetry-file", str(tmp_path / "port.jsonl")])
        finally:
            ref_pool.configure_pool(None)
            port_pool.configure_pool(None)
            from deppy_tpu import telemetry as ref_tel
            from deppy_tpu_torch import telemetry as port_tel

            ref_tel.configure_sink(None)
            port_tel.configure_sink(None)
        assert got == ref
        assert (tmp_path / "port.jsonl").stat().st_size > 0

    def test_fault_plan_flag(self, tmp_path, capsys):
        """A scripted dispatch error is retried: the answers stand; a
        malformed plan is a usage error in both."""
        from deppy_tpu import faults as ref_faults
        from deppy_tpu_torch import faults as port_faults

        path = write_doc(tmp_path, RESOLVE_CASES["batch"][0])
        plan = '[{"point": "driver.dispatch", "times": 1}]'
        try:
            ref, got = both(capsys, ["resolve", path, "--backend", "tpu",
                                     "--output", "json", "--fault-plan",
                                     plan])
            bad = both(capsys, ["resolve", path, "--fault-plan", "{nope"])
        finally:
            ref_faults.configure_plan(None)
            port_faults.configure_plan(None)
        assert ref[0] == 1 and got == ref
        assert bad[0][0] == 2 and bad[1] == bad[0]

    def test_no_command_prints_help(self, capsys):
        for main in (ref_cli.main, port_cli.main):
            rc, out, _ = run(capsys, main, [])
            assert rc == 0 and "resolve" in out


class TestPortOnly:
    @pytest.mark.parametrize("verb", ["resolve", "serve", "fleet"])
    def test_backend_tpu_is_a_usage_error(self, tmp_path, capsys, verb):
        argv = {"resolve": ["resolve", str(tmp_path / "x.json")],
                "serve": ["serve"], "fleet": ["fleet", "scale"]}[verb]
        with pytest.raises(SystemExit) as e:
            port_cli.main(argv + ["--backend", "tpu"])
        assert e.value.code == 2
        assert "invalid choice: 'tpu'" in capsys.readouterr().err

    @pytest.mark.parametrize("argv,item", [
        (["bench"], "A7.2b"), (["bench", "--problems", "8"], "A7.2b"),
        (["lint"], "A7.2c"), (["lint", "--json"], "A7.2c"),
        (["compiles"], "A7.2c"), (["compiles", "--surface"], "A7.2c"),
        (["compiles", "sink.jsonl", "--output", "json"], "A7.2c"),
        (["doctor"], "A7.2c"), (["doctor", "--watch"], "A7.2c")])
    def test_deferred_verbs_name_their_item(self, capsys, argv, item):
        rc, out, err = run(capsys, port_cli.main, argv)
        assert rc == 2 and out == ""
        assert err == (f"error: deppy {argv[0]} is not in the port yet "
                       f"(ROADMAP {item})\n")

    def test_undeclared_flag_is_refused_as_in_reference(self, tmp_path,
                                                        capsys):
        """Only a deferred verb takes arguments it does not declare."""
        path = write_doc(tmp_path, RESOLVE_CASES["sat"][0])
        errs = []
        for main in (ref_cli.main, port_cli.main):
            with pytest.raises(SystemExit) as e:
                main(["resolve", path, "--problems", "8"])
            assert e.value.code == 2
            errs.append(capsys.readouterr().err)
        assert "unrecognized arguments: --problems 8" in errs[1]
        assert errs[1] == errs[0]

    def test_missing_card_prints_no_answer(self, tmp_path, capsys,
                                           monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        path = write_doc(tmp_path, RESOLVE_CASES["sat"][0])
        rc, out, err = run(capsys, port_cli.main, ["resolve", path])
        assert rc == 2 and out == ""
        assert "device='cuda' was requested" in err

    def test_missing_card_in_a_fresh_process(self, tmp_path):
        path = write_doc(tmp_path, RESOLVE_CASES["sat"][0])
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run(
            [sys.executable, "-m", "deppy_tpu_torch", "resolve", path],
            cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
            env=env)
        assert proc.returncode == 2 and proc.stdout == ""
        assert "torch.cuda.is_available() is False" in proc.stderr


# ------------------------------------------------------------- serve config


SERVE_KWARGS = {}


def _record_serve(**kwargs):
    SERVE_KWARGS.clear()
    SERVE_KWARGS.update(kwargs)


class TestServeConfig:
    @pytest.mark.parametrize("text,name", [
        ("apiVersion: deppy-tpu.io/v1alpha1\nkind: ResolverConfig\n"
         'bindAddress: ":9090"\nhealthProbeBindAddress: ":9091"\n'
         "backend: host\nmaxSteps: 123\n", "cfg.yaml"),
        ('{"bindAddress": ":7070", "backend": "host"}', "cfg.json"),
        (json.dumps({key: (1 if cast is int else 0.5 if cast is float
                           else "on")
                     for key, (_, cast) in ref_cli._CONFIG_KEYS.items()}),
         "every_key.json"),
        (None, "shipped")])
    def test_load_serve_config_matches_reference(self, tmp_path, text,
                                                 name):
        path = SHIPPED
        if text is not None:
            path = tmp_path / name
            path.write_text(text)
        want = ref_cli._load_serve_config(str(path))
        assert port_cli._load_serve_config(str(path)) == want
        if name == "shipped":
            assert want["bind_address"] == ":8080"
            assert want["probe_address"] == ":8081"
            assert want["backend"] == "auto"

    def test_config_keys_equal_the_reference(self):
        assert port_cli._CONFIG_KEYS == ref_cli._CONFIG_KEYS

    @pytest.mark.parametrize("backend", ["tpu", "gpu"])
    def test_unknown_config_backend_is_usage_error(self, tmp_path, capsys,
                                                   backend):
        """A backend the port does not serve, named by the config file,
        is a usage error before anything binds."""
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"backend": backend}))
        rc, out, err = run(capsys, port_cli.main,
                           ["serve", "--config", str(cfg), "--device", "cpu",
                            "--bind-address", "127.0.0.1:0",
                            "--health-probe-bind-address", "127.0.0.1:0"])
        assert (rc, out) == (2, "")
        assert err == ("error: 1 errors encountered: "
                       f"unknown backend {backend!r}\n")

    def test_missing_config_is_usage_error(self, capsys):
        ref, got = both(capsys, ["serve", "--config",
                                 "/nonexistent/cfg.yaml"])
        assert ref[0] == 2 and "no such file" in ref[2]
        assert got == ref

    def test_precedence_matches_reference(self, tmp_path, monkeypatch):
        """Built-in defaults < --config < explicit flags: the kwargs that
        reach ``serve()`` equal the reference's, but for the port's
        ``device`` and its ``device`` backend default."""
        from deppy_tpu import service as ref_service
        from deppy_tpu.engine import core as ref_core
        from deppy_tpu_torch import service as port_service
        from deppy_tpu_torch.engine import core as port_core

        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"bindAddress": ":7070",
                                   "maxSteps": 9, "schedMaxFill": 64,
                                   "bcp": "blockwise",
                                   "sessionLeaseS": 2.5}))
        seen = {}
        for name, mod in (("ref", ref_service), ("port", port_service)):
            monkeypatch.setattr(mod, "serve", _record_serve)
        argv = ["serve", "--config", str(cfg), "--max-steps", "11",
                "--mesh-devices", "all", "--sched", "off"]
        try:
            for name, main, core in (("ref", ref_cli.main, ref_core),
                                     ("port", port_cli.main, port_core)):
                for extra in ([], ["--backend", "host"]):
                    assert main(argv + extra) == 0
                    seen[name, bool(extra)] = dict(SERVE_KWARGS)
                assert core._BCP_IMPL == "blockwise"
                core.set_bcp_impl("auto")
        finally:
            ref_core.set_bcp_impl("auto")
            port_core.set_bcp_impl("auto")
        for flagged in (False, True):
            ref, got = seen["ref", flagged], seen["port", flagged]
            assert got.pop("device") == "cuda"
            assert ref.pop("backend") == ("host" if flagged else "auto")
            assert got.pop("backend") == ("host" if flagged else "device")
            assert got == ref
        assert (ref["bind_address"], ref["max_steps"], ref["mesh_devices"],
                ref["session_lease_s"]) == (":7070", 11, -1, 2.5)


# ----------------------------------------------------------- client verbs


def _server(**kw):
    from deppy_tpu_torch.service import Server

    srv = Server(device="cpu", bind_address="127.0.0.1:0",
                 probe_address="127.0.0.1:0", **kw)
    srv.start()
    return srv


def _post(port: int, path: str, doc) -> dict:
    conn = HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", path, json.dumps(doc),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _family(prefix: str, bundles: int = 3, size: int = 5) -> dict:
    """``tests/test_speculate.py:55-75``'s bundle-catalog family."""
    doc = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0:
                cons += [{"type": "mandatory"},
                         {"type": "dependency", "ids": [f"{prefix}b{b}v1"]}]
            elif j < size - 2:
                cons.append({"type": "dependency",
                             "ids": [f"{prefix}b{b}v{j + 1}"]})
            doc.append({"id": f"{prefix}b{b}v{j}", "constraints": cons})
    return {"variables": doc}


PUBLISH = {"updates": [{"id": "f.b1v1", "constraints": [
    {"type": "dependency", "ids": ["f.b1v4", "f.b1v3"]}]}]}

UPGRADE = {"query": "upgrade", "installed": ["root", "app-v1", "lib-v1"],
           "prefer": ["app-v2"], "variables": [
               {"id": "root", "constraints": [
                   {"type": "mandatory"},
                   {"type": "dependency", "ids": ["app-v2", "app-v1"]},
                   {"type": "atMost", "n": 1, "ids": ["app-v2", "app-v1"]}]},
               {"id": "app-v1", "constraints": [
                   {"type": "dependency", "ids": ["lib-v1"]}]},
               {"id": "app-v2", "constraints": [
                   {"type": "dependency", "ids": ["lib-v1", "lib-v2"]}]},
               {"id": "lib-v1"}, {"id": "lib-v2"}]}

SOFT = {"query": "soft", "variables": [{"id": "a"}, {"id": "b"}],
        "soft": [{"id": "a", "installed": False, "weight": 2},
                 {"id": "b", "installed": True}]}

EXPLAIN = {"goal": ["x"], "variables": [
    {"id": "r", "constraints": [{"type": "mandatory"},
                                {"type": "conflict", "id": "x"}]},
    {"id": "x"}]}


class TestClientVerbs:
    @pytest.mark.parametrize("output", ["text", "json"])
    def test_publish_matches_reference(self, tmp_path, capsys, output):
        """The same publish against two fresh port servers that served
        the family once: the reference's client on one, the port's on the
        other."""
        path = write_doc(tmp_path, PUBLISH, "publish.json")
        outs = []
        for main in (ref_cli.main, port_cli.main):
            srv = _server()
            try:
                assert _post(srv.api_port, "/v1/resolve",
                             _family("f."))[0] == 200
                outs.append(run(capsys, main, [
                    "publish", path, "--server",
                    f"127.0.0.1:{srv.api_port}", "--output", output]))
            finally:
                srv.shutdown()
        assert outs[0][0] == 0 and "affected" in outs[0][1]
        assert outs[1] == outs[0]

    def test_client_verbs_on_one_server(self, tmp_path, capsys):
        """preview, optimize (upgrade, soft), explain, and their error
        paths (a bad document, a wrong query, the tier off) answer alike
        through both clients."""
        docs = {name: write_doc(tmp_path, doc, f"{name}.json")
                for name, doc in (("publish", PUBLISH), ("upgrade", UPGRADE),
                                  ("soft", SOFT), ("explain", EXPLAIN),
                                  ("wrong", dict(EXPLAIN, query="soft")),
                                  ("list", [1, 2]))}
        bad = tmp_path / "bad.json"
        bad.write_text("{nope")
        srv = _server()
        off = _server(opt="off")
        try:
            assert _post(srv.api_port, "/v1/resolve",
                         _family("f."))[0] == 200
            server = ["--server", f"http://127.0.0.1:{srv.api_port}"]
            cases = [
                ["publish", docs["publish"], "--preview", "--limit", "4"],
                ["publish", docs["list"], "--preview", "--limit", "4"],
                ["optimize", docs["upgrade"]],
                ["optimize", docs["upgrade"], "--output", "json"],
                ["optimize", docs["soft"]],
                ["explain", docs["explain"]],
                ["explain", docs["explain"], "--output", "json"],
                ["explain", docs["wrong"]],
                ["explain", docs["list"]],
                ["optimize", str(bad)],
                ["optimize", str(tmp_path / "nope.json")]]
            rcs = []
            for argv in cases:
                ref, got = both(capsys, argv + server)
                assert got == ref, argv
                rcs.append(ref[0])
            assert rcs == [0, 2, 0, 0, 0, 0, 0, 2, 2, 2, 2]
            ref, got = both(capsys, [
                "optimize", docs["soft"], "--server",
                f"127.0.0.1:{off.api_port}"])
            assert ref[0] == 2 and got == ref
            ref, got = both(capsys, ["optimize", docs["soft"], "--server",
                                     "ftp://127.0.0.1:1"])
            assert ref[0] == 2 and got == ref
        finally:
            srv.shutdown()
            off.shutdown()


# ---------------------------------------------------------- router verbs


class _Stub:
    """A stub router: canned bodies by (method, path), and the requests
    it was sent."""

    def __init__(self, routes: dict):
        stub = self
        self.routes = routes
        self.seen = []

        class Handler(BaseHTTPRequestHandler):
            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                stub.seen.append((self.command, self.path, body))
                status, data = stub.routes.get(
                    (self.command, self.path), (404, b'{"error": "nf"}'))
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _answer

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@contextmanager
def stub(routes):
    s = _Stub(routes)
    try:
        yield s
    finally:
        s.close()


def _policy(decision, target=None) -> bytes:
    return json.dumps({"policy": {
        "decision": decision, "target": target, "reason": "burn",
        "burn": {"t1": 1.5}}}).encode()


class _Spawned:
    pid = 4242


class TestFleetVerbs:
    @pytest.mark.parametrize("decision,target", [
        ("hold", None), ("scale_down", "127.0.0.1:9"),
        ("rebalance", None)])
    @pytest.mark.parametrize("verb", ["policy", "scale"])
    def test_matches_reference(self, capsys, verb, decision, target):
        drain = json.dumps({"drain": {"handed_off": 3, "recipients": {
            "127.0.0.1:8": 3}}}).encode()
        with stub({("GET", "/fleet/policy"): (200, _policy(decision,
                                                           target)),
                   ("POST", "/fleet/drain"): (200, drain)}) as s:
            argv = ["fleet", verb, "--router", s.addr]
            ref, got = both(capsys, argv + (["--apply"] if verb == "scale"
                                            else []))
        assert ref[0] == 0 and got == ref

    @pytest.mark.parametrize("case", ["no_subcommand", "bad_router",
                                      "unreachable", "policy_500",
                                      "drain_500"])
    def test_errors_match_reference(self, capsys, case):
        with stub({("GET", "/fleet/policy"):
                   (500, b"boom") if case == "policy_500"
                   else (200, _policy("scale_down", "127.0.0.1:9")),
                   ("POST", "/fleet/drain"): (500, b"nope")}) as s:
            argv = {"no_subcommand": ["fleet"],
                    "bad_router": ["fleet", "policy", "--router", "x:y"],
                    "unreachable": ["fleet", "policy", "--router",
                                    "127.0.0.1:1"],
                    "policy_500": ["fleet", "policy", "--router", s.addr],
                    "drain_500": ["fleet", "scale", "--apply",
                                  "--router", s.addr]}[case]
            ref, got = both(capsys, argv)
        assert ref[0] in (1, 2) and got == ref

    def test_scale_up_spawns_the_port(self, capsys, monkeypatch):
        """``scale --apply`` on scale_up spawns ``deppy_tpu_torch.cli``
        with ``--device``; the reference spawns ``deppy_tpu.cli``."""
        spawned = []

        def popen(argv, **kw):
            spawned.append(argv)
            return _Spawned()

        monkeypatch.setattr(subprocess, "Popen", popen)
        with stub({("GET", "/fleet/policy"): (200, _policy("scale_up"))}) \
                as s:
            ref = run(capsys, ref_cli.main, ["fleet", "scale", "--apply",
                                             "--router", s.addr])
            got = run(capsys, port_cli.main, [
                "fleet", "scale", "--apply", "--router", s.addr,
                "--device", "cpu", "--backend", "device"])
        ref_argv, port_argv_ = spawned
        assert "from deppy_tpu.cli import main" in ref_argv[2]
        assert "from deppy_tpu_torch.cli import main" in port_argv_[2]
        assert "deppy_tpu.cli" not in port_argv_[2]
        assert port_argv_[port_argv_.index("--device") + 1] == "cpu"
        assert port_argv_[port_argv_.index("--backend") + 1] == "device"
        assert port_argv_[port_argv_.index("--fleet-router") + 1] == s.addr
        # The same lines, but for the free port each one picked.
        for rc_out, argv in ((ref, ref_argv), (got, port_argv_)):
            addr = argv[argv.index("--bind-address") + 1]
            assert rc_out[0] == 0 and f"spawned replica {addr} (pid 4242)" \
                in rc_out[1]
        strip = [o[1].split("fleet scale: spawned")[0] for o in (ref, got)]
        assert strip[0] == strip[1]

    def test_scale_up_defaults_to_the_card(self, capsys, monkeypatch):
        """Without ``--backend`` or ``--device`` the spawned replica
        solves on the card, as ``serve``'s own defaults do."""
        spawned = []

        def popen(argv, **kw):
            spawned.append(argv)
            return _Spawned()

        monkeypatch.setattr(subprocess, "Popen", popen)
        with stub({("GET", "/fleet/policy"): (200, _policy("scale_up"))}) \
                as s:
            rc, _, _ = run(capsys, port_cli.main,
                           ["fleet", "scale", "--apply", "--router", s.addr])
        [argv] = spawned
        assert rc == 0
        i = argv.index("--backend")
        assert argv[i:i + 4] == ["--backend", "device", "--device", "cuda"]

    def test_top_once_matches_reference(self, capsys):
        """``top --once`` renders a port router's status and federated
        metrics, captured once and served by a stub, alike."""
        from deppy_tpu_torch.fleet import Router

        srv = _server(replica="r0")
        router = Router(bind_address="127.0.0.1:0",
                        replicas=[f"127.0.0.1:{srv.api_port}"],
                        probe_interval_s=0)
        router.start()
        srv_addr = f"127.0.0.1:{srv.api_port}"
        try:
            assert _post(router.api_port, "/v1/resolve",
                         RESOLVE_CASES["batch"][0])[0] == 200
            captured = {}
            for path in ("/fleet/status", "/fleet/metrics"):
                conn = HTTPConnection("127.0.0.1", router.api_port,
                                      timeout=TIMEOUT_S)
                conn.request("GET", path)
                captured[("GET", path)] = (200, conn.getresponse().read())
                conn.close()
        finally:
            router.shutdown()
            srv.shutdown()
        with stub(captured) as s:
            ref, got = both(capsys, ["top", "--once", "--router", s.addr])
        assert ref[0] == 0 and srv_addr in ref[1]
        assert got == ref
        ref, got = both(capsys, ["top", "--once", "--router", "127.0.0.1:1"])
        assert got == ref

    @pytest.mark.parametrize("argv", [
        ["route", "--bind-address", "127.0.0.1:0"],
        ["route", "--fault-plan", "{nope"]])
    def test_route_usage_errors_match_reference(self, capsys, monkeypatch,
                                                argv):
        """No replica to front, a malformed fault plan: exit 2 before
        anything listens.  The message names each package's knob."""
        monkeypatch.delenv("DEPPY_TPU_FLEET_REPLICAS", raising=False)
        monkeypatch.delenv("DEPPY_GPU_FLEET_REPLICAS", raising=False)
        ref, got = both(capsys, argv)
        assert ref[0] == 2
        assert got == (ref[0], ref[1],
                       ref[2].replace("DEPPY_TPU_", "DEPPY_GPU_"))


# ------------------------------------------------------------ serve process


def test_serve_subprocess_answers_and_exits_on_sigterm(tmp_path, capsys):
    """``python -m deppy_tpu_torch serve --device cpu``: the banner, one
    ``/v1/resolve`` whose body equals ``resolve --output json``'s answer,
    and exit 0 on SIGTERM.  Every wait is bounded; the child is killed in
    ``finally``."""
    doc = seeded_batch()
    path = write_doc(tmp_path, doc)
    rc, out, _ = run(capsys, port_cli.main, [
        "resolve", path, "--device", "cpu", "--output", "json"])
    assert rc == 1
    log = open(tmp_path / "serve.out", "w+")
    env = dict(os.environ, DEPPY_GPU_HOST_WORKERS="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deppy_tpu_torch", "serve", "--device", "cpu",
         "--bind-address", "127.0.0.1:0",
         "--health-probe-bind-address", "127.0.0.1:0"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        banner = ""
        while "listening on :" not in banner:
            assert proc.poll() is None, banner
            assert time.monotonic() < deadline, banner
            time.sleep(0.05)
            banner = (tmp_path / "serve.out").read_text()
        port = int(banner.split("listening on :")[1].split()[0])
        status, body = _post(port, "/v1/resolve", doc)
        assert status == 200
        assert body == json.loads(out)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()
