"""The port's telemetry plane (``obs/promtext.py``, the cumulative
registry's ``replace_gauges``, request IDs, the access log, the flight
recorder and its dump, ``/metrics``, ``/debug/flight``, ``/debug/profile``)
and the daemon's ``--clusters`` entry, against the JAX package's on the
CPU.

``promtext.render`` on the same cumulative snapshot gives the reference's
text; ``parse`` and ``check_histogram`` give the reference's results on its
hard cases (``tests/test_telemetry.py:133-215``, ``:649-697``). The daemon
cases are the reference's, on the port's daemon, byte for byte where the
reference's daemon is run beside it.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from kafka_assigner_tpu.cli import parse_clusters_spec as jax_parse_clusters
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu.obs import promtext as jax_promtext
from kafka_assigner_tpu.utils import env as jax_env
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch.daemon import AssignerDaemon
from kafka_assigner_tpu_torch.obs import flight, promtext
from kafka_assigner_tpu_torch.obs import metrics as metrics_mod
from kafka_assigner_tpu_torch.utils import env as torch_env

from .jute_server import JuteZkServer, cluster_tree, exec_snapshot_cluster
from .test_torch_daemon import _await, port_cli, req

ROOT = Path(__file__).resolve().parent.parent
NEW_KNOBS = ("KA_DAEMON_JOURNAL_DIR", "KA_HEALTH_MOVE_COST", "KA_OBS_ACCESS_LOG",
             "KA_OBS_TRAFFIC_SERIES_MAX")


def _reset_planes():
    for mod in (jax_metrics, metrics_mod):
        mod.disable_cumulative()
    for mod in (jax_flight, flight):
        mod.disable()


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for knob in ("KA_FAULTS_SPEC", "KA_OBS_REPORT", "KA_OBS_ENABLE", "KA_OBS_ACCESS_LOG",
                 "KA_OBS_FLIGHT_DUMP", "KA_OBS_PROFILE_DIR", "KA_PROFILE",
                 "KA_OBS_FLIGHT_EVENTS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.5")
    monkeypatch.setenv("KA_DISPATCH", "0")
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(tmp_path))
    _reset_planes()
    yield
    _reset_planes()


@pytest.fixture()
def server():
    s = JuteZkServer(cluster_tree())
    s.start()
    yield s
    s.shutdown()


@contextlib.contextmanager
def daemon(spec, **kw):
    kw.setdefault("err", io.StringIO())
    d = AssignerDaemon(spec, solver="greedy", device="cpu", **kw)
    d.start()
    try:
        yield d
    finally:
        if d.lifecycle() != "stopped":
            d.shutdown()


def scrape(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode("utf-8")
    finally:
        conn.close()


def test_new_knobs_match_the_reference():
    for name in NEW_KNOBS:
        ref = jax_env.KNOBS[name]
        assert (torch_env.KNOBS[name].default, torch_env.KNOBS[name].floor) == (
            ref.default, ref.floor), name


# --- promtext ---------------------------------------------------------------------------


def _sample(mod):
    cum = mod.CumulativeMetrics(hist_edges=(1.0, 10.0))
    cum.counter_add("daemon.requests@west", 4)
    cum.counter_add("daemon.requests")
    cum.gauge_set("plan.moves", 12)
    for v in (0.5, 5.0, 50.0):
        cum.hist_observe("daemon.http.request_ms", v,
                         labels={"endpoint": "plan", "cluster": "west"})
    return cum.snapshot()


def _escapes(mod):
    cum = mod.CumulativeMetrics()
    for i, v in enumerate(["a\\nb", 'q"\\"w', "line1\nline2\\", "\\\\", "plain",
                           'we"st\\x\nq']):
        cum.counter_add("daemon.requests", i + 1, labels={"cluster": v})
    return cum.snapshot()


def _zero_obs(mod):
    cum = mod.CumulativeMetrics(hist_edges=(1.0, 10.0))
    cum.hist_observe("exec.wave_ms", 5.0)
    snap = cum.snapshot()
    h = snap["hists"]["exec.wave_ms"][()]
    h["counts"] = [0] * len(h["counts"])
    h["count"], h["sum"] = 0, 0.0
    return snap


def _gauges(mod):
    cum = mod.CumulativeMetrics()
    cum.replace_gauges("traffic.lag", {(("partition", "0"), ("topic", "t")): 7,
                                       (("partition", "1"), ("topic", "t")): 2.5},
                       {"cluster": "a"})
    cum.gauge_set("health.score@a", 6.0)
    cum.gauge_set("health.replica_stddev", 0.471405)
    return cum.snapshot()


RENDER_CASES = {
    "sample": (_sample, {"process_uptime_seconds": 1.5},
               {"tool": "kafka-assignment-generator", "report_schema": "1"}),
    "empty": (lambda mod: {"counters": {}, "gauges": {}, "hists": {}}, None, None),
    "empty-with-process-gauges": (lambda mod: {"counters": {}, "gauges": {}, "hists": {}},
                                  {"daemon_clusters": 2}, {"tool": "x"}),
    "escapes": (_escapes, None, None),
    "zero-observations": (_zero_obs, None, None),
    "gauges": (_gauges, {"flight_events_recorded": 3}, None),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_of_one_snapshot_is_the_references(case):
    build, extra, info = RENDER_CASES[case]
    text = promtext.render(build(metrics_mod), extra_gauges=extra, info=info)
    assert text == jax_promtext.render(build(jax_metrics), extra_gauges=extra, info=info)
    fams = promtext.parse(text)
    assert fams == jax_promtext.parse(text)
    for data in fams.values():
        if data["type"] == "histogram":
            assert promtext.check_histogram(data) == []


def test_render_parse_round_trip_values():
    text = promtext.render(*(RENDER_CASES["sample"][0](metrics_mod),),
                           extra_gauges={"process_uptime_seconds": 1.5},
                           info={"tool": "kafka-assignment-generator"})
    fams = promtext.parse(text)
    [(_, labels, value)] = fams["ka_build_info"]["samples"]
    assert value == 1 and labels["tool"] == "kafka-assignment-generator"
    counters = {tuple(sorted(lb.items())): v
                for _, lb, v in fams["ka_daemon_requests_total"]["samples"]}
    assert counters == {(("cluster", "west"),): 4, (): 1}
    buckets = {lb["le"]: v for name, lb, v in fams["ka_daemon_http_request_ms"]["samples"]
               if name.endswith("_bucket")}
    assert buckets == {"1": 1, "10": 2, "+Inf": 3}
    assert promtext.render({"counters": {}, "gauges": {}, "hists": {}}) == "\n"
    got = {lb["cluster"]: v for _, lb, v in promtext.parse(
        promtext.render(_escapes(metrics_mod)))["ka_daemon_requests_total"]["samples"]}
    assert got["a\\nb"] == 1.0 and got["line1\nline2\\"] == 3.0


PARSE_CASES = {
    "untyped": "ka_undeclared_total 3\n",
    "bad-value": "# TYPE ka_x counter\nka_x not-a-number\n",
    "bad-type": "# TYPE ka_x wat\n",
    "dropped-comma": '# TYPE ka_x counter\nka_x{a="1"b="2"} 1\n',
    "junk-between": '# TYPE ka_x counter\nka_x{a="1" !! b="2"} 1\n',
    "trailing-comma": '# TYPE ka_x counter\nka_x{a="1",} 1\n',
    "missing-le": ("# TYPE ka_h histogram\n" 'ka_h_bucket{cluster="a"} 5\n'
                   'ka_h_bucket{cluster="a",le="+Inf"} 5\n'
                   'ka_h_sum{cluster="a"} 1.0\nka_h_count{cluster="a"} 5\n'),
    "inconsistent": ("# TYPE ka_h histogram\n" 'ka_h_bucket{le="1"} 5\n'
                     'ka_h_bucket{le="10"} 3\n' 'ka_h_bucket{le="+Inf"} 9\n'
                     "ka_h_sum 1.0\nka_h_count 8\n"),
    "no-inf-bucket": ("# TYPE ka_h histogram\n" 'ka_h_bucket{le="1"} 2\n'
                      "ka_h_sum 1.0\nka_h_count 2\n"),
    "zero-count-with-sum": ("# TYPE ka_h histogram\n" 'ka_h_bucket{le="+Inf"} 0\n'
                            "ka_h_sum 3.0\nka_h_count 0\n"),
    "infinities": "# TYPE ka_g gauge\nka_g +Inf\nka_g{a=\"b\"} -Inf\n",
}


def _parse_outcome(mod, text):
    try:
        fams = mod.parse(text)
    except mod.PromParseError as e:
        return ("error", str(e))
    checks = {f: mod.check_histogram(v) for f, v in fams.items()
              if v["type"] == "histogram"}
    return ("ok", fams, checks)


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_and_check_histogram_match_the_reference(case):
    text = PARSE_CASES[case]
    got = _parse_outcome(promtext, text)
    assert got == _parse_outcome(jax_promtext, text)
    if case in ("untyped", "bad-value", "bad-type", "dropped-comma", "junk-between"):
        assert got[0] == "error"
    if case == "missing-le":
        assert any("le label" in p for p in got[2]["ka_h"])
    if case == "inconsistent":
        assert any("monotone" in p for p in got[2]["ka_h"])
        assert any("_count" in p for p in got[2]["ka_h"])
    if case == "infinities":
        assert [v for _, _, v in got[1]["ka_g"]["samples"]] == [math.inf, -math.inf]


def test_cumulative_splits_the_cluster_label_as_the_reference():
    snaps = []
    for mod in (metrics_mod, jax_metrics):
        cum = mod.CumulativeMetrics(hist_edges=(1.0, 10.0))
        for name, n in (("daemon.requests@west", 2), ("daemon.requests@west", 1),
                        ("daemon.requests@east", 1), ("daemon.requests", 1)):
            cum.counter_add(name, n)
        for v in (0.5, 5.0, 50.0):
            cum.hist_observe("daemon.http.request_ms", v,
                             labels={"endpoint": "plan", "cluster": "a"})
        assert cum.counter_value("daemon.requests", labels={"cluster": "west"}) == 3
        snaps.append(cum.snapshot())
    assert snaps[0] == snaps[1]


# --- the daemon's telemetry -------------------------------------------------------------


def test_request_id_correlation_end_to_end(server):
    spec = f"127.0.0.1:{server.port}"
    with daemon(spec) as d:
        port = d.http_port
        s, body, headers = req(port, "POST", "/plan", {})
        rid = body["result"]["request_id"]
        assert s == 200 and rid and headers.get("X-Request-Id") == rid
        assert {sp["request_id"] for sp in body["spans"]} == {rid}
        for sent, kept in (("client-rid-7", True), ("evil\tid", False), ("x" * 129, False)):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/plan", body="{}", headers={"X-Request-Id": sent})
            resp = conn.getresponse()
            got = json.loads(resp.read())
            conn.close()
            assert (got["result"]["request_id"] == sent) is kept
            assert resp.getheader("X-Request-Id") == got["result"]["request_id"]
        s, _, h = req(port, "GET", "/healthz")
        assert s == 200 and h.get("X-Request-Id")
        assert "cluster" not in body["result"]


def test_metrics_endpoint_serves_a_valid_exposition(server):
    with daemon(f"127.0.0.1:{server.port}") as d:
        port = d.http_port
        assert req(port, "POST", "/plan", {})[0] == 200
        key = (("cluster", "default"), ("endpoint", "plan"))
        assert _await(lambda: key in metrics_mod.cumulative().snapshot()["hists"].get(
            "daemon.http.request_ms", {}))
        status, headers, text = scrape(port)
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        fams = promtext.parse(text)
        assert {"ka_build_info", "ka_process_start_time_seconds", "ka_daemon_requests_total",
                "ka_health_score", "ka_traffic_in_bytes", "ka_daemon_clusters",
                "ka_flight_events_recorded"} <= set(fams)
        for fam, data in fams.items():
            if data["type"] == "histogram":
                assert promtext.check_histogram(data) == [], fam
        assert any(lb.get("endpoint") == "plan" and lb.get("cluster") == "default"
                   for _, lb, _ in fams["ka_daemon_http_request_ms"]["samples"])
        [(_, info, _)] = fams["ka_build_info"]["samples"]
        assert info["mode"] == "single"
        # One cluster: the health gauges carry no label.
        assert fams["ka_health_score"]["samples"][0][1] == {}


def test_debug_flight_whole_and_per_cluster(server, tmp_path):
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    d = AssignerDaemon(clusters={"a": f"127.0.0.1:{server.port}", "b": str(snap)},
                       solver="greedy", device="cpu", err=io.StringIO())
    d.start()
    try:
        port = d.http_port
        s, body, _ = req(port, "POST", "/clusters/a/plan", {})
        rid = body["result"]["request_id"]
        assert _await(lambda: any(e["kind"] == "request" and e.get("request_id") == rid
                                  for e in flight.recorder().snapshot()))
        s, whole, _ = req(port, "GET", "/debug/flight")
        kinds = {e["kind"] for e in whole["events"]}
        assert s == 200 and {"daemon", "lifecycle", "resync", "request"} <= kinds
        assert whole["dropped"] == 0
        for path in ("/clusters/b/debug/flight", "/debug/flight?cluster=b"):
            s, per, _ = req(port, "GET", path)
            assert s == 200 and per["events"]
            assert all(e.get("cluster", "b") == "b" for e in per["events"])
            assert not any(e.get("request_id") == rid for e in per["events"])
    finally:
        d.shutdown()


def test_stderr_summary_is_opt_in_and_one_access_line_a_request(server, monkeypatch):
    err = io.StringIO()
    with daemon(f"127.0.0.1:{server.port}", err=err) as d:
        assert req(d.http_port, "POST", "/plan", {})[0] == 200

        def plan_lines():
            return [ln for ln in err.getvalue().splitlines()
                    if ln.startswith("{") and '"path": "/plan"' in ln]

        assert _await(lambda: plan_lines())
        assert len(plan_lines()) == 1 and "obs: run" not in err.getvalue()
        line = json.loads(plan_lines()[0])
        assert set(line) == {"ts", "request_id", "method", "path", "cluster", "code",
                             "status", "ms", "inflight", "stale", "degraded"}
        assert (line["code"], line["status"], line["cluster"]) == (200, "ok", "default")
        monkeypatch.setenv("KA_OBS_REPORT", "/dev/null")
        assert req(d.http_port, "POST", "/plan", {})[0] == 200
        assert "obs: run" in err.getvalue()


def test_debug_profile_endpoint(server, monkeypatch, tmp_path):
    with daemon(f"127.0.0.1:{server.port}") as d:
        port = d.http_port
        s, body, _ = req(port, "GET", "/debug/profile?seconds=0.05")
        assert s == 400 and "KA_OBS_PROFILE_DIR" in body["error"]
        monkeypatch.setenv("KA_OBS_PROFILE_DIR", str(tmp_path))
        s, body, _ = req(port, "GET", "/debug/profile?seconds=0.05")
        assert s == 200 and body["artifact_dir"] == str(tmp_path)
        assert list(tmp_path.iterdir())
        assert req(port, "GET", "/debug/profile?seconds=wat")[0] == 400


def test_scrape_raced_against_the_drain(server):
    """``/metrics`` scraped while another thread drains: every answered
    scrape is a whole, parseable exposition."""
    d = AssignerDaemon(f"127.0.0.1:{server.port}", solver="greedy", device="cpu",
                       err=io.StringIO())
    d.start()
    port = d.http_port
    assert req(port, "POST", "/plan", {})[0] == 200
    results = {"scrapes": 0, "torn": []}
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                status, _, text = scrape(port)
            except OSError:
                break
            if status != 200:
                continue
            try:
                for fam, data in promtext.parse(text).items():
                    if data["type"] == "histogram":
                        assert promtext.check_histogram(data) == [], fam
            except (promtext.PromParseError, AssertionError) as e:
                results["torn"].append(str(e))
                break
            results["scrapes"] += 1

    threads = [threading.Thread(target=scraper) for _ in range(3)]
    for t in threads:
        t.start()
    assert _await(lambda: results["scrapes"] >= 3, timeout=10)
    d.shutdown()
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert results["torn"] == [] and results["scrapes"] >= 3


# --- --clusters and the process ------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "a=127.0.0.1:2181,127.0.0.2:2181/kafka;b=file:///tmp/b.json",
    " a = x:1 ; ; b=y:2 ",
    "a=x:1#controller=off",
    "a=x:1;a=y:2",
    "a",
    "",
])
def test_clusters_spec_parses_as_the_references(spec):
    outcomes = []
    for parse in (cli.parse_clusters_spec, jax_parse_clusters):
        try:
            outcomes.append(parse(spec))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_clusters_spec_file_parses_as_the_references(tmp_path):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"a": "x:1", "b": {"connect": "y:2", "controller": "off"}}))
    assert cli.parse_clusters_spec(str(path)) == jax_parse_clusters(str(path)) \
        == {"a": "x:1", "b": {"connect": "y:2", "controller": "off"}}


@pytest.mark.parametrize("spec,ok", [
    ({"a": "FILE#controller=off"}, True),
    ({"a": {"connect": "FILE", "controller": "off"}}, True),
    ({"a": "FILE#controller=auto"}, True),
    ({"a": "FILE#controller=observe"}, True),
    ({"a": {"connect": "FILE", "controller": "auto"}}, True),
    ({"a": "FILE#controller=bogus"}, False),
    ({"bad name": "FILE"}, False),
    ({"a": {"connect": "FILE", "extra": 1}}, False),
])
def test_a_controller_policy_is_refused_at_startup(tmp_path, monkeypatch, spec, ok):
    """A cluster's controller policy at startup, in both packages: ``off``,
    ``observe`` and ``auto`` start with that policy in the cluster's
    ``/state``; an unknown policy, a bad cluster name and an unknown spec key
    are refused before anything starts, with the reference's message."""
    monkeypatch.setenv("KA_CONTROLLER_INTERVAL", "3600")
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    clusters = json.loads(json.dumps(spec).replace("FILE", str(snap)))
    seen = {}
    for pkg, daemon_cls, kw in (("torch", AssignerDaemon, {"device": "cpu"}),
                                ("jax", JaxDaemon, {})):
        if not ok:
            with pytest.raises(ValueError) as info:
                daemon_cls(clusters=clusters, solver="greedy", **kw)
            seen[pkg] = str(info.value)
            continue
        with contextlib.closing(io.StringIO()) as err:
            d = daemon_cls(clusters=clusters, solver="greedy", err=err, **kw)
            d.start()
            try:
                _, state, _ = req(d.http_port, "GET", "/clusters/a/state")
                seen[pkg] = state["controller"]
            finally:
                d.shutdown()
    assert seen["torch"] == seen["jax"]
    if ok:
        policy = json.dumps(spec).split("controller")[-1].strip('":= }')
        assert seen["torch"] == {"policy": policy, "paused": False,
                                 "breaker": {"state": "closed"}}
    elif "bogus" in json.dumps(spec):
        assert seen["torch"] == ("unknown controller policy 'bogus' (expected one "
                                 "of ['off', 'observe', 'auto'])")


def test_the_cli_refuses_a_controller_and_a_double_spec(tmp_path, capsys):
    """``ka-daemon --clusters 'a=...#controller=bogus'`` exits with the
    validation code and the reference's message, as the reference's CLI
    does; a double spec and a malformed one are usage errors."""
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    from kafka_assigner_tpu import cli as jax_cli_mod

    errs = []
    for main, extra in ((cli.daemon_main, ["--device", "cpu"]),
                        (jax_cli_mod.daemon_main, ["--solver", "greedy"])):
        with pytest.raises(SystemExit) as code:
            sys_argv = ["ka-daemon", "--clusters", f"a={snap}#controller=bogus", *extra]
            with _argv(sys_argv):
                main()
        assert code.value.code == cli.EXIT_VALIDATION
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "unknown controller policy 'bogus'" in errs[0]
    assert cli.run_daemon(["--zk_string", str(snap), "--clusters", f"a={snap}",
                           "--device", "cpu"]) == cli.EXIT_USAGE
    assert cli.run_daemon(["--clusters", "nonsense", "--device", "cpu"]) == cli.EXIT_USAGE


@contextlib.contextmanager
def _argv(argv):
    old = sys.argv
    sys.argv = argv
    try:
        yield
    finally:
        sys.argv = old


def test_daemon_process_for_two_clusters_logs_and_dumps(server, tmp_path):
    """``python -m kafka_assigner_tpu_torch.daemon --clusters 'a=...;b=...'
    --device cpu --access-log PATH``: the banner names the clusters, each
    cluster's plan is its CLI's, one access-log line a request in the file,
    SIGTERM drains to exit 0 and the flight ring lands in
    ``KA_OBS_FLIGHT_DUMP``."""
    snap = tmp_path / "b.json"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    spec_a = f"127.0.0.1:{server.port}"
    base_a = port_cli(spec_a, "--solver", "greedy")
    base_b = port_cli(str(snap), "--solver", "greedy", "--broker_hosts_to_remove", "h9")
    log, dump = tmp_path / "access.log", tmp_path / "flight.ndjson"
    env = dict(os.environ, PYTHONPATH=str(ROOT), KA_OBS_FLIGHT_DUMP=str(dump))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.daemon", "--clusters",
         f"a={spec_a};b={snap}", "--solver", "greedy", "--device", "cpu",
         "--access-log", str(log)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
        reader.start()
        assert _await(lambda: any("listening on http://" in ln for ln in lines), timeout=60)
        banner = next(ln for ln in lines if "listening on http://" in ln)
        assert banner.rstrip().endswith("(solver=greedy, clusters=a,b)")
        port = int(banner.split("http://127.0.0.1:")[1].split()[0])
        s, body, _ = req(port, "POST", "/clusters/a/plan", {})
        assert s == 200 and body["result"]["stdout"] == base_a
        s, body, _ = req(port, "POST", "/clusters/b/plan", {"broker_hosts_to_remove": "h9"})
        assert s == 200 and body["result"]["stdout"] == base_b
        assert req(port, "POST", "/plan", {})[0] == 400
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        reader.join(5)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert any("drained; exiting 0" in ln for ln in lines)
    logged = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [(x["path"], x["code"]) for x in logged] == [
        ("/clusters/a/plan", 200), ("/clusters/b/plan", 200), ("/plan", 400)]
    events = [json.loads(ln) for ln in dump.read_text().splitlines()]
    assert (events[0]["kind"], events[0]["event"]) == ("daemon", "start")
    assert (events[-1]["kind"], events[-1]["event"]) == ("daemon", "stopped")
    assert sum(e["kind"] == "request" for e in events) == 3


def test_a_cuda_daemon_of_many_clusters_needs_a_card(tmp_path):
    """Without a card the default ``--device cuda`` refuses to start."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    with pytest.raises(RuntimeError):
        AssignerDaemon(clusters={"a": str(snap)}, solver="device")
    assert metrics_mod.cumulative() is None and flight.recorder() is None
    t0 = time.monotonic()
    assert cli.run_daemon(["--clusters", f"a={snap}"]) == cli.EXIT_USAGE
    assert time.monotonic() - t0 < 30


def test_the_reference_daemon_serves_the_same_exposition_families(server):
    """The port's scrape after one plan has the reference's families, the
    fleet's among them, less the program store's own."""
    fams = {}
    for pkg in ("torch", "jax"):
        cls, kw = (AssignerDaemon, {"device": "cpu"}) if pkg == "torch" else (JaxDaemon, {})
        d = cls(f"127.0.0.1:{server.port}", solver="greedy", err=io.StringIO(), **kw)
        d.start()
        try:
            assert req(d.http_port, "POST", "/plan", {})[0] == 200
            mod = metrics_mod if pkg == "torch" else jax_metrics
            assert _await(lambda mod=mod: sum(mod.cumulative().snapshot()["counters"].get(
                "daemon.http.requests", {}).values()) >= 1)
            fams[pkg] = set(promtext.parse(scrape(d.http_port)[2]))
        finally:
            d.shutdown()
    own = ("ka_compile_store_",)
    assert {f for f in fams["torch"] if not f.startswith(own)} == \
        {f for f in fams["jax"] if not f.startswith(own)}
