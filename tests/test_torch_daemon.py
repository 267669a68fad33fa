"""The port's resident daemon for one cluster (``kafka_assigner_tpu_torch.
daemon``) against the JAX package's (``kafka_assigner_tpu.daemon`` under
``KA_DISPATCH=0``, its single-cluster lock regime), on the CPU, over the
in-repo jute server (``tests/jute_server.py``, real TCP) and the snapshot
backend.

The cases of ``tests/test_daemon.py:184-541`` run on the port's daemon with
``device="cpu"``. On every path a served ``result.stdout`` equals a fresh
port CLI run, the reference daemon's (its ``tpu`` lane against the port's
``device``; ``native`` and ``greedy`` alike) and the reference CLI's: the
endpoints, the parameters that mirror the CLI's flags, the cached
preencode and its bypass, 400 and never 500, ``/whatif`` against the
ranking, backpressure, the watchdog, the drain, churn and the churn race,
session loss, interval-only resyncs, canonical topic order. One scripted
sequence gives the reference's ``daemon.*`` counters and lifecycle; the four
daemon fault seams under both failure policies give the reference's bytes,
or its explicit ``degraded``; ``/state`` has the reference's keys less those
of later slices. Plans are compared byte for byte.

Every wait has its own bound; retry and resync intervals are short.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.daemon import CircuitBreaker as JaxBreaker
from kafka_assigner_tpu.daemon import DaemonState as JaxState
from kafka_assigner_tpu.io.base import BrokerInfo as JaxBroker
from kafka_assigner_tpu.utils import env as jax_env
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch import generator
from kafka_assigner_tpu_torch.daemon import (
    AssignerDaemon,
    CacheBackend,
    CircuitBreaker,
    DaemonState,
)
from kafka_assigner_tpu_torch.io.base import BrokerInfo
from kafka_assigner_tpu_torch.io.zkwire import MiniZkClient
from kafka_assigner_tpu_torch.obs.report import validate_report
from kafka_assigner_tpu_torch.utils import env as torch_env

from .jute_server import JuteZkServer, cluster_tree, exec_snapshot_cluster

ROOT = Path(__file__).resolve().parent.parent
#: The reference's name for each port solver lane.
JAX_LANE = {"device": "tpu", "native": "native", "greedy": "greedy"}
DAEMON_KNOBS = (
    "KA_DAEMON_BIND", "KA_DAEMON_PORT", "KA_DAEMON_MAX_INFLIGHT",
    "KA_DAEMON_REQUEST_TIMEOUT", "KA_DAEMON_RESYNC_INTERVAL",
    "KA_DAEMON_RESYNC_RETRIES", "KA_DAEMON_DRAIN_TIMEOUT",
    "KA_DAEMON_BREAKER_THRESHOLD", "KA_DAEMON_BREAKER_COOLDOWN", "KA_DAEMON_WATCH",
)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for knob in DAEMON_KNOBS + ("KA_FAULTS_SPEC", "KA_FAILURE_POLICY", "KA_OBS_REPORT",
                                "KA_OBS_ENABLE", "KA_ZK_PIPELINE", "KA_HOSTCODEC"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.5")
    # The reference daemon's single-cluster lock regime, and its journal
    # scan kept out of the working tree.
    monkeypatch.setenv("KA_DISPATCH", "0")
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(tmp_path))
    jax_faults.reset()
    torch_faults.reset()
    yield
    jax_faults.reset()
    torch_faults.reset()


@pytest.fixture()
def server():
    s = JuteZkServer(cluster_tree())
    s.start()
    yield s
    s.shutdown()


def zk(server) -> str:
    return f"127.0.0.1:{server.port}"


@contextlib.contextmanager
def running(pkg, spec, solver="greedy", **kw):
    """A started daemon of ``pkg`` ("torch" on the CPU, or "jax"), shut down
    on exit."""
    if pkg == "torch":
        d = AssignerDaemon(spec, solver=solver, device="cpu", **kw)
    else:
        d = JaxDaemon(spec, solver=JAX_LANE[solver], **kw)
    d.start()
    try:
        yield d
    finally:
        d.shutdown()


def port_cli(spec, *argv, mode="PRINT_REASSIGNMENT"):
    """A fresh in-process port CLI run: the byte-identity oracle."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(["--zk_string", spec, "--mode", mode, *argv, "--device", "cpu"])
    assert rc == 0, err.getvalue()
    return out.getvalue()


def jax_cli(spec, *argv, mode="PRINT_REASSIGNMENT"):
    argv = [JAX_LANE.get(a, a) for a in argv]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jax_run(["--zk_string", spec, "--mode", mode, *argv])
    assert rc == 0, err.getvalue()
    return out.getvalue()


def both_clis(spec, *argv, mode="PRINT_REASSIGNMENT"):
    """The port CLI's stdout, held equal to the reference CLI's."""
    text = port_cli(spec, *argv, mode=mode)
    assert jax_cli(spec, *argv, mode=mode) == text
    return text


def req(port, method, path, payload=None, timeout=30.0, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = raw if raw is not None else (None if payload is None else json.dumps(payload))
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, dict(resp.getheaders())
    finally:
        conn.close()


def plan(d, payload=None, path="/plan"):
    status, body, _ = req(d.http_port, "POST", path, payload or {})
    assert status == 200, body
    return body


def _await(predicate, timeout=10.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


# --- the resident state ----------------------------------------------------------


def _states():
    out = []
    for state_cls, broker_cls in ((DaemonState, BrokerInfo), (JaxState, JaxBroker)):
        st = state_cls()
        st.reset([broker_cls(id=i, host=f"h{i}", port=9092, rack=f"r{i % 2}")
                  for i in range(1, 5)],
                 {"events": {0: [1, 2], 1: [2, 3]}, "logs": {0: [3, 4]}})
        out.append(st)
    return out


def test_cache_backend_serves_metadata():
    st, _ = _states()
    be = CacheBackend(st)
    assert [b.id for b in be.brokers()] == [1, 2, 3, 4]
    assert be.all_topics() == ["events", "logs"]
    assert be.partition_assignment(["logs"]) == {"logs": {0: [3, 4]}}
    assert list(be.fetch_topics(["logs", "ghost"], missing="skip")) == [
        ("logs", {0: [3, 4]}), ("ghost", None)]
    with pytest.raises(KeyError):
        be.partition_assignment(["ghost"])


def test_state_delta_and_plan_inputs_match_the_reference():
    port, ref = _states()
    for st in (port, ref):
        v0 = st.version
        assert st.apply_topic("fresh", {0: [1, 2, 3]})
        assert st.version == v0 + 1
    (initial, pre), (initial_j, pre_j) = (
        st.plan_inputs(["events", "fresh"], want_encode=True) for st in (port, ref))
    assert initial == initial_j and initial["fresh"] == {0: [1, 2, 3]}
    assert [e.topic for e in pre[0]] == [e.topic for e in pre_j[0]] == ["events", "fresh"]
    for x, y in zip(pre[1:], pre_j[1:]):
        assert x.tobytes() == y.tobytes()
    assert port.encode_shape() == ref.encode_shape()
    for st in (port, ref):
        assert not st.apply_topic("fresh", None)
        with pytest.raises(KeyError):
            st.plan_inputs(["fresh"], want_encode=False)
    assert port.encode_shape() == ref.encode_shape() == (8, 2)


def test_circuit_breaker_transitions_match_the_reference(monkeypatch):
    """Threshold, open, the cooldown's half-open probe, a failed probe
    re-opening, a success closing: the reference's transitions and
    snapshots (jitter pinned)."""
    from kafka_assigner_tpu.utils import backoff as jax_backoff
    from kafka_assigner_tpu_torch.utils import backoff as torch_backoff

    for mod in (jax_backoff, torch_backoff):
        monkeypatch.setattr(mod.random, "random", lambda: 0.5)
    trails = []
    for cls in (CircuitBreaker, JaxBreaker):
        b = cls(2, 0.05, cap=1.0)
        trail = [b.record_failure(), b.snapshot()["state"], b.record_failure(),
                 b.snapshot()["state"], b.allow_attempt()]
        time.sleep(0.08)
        trail += [b.allow_attempt(), b.state, b.record_failure(), b.state,
                  b.allow_attempt()]
        time.sleep(0.15)
        trail += [b.allow_attempt(), b.record_success(), b.snapshot()]
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][:5] == [False, "closed", True, "open", False]


def test_knobs_match_the_reference():
    for name in DAEMON_KNOBS:
        ref = jax_env.KNOBS[name]
        assert (torch_env.KNOBS[name].default, torch_env.KNOBS[name].floor) == (
            ref.default, ref.floor), name


# --- the HTTP surface -----------------------------------------------------------------


def test_endpoints_and_plan_byte_identity(server):
    base = both_clis(zk(server), "--solver", "greedy")
    with running("torch", zk(server)) as d:
        port = d.http_port
        s, health, _ = req(port, "GET", "/healthz")
        assert s == 200 and health == {"status": "ready", "stale": False}
        s, ready, _ = req(port, "GET", "/readyz")
        assert s == 200 and ready == {"ready": True, "status": "ready"}
        body = plan(d)
        assert body["status"] == "ok" and body["result"]["stdout"] == base
        assert body["mode"] == "DAEMON_PLAN"
        assert validate_report(body) == []
        assert any(sp["name"] == "daemon/request" for sp in body["spans"])
        s, view, _ = req(port, "GET", "/state")
        assert s == 200 and view["lifecycle"] == "ready"
        assert view["topics"] == 2 and view["brokers"] == 4 and view["watches"] is True
        # The controller's paths answer under the default `off` policy; an
        # unknown path is a 404.
        s, ctl, _ = req(port, "GET", "/controller")
        assert s == 200 and ctl["policy"] == "off" and ctl["decisions"] == []
        s, bad, _ = req(port, "POST", "/controller", {})
        assert s == 400 and "unknown controller action None" in bad["error"]
        for method, path in (("GET", "/nope"), ("POST", "/nope")):
            s, nf, _ = req(port, method, path, {} if method == "POST" else None)
            assert s == 404 and nf == {"error": f"unknown path {path!r}"}, path


def test_state_keys_are_the_references_less_later_slices(server, monkeypatch):
    # Both daemons must read their first sync's cache_version: with the
    # fixture's 0.5 s resync interval a loaded host can let one daemon
    # resync (and bump its version) before /state and not the other.
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "3600")
    views = {}
    for pkg in ("torch", "jax"):
        with running(pkg, zk(server), solver="device") as d:
            _, views[pkg], _ = req(d.http_port, "GET", "/state")
            _, health, _ = req(d.http_port, "GET", "/healthz")
            assert health == {"status": "ready", "stale": False}
    assert set(views["torch"]) == set(views["jax"])
    for key in ("lifecycle", "stale", "cache_version", "brokers", "topics",
                "encode_shape", "watches", "failure_policy", "cluster", "breaker",
                "controller"):
        assert views["torch"][key] == views["jax"][key], key
    assert (views["torch"]["solver"], views["jax"]["solver"]) == ("device", "tpu")


PARAM_CASES = [
    ({"broker_hosts_to_remove": "h4", "topics": ["events"]},
     ["--broker_hosts_to_remove", "h4", "--topics", "events"]),
    ({"integer_broker_ids": "1,2,3"}, ["--integer_broker_ids", "1,2,3"]),
    ({"broker_hosts": "h1,h2,h3"}, ["--broker_hosts", "h1,h2,h3"]),
    ({"desired_replication_factor": 2, "topics": ["logs"]},
     ["--desired_replication_factor", "2", "--topics", "logs"]),
    ({"disable_rack_awareness": True}, ["--disable_rack_awareness"]),
    ({"topics": ["logs", "events"]}, ["--topics", "logs,events"]),
]


def test_plan_params_mirror_cli_flags(server):
    with running("torch", zk(server)) as d, running("jax", zk(server)) as j:
        for payload, argv in PARAM_CASES:
            base = both_clis(zk(server), "--solver", "greedy", *argv)
            got = plan(d, payload)
            assert got["status"] == "ok" and got["result"]["stdout"] == base, payload
            assert plan(j, payload)["result"]["stdout"] == base, payload
        # A query parameter merges under the body, booleans both ways.
        base = port_cli(zk(server), "--solver", "greedy", "--disable_rack_awareness")
        assert plan(d, path="/plan?disable_rack_awareness=1")["result"]["stdout"] == base
        assert plan(d, path="/plan?disable_rack_awareness=0")["result"]["stdout"] \
            == port_cli(zk(server), "--solver", "greedy")


@pytest.mark.parametrize("lane", ["device", "native", "greedy"])
def test_plan_lanes_match_the_reference_daemon(server, lane):
    """Each lane through both daemons, whole-cluster and narrowed: the
    device lane takes the cache's merged preencode for a whole-cluster
    request and encodes for itself when the request narrows the brokers or
    drops the racks; the bytes are the CLIs' either way."""
    requests = [({}, []), ({"broker_hosts_to_remove": "h4"}, ["--broker_hosts_to_remove", "h4"]),
                ({"disable_rack_awareness": True}, ["--disable_rack_awareness"])]
    bases = [both_clis(zk(server), "--solver", lane, *argv) for _, argv in requests]
    with running("torch", zk(server), solver=lane) as d:
        if lane == "device":
            assert _await(lambda: d.counters().get("daemon.warmups", 0)
                          + d.counters().get("daemon.warmup_failures", 0) >= 1, timeout=30)
            assert not d.counters().get("daemon.warmup_failures")
        takes = []
        for (payload, _), base in zip(requests, bases):
            body = plan(d, payload)
            assert body["status"] == "ok" and body["result"]["stdout"] == base, payload
            takes.append(generator.last_ingest.get("solve_encode"))
        if lane == "device":
            assert takes[0] == "preencoded" and "preencoded" not in takes[1:], takes
    with running("jax", zk(server), solver=lane) as j:
        for (payload, _), base in zip(requests, bases):
            assert plan(j, payload)["result"]["stdout"] == base, payload


def test_bad_requests_are_400_never_500(server):
    bad = [{"topics": ["ghost"]}, {"topics": "not-a-list"},
           {"desired_replication_factor": "three"}, {"broker_hosts": "unknown-host"},
           {"solver": "bogus"}, {"integer_broker_ids": "x"}]
    codes = {}
    for pkg in ("torch", "jax"):
        with running(pkg, zk(server)) as d:
            port = d.http_port
            got = []
            for payload in bad:
                s, body, _ = req(port, "POST", "/plan", payload)
                got.append((s, body.get("status")))
                if payload == bad[0]:
                    assert "ghost" in body["error"]["message"]
            s, body, _ = req(port, "POST", "/plan", {"desired_replication_factor": None})
            got.append((s, body["status"]))
            for raw in ("{nope", "[1, 2]"):
                s, body, _ = req(port, "POST", "/plan", raw=raw)
                got.append((s, sorted(body)))
            s, _, _ = req(port, "GET", "/readyz")
            got.append(s)
            codes[pkg] = got
    assert codes["torch"] == codes["jax"]
    assert all(c[0] == 400 for c in codes["torch"][:len(bad)])
    assert codes["torch"][len(bad)] == (200, "ok") and codes["torch"][-1] == 200


def test_whatif_matches_cli_ranking(server, tmp_path):
    ranking = both_clis(zk(server), mode="RANK_DECOMMISSION")
    scen = tmp_path / "s.json"
    scen.write_text(json.dumps([[1], ["h3", "h4"]]))
    scenario_ranking = both_clis(zk(server), "--scenario_file", str(scen),
                                 mode="RANK_DECOMMISSION")
    for pkg in ("torch", "jax"):
        with running(pkg, zk(server)) as d:
            body = plan(d, path="/whatif")
            assert body["status"] == "ok" and body["result"]["stdout"] == ranking
            body = plan(d, {"scenarios": [[1], ["h3", "h4"]]}, path="/whatif")
            assert body["result"]["stdout"] == scenario_ranking
            assert "DECOMMISSION RANKING:" in scenario_ranking


def test_backpressure_sheds_with_retry_after(server, monkeypatch):
    """The inflight gate is live: KA_DAEMON_MAX_INFLIGHT is read per
    request; an admitted request gives the CLIs' bytes."""
    base = both_clis(zk(server), "--solver", "greedy")
    with running("torch", zk(server)) as d:
        sup = d.supervisor()
        monkeypatch.setenv("KA_DAEMON_MAX_INFLIGHT", "1")
        with sup._active_lock:
            sup._active += 1
        try:
            s, body, headers = req(d.http_port, "POST", "/plan", {})
            assert s == 503 and body == {"error": "overloaded", "max_inflight": 1}
            assert headers.get("Retry-After") == "1"
            assert d.counters().get("daemon.requests_shed") == 1
            monkeypatch.setenv("KA_DAEMON_MAX_INFLIGHT", "2")
            assert plan(d)["result"]["stdout"] == base
        finally:
            with sup._active_lock:
                sup._active -= 1
        assert plan(d)["result"]["stdout"] == base


def test_watchdog_flags_slow_requests(server):
    """A request over its budget is flagged, not failed, in both daemons."""
    base = both_clis(zk(server), "--solver", "greedy")
    for pkg in ("torch", "jax"):
        with running(pkg, zk(server)) as d:
            d.supervisor().request_timeout = 0.0
            body = plan(d)
            assert body["status"] == "ok" and body["result"]["stdout"] == base
            assert body["result"]["watchdog_exceeded"] is True
            assert d.counters().get("daemon.watchdog_exceeded") == 1


def test_drain_refuses_and_exits_clean(server):
    d = AssignerDaemon(zk(server), solver="greedy", device="cpu")
    d.start()
    port = d.http_port
    d.request_stop()
    s, body, headers = req(port, "GET", "/readyz")
    assert s == 503 and body == {"ready": False, "status": "draining"}
    assert headers.get("Retry-After") == "5"
    s, body, _ = req(port, "POST", "/plan", {})
    assert s == 503 and body["error"] == "draining"
    d.shutdown()
    assert d.lifecycle() == "stopped"
    assert getattr(d.supervisor().backend._zk, "_sock", None) is None
    assert d.httpd.socket.fileno() == -1


def test_drain_answers_the_request_in_flight(server):
    """A request admitted before the stop is answered in full before the
    daemon stops, while /readyz already answers 503."""
    base = both_clis(zk(server), "--solver", "greedy")
    d = AssignerDaemon(zk(server), solver="greedy", device="cpu")
    d.start()
    sup = d.supervisor()
    gate, entered = threading.Event(), threading.Event()
    run_plan = sup._run_plan

    def held(params, out):
        entered.set()
        assert gate.wait(10)
        return run_plan(params, out)

    sup._run_plan = held
    result = {}
    client = threading.Thread(
        target=lambda: result.update(r=req(d.http_port, "POST", "/plan", {})))
    client.start()
    assert entered.wait(10)
    stopper = threading.Thread(target=d.shutdown)
    d.request_stop()
    stopper.start()
    s, body, _ = req(d.http_port, "GET", "/readyz")
    assert s == 503 and body["status"] == "draining"
    gate.set()
    client.join(10)
    stopper.join(15)
    assert not stopper.is_alive() and d.lifecycle() == "stopped"
    s, body, _ = result["r"]
    assert s == 200 and body["result"]["stdout"] == base


# --- churn, sessions, resyncs ------------------------------------------------------


def test_churn_updates_cache_and_stays_cli_identical(server):
    """Create, reassign, delete, with both daemons watching one server: each
    cache follows by delta re-encodes, and each served plan equals the CLIs'
    on the new tree."""
    with running("torch", zk(server)) as d, running("jax", zk(server)) as j:
        sups = [d.supervisor(), j.supervisor()]
        w = MiniZkClient(zk(server))
        w.start()
        try:
            w.create("/brokers/topics/fresh",
                     b'{"partitions": {"0": [1, 2, 3], "1": [2, 3, 4]}}')
            assert _await(lambda: all("fresh" in s.state.topic_names() for s in sups))
            w.set_data("/brokers/topics/logs", b'{"partitions": {"0": [1, 2]}}')
            assert _await(lambda: all(s.state.assignments(["logs"])["logs"] == {0: [1, 2]}
                                      for s in sups))
            w.delete("/brokers/topics/events")
            assert _await(lambda: all("events" not in s.state.topic_names() for s in sups))
            assert d.counters().get("daemon.reencode.topics", 0) >= 2
            assert _await(lambda: not any(s.state.stale for s in sups))
            base = both_clis(zk(server), "--solver", "greedy")
            for daemon in (d, j):
                body = plan(daemon)
                assert body["status"] == "ok" and body["result"]["stdout"] == base
        finally:
            w.close()


def test_churn_race_mid_request_retries_to_fresh_truth(server):
    """A topic deleted between a request's topic listing and its cache read
    is retried once against the new state, never a client error; the
    reference does the same."""
    outs = []
    for pkg in ("torch", "jax"):
        with running(pkg, zk(server)) as d:
            sup = d.supervisor()
            orig = sup.state.plan_inputs
            fired = []

            def racy(topic_list, want_encode, sup=sup, orig=orig, fired=fired):
                if not fired:
                    fired.append(1)
                    sup.state.apply_topic("logs", None)  # the churn wins the race
                return orig(topic_list, want_encode)

            sup.state.plan_inputs = racy
            body = plan(d)
            outs.append(body["result"]["stdout"])
            assert d.counters().get("daemon.churn_retries") == 1
    assert outs[0] == outs[1]
    assert '"topic":"logs"' not in outs[0] and '"topic":"events"' in outs[0]


def test_session_loss_recovers_via_resync(server):
    base = both_clis(zk(server), "--solver", "greedy")
    with running("torch", zk(server)) as d:
        sup = d.supervisor()
        sup._expire_session()
        assert sup.state.stale
        assert _await(lambda: not sup.state.stale and d.counters().get("daemon.resyncs", 0) >= 2)
        assert d.counters().get("daemon.session_lost", 0) >= 1
        body = plan(d)
        assert body["status"] == "ok" and body["result"]["stdout"] == base


def test_watchless_interval_resync(server, monkeypatch):
    """KA_DAEMON_WATCH=0: the interval's full resyncs alone pick up a new
    topic, in both daemons on one server, with no delta re-encode."""
    monkeypatch.setenv("KA_DAEMON_WATCH", "0")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.2")
    with running("torch", zk(server)) as d, running("jax", zk(server)) as j:
        sups = [d.supervisor(), j.supervisor()]
        assert not any(s.uses_watches() for s in sups)
        w = MiniZkClient(zk(server))
        w.start()
        try:
            w.create("/brokers/topics/later", b'{"partitions": {"0": [1, 2]}}')
            assert _await(lambda: all("later" in s.state.topic_names() for s in sups))
            base = both_clis(zk(server), "--solver", "greedy")
            for daemon in (d, j):
                assert daemon.counters().get("daemon.reencode.topics") is None
                assert plan(daemon)["result"]["stdout"] == base
        finally:
            w.close()


def _snapshot(tmp_path, name, content):
    path = tmp_path / name
    path.write_text(json.dumps(content))
    return str(path)


def test_snapshot_backend_daemon(tmp_path):
    """A snapshot cluster is served too (watchless), on every lane."""
    snap = _snapshot(tmp_path, "cluster.json", exec_snapshot_cluster())
    for lane in ("greedy", "device"):
        base = both_clis(snap, "--solver", lane)
        for pkg in ("torch", "jax"):
            with running(pkg, snap, solver=lane) as d:
                assert not d.supervisor()._use_watches
                body = plan(d)
                assert body["status"] == "ok" and body["result"]["stdout"] == base


def test_snapshot_topic_order_canonical(tmp_path):
    """More than ten numerically named topics, listed in file order: the
    daemon's cache (sorted) and a fresh CLI run give the same bytes."""
    snap = _snapshot(tmp_path, "many.json", {
        "brokers": [{"id": i, "host": f"b{i}", "port": 9092, "rack": f"r{i % 2}"}
                    for i in range(4)],
        "topics": {f"t{t}": {str(p): [(t + p) % 4, (t + p + 1) % 4] for p in range(2)}
                   for t in range(12)},
    })
    base = both_clis(snap, "--solver", "greedy")
    for pkg in ("torch", "jax"):
        with running(pkg, snap) as d:
            body = plan(d)
            assert body["status"] == "ok" and body["result"]["stdout"] == base


# --- the reference's counters, lifecycle and fault seams ------------------------------


def test_counters_and_lifecycle_match_the_reference(monkeypatch):
    """One scripted sequence through each daemon, each on a fresh server:
    start, a plan, a 400, a ranking, a topic's reassignment (one delta
    re-encode), a broker joining (one full resync), a plan, the drain. The
    ``daemon.*`` counters and the lifecycle at each step are the
    reference's."""
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "60")
    seen = {}
    for pkg in ("torch", "jax"):
        server = JuteZkServer(cluster_tree())
        server.start()
        w = MiniZkClient(zk(server))
        w.start()
        try:
            cls = AssignerDaemon if pkg == "torch" else JaxDaemon
            kw = {"device": "cpu"} if pkg == "torch" else {}
            d = cls(zk(server), solver="greedy", **kw)
            trail = [d.lifecycle()]
            d.start()
            trail.append(d.lifecycle())
            outs = [plan(d)["result"]["stdout"]]
            trail.append(req(d.http_port, "POST", "/plan", {"topics": ["ghost"]})[0])
            outs.append(plan(d, path="/whatif")["result"]["stdout"])
            w.set_data("/brokers/topics/logs", b'{"partitions": {"0": [1, 2]}}')
            assert _await(lambda: d.counters().get("daemon.reencode.topics") == 1)
            w.create("/brokers/ids/5", b'{"host": "h5", "port": 9092, "rack": "rb"}')
            assert _await(lambda: d.counters().get("daemon.resyncs") == 2
                          and d.supervisor().state.version == 3)
            trail.append(d.lifecycle())
            outs.append(plan(d)["result"]["stdout"])
            d.request_stop()
            trail.append(d.lifecycle())
            d.shutdown()
            trail.append(d.lifecycle())
            seen[pkg] = (trail, d.counters(), outs)
        finally:
            w.close()
            server.shutdown()
    assert seen["torch"] == seen["jax"]
    trail, counters, _ = seen["torch"]
    assert trail == ["syncing", "ready", 400, "ready", "draining", "stopped"]
    assert counters["daemon.requests"] == 4 and counters["daemon.reencode.topics"] == 1


def _seam_run(pkg, seam, server_port):
    """The requests of one fault seam's scenario through one daemon; returns
    ``(statuses, stdouts, counters)``."""
    spec = f"127.0.0.1:{server_port}"
    lane = "device" if seam == "daemon:0=solver-crash" else "greedy"
    with running(pkg, spec, solver=lane) as d:
        sup = d.supervisor()
        bodies = []
        if seam == "watch:0=drop":
            w = MiniZkClient(spec)
            w.start()
            try:
                w.set_data("/brokers/topics/logs", b'{"partitions": {"0": [1, 2]}}')
            finally:
                w.close()
            assert _await(lambda: sup.state.assignments(["logs"])["logs"] == {0: [1, 2]})
            assert _await(lambda: not sup.state.stale)
            bodies.append(plan(d))
        elif seam == "session:0=expire":
            bodies.append(plan(d))  # served from the stale-marked cache
            assert _await(lambda: not sup.state.stale
                          and d.counters().get("daemon.resyncs", 0) >= 2)
            bodies.append(plan(d))
        else:
            bodies += [plan(d), plan(d)]
        counters = d.counters()
    statuses = [(b["status"], b["result"]["stale"]) for b in bodies]
    return statuses, [b["result"]["stdout"] for b in bodies], counters


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
@pytest.mark.parametrize("seam", ["watch:0=drop", "session:0=expire", "resync:0=stall",
                                  "daemon:0=solver-crash"])
def test_fault_seams_match_the_reference(monkeypatch, seam, policy):
    """Each daemon seam under each failure policy, each daemon on a fresh
    server: the plans are the CLIs' bytes on the tree the cache holds, and
    the status is ``ok``, or ``degraded`` exactly where the reference's is
    (a crashed solve re-run on the greedy lane; a request served from a
    stale cache)."""
    monkeypatch.setenv("KA_FAULTS_SPEC", seam)
    monkeypatch.setenv("KA_FAILURE_POLICY", policy)
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.3")
    runs, trees = {}, {}
    for pkg in ("torch", "jax"):
        jax_faults.reset()
        torch_faults.reset()
        server = JuteZkServer(cluster_tree())
        server.start()
        try:
            runs[pkg] = _seam_run(pkg, seam, server.port)
            monkeypatch.delenv("KA_FAULTS_SPEC")
            trees[pkg] = {lane: both_clis(zk(server), "--solver", lane)
                          for lane in ("greedy", "device")}
            monkeypatch.setenv("KA_FAULTS_SPEC", seam)
        finally:
            server.shutdown()
    (statuses, outs, counters), (statuses_j, outs_j, counters_j) = runs["torch"], runs["jax"]
    assert outs == outs_j and trees["torch"] == trees["jax"]
    scope = seam.split(":")[0]
    if scope == "daemon":
        # The crashed request re-runs on the greedy lane and says so.
        assert statuses == statuses_j == [("degraded", False), ("ok", False)]
        assert outs == [trees["torch"]["greedy"], trees["torch"]["device"]]
        assert counters["daemon.solve_fallbacks"] == counters_j["daemon.solve_fallbacks"] == 1
    elif scope == "session":
        # The first request may finish before or after the resync lands; a
        # stale answer says degraded, and its bytes are the same.
        for status, stale in statuses + statuses_j:
            assert status == ("degraded" if stale else "ok")
        assert statuses[1] == statuses_j[1] == ("ok", False)
        assert outs == [trees["torch"]["greedy"]] * 2
        assert counters["daemon.session_lost"] >= 1 and counters_j["daemon.session_lost"] >= 1
    else:
        assert statuses == statuses_j and all(s == ("ok", False) for s in statuses)
        assert set(outs) == {trees["torch"]["greedy"]}
        key = "daemon.watch_dropped" if scope == "watch" else "daemon.resync_failures"
        assert counters[key] == counters_j[key] == 1


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
def test_device_solve_crash_follows_the_failure_policy(monkeypatch, server, policy):
    """A crash inside the device solve (the ``solve`` seam, the stand-in for
    a kernel that fails to launch) follows the failure policy, as the CLI
    does: under strict a 500 ``error`` carrying the ``SolveError`` and no
    greedy re-run; under best-effort the solver's own greedy re-run,
    ``degraded``, with the reference daemon's status and bytes. The next
    request solves on the device lane. Under strict the reference daemon
    re-runs the request on the greedy lane instead (ROADMAP §3)."""
    monkeypatch.setenv("KA_FAILURE_POLICY", policy)
    trees = {lane: both_clis(zk(server), "--solver", lane) for lane in ("greedy", "device")}
    seen = {}
    for pkg in ("torch", "jax"):
        jax_faults.reset()
        torch_faults.reset()
        monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
        with running(pkg, zk(server), solver="device") as d:
            first = req(d.http_port, "POST", "/plan", {})[:2]
            second = plan(d)
            seen[pkg] = (first, second, d.counters())
        monkeypatch.delenv("KA_FAULTS_SPEC")
    (status, body), second, counters = seen["torch"]
    (status_j, body_j), second_j, counters_j = seen["jax"]
    for after in (second, second_j):
        assert after["status"] == "ok" and after["result"]["stdout"] == trees["device"]
    assert "daemon.solve_fallbacks" not in counters
    if policy == "strict":
        assert status == 500 and body["status"] == "error"
        # The current assignment is out before the solve, as in the CLI's
        # strict exit; no plan follows it.
        assert body["error"]["type"] == "SolveError"
        assert "NEW ASSIGNMENT" not in body["result"]["stdout"]
        assert (status_j, body_j["status"]) == (200, "degraded")
        assert body_j["result"]["stdout"] == trees["greedy"]
    else:
        assert status == status_j == 200
        assert body["status"] == body_j["status"] == "degraded"
        assert body["result"]["stdout"] == body_j["result"]["stdout"] == trees["greedy"]
        assert counters.get("daemon.requests_degraded") == 1


# --- the process ---------------------------------------------------------------------------


def _spawn_daemon(argv, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.daemon", *argv],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_daemon_process_serves_and_drains_on_sigterm(tmp_path):
    """``python -m kafka_assigner_tpu_torch.daemon``: the banner on stderr,
    a plan byte-identical to the CLI's, SIGTERM's drain and exit 0."""
    snap = _snapshot(tmp_path, "cluster.json", exec_snapshot_cluster())
    base = port_cli(snap, "--solver", "greedy")
    proc = _spawn_daemon(["--zk_string", snap, "--solver", "greedy", "--device", "cpu"])
    lines = []
    try:
        reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
        reader.start()
        assert _await(lambda: any("listening on http://" in ln for ln in lines), timeout=60)
        banner = next(ln for ln in lines if "listening on http://" in ln)
        assert banner.startswith("ka-daemon: listening on http://127.0.0.1:")
        assert banner.rstrip().endswith("(solver=greedy, watches=off)")
        port = int(banner.split("http://127.0.0.1:")[1].split()[0])
        s, body, _ = req(port, "POST", "/plan", {})
        assert s == 200 and body["status"] == "ok" and body["result"]["stdout"] == base
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        reader.join(5)
        assert any("drained; exiting 0" in ln for ln in lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
