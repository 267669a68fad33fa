"""The port's daemon for many clusters (``kafka_assigner_tpu_torch.daemon``
with ``clusters=``) against the JAX package's under ``KA_DISPATCH=0``, on
the CPU, over two ``tests/jute_server.py`` servers and snapshots.

Byte for byte against the reference daemon: ``/clusters/<name>/plan`` and
``/whatif`` stdout, the 400s and 404s of the routing, the ``/healthz``,
``/readyz`` and ``/state`` aggregates, ``/execute``'s NDJSON event stream
(less the journal path), its final snapshot and journal, a kill mid-run
resumed by the other package's offline ``ka-execute --resume``, the
``/recommendations`` and ``/groups/*`` envelopes, the ``/metrics`` counter
families and values after one request sequence, the access log's fields and
the flight recorder's event kinds in order; and the bulkhead (an expired and
stalled cluster ``a`` while ``b`` serves its bytes) in both packages.

Every wait has its own bound; resync intervals are short or long enough
that no resync lands inside a comparison.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import shutil
import threading
import time

import pytest
import torch

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import execute as jax_execute
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu.obs import promtext as jax_promtext
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.cli import execute as torch_execute
from kafka_assigner_tpu_torch.daemon import AssignerDaemon
from kafka_assigner_tpu_torch.obs import flight as torch_flight
from kafka_assigner_tpu_torch.obs import metrics as torch_metrics
from kafka_assigner_tpu_torch.obs import promtext
from kafka_assigner_tpu_torch.parallel import mesh as torch_mesh

from .jute_server import JuteZkServer, cluster_tree, exec_snapshot_cluster
from .test_torch_daemon import JAX_LANE, _await, both_clis, req

#: Knobs the daemon reads, unset around every test.
KNOBS = ("KA_FAULTS_SPEC", "KA_FAILURE_POLICY", "KA_OBS_REPORT", "KA_OBS_ENABLE",
         "KA_OBS_ACCESS_LOG", "KA_OBS_FLIGHT_DUMP", "KA_DAEMON_MAX_INFLIGHT",
         "KA_DAEMON_WATCH", "KA_DAEMON_RESYNC_RETRIES", "KA_HEALTH_MOVE_COST",
         "KA_EXEC_WAVE_SIZE", "KA_EXEC_POLL_INTERVAL", "KA_EXEC_POLL_TIMEOUT",
         "KA_EXEC_SIM_POLLS", "KA_EXEC_JOURNAL", "KA_ZK_PIPELINE", "KA_HOSTCODEC")


def _reset_planes():
    for mod in (jax_faults, torch_faults):
        mod.reset()
    for mod in (jax_metrics, torch_metrics):
        mod.disable_cumulative()
    for mod in (jax_flight, torch_flight):
        mod.disable()


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.5")
    monkeypatch.setenv("KA_DISPATCH", "0")
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(tmp_path))
    _reset_planes()
    yield
    _reset_planes()


@pytest.fixture()
def servers():
    pair = [JuteZkServer(cluster_tree()) for _ in range(2)]
    for s in pair:
        s.start()
    yield pair
    for s in pair:
        s.shutdown()


def spec(server) -> str:
    return f"127.0.0.1:{server.port}"


@contextlib.contextmanager
def running(pkg, clusters, solver="greedy", **kw):
    """A started daemon of ``pkg`` for ``clusters``, shut down on exit."""
    if pkg == "torch":
        d = AssignerDaemon(clusters=clusters, solver=solver, device="cpu", **kw)
    else:
        d = JaxDaemon(clusters=clusters, solver=JAX_LANE[solver], **kw)
    d.start()
    try:
        yield d
    finally:
        d.shutdown()


def post(port, path, payload=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload or {}),
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def stream_execute(port, path, payload, timeout=60.0):
    """POST an /execute; ``(status, events)`` or ``(status, error body)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload))
        resp = conn.getresponse()
        raw = resp.read().decode("utf-8")
        if resp.status != 200:
            return resp.status, json.loads(raw)
        return resp.status, [json.loads(ln) for ln in raw.splitlines()]
    finally:
        conn.close()


def snapshot(tmp_path, name, content) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(content))
    return str(path)


def groups_cluster():
    """``exec_snapshot_cluster`` with a consumer-group section."""
    snap = exec_snapshot_cluster()
    snap["groups"] = {
        "ingest": {"members": {"c-0": 40.0, "c-1": None, "c-2": 25.0},
                   "assignment": {"events": {"0": "c-0", "1": "c-1", "4": "c-9"},
                                  "logs": {"2": "c-2"}},
                   "lag": {"events": {str(p): 10 * (p + 1) for p in range(6)},
                           "logs": {"1": 7}}},
    }
    return snap


# --- routing and aggregates -------------------------------------------------------------


def test_routing_plans_and_aggregates_match_the_reference(servers, monkeypatch):
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "60")
    a, b = servers
    base_a = both_clis(spec(a), "--solver", "greedy")
    base_b = both_clis(spec(b), "--solver", "greedy", "--broker_hosts_to_remove", "h4")
    ranking = both_clis(spec(a), mode="RANK_DECOMMISSION")
    clusters = {"a": spec(a), "b": spec(b)}
    seen = {}
    for pkg in ("torch", "jax"):
        with running(pkg, clusters, err=io.StringIO()) as d:
            port = d.http_port
            got = []
            s, body, _ = post(port, "/clusters/a/plan")
            assert s == 200 and body["status"] == "ok"
            assert body["result"]["stdout"] == base_a and body["result"]["cluster"] == "a"
            assert any(sp["name"] == "daemon/request@a" for sp in body["spans"])
            s, body, _ = post(port, "/clusters/b/plan", {"broker_hosts_to_remove": "h4"})
            assert s == 200 and body["result"]["stdout"] == base_b
            s, body, _ = post(port, "/clusters/a/whatif")
            assert s == 200 and body["result"]["stdout"] == ranking
            # Bare data paths: a 400 naming the clusters; unknown names 404.
            for method, path in (("POST", "/plan"), ("POST", "/whatif"),
                                 ("POST", "/execute"), ("POST", "/groups/plan"),
                                 ("GET", "/recommendations"), ("GET", "/groups/sweep"),
                                 ("POST", "/clusters/nope/plan"),
                                 ("GET", "/clusters/nope/state"),
                                 ("GET", "/clusters/a/nope"), ("GET", "/nope")):
                s, body, _ = req(port, method, path, {} if method == "POST" else None)
                got.append((method, path, s, body))
            for path in ("/healthz", "/readyz", "/clusters/b/healthz",
                         "/clusters/b/readyz"):
                s, body, _ = req(port, "GET", path)
                got.append(("GET", path, s, body))
            _, state, _ = req(port, "GET", "/state")
            _, one, _ = req(port, "GET", "/clusters/a/state")
            seen[pkg] = (got, state, one, d.counters())
    got, state, one, counters = seen["torch"]
    got_j, state_j, one_j, counters_j = seen["jax"]
    assert got == got_j
    assert [g[2] for g in got[:6]] == [400] * 6 and got[0][3]["clusters"] == ["a", "b"]
    assert [g[2] for g in got[6:10]] == [404] * 4
    assert got[10][3]["status"] == "ready" and set(got[10][3]["clusters"]) == {"a", "b"}
    assert got[12][3]["breaker"]["state"] == "closed"
    # The aggregate /state, the fleet scheduler's summary included.
    assert set(state) == set(state_j) and set(state["clusters"]) == {"a", "b"}
    assert state["fleet"] == state_j["fleet"] and state["fleet"]["recovered"] is True
    assert set(one) == set(one_j)
    for key in ("lifecycle", "cache_version", "brokers", "topics", "encode_shape",
                "watches", "breaker", "execution_in_flight", "health",
                "traffic_real", "cluster", "controller"):
        assert one[key] == one_j[key], key
    assert {k: v for k, v in counters.items() if "warmup" not in k} \
        == {k: v for k, v in counters_j.items() if "warmup" not in k}
    assert counters["daemon.requests@a"] == 2 and counters["daemon.requests@b"] == 1


def test_a_cluster_that_cannot_sync_leaves_the_others_serving(servers, monkeypatch):
    """A dead quorum at startup: its cluster stays ``syncing`` (503 with
    ``cluster not synced yet``), the aggregate stays ready, the other cluster
    serves its bytes; in both packages alike."""
    monkeypatch.setenv("KA_DAEMON_RESYNC_RETRIES", "1")
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "1")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "30")
    a, _ = servers
    base = both_clis(spec(a), "--solver", "greedy")
    clusters = {"live": spec(a), "dead": "127.0.0.1:1"}
    seen = {}
    for pkg in ("torch", "jax"):
        with running(pkg, clusters, err=io.StringIO()) as d:
            port = d.http_port
            s, body, _ = post(port, "/clusters/live/plan")
            assert s == 200 and body["result"]["stdout"] == base
            out = [post(port, "/clusters/dead/plan")[:2],
                   req(port, "GET", "/clusters/dead/recommendations")[:2],
                   req(port, "GET", "/readyz")[:2],
                   req(port, "GET", "/clusters/dead/readyz")[:2]]
            _, health, _ = req(port, "GET", "/healthz")
            out.append((health["status"], health["clusters"]["dead"]["status"]))
            seen[pkg] = (out, d.supervisors["dead"].counters().get(
                "daemon.requests_unsynced"))
    assert seen["torch"] == seen["jax"]
    out, unsynced = seen["torch"]
    assert out[0] == (503, {"error": "cluster not synced yet", "cluster": "dead"})
    assert out[2][0] == 200 and out[3][0] == 503 and unsynced == 2
    assert out[4] == ("syncing", "syncing")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_bulkhead_expiry_and_stall_on_a_leave_b_serving(servers, pkg, monkeypatch):
    """``session@a:1=expire;resync@a:1=stall``: ``a`` answers stale and
    degraded, then recovers; ``b``'s concurrent plans stay ``ok`` and
    byte-identical to the CLIs' throughout."""
    a, b = servers
    base_a = both_clis(spec(a), "--solver", "greedy")
    base_b = both_clis(spec(b), "--solver", "greedy")
    monkeypatch.setenv("KA_FAULTS_SPEC", "session@a:1=expire;resync@a:1=stall")
    with running(pkg, {"a": spec(a), "b": spec(b)}, err=io.StringIO()) as d:
        port = d.http_port
        s, body, _ = post(port, "/clusters/a/plan")
        assert s == 200 and body["status"] == "ok"
        s, body, _ = post(port, "/clusters/a/plan")  # the expiry lands here
        assert s == 200 and body["result"]["stdout"] == base_a
        assert body["status"] == "degraded"
        b_failures = []

        def hammer_b():
            for _ in range(6):
                s2, b2, _ = post(port, "/clusters/b/plan")
                if s2 != 200 or b2["status"] != "ok" or b2["result"]["stdout"] != base_b:
                    b_failures.append((s2, b2.get("status")))

        t = threading.Thread(target=hammer_b)
        t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            s, body, _ = post(port, "/clusters/a/plan")
            assert s == 200 and body["result"]["stdout"] == base_a
            if body["status"] == "ok":
                break
            time.sleep(0.1)
        t.join(timeout=30)
        assert not t.is_alive()
        assert body["status"] == "ok", "cluster a never recovered"
        assert b_failures == []
        assert d.supervisors["a"].counters().get("daemon.resync_failures", 0) >= 1
        assert not d.supervisors["b"].counters().get("daemon.session_lost")


# --- /execute ----------------------------------------------------------------------------

EXEC_KNOBS = {"KA_EXEC_WAVE_SIZE": "3", "KA_EXEC_POLL_INTERVAL": "0.01",
              "KA_EXEC_POLL_TIMEOUT": "10", "KA_EXEC_SIM_POLLS": "1"}


def _without_journal(events):
    return [{k: v for k, v in e.items() if k != "journal"} for e in events]


def test_execute_stream_snapshot_and_journal_match_the_reference(
        tmp_path, monkeypatch):
    """``/clusters/x/execute`` of one plan on one snapshot path, once per
    package: the NDJSON events (less the journal path), the final snapshot
    and the journal are the reference's; a held slot answers 409, a bad
    request 400, and the slot comes back."""
    for k, v in EXEC_KNOBS.items():
        monkeypatch.setenv(k, v)
    original = exec_snapshot_cluster()
    snap = snapshot(tmp_path, "cluster.json", original)
    plan_text = both_clis(snap, "--solver", "greedy", "--broker_hosts_to_remove", "h9")
    seen = {}
    for pkg in ("torch", "jax"):
        snapshot(tmp_path, "cluster.json", original)
        for j in tmp_path.glob("ka-execute-*"):
            j.unlink()
        with running(pkg, {"x": snap, "y": snap}, err=io.StringIO()) as d:
            s, events = stream_execute(d.http_port, "/clusters/x/execute",
                                       {"plan_text": plan_text})
            assert s == 200, events
            sup = d.supervisors["x"]
            assert sup._exec_lock.acquire(blocking=False)
            try:
                conflict = stream_execute(d.http_port, "/clusters/x/execute",
                                          {"plan_text": plan_text})
                other = d.supervisors["y"].execution_in_flight()
            finally:
                sup._exec_lock.release()
            bad = [stream_execute(d.http_port, "/clusters/x/execute", payload)
                   for payload in ({}, {"plan_text": plan_text, "failure_policy": "nope"},
                                   {"plan_text": plan_text, "section": "old"},
                                   {"plan": [1]})]
            assert not sup._exec_lock.locked()
            _, view, _ = req(d.http_port, "GET", "/clusters/x/state")
            (journal,) = tmp_path.glob("ka-execute-x-*.journal")
            seen[pkg] = (events, conflict, other, bad, view["execution_in_flight"],
                         (tmp_path / "cluster.json").read_text(), journal.read_text(),
                         sup.counters())
    torch_run, jax_run = seen["torch"], seen["jax"]
    assert _without_journal(torch_run[0]) == _without_journal(jax_run[0])
    assert torch_run[1:] == jax_run[1:]
    events, conflict, other, bad, in_flight, final, journal, counters = torch_run
    kinds = [e["event"] for e in events]
    assert kinds[0] == "exec/start" and kinds[-2:] == ["exec/verify", "exec/done"]
    assert kinds.count("exec/wave") == kinds.count("exec/wave.committed") >= 2
    assert events[-1]["status"] == "ok" and events[-1]["exit_code"] == 0
    assert conflict[0] == 409 and "single-flight" in conflict[1]["error"]
    assert other is False and in_flight is False
    assert [s for s, _ in bad] == [400] * 4
    assert json.loads(journal)["status"] == "complete"
    assert counters["daemon.executes"] == 1 and counters["daemon.execute_conflicts"] == 1
    moved = json.loads(final)["topics"]
    assert all(9 not in reps for parts in moved.values() for reps in parts.values())


@pytest.mark.parametrize("killed,resumer", [("torch", "jax"), ("jax", "torch")])
def test_a_kill_mid_execute_resumes_offline_in_the_other_package(
        tmp_path, monkeypatch, killed, resumer):
    """``wave:1=crash`` kills the daemon's execution at its second wave: the
    stream ends with no terminal event, one wave journaled; the other
    package's ``ka-execute --resume`` on that journal ends byte-identical to
    an uninterrupted offline run."""
    for k, v in EXEC_KNOBS.items():
        monkeypatch.setenv(k, v)
    original = exec_snapshot_cluster()
    snap = snapshot(tmp_path, "cluster.json", original)
    plan_text = both_clis(snap, "--solver", "greedy", "--broker_hosts_to_remove", "h9")
    plan_file = tmp_path / "plan.txt"
    plan_file.write_text(plan_text)
    clean = tmp_path / "clean.json"
    shutil.copy(snap, clean)
    with contextlib.redirect_stderr(io.StringIO()):
        assert torch_execute(["--zk_string", str(clean), "--plan", str(plan_file),
                              "--journal", str(tmp_path / "clean.journal")]) == 0
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    with running(killed, {"x": snap}, err=io.StringIO()) as d:
        s, events = stream_execute(d.http_port, "/clusters/x/execute",
                                   {"plan_text": plan_text})
        assert s == 200
        counters = d.supervisors["x"].counters()
        assert not d.supervisors["x"].execution_in_flight()
    assert [e["event"] for e in events] == ["exec/start", "exec/wave",
                                            "exec/wave.committed"]
    assert counters["daemon.execute_interrupted"] == 1
    (journal,) = tmp_path.glob("ka-execute-x-*.journal")
    assert json.loads(journal.read_text())["waves_committed"] == 1
    monkeypatch.delenv("KA_FAULTS_SPEC")
    _reset_planes()
    resume = torch_execute if resumer == "torch" else jax_execute
    with contextlib.redirect_stderr(io.StringIO()):
        assert resume(["--zk_string", snap, "--plan", str(plan_file), "--journal",
                       str(journal), "--resume"]) == 0
    assert (tmp_path / "cluster.json").read_text() == clean.read_text()


# --- /recommendations and the groups endpoints --------------------------------------------


def _scrub_solver(body):
    """An envelope with the device lane's name made the port's (the
    reference's ``tpu`` is the port's ``device``)."""
    return json.loads(json.dumps(body).replace('"solver": "tpu"', '"solver": "device"'))


@pytest.mark.parametrize("lane", ["greedy", "device"])
def test_recommendations_and_groups_envelopes_match_the_reference(
        servers, tmp_path, lane):
    a, _ = servers
    snap = snapshot(tmp_path, "groups.json", groups_cluster())
    calls = [("GET", "/clusters/a/recommendations", None),
             ("GET", "/clusters/a/recommendations?move_cost=0", None),
             ("GET", "/clusters/g/recommendations?move_cost=0.5", None),
             ("GET", "/clusters/g/recommendations?move_cost=cheap", None),
             ("GET", "/clusters/g/groups/plan", None),
             ("POST", "/clusters/g/groups/plan", {"group": "ingest"}),
             ("GET", "/clusters/g/groups/sweep?counts=1,2,3&scales=100,150", None),
             ("POST", "/clusters/g/groups/sweep", {"weight": "throughput"}),
             ("GET", "/clusters/a/groups/plan", None),
             ("GET", "/clusters/a/groups/plan?synthetic=1", None),
             ("POST", "/clusters/a/groups/sweep", {"synthetic": "true", "counts": [2, 4]}),
             ("POST", "/clusters/g/groups/plan", {"group": 7}),
             ("GET", "/clusters/g/groups/plan?group=ghost", None)]
    seen = {}
    for pkg in ("torch", "jax"):
        with running(pkg, {"a": spec(a), "g": snap}, solver=lane) as d:
            seen[pkg] = [req(d.http_port, m, p, body)[:2] for m, p, body in calls]
            counters = d.counters()
        seen[pkg].append({k: v for k, v in counters.items()
                          if k.startswith(("groups.", "daemon.recommendations"))})
    assert [_scrub_solver(x) for x in seen["torch"]] == [_scrub_solver(x)
                                                        for x in seen["jax"]]
    got = seen["torch"]
    assert [s for s, _ in got[:-1]] == [200, 200, 200, 400, 200, 200, 200, 200, 400,
                                       200, 200, 400, 400]
    assert got[0][1]["verdict"] in ("recommend", "hold")
    assert got[4][1]["groups_real"] is True and got[9][1]["groups_real"] is False
    assert "ghost" in got[12][1]["error"]


# --- telemetry against the reference --------------------------------------------------------


def _wait_http(cum_mod, n):
    """Every request so far in ``daemon.http.requests``: the routing layer
    counts after the reply is written."""
    def counted():
        cum = cum_mod.cumulative()
        snap = cum.snapshot()["counters"].get("daemon.http.requests", {})
        return sum(snap.values()) >= n
    assert _await(counted, timeout=10)


#: Families whose values are the process's or the artifact's own.
OWN_FAMILIES = ("ka_process_", "ka_build_info", "ka_compile_store_", "ka_flight_events_")


def _logged(log, n):
    """``n`` lines in the access log: a request's line is written after its
    reply, and it reads the cluster's ``inflight`` then. The next request
    waits for it, so both daemons read ``inflight`` at rest."""
    def lines():
        return log.exists() and len(log.read_text().splitlines()) >= n
    assert _await(lines, timeout=10), f"access log never reached {n} lines"


def test_metrics_access_log_and_flight_match_the_reference(tmp_path, monkeypatch):
    """One request sequence through each package's daemon over two
    snapshot clusters: the ``/metrics`` families, every counter's samples,
    the gauges' samples and the histograms' counts; the access log's lines
    less their times and ids; the flight ring's event kinds in order. Each
    request waits for the last one's access-log line."""
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "60")
    for k, v in EXEC_KNOBS.items():
        monkeypatch.setenv(k, v)
    # Under KA_DISPATCH=0 the reference's /whatif auto-meshes over the test
    # process's eight virtual CPU devices and tiles its fan-out gauge to
    # them; the port's daemon sees eight cpu positions, so it meshes alike
    # and every gauge compares.
    monkeypatch.setattr(torch_mesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    original = groups_cluster()
    snap_a = snapshot(tmp_path, "a.json", exec_snapshot_cluster())
    snap_b = str(tmp_path / "b.json")
    plan_text = both_clis(snap_a, "--solver", "greedy", "--broker_hosts_to_remove", "h9")
    sequence = [("POST", "/clusters/a/plan", {}),
                ("POST", "/clusters/b/plan", {"broker_hosts_to_remove": "h1"}),
                ("POST", "/clusters/b/plan", {"topics": ["ghost"]}),
                ("POST", "/clusters/a/whatif", {"scenarios": [[1], [2, 3]]}),
                ("GET", "/clusters/b/recommendations?move_cost=0", None),
                ("GET", "/clusters/b/groups/plan", None),
                ("POST", "/clusters/b/groups/sweep", {"counts": "1,2"}),
                ("GET", "/clusters/a/healthz", None),
                ("GET", "/readyz", None),
                ("POST", "/plan", {})]
    seen = {}
    for pkg in ("torch", "jax"):
        snapshot(tmp_path, "b.json", original)
        log = tmp_path / f"access-{pkg}.log"
        metrics_mod = torch_metrics if pkg == "torch" else jax_metrics
        with running(pkg, {"a": snap_a, "b": snap_b}, access_log=str(log),
                     err=io.StringIO()) as d:
            port = d.http_port
            for i, (method, path, body) in enumerate(sequence):
                req(port, method, path, body)
                _logged(log, i + 1)
            s, events = stream_execute(port, "/clusters/b/execute",
                                       {"plan_text": plan_text})
            assert s == 200 and events[-1]["event"] == "exec/done"
            _logged(log, len(sequence) + 1)
            # Nine requests and the execution carry an endpoint (the bare
            # /plan's 400 does not); seven are POSTs.
            _wait_http(metrics_mod, len(sequence))
            flight_mod = torch_flight if pkg == "torch" else jax_flight
            assert _await(lambda: sum(e["kind"] == "request" for e in
                                      flight_mod.recorder().snapshot()) == 7)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode("utf-8")
            conn.close()
            _wait_http(metrics_mod, len(sequence) + 1)
            _logged(log, len(sequence) + 2)
            _, view, _ = req(port, "GET", "/debug/flight")
            _logged(log, len(sequence) + 3)
            _, per_b, _ = req(port, "GET", "/clusters/b/debug/flight")
            _logged(log, len(sequence) + 4)
        parse = promtext.parse if pkg == "torch" else jax_promtext.parse
        lines = [json.loads(ln) for ln in log.read_text().splitlines()]
        seen[pkg] = (parse(text), lines, view, per_b)
    fams, lines, view, per_b = seen["torch"]
    fams_j, lines_j, view_j, per_b_j = seen["jax"]
    ours = {f for f in fams if not f.startswith(OWN_FAMILIES)}
    assert ours == {f for f in fams_j if not f.startswith(OWN_FAMILIES)}
    for fam in sorted(ours):
        kind = fams[fam]["type"]
        assert kind == fams_j[fam]["type"], fam
        if kind == "histogram":
            assert promtext.check_histogram(fams[fam]) == [], fam
            counts = [x for x in fams[fam]["samples"] if x[0].endswith("_count")]
            assert counts == [x for x in fams_j[fam]["samples"]
                              if x[0].endswith("_count")], fam
        else:
            assert fams[fam]["samples"] == fams_j[fam]["samples"], fam
    assert {"ka_daemon_http_requests_total", "ka_health_score", "ka_traffic_lag",
            "ka_whatif_scenario_ms", "ka_groups_sweep_ms", "ka_daemon_executes_total",
            "ka_health_movement_debt", "ka_fleet_leases", "ka_fleet_window_moves"} <= ours
    keep = ("method", "path", "cluster", "code", "status", "inflight", "stale",
            "degraded")
    assert [{k: ln[k] for k in keep} for ln in lines] == \
        [{k: ln[k] for k in keep} for ln in lines_j]
    assert {k for ln in lines for k in ln} == {k for ln in lines_j for k in ln}
    assert len(lines) == len(sequence) + 4  # the execution, the scrape, two flight views
    for v, v_j in ((view, view_j), (per_b, per_b_j)):
        assert [e["kind"] for e in v["events"]] == [e["kind"] for e in v_j["events"]]
    kinds = [e["kind"] for e in per_b["events"]]
    assert {"daemon", "lifecycle", "resync", "request", "recommendation", "groups",
            "execute"} <= set(kinds)
    assert all(e.get("cluster", "b") == "b" for e in per_b["events"])


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
def test_a_crashed_groups_solve_follows_the_failure_policy(tmp_path, monkeypatch, policy):
    """A device packing solve that crashes (the ``solve`` seam, the
    stand-in for a group-pack launch that fails): under ``best-effort`` both
    daemons answer the host oracle's plan, ``degraded``, byte for byte;
    under ``strict`` the port answers 500 with the ``SolveError`` where the
    reference re-runs on its oracle (ROADMAP §3). The ``daemon:solver-crash``
    seam re-runs on the oracle in both under either policy."""
    monkeypatch.setenv("KA_FAILURE_POLICY", policy)
    snap = snapshot(tmp_path, "groups.json", groups_cluster())
    seen = {}
    for pkg in ("torch", "jax"):
        runs = []
        for spec in ("solve:0=crash", "daemon:0=solver-crash"):
            _reset_planes()
            monkeypatch.setenv("KA_FAULTS_SPEC", spec)
            with running(pkg, {"g": snap}, solver="device", err=io.StringIO()) as d:
                runs.append(req(d.http_port, "GET", "/clusters/g/groups/plan")[:2])
                counters = d.supervisors["g"].counters()
            runs.append(counters.get("groups.solve_fallbacks"))
        seen[pkg] = runs
    (solve_crash, fallbacks), (seam, seam_fallbacks) = (seen["torch"][:2], seen["torch"][2:])
    assert seen["torch"][2:] == seen["jax"][2:]
    assert seam[0] == 200 and seam[1]["degraded"] and seam_fallbacks == 1
    assert seam[1]["groups"]["ingest"]["solver"] == "greedy-fallback"
    if policy == "best-effort":
        assert seen["torch"][:2] == seen["jax"][:2]
        assert solve_crash[0] == 200 and solve_crash[1]["degraded"] and fallbacks == 1
    else:
        assert solve_crash[0] == 500 and "SolveError" in solve_crash[1]["error"]
        assert fallbacks is None
        assert seen["jax"][0][0] == 200 and seen["jax"][0][1]["degraded"]
