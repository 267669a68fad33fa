"""The port's health plane (``kafka_assigner_tpu_torch/obs/health.py``, the
supervisor's ``health.*`` and ``traffic.*`` publishing, ``/recommendations``)
against the JAX package's, on the CPU.

``score_assignment``, ``movement_debt`` and ``validate_recommendation`` on
the cases of ``tests/test_health.py:56-213`` and on assignments drawn from a
numpy seed give the reference's values exactly; the snapshot's ``traffic``
section reads as the reference's; the daemon's gauges, its envelope, its
verdict flip and its flight trail are the reference daemon's. No tolerance:
the scores are rounded as the reference rounds them.
"""
from __future__ import annotations

import http.client
import io
import json
import time

import numpy as np
import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JaxSnapshot
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import health as jax_health
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.daemon import AssignerDaemon
from kafka_assigner_tpu_torch.io.base import PartitionTraffic
from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
from kafka_assigner_tpu_torch.io.zkwire import MiniZkClient
from kafka_assigner_tpu_torch.obs import flight, health, promtext
from kafka_assigner_tpu_torch.obs import metrics as metrics_mod

from .jute_server import JuteZkServer
from .test_torch_daemon import _await, req


def _reset_planes():
    for mod in (jax_faults, torch_faults):
        mod.reset()
    for mod in (jax_metrics, metrics_mod):
        mod.disable_cumulative()
    for mod in (jax_flight, flight):
        mod.disable()


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for knob in ("KA_FAULTS_SPEC", "KA_HEALTH_MOVE_COST", "KA_DAEMON_MAX_INFLIGHT",
                 "KA_OBS_TRAFFIC_SERIES_MAX", "KA_OBS_ACCESS_LOG"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "0.5")
    monkeypatch.setenv("KA_DISPATCH", "0")
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(tmp_path))
    _reset_planes()
    yield
    _reset_planes()


def imbalanced_tree():
    """Every replica on brokers 1-2 of four brokers in four racks."""
    tree = {}
    for i in range(1, 5):
        tree[f"/brokers/ids/{i}"] = json.dumps(
            {"host": f"h{i}", "port": 9092, "rack": f"r{i}"}).encode()
    tree["/brokers/topics/hot"] = json.dumps(
        {"partitions": {str(p): [1, 2] for p in range(4)}}).encode()
    return tree


# --- scoring -----------------------------------------------------------------------------

#: ``tests/test_health.py``'s score cases: (brokers, topics, racks).
SCORE_CASES = {
    "balanced": ({1, 2, 3, 4}, {"t": {0: [1, 2], 1: [3, 4], 2: [2, 1], 3: [4, 3]}},
                 {1: "ra", 2: "rb", 3: "ra", 4: "rb"}),
    "skew": ({1, 2, 3, 4}, {"hot": {p: [1, 2] for p in range(4)}},
             {i: f"r{i}" for i in range(1, 5)}),
    "empty-brokers": ({1, 2, 3}, {"t": {0: [1]}}, {}),
    "rack-violation": ({1, 2, 3}, {"t": {0: [1, 2], 1: [1, 3], 2: [2, 3]}},
                       {1: "ra", 2: "ra", 3: "rb"}),
    "rackless": ({1, 2, 3}, {"t": {0: [1, 2], 1: [1, 3], 2: [2, 3]}}, {}),
    "stray": ({1, 2}, {"t": {0: [1, 9]}}, {}),
    "clean": ({1, 2}, {"t": {0: [1, 2]}}, {1: "ra", 2: "rb"}),
    "dirty": ({1, 2}, {"t": {0: [1, 2]}}, {1: "ra", 2: "ra"}),
    "nothing": (set(), {}, {}),
}
EXPECTED = {
    "balanced": dict(replica_spread=0, replica_stddev=0.0, leader_spread=0,
                     rack_violations=0, score=0.0, brokers=4, topics=1, partitions=4,
                     replicas=8),
    "skew": dict(replica_spread=4, replica_stddev=2.0, leader_spread=4, score=6.0),
    "empty-brokers": dict(replica_spread=1, brokers=3),
    "rack-violation": dict(rack_violations=1),
    "rackless": dict(rack_violations=0),
    "stray": dict(brokers=3, replicas=2),
    "clean": dict(score=0.5),
    "dirty": dict(score=10.5),  # clean + 10 for the one violation
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_assignment_cases_match_the_reference(case):
    brokers, topics, racks = SCORE_CASES[case]
    got = health.score_assignment(brokers, topics, racks).as_dict()
    assert got == jax_health.score_assignment(brokers, topics, racks).as_dict()
    for key, value in EXPECTED.get(case, {}).items():
        assert got[key] == value, key


def _random_assignment(rng, n_brokers, n_topics, rf):
    brokers = list(range(n_brokers))
    topics = {}
    for t in range(n_topics):
        parts = {}
        for p in range(int(rng.integers(1, 9))):
            k = int(rng.integers(1, rf + 1))
            # Some replicas on a broker outside the live set.
            pool = brokers + [n_brokers + 7]
            parts[p] = [int(x) for x in rng.choice(pool, size=k, replace=False)]
        topics[f"t{t}"] = parts
    racks = {b: f"r{int(rng.integers(0, 3))}" for b in brokers if rng.random() < 0.8}
    return set(brokers), topics, racks


@pytest.mark.parametrize("seed", range(6))
def test_scores_and_movement_debt_on_seeded_assignments(seed):
    rng = np.random.default_rng(seed)
    brokers, current, racks = _random_assignment(rng, 12, 5, 3)
    _, proposed, _ = _random_assignment(rng, 12, 5, 3)
    proposed = {t: parts for t, parts in proposed.items() if rng.random() < 0.7}
    for topics in (current, proposed):
        assert health.score_assignment(brokers, topics, racks).as_dict() == \
            jax_health.score_assignment(brokers, topics, racks).as_dict()
    assert health.movement_debt(current, proposed) == \
        jax_health.movement_debt(current, proposed)
    assert health.movement_debt(current, current) == (0, 0)


@pytest.mark.parametrize("cur,new,want", [
    ({"t": {0: [1, 2], 1: [2, 3]}}, {"t": {0: [1, 2], 1: [2, 3]}}, (0, 0)),
    ({"t": {0: [1, 2]}}, {"t": {0: [2, 1]}}, (0, 1)),
    ({"t": {0: [1, 2]}, "gone": {0: [5, 6]}}, {"t": {0: [2, 3]}, "fresh": {0: [7]}},
     (4, 3)),
])
def test_movement_debt_cases_match_the_reference(cur, new, want):
    assert health.movement_debt(cur, new) == jax_health.movement_debt(cur, new) == want


def _envelope():
    scores = health.HealthScores(4, 1, 4, 8, 4, 2.0, 4, 1.5, 0, 6.0).as_dict()
    return {"schema_version": 1, "kind": "recommendations", "policy": "observe",
            "cluster": "a", "solver": "greedy", "stale": False, "degraded": False,
            "current": scores, "candidate": {"projected": scores, "moves_required": 2,
                                             "leader_moves": 1},
            "cost_model": {"move_cost": 1.0, "cost": 2.0, "improvement": 0.5},
            "verdict": "hold"}


def _broken(env, path, value):
    env = json.loads(json.dumps(env))
    node = env
    for key in path[:-1]:
        node = node[key]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return env


@pytest.mark.parametrize("obj", [
    _envelope(), [], {"schema_version": 99},
    _broken(_envelope(), ("policy",), "auto"),
    _broken(_envelope(), ("verdict",), "maybe"),
    _broken(_envelope(), ("current", "score"), KeyError),
    _broken(_envelope(), ("candidate", "moves_required"), 1.5),
    _broken(_envelope(), ("cost_model",), None),
    _broken(_envelope(), ("cost_model", "cost"), "x"),
])
def test_validate_recommendation_matches_the_reference(obj):
    got = health.validate_recommendation(obj)
    assert got == jax_health.validate_recommendation(obj)
    assert (got == []) == (obj == _envelope())


# --- traffic -------------------------------------------------------------------------------


def test_synthetic_traffic_is_the_references():
    parts = {"events": [0, 1, 2, 3], "logs": [5]}
    got = health.synthetic_partition_traffic(parts)
    assert {t: {p: tuple(tr) for p, tr in per.items()} for t, per in got.items()} == \
        {t: {p: tuple(tr) for p, tr in per.items()}
         for t, per in jax_health.synthetic_partition_traffic(parts).items()}
    assert len({tr.in_bytes for tr in got["events"].values()}) > 1


@pytest.mark.parametrize("section", [True, False])
def test_snapshot_traffic_section_reads_as_the_references(tmp_path, section):
    """``tests/test_health.py:150`` and ``:167`` on the port's snapshot
    backend: a recorded meter wins, the synthetic series fills the rest."""
    data = {"brokers": [{"id": 1, "host": "h1", "port": 9092}],
            "topics": {"t": {"0": [1], "1": [1]}}}
    if section:
        data["traffic"] = {"t": {"0": {"in_bytes": 1.5, "out_bytes": 2.5, "lag": 7}}}
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps(data))
    be, ref = SnapshotBackend(str(snap)), JaxSnapshot(str(snap))
    assert be.supports_traffic() is ref.supports_traffic() is section
    got = be.fetch_partition_traffic({"t": [0, 1]})
    assert {p: tuple(tr) for p, tr in got["t"].items()} == \
        {p: tuple(tr) for p, tr in ref.fetch_partition_traffic({"t": [0, 1]})["t"].items()}
    if section:
        assert got["t"][0] == PartitionTraffic(1.5, 2.5, 7)
    assert got["t"][1] == health.synthetic_partition_traffic({"t": [1]})["t"][1]


def test_replace_gauges_swaps_one_clusters_series():
    snaps = []
    for mod in (metrics_mod, jax_metrics):
        cum = mod.CumulativeMetrics()
        cum.replace_gauges("traffic.lag", {(("partition", "0"), ("topic", "old")): 5.0},
                           {"cluster": "a"})
        cum.replace_gauges("traffic.lag", {(("partition", "0"), ("topic", "keep")): 9.0},
                           {"cluster": "b"})
        cum.replace_gauges("traffic.lag", {(("partition", "0"), ("topic", "new")): 6.0},
                           {"cluster": "a"})
        cum.replace_gauges("traffic.in_bytes", {(("partition", "1"), ("topic", "x")): 2.0})
        snaps.append(cum.snapshot())
    assert snaps[0] == snaps[1]
    series = snaps[0]["gauges"]["traffic.lag"]
    assert {dict(k)["topic"]: v for k, v in series.items()} == {"new": 6.0, "keep": 9.0}


# --- the daemon ------------------------------------------------------------------------------


def _metrics(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        return promtext.parse(conn.getresponse().read().decode("utf-8"))
    finally:
        conn.close()


def test_daemon_health_gauges_and_recommendations_match_the_reference(monkeypatch):
    """``tests/test_health.py:213`` on both daemons over one imbalanced
    server: the health gauges and traffic series in the scrape, the
    envelope (valid, byte-stable, ``hold`` at a high cost, ``recommend`` at
    ``?move_cost=0``), the 400s, the flight trail, no write to the cluster,
    and the movement debt gauge."""
    monkeypatch.setenv("KA_HEALTH_MOVE_COST", "1000000")
    server = JuteZkServer(imbalanced_tree())
    server.start()
    seen = {}
    try:
        for pkg in ("torch", "jax"):
            if pkg == "torch":
                d = AssignerDaemon(clusters={"a": f"127.0.0.1:{server.port}"},
                                   solver="greedy", device="cpu", err=io.StringIO())
            else:
                d = JaxDaemon(clusters={"a": f"127.0.0.1:{server.port}"},
                              solver="greedy", err=io.StringIO())
            d.start()
            try:
                port = d.http_port
                fams = _metrics(port)
                gauges = {f: fams[f]["samples"] for f in fams if f.startswith("ka_health_")
                          and fams[f]["type"] == "gauge"}
                lag = fams["ka_traffic_lag"]["samples"]
                calls = [req(port, "GET", path)[:2] for path in (
                    "/clusters/a/recommendations", "/clusters/a/recommendations",
                    "/clusters/a/recommendations?move_cost=0",
                    "/clusters/a/recommendations?move_cost=cheap", "/recommendations")]
                _, view, _ = req(port, "GET", "/clusters/a/debug/flight")
                trail = [e["verdict"] for e in view["events"]
                         if e["kind"] == "recommendation"]
                cum = (metrics_mod if pkg == "torch" else jax_metrics).cumulative()
                debt = cum.snapshot()["gauges"]["health.movement_debt"][(("cluster", "a"),)]
                _, state, _ = req(port, "GET", "/clusters/a/state")
                seen[pkg] = (gauges, lag, calls, trail, debt, state["health"])
            finally:
                d.shutdown()
    finally:
        server.shutdown()
    assert seen["torch"] == seen["jax"]
    gauges, lag, calls, trail, debt, state_health = seen["torch"]
    assert gauges["ka_health_replica_spread"] == [("ka_health_replica_spread",
                                                   {"cluster": "a"}, 4.0)]
    assert {(lb["topic"], lb["partition"]) for _, lb, _ in lag} == \
        {("hot", str(p)) for p in range(4)}
    (s1, high), (_, again), (_, low), (s_bad, bad), (s_bare, bare) = calls
    assert s1 == 200 and health.validate_recommendation(high) == [] and again == high
    assert high["verdict"] == "hold" and high["candidate"]["moves_required"] > 0
    assert high["cost_model"]["improvement"] > 0
    assert low["verdict"] == "recommend"
    assert low["candidate"]["projected"]["replica_spread"] < high["current"]["replica_spread"]
    assert s_bad == 400 and "move_cost" in bad["error"]
    assert s_bare == 400 and bare["clusters"] == ["a"]
    assert trail == ["hold", "hold", "recommend"] and debt > 0
    assert state_health == high["current"]
    assert server.write_ops == {"create": 0, "setData": 0, "delete": 0}


def test_single_cluster_recommendations_and_unlabelled_gauges(tmp_path):
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps({
        "brokers": [{"id": i, "host": f"h{i}", "port": 9092, "rack": f"r{i}"}
                    for i in range(1, 5)],
        "topics": {"hot": {str(p): [1, 2] for p in range(4)}},
    }))
    bodies = []
    for pkg in ("torch", "jax"):
        cls, kw = (AssignerDaemon, {"device": "cpu"}) if pkg == "torch" else (JaxDaemon, {})
        d = cls(str(snap), solver="greedy", err=io.StringIO(), **kw)
        d.start()
        try:
            s, body, _ = req(d.http_port, "GET", "/recommendations?move_cost=0")
            assert s == 200 and health.validate_recommendation(body) == []
            cum = (metrics_mod if pkg == "torch" else jax_metrics).cumulative()
            assert () in cum.snapshot()["gauges"]["health.replica_spread"]
            bodies.append(body)
        finally:
            d.shutdown()
    assert bodies[0] == bodies[1]
    assert bodies[0]["cluster"] == "default" and bodies[0]["verdict"] == "recommend"
    assert json.loads(snap.read_text())["topics"]["hot"]["0"] == [1, 2]


def test_watch_churn_republishes_the_health_gauges():
    server = JuteZkServer(imbalanced_tree())
    server.start()
    d = AssignerDaemon(clusters={"a": f"127.0.0.1:{server.port}"}, solver="greedy",
                       device="cpu", err=io.StringIO())
    try:
        d.start()
        cum = metrics_mod.cumulative()

        def spread():
            return cum.snapshot()["gauges"]["health.replica_spread"][(("cluster", "a"),)]

        assert spread() == 4
        w = MiniZkClient(f"127.0.0.1:{server.port}")
        w.start()
        try:
            w.create("/brokers/topics/counter",
                     b'{"partitions": {"0": [3, 4], "1": [3, 4], "2": [3, 4], "3": [3, 4]}}')
        finally:
            w.close()
        assert _await(lambda: spread() == 0, timeout=15)
        assert d.supervisors["a"].counters().get("daemon.reencode.topics", 0) >= 1
    finally:
        d.shutdown()
        server.shutdown()


def test_traffic_series_cap_counts_what_it_drops(tmp_path, monkeypatch):
    """``KA_OBS_TRAFFIC_SERIES_MAX`` keeps the busiest series a cluster and
    counts the rest in ``traffic.series_dropped``, as the reference does."""
    monkeypatch.setenv("KA_OBS_TRAFFIC_SERIES_MAX", "3")
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps({
        "brokers": [{"id": i, "host": f"h{i}", "port": 9092} for i in range(1, 4)],
        "topics": {"t": {str(p): [1 + p % 3] for p in range(8)}},
    }))
    seen = []
    for pkg in ("torch", "jax"):
        cls, kw = (AssignerDaemon, {"device": "cpu"}) if pkg == "torch" else (JaxDaemon, {})
        d = cls(clusters={"x": str(snap)}, solver="greedy", err=io.StringIO(), **kw)
        d.start()
        try:
            snapshot = (metrics_mod if pkg == "torch" else jax_metrics).cumulative().snapshot()
            seen.append((snapshot["gauges"]["traffic.in_bytes"],
                         snapshot["gauges"]["traffic.series_dropped"]))
        finally:
            d.shutdown()
    assert seen[0] == seen[1]
    series, dropped = seen[0]
    assert len(series) == 3 and dropped == {(("cluster", "x"),): 5}


def test_recommendations_watchdog_and_shed(tmp_path, monkeypatch):
    """The admission gate and the live watchdog cover ``/recommendations``:
    an overrun is counted and flight-recorded; with the one slot held the
    endpoint sheds 503."""
    snap = tmp_path / "c.json"
    snap.write_text(json.dumps({
        "brokers": [{"id": i, "host": f"h{i}", "port": 9092, "rack": f"r{i}"}
                    for i in range(1, 5)],
        "topics": {"hot": {str(p): [1, 2] for p in range(4)}},
    }))
    d = AssignerDaemon(str(snap), solver="greedy", device="cpu", err=io.StringIO())
    try:
        d.start()
        sup = d.supervisor()
        sup.request_timeout = 0.0
        code, body, _ = sup.recommendations({"move_cost": "0"})
        assert code == 200 and body["verdict"] == "recommend"
        assert _await(lambda: sup.counters().get("daemon.watchdog_exceeded", 0) >= 1,
                      timeout=5)
        assert any(e["kind"] == "watchdog" and e["path"] == "/recommendations"
                   for e in flight.recorder().snapshot())
        sup.request_timeout = None
        monkeypatch.setenv("KA_DAEMON_MAX_INFLIGHT", "1")
        assert sup._gate() is None  # hold the one slot
        try:
            code, body, headers = sup.recommendations({})
            assert code == 503 and body["error"] == "overloaded"
            assert headers["Retry-After"] == "1"
            assert sup.counters()["daemon.requests_shed"] == 1
        finally:
            sup._release()
        time.sleep(0.01)
        assert sup.recommendations({})[0] == 200
    finally:
        d.shutdown()
