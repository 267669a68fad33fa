"""The port's closed-loop rebalance controller
(``kafka_assigner_tpu_torch/daemon/controller.py``) against the JAX
package's, on the CPU, over snapshot clusters.

Each case of ``tests/test_controller.py`` runs the same scenario through
both packages' daemons, one after the other in the same directory (the same
snapshot path, the same journal directory), and compares, less times: the
decision trail (the ring, the flight ``controller`` and ``fleet`` events,
the ``controller.*`` counters and the ``fleet.*`` series), ``GET
/controller``, the window ledger, the verdict memory, the fleet's ledger
``ka-fleet.json``, the journals and the snapshot's bytes. The daemon-level
cases (restarts, rollbacks, the pause race, two ``auto`` clusters under the
fleet, the shared ticker) are in ``test_torch_controller_daemon.py``; the
fleet's own cases in ``test_torch_fleet.py``.

Ticks are driven by hand with the loop parked on an hour's interval, the
resync interval is an hour too (an action prompts its own resync), the
controller's jitter is seeded, and every wait is on a condition with a
bound.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import random
import shutil

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import parse_clusters_spec as jax_parse_clusters
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.daemon.controller import RebalanceController as JaxController
from kafka_assigner_tpu.daemon.controller import resolve_policy as jax_resolve_policy
from kafka_assigner_tpu.exec.engine import PlanExecutor as JaxExecutor
from kafka_assigner_tpu.exec.engine import parse_plan_payload as jax_parse_plan
from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JaxSnapshot
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.cli import parse_clusters_spec
from kafka_assigner_tpu_torch.daemon import AssignerDaemon
from kafka_assigner_tpu_torch.daemon.controller import RebalanceController, resolve_policy
from kafka_assigner_tpu_torch.exec.engine import PlanExecutor, parse_plan_payload
from kafka_assigner_tpu_torch.io.json_io import format_reassignment_json
from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
from kafka_assigner_tpu_torch.obs import flight as torch_flight
from kafka_assigner_tpu_torch.obs import metrics as torch_metrics

from .test_torch_daemon import _await, req

PKGS = ("torch", "jax")
FAULTS = {"torch": torch_faults, "jax": jax_faults}
FLIGHT = {"torch": torch_flight, "jax": jax_flight}
METRICS = {"torch": torch_metrics, "jax": jax_metrics}
#: Keys that hold a wall-clock or monotonic time.
TIMES = frozenset({"t", "retry_in_s", "cooldown_remaining_s", "granted", "heartbeat"})


def _reset_planes():
    for mod in (jax_faults, torch_faults):
        mod.reset()
    for mod in (jax_metrics, torch_metrics):
        mod.disable_cumulative()
    for mod in (jax_flight, torch_flight):
        mod.disable()


@pytest.fixture(autouse=True)
def _controller_env(monkeypatch):
    """The reference tests' knobs, less their 0.2 s resync: a resync lands
    only where an action prompts one."""
    for knob in ("KA_CONTROLLER", "KA_FAULTS_SPEC", "KA_HEALTH_MOVE_COST",
                 "KA_EXEC_WAVE_SIZE", "KA_EXEC_SIM_POLLS", "KA_DAEMON_WATCH",
                 "KA_DAEMON_MAX_INFLIGHT", "KA_FAILURE_POLICY",
                 "KA_CONTROLLER_WINDOW", "KA_CONTROLLER_REGRESSION_TOL"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "3600")
    monkeypatch.setenv("KA_CONTROLLER_INTERVAL", "3600")
    monkeypatch.setenv("KA_CONTROLLER_COOLDOWN", "0")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "2")
    monkeypatch.setenv("KA_CONTROLLER_MAX_MOVES", "32")
    monkeypatch.setenv("KA_EXEC_POLL_INTERVAL", "0.01")
    _reset_planes()
    yield
    _reset_planes()


#: ``tests/test_controller.py``'s cluster: four brokers on four racks with
#: every replica on brokers 1-2, so the default cost model recommends.
IMBALANCED = {
    "brokers": [
        {"id": i, "host": f"b{i}", "port": 9092, "rack": f"r{i}"}
        for i in range(1, 5)
    ],
    "topics": {
        "hot": {str(p): [1, 2] for p in range(4)},
        "events": {"0": [1, 2, 3]},
    },
}


def fresh_dir(tmp_path, monkeypatch, names=("cluster.json",)):
    """An empty run directory at the same path for each package, holding
    the snapshot(s) and the journal directory; returns the snapshot paths."""
    run = tmp_path / "run"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir()
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(run))
    paths = []
    for name in names:
        (run / name).write_text(json.dumps(IMBALANCED))
        paths.append(str(run / name))
    return paths


def install(pkg, spec):
    inject = FAULTS[pkg]
    inject.install(inject.FaultInjector(inject.parse_spec(spec)))


@contextlib.contextmanager
def controller_daemon(pkg, snap=None, **kw):
    """A started single-cluster (``snap``) or many-cluster (``clusters=``)
    daemon of ``pkg`` on the greedy lane, shut down on exit."""
    kw.setdefault("solver", "greedy")
    kw.setdefault("err", io.StringIO())
    if pkg == "torch":
        d = AssignerDaemon(snap, device="cpu", controller_rng=random.Random(7), **kw)
    else:
        kw["solver"] = {"device": "tpu"}.get(kw["solver"], kw["solver"])
        d = JaxDaemon(snap, **kw)
    d.start()
    try:
        yield d
    finally:
        d.shutdown()


def scrub(x):
    """``x`` less its times."""
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in TIMES}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    return x


def await_ready(sup, timeout=20.0):
    """After an action the cache is stale until the watch loop's prompted
    resync: wait for it, so the next tick sees the world after the move."""
    assert _await(lambda: sup.lifecycle() == "ready", timeout=timeout), sup.lifecycle()


def files_of(run):
    """The journal directory's files (less the snapshots), each parsed, the
    window ledger and the fleet's ledger less their times."""
    out = {}
    for name in sorted(os.listdir(run)):
        if name.endswith(".json") and not name.startswith("ka-"):
            continue
        text = (run / name).read_text()
        body = json.loads(text)
        if name.endswith(".window.json"):
            body = {"actions": [n for _t, n in body["actions"]]}
        elif name == "ka-fleet.json":
            body["actions"] = [[n, c] for _t, n, c in body["actions"]]
            body["leases"] = {c: scrub(lease) for c, lease in body["leases"].items()}
        out[name] = body
    return out


def record(pkg, d, run, snaps):
    """Everything a case compares, for one package's finished daemon."""
    events = [scrub({k: v for k, v in e.items() if k != "seq"})
              for e in FLIGHT[pkg].recorder().snapshot()
              if e["kind"] in ("controller", "fleet")]
    cum = METRICS[pkg].cumulative().snapshot()
    return {
        "views": {n: scrub(s.controller_view()) for n, s in sorted(d.supervisors.items())},
        "fleet": scrub(d.fleet.view()),
        "events": events,
        "counters": {k: v for k, v in d.counters().items()
                     if k.startswith("controller.")},
        "fleet_series": {f"{section}:{name}": sorted(by.items())
                         for section in ("counters", "gauges")
                         for name, by in cum[section].items() if name.startswith("fleet.")},
        "files": files_of(run),
        "snapshots": [open(p).read() for p in snaps],
    }


def run_both(tmp_path, monkeypatch, body, names=("cluster.json",), spec=None, **kw):
    """``body(pkg, d)`` in each package's daemon, from a fresh directory;
    returns ``{pkg: (body's result, record)}`` and asserts the records
    equal."""
    out = {}
    for pkg in PKGS:
        _reset_planes()
        snaps = fresh_dir(tmp_path, monkeypatch, names)
        if spec is not None:
            install(pkg, spec)
        if len(snaps) == 1 and "clusters" not in kw:
            ctx = controller_daemon(pkg, snaps[0], **kw)
        else:
            ctx = controller_daemon(pkg, **kw)
        with ctx as d:
            result = body(pkg, d)
            rec = record(pkg, d, tmp_path / "run", snaps)
        rec["snapshots"] = [open(p).read() for p in snaps]
        out[pkg] = (result, rec)
    assert out["torch"][1] == out["jax"][1]
    return out


def decisions(rec, cluster="default"):
    return [e["decision"] for e in rec["views"][cluster]["decisions"]]


# --- the policy ladder -------------------------------------------------------------------


def test_off_policy_is_inert(tmp_path, monkeypatch):
    def body(pkg, d):
        sup = d.supervisor()
        assert sup.controller.policy == "off"
        assert sup.controller._thread is None  # no thread started
        assert sup.controller.tick() is None
        s, view, _ = req(d.http_port, "GET", "/controller")
        return s, scrub(view)

    out = run_both(tmp_path, monkeypatch, body)
    assert out["torch"][0] == out["jax"][0]
    s, view = out["torch"][0]
    assert s == 200 and view["policy"] == "off" and view["decisions"] == []
    assert out["torch"][1]["counters"] == {} and out["torch"][1]["files"] == {}


@pytest.mark.parametrize("override", [None, "off", "observe", "auto", "yolo", "", "AUTO"])
def test_resolve_policy_validates_overrides(override, monkeypatch):
    got = []
    for resolve in (resolve_policy, jax_resolve_policy):
        try:
            got.append(resolve(override))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]
    if override in (None, "off", "observe", "auto"):
        assert got[0] == (override or "off")
    # The knob decides without an override, with the reference's parsing.
    monkeypatch.setenv("KA_CONTROLLER", " Observe ")
    assert resolve_policy(None) == jax_resolve_policy(None) == "observe"


def test_clusters_spec_controller_override(tmp_path, monkeypatch):
    a, b = fresh_dir(tmp_path, monkeypatch, ("a.json", "b.json"))
    spec = parse_clusters_spec(f"a={a}#controller=observe;b={b}")
    assert spec == jax_parse_clusters(f"a={a}#controller=observe;b={b}") \
        == {"a": f"{a}#controller=observe", "b": b}
    for pkg in PKGS:
        with controller_daemon(pkg, clusters=spec) as d:
            assert d.supervisors["a"].controller.policy == "observe"
            assert d.supervisors["b"].controller.policy == "off"
    # The object form carries the same override; an unknown key is refused
    # with the reference's message.
    for cls, kw in ((AssignerDaemon, {"device": "cpu"}), (JaxDaemon, {})):
        d2 = cls(clusters={"a": {"connect": a, "controller": "auto"}}, solver="greedy", **kw)
        assert d2.supervisors["a"].controller.policy == "auto"
    errors = []
    for cls, kw in ((AssignerDaemon, {"device": "cpu"}), (JaxDaemon, {})):
        with pytest.raises(ValueError) as info:
            cls(clusters={"a": {"connect": a, "bogus": 1}}, solver="greedy", **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# --- hysteresis under a flapping verdict ---------------------------------------------


def test_verdict_flap_under_hysteresis_never_acts(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    spec = ";".join(f"controller:{i}=verdict-flap" for i in range(4))

    def body(pkg, d):
        sup = d.supervisor()
        entries = [sup.controller.tick() for _ in range(4)]
        assert all(e["decision"] == "hold" and e["flapped"] is True for e in entries)
        return [scrub(e) for e in entries]

    out = run_both(tmp_path, monkeypatch, body, spec=spec)
    rec = out["torch"][1]
    assert "act" not in decisions(rec) and rec["views"]["default"]["streak"] == 0
    assert rec["snapshots"] == [json.dumps(IMBALANCED)]  # no write
    assert "controller.actions" not in rec["counters"]
    assert rec["counters"]["controller.holds"] == 4


def test_single_flap_resets_the_streak(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")

    def body(pkg, d):
        sup = d.supervisor()
        steps = [sup.controller.tick(), sup.controller.tick()]  # streak 1, flap
        streak_after_flap = sup.controller_view()["streak"]
        steps += [sup.controller.tick(), sup.controller.tick()]  # streak 1, 2
        return [e["decision"] for e in steps], streak_after_flap

    out = run_both(tmp_path, monkeypatch, body, spec="controller:1=verdict-flap")
    assert out["torch"][0] == out["jax"][0] == (["confirmed", "hold", "confirmed", "acted"], 0)
    rec = out["torch"][1]
    assert rec["counters"]["controller.actions"] == 1
    assert rec["snapshots"] != [json.dumps(IMBALANCED)]
    # The action's record is discarded; its forward journal stays, complete.
    names = sorted(rec["files"])
    assert not [n for n in names if n.endswith(".action.json")]
    (journal,) = [n for n in names if n.endswith(".journal")]
    assert rec["files"][journal]["status"] == "complete"
    assert rec["files"]["ka-controller-default.verdict.json"] == {
        "sha": None, "streak": 0, "version": 1}


# --- the blast radius ------------------------------------------------------------------


def _plan_text(cur, new):
    return ("CURRENT ASSIGNMENT:\n" + format_reassignment_json(cur, topic_order=["t"])
            + "\nNEW ASSIGNMENT:\n" + format_reassignment_json(new, topic_order=["t"])
            + "\n")


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 4, 5, 6])
def test_truncation_is_a_prefix_of_whole_partitions(cap):
    """Moves per partition p0 2, p1 1, p2 2, p3 a noop, p4 with no rollback
    anchor: a cap takes whole partitions in order and stops at the first
    that overflows, in both packages, bytes and fingerprint alike."""
    cur = {"t": {0: [1, 2], 1: [1, 2], 2: [1, 2], 3: [3, 4]}}
    new = {"t": {0: [3, 4], 1: [1, 3], 2: [3, 4], 3: [3, 4], 4: [1, 2]}}
    text = _plan_text(cur, new)
    got = RebalanceController._truncate(text, cap)
    assert got == JaxController._truncate(text, cap)
    out_text, moves, sha = got
    want = {0: 0, 1: 0, 2: 2, 3: 3, 4: 3, 5: 5, 6: 5}[cap]
    assert moves == want and bool(sha) == bool(want)
    if want:
        new_sub, order = parse_plan_payload(out_text)
        assert new_sub == jax_parse_plan(out_text)[0] and order == ["t"]
        assert list(new_sub["t"]) == [0, 1, 2][:len(new_sub["t"])]
        cur_sub, _ = parse_plan_payload(out_text, section="current")
        assert cur_sub == {"t": {p: cur["t"][p] for p in new_sub["t"]}}
    else:
        assert out_text == text


# --- observe ---------------------------------------------------------------------------


def test_observe_mode_decides_but_never_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "observe")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")

    def body(pkg, d):
        sup = d.supervisor()
        return [scrub(sup.controller.tick()) for _ in range(2)]

    out = run_both(tmp_path, monkeypatch, body)
    first, second = out["torch"][0]
    assert first["decision"] == second["decision"] == "would-act" and first["moves"] > 0
    rec = out["torch"][1]
    assert rec["snapshots"] == [json.dumps(IMBALANCED)]
    assert not [n for n in rec["files"] if n.endswith((".journal", ".action.json"))]
    assert rec["counters"]["controller.evaluations"] == 2
    assert "controller.actions" not in rec["counters"]
    assert "controller.moves" not in rec["counters"]


# --- the /controller endpoint ----------------------------------------------------------


def test_controller_endpoint_get_and_pause_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "observe")
    calls = [("GET", "/controller", None),
             ("POST", "/controller", {"action": "pause"}),
             ("POST", "/controller", {"action": "pause"}),
             ("POST", "/controller", {"action": "resume"}),
             ("POST", "/controller", {"action": "explode"}),
             ("POST", "/controller?action=pause", None),
             ("GET", "/clusters/default/controller", None),
             ("POST", "/clusters/default/controller", {"action": "resume"})]

    def body(pkg, d):
        return [(s, scrub(b)) for s, b, _ in
                (req(d.http_port, m, p, payload) for m, p, payload in calls)]

    out = run_both(tmp_path, monkeypatch, body)
    assert out["torch"][0] == out["jax"][0]
    got = out["torch"][0]
    assert [s for s, _ in got] == [200, 200, 200, 200, 400, 200, 200, 200]
    assert got[0][1]["policy"] == "observe" and got[0][1]["paused"] is False
    assert got[0][1]["breaker"] == {"state": "closed"}
    assert got[1][1]["paused"] is True and got[3][1]["paused"] is False
    assert "explode" in got[4][1]["error"]
    assert got[5][1]["paused"] is True and got[6][1]["cluster"] == "default"
    assert decisions(out["torch"][1]) == ["paused", "resumed", "paused", "resumed"]


def test_controller_routes_of_many_clusters(tmp_path, monkeypatch):
    """With many clusters the bare ``/controller`` is a 400 naming them, an
    unknown cluster a 404, and each cluster's view its own policy; the
    aggregate ``/state`` holds each cluster's ``controller`` key and the
    fleet's summary."""
    calls = [("GET", "/controller", None), ("POST", "/controller", {"action": "pause"}),
             ("GET", "/clusters/a/controller", None), ("GET", "/clusters/b/controller", None),
             ("POST", "/clusters/b/controller", {"action": "pause"}),
             ("GET", "/clusters/nope/controller", None)]

    def body(pkg, d):
        got = [(s, scrub(b)) for s, b, _ in
               (req(d.http_port, m, p, payload) for m, p, payload in calls)]
        _, state, _ = req(d.http_port, "GET", "/state")
        return got, {n: v["controller"] for n, v in state["clusters"].items()}, state["fleet"]

    out = {}
    for pkg in PKGS:
        _reset_planes()
        a, b = fresh_dir(tmp_path, monkeypatch, ("a.json", "b.json"))
        with controller_daemon(pkg, clusters={"a": f"{a}#controller=observe", "b": b}) as d:
            out[pkg] = body(pkg, d)
    assert out["torch"] == out["jax"]
    got, state, fleet = out["torch"]
    assert fleet == {"recovered": True, "leases": {}, "max_concurrent": 1,
                     "window": {"seconds": 3600.0, "max_moves": 64, "moves": 0}}
    assert [s for s, _ in got] == [400, 400, 200, 200, 200, 404]
    assert got[2][1]["policy"] == "observe" and got[3][1]["policy"] == "off"
    assert state == {"a": {"policy": "observe", "paused": False, "breaker": {"state": "closed"}},
                     "b": {"policy": "off", "paused": True, "breaker": {"state": "closed"}}}


# --- the execution engine's hooks ------------------------------------------------------


@pytest.mark.parametrize("wave_size", [1, 2, 8])
def test_engine_probe_and_on_verified_match_the_reference(tmp_path, monkeypatch, wave_size):
    """``PlanExecutor``'s ``probe`` fires once at each wave boundary, before
    the wave submits, and ``on_verified`` gets the state the verify pass
    read, as in the reference; the final snapshot and journal are the
    reference's."""
    monkeypatch.setenv("KA_EXEC_POLL_INTERVAL", "0.01")
    new = {"hot": {0: [3, 4], 1: [1, 3], 2: [2, 4], 3: [1, 2]}}
    seen = {}
    for pkg, executor_cls, backend_cls in (("torch", PlanExecutor, SnapshotBackend),
                                           ("jax", JaxExecutor, JaxSnapshot)):
        snap = tmp_path / f"{pkg}.json"
        snap.write_text(json.dumps(IMBALANCED))
        backend = backend_cls(str(snap))
        calls = []
        ex = executor_cls(
            backend, new, ["hot"], str(tmp_path / f"{pkg}.journal"),
            wave_size=wave_size, err=io.StringIO(),
            probe=lambda: calls.append(("probe", ex.outcome.waves_run)),
            on_verified=lambda observed: calls.append(("verified", observed)),
        )
        out = ex.execute()
        backend.close()
        journal = json.loads((tmp_path / f"{pkg}.journal").read_text())
        journal.pop("cluster", None)
        seen[pkg] = (calls, out.waves_total, snap.read_text(), journal, ex.plan_hash)
    assert seen["torch"] == seen["jax"]
    calls, waves = seen["torch"][:2]
    assert calls[:-1] == [("probe", i) for i in range(waves)]
    assert calls[-1] == ("verified", {"hot": {0: [3, 4], 1: [1, 3], 2: [2, 4], 3: [1, 2]}})
    # An asserted plan hash is the executor's identity, in both.
    for cls, backend_cls, pkg in ((PlanExecutor, SnapshotBackend, "torch"),
                                  (JaxExecutor, JaxSnapshot, "jax")):
        ex = cls(backend_cls(str(tmp_path / f"{pkg}.json")), new, ["hot"],
                 str(tmp_path / "x.journal"), plan_hash="f" * 64)
        assert ex.plan_hash == "f" * 64
