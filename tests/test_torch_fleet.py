"""The port's fleet scheduler (``kafka_assigner_tpu_torch/daemon/fleet.py``)
against the JAX package's, on the CPU, over snapshot clusters.

Each case of ``tests/test_fleet.py`` runs here through both packages, one
after the other in the same directory (the same snapshot path, the same
journal directory), with the reference test's knobs and asserts, and the
two runs' records are compared, less times: the admission outcomes, the
fleet's ``view()`` and ``GET /fleet``, the bytes of ``ka-fleet.json``, the
journals, action records, window ledgers, verdict memories and snapshots,
the flight ``fleet`` and ``controller`` events, and the ``fleet.*`` and
``controller.*`` series of the cumulative registry.

Kills are simulated as the reference simulates them, by seams and by
planted journals and records; no case kills a process. The controller's
loop is parked (an hour's interval) and ticked by hand, and the resync
interval is an hour too (an action prompts its own resync), so nothing
lands between the two packages' runs that the other would not see.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import random
import shutil
import time
from types import SimpleNamespace

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.daemon.fleet import FleetScheduler as JaxFleet
from kafka_assigner_tpu.exec import journal as jax_journal
from kafka_assigner_tpu.io.json_io import format_reassignment_json as jax_format
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.daemon import AssignerDaemon, FleetScheduler
from kafka_assigner_tpu_torch.exec import journal as torch_journal
from kafka_assigner_tpu_torch.io.json_io import format_reassignment_json
from kafka_assigner_tpu_torch.obs import flight as torch_flight
from kafka_assigner_tpu_torch.obs import metrics as torch_metrics
from kafka_assigner_tpu_torch.obs import names as torch_names

from .test_torch_daemon import req

PKGS = ("torch", "jax")
P = {
    "torch": SimpleNamespace(
        name="torch", Fleet=FleetScheduler, faults=torch_faults, journal=torch_journal,
        flight=torch_flight, metrics=torch_metrics, fmt=format_reassignment_json),
    "jax": SimpleNamespace(
        name="jax", Fleet=JaxFleet, faults=jax_faults, journal=jax_journal,
        flight=jax_flight, metrics=jax_metrics, fmt=jax_format),
}
#: Keys that hold a wall-clock or monotonic time.
TIMES = frozenset({"t", "granted", "heartbeat", "retry_in_s", "cooldown_remaining_s"})
#: The reference test's cluster (``tests/test_controller.py``): four brokers
#: on four racks, every replica on brokers 1-2.
HOT_ORIG = {str(p): [1, 2] for p in range(4)}
EVENTS_ORIG = [1, 2, 3]
EVENTS_NEW = [2, 3, 4]


def _reset_planes():
    for p in P.values():
        p.faults.reset()
        p.metrics.disable_cumulative()
        p.flight.disable()


@pytest.fixture(autouse=True)
def _fleet_env(monkeypatch):
    """The reference tests' knobs, less their 0.2 s resync."""
    for knob in ("KA_CONTROLLER", "KA_FAULTS_SPEC", "KA_HEALTH_MOVE_COST",
                 "KA_EXEC_WAVE_SIZE", "KA_EXEC_SIM_POLLS", "KA_EXEC_THROTTLE",
                 "KA_DAEMON_WATCH", "KA_FAILURE_POLICY", "KA_CONTROLLER_WINDOW",
                 "KA_FLEET_MAX_MOVES", "KA_FLEET_WINDOW", "KA_FLEET_MAX_CONCURRENT",
                 "KA_FLEET_LEASE_TTL"):
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


def scrub(x):
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in TIMES}
    if isinstance(x, (list, tuple)):
        return [scrub(v) for v in x]
    return x


def ledger_bytes(run):
    """``ka-fleet.json`` with its times zeroed, as the scheduler writes it
    (the file must be that canonical form in the first place)."""
    path = run / "ka-fleet.json"
    if not path.exists():
        return None
    raw = path.read_text()
    body = json.loads(raw)
    assert json.dumps(body, sort_keys=True) == raw
    body["actions"] = [[0, n, c] for _t, n, c in body["actions"]]
    for lease in body["leases"].values():
        lease["granted"] = lease["heartbeat"] = 0
    return json.dumps(body, sort_keys=True)


def files_of(run):
    """Every other file of the directory: snapshots by their bytes, the rest
    parsed (the window ledger less its times)."""
    out = {}
    for name in sorted(os.listdir(run)):
        if name == "ka-fleet.json" or name.startswith("."):
            continue
        text = (run / name).read_text()
        if not name.startswith("ka-"):
            out[name] = text
            continue
        body = json.loads(text)
        if name.endswith(".window.json"):
            body = {"actions": [n for _t, n in body["actions"]]}
        out[name] = body
    return out


def observe(p, fs, run):
    """What a case compares at one point: the fleet's view, its ledger's
    bytes, the directory's files, the ``fleet`` and ``controller`` flight
    events and the ``fleet.*`` and ``controller.*`` series."""
    rec = p.flight.recorder()
    events = [scrub({k: v for k, v in e.items() if k != "seq"})
              for e in (rec.snapshot() if rec is not None else [])
              if e["kind"] in ("fleet", "controller")]
    cum = p.metrics.cumulative()
    series = {}
    if cum is not None:
        snap = cum.snapshot()
        for section in ("counters", "gauges"):
            for name, by in snap[section].items():
                if name.startswith(("fleet.", "controller.")):
                    series[f"{section}:{name}"] = sorted(by.items())
    return {
        "view": scrub(fs.view()),
        "ledger": ledger_bytes(run),
        "files": files_of(run),
        "events": events,
        "series": series,
    }


def both(tmp_path, monkeypatch, body):
    """``body(p, run)`` for each package from a fresh directory (the journal
    directory); asserts the two results equal and returns the port's."""
    out = {}
    for pkg in PKGS:
        _reset_planes()
        run = tmp_path / "run"
        shutil.rmtree(run, ignore_errors=True)
        run.mkdir()
        monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(run))
        out[pkg] = body(P[pkg], run)
        _reset_planes()
    assert out["torch"] == out["jax"]
    return out["torch"]


def install(p, spec):
    p.faults.install(p.faults.FaultInjector(p.faults.parse_spec(spec)))


def ready_scheduler(p):
    """A scheduler whose recovery gate is open (the empty scan a fresh
    journal directory gives at boot), its flight ring and registry on."""
    if p.metrics.cumulative() is None:
        p.metrics.enable_cumulative()
        p.flight.enable()
    fs = p.Fleet(err=io.StringIO())
    fs.recover({})
    return fs


def imbalanced_snapshot(run, name="cluster.json"):
    path = run / name
    path.write_text(json.dumps({
        "brokers": [{"id": i, "host": f"b{i}", "port": 9092, "rack": f"r{i}"}
                    for i in range(1, 5)],
        "topics": {"hot": dict(HOT_ORIG), "events": {"0": list(EVENTS_ORIG)}},
    }))
    return str(path)


def topics_of(path):
    with open(path) as f:
        return json.load(f)["topics"]


@contextlib.contextmanager
def controller_daemon(p, snap=None, **kw):
    """A started daemon of package ``p`` on the greedy lane, shut down on
    exit: ``(daemon, its one supervisor or None)``."""
    kw.setdefault("solver", "greedy")
    kw.setdefault("err", io.StringIO())
    if p.name == "torch":
        d = AssignerDaemon(snap, device="cpu", controller_rng=random.Random(7), **kw)
    else:
        d = JaxDaemon(snap, **kw)
    d.start()
    try:
        yield d, (d.supervisor() if snap is not None else None)
    finally:
        d.shutdown()


def _plan_text(p):
    return ("CURRENT ASSIGNMENT:\n"
            + p.fmt({"events": {0: list(EVENTS_ORIG)}}, topic_order=["events"])
            + "\nNEW ASSIGNMENT:\n"
            + p.fmt({"events": {0: list(EVENTS_NEW)}}, topic_order=["events"])
            + "\n")


def _forward_sha(p):
    return p.journal.plan_fingerprint({"events": {0: list(EVENTS_NEW)}}, ["events"])


def _rollback_sha(p):
    return p.journal.plan_fingerprint({"events": {0: list(EVENTS_ORIG)}}, ["events"])


def _write_journal(p, run, fname, plan_hash, moves, *, cluster, waves_committed=0):
    j = p.journal.ExecutionJournal(str(run / fname), plan_hash, 8, moves,
                                   waves_committed=waves_committed, cluster=cluster)
    j.save()
    return j.path


def _write_record(p, run, sha, *, aborted):
    path = run / f"ka-controller-default-{sha[:12]}.action.json"
    path.write_text(json.dumps({"version": 1, "cluster": "default", "sha": sha, "moves": 3,
                                "aborted": aborted, "plan_text": _plan_text(p)}))
    return str(path)


def _journal_files(run):
    return sorted(n for n in os.listdir(run) if n.endswith((".journal", ".action.json")))


def _decisions(view):
    return [e["decision"] for e in view["decisions"]]


# --- the admission lease API ------------------------------------------------------------


def test_admission_defers_until_recovery_ran(tmp_path, monkeypatch):
    def body(p, run):
        p.metrics.enable_cumulative()
        p.flight.enable()
        fs = p.Fleet(err=io.StringIO())
        first = fs.acquire("a", moves=1, sha="ab" * 32)
        assert first[0] == "deferred" and first[1]["reason"] == "recovery pending"
        fs.recover({})
        second = fs.acquire("a", moves=1, sha="ab" * 32)
        assert second[0] == "granted"
        return scrub([first, second]), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_concurrency_cap_and_release(tmp_path, monkeypatch):
    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=2, sha="aa" * 32)]
        assert got[0][0] == "granted" and got[0][1]["kind"] == "action"
        got.append(fs.acquire("b", moves=2, sha="bb" * 32))
        assert got[1][0] == "deferred"
        assert got[1][1]["holders"] == ["a"] and got[1][1]["max_concurrent"] == 1
        assert fs.release("a") is True
        got.append(fs.acquire("b", moves=2, sha="bb" * 32))
        assert got[2][0] == "granted"
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_budget_hold_and_refund(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_FLEET_MAX_MOVES", "10")

    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=8, sha="aa" * 32)]
        assert got[0][0] == "granted"
        fs.release("a")  # no refund: the 8 moves stay charged
        got.append(fs.acquire("b", moves=8, sha="bb" * 32))
        assert got[1][0] == "budget-hold"
        assert got[1][1]["window_moves"] == 8 and got[1][1]["max_moves"] == 10
        got.append(fs.acquire("b", moves=2, sha="bb" * 32))
        assert got[2][0] == "granted"
        fs.release("b", refund=True)
        got.append(fs.acquire("c", moves=2, sha="cc" * 32))
        assert got[3][0] == "granted"
        assert fs.view()["window"]["moves"] == 10
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_most_degraded_cluster_preempts_the_healthier_one(tmp_path, monkeypatch):
    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=1, sha="aa" * 32, score=1.0),
               fs.acquire("b", moves=1, sha="bb" * 32, score=5.0)]
        assert [g[0] for g in got] == ["granted", "deferred"]
        fs.release("a")
        got.append(fs.acquire("a", moves=1, sha="aa" * 32, score=1.0))
        assert got[2][0] == "preempted"
        assert got[2][1]["winner"] == "b" and got[2][1]["winner_score"] == 5.0
        got.append(fs.acquire("b", moves=1, sha="bb" * 32, score=5.0))
        assert got[3][0] == "granted"
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_lease_ttl_expires_a_crashed_holder(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_FLEET_LEASE_TTL", "0.1")

    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=1, sha="aa" * 32)]
        time.sleep(0.15)
        got.append(fs.acquire("b", moves=1, sha="bb" * 32))
        assert [g[0] for g in got] == ["granted", "granted"]
        assert fs.release("a") is False
        assert "lease-expired" in _decisions(fs.view())
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_heartbeat_keeps_a_live_holder_alive(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_FLEET_LEASE_TTL", "0.2")

    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=1, sha="aa" * 32)]
        for _ in range(3):
            time.sleep(0.1)
            fs.heartbeat("a")
        got.append(fs.acquire("b", moves=1, sha="bb" * 32))
        assert [g[0] for g in got] == ["granted", "deferred"]
        assert fs.release("a") is True
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


# --- the persisted ledger -------------------------------------------------------------


def test_ledger_persists_leases_and_budget_across_instances(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_FLEET_MAX_MOVES", "10")

    def body(p, run):
        fs1 = ready_scheduler(p)
        got = [fs1.acquire("a", moves=8, sha="aa" * 32)]
        first = observe(p, fs1, run)
        fs2 = ready_scheduler(p)
        got.append(fs2.acquire("b", moves=1, sha="bb" * 32))
        assert fs2.release("a") is True
        got.append(fs2.acquire("b", moves=8, sha="bb" * 32))
        assert [g[0] for g in got] == ["granted", "deferred", "budget-hold"]
        return scrub(got), first, observe(p, fs2, run)

    both(tmp_path, monkeypatch, body)


def test_corrupt_ledger_starts_fresh_loudly(tmp_path, monkeypatch):
    def body(p, run):
        (run / "ka-fleet.json").write_text("{torn!")
        err = io.StringIO()
        p.metrics.enable_cumulative()
        p.flight.enable()
        fs = p.Fleet(err=err)
        fs.recover({})
        got = fs.acquire("a", moves=1, sha="aa" * 32)
        assert got[0] == "granted"
        assert "unreadable" in err.getvalue()
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


def test_ledger_torn_seam_discards_the_read(tmp_path, monkeypatch):
    def body(p, run):
        fs1 = ready_scheduler(p)
        got = [fs1.acquire("a", moves=4, sha="aa" * 32)]
        install(p, "fleet:0=ledger-torn")
        fs2 = ready_scheduler(p)
        assert fs2.view()["leases"] == {}
        got.append(fs2.acquire("b", moves=1, sha="bb" * 32))
        assert [g[0] for g in got] == ["granted", "granted"]
        return scrub(got), observe(p, fs2, run)

    both(tmp_path, monkeypatch, body)


def test_lease_expire_seam_sweeps_every_lease(tmp_path, monkeypatch):
    def body(p, run):
        fs = ready_scheduler(p)
        got = [fs.acquire("a", moves=1, sha="aa" * 32)]
        install(p, "fleet:0=lease-expire")
        got.append(fs.acquire("b", moves=1, sha="bb" * 32))
        assert [g[0] for g in got] == ["granted", "granted"]
        assert fs.release("a") is False
        return scrub(got), observe(p, fs, run)

    both(tmp_path, monkeypatch, body)


# --- boot-time recovery ---------------------------------------------------------------


def test_orphaned_execute_journal_resumes_at_boot(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        sha = _forward_sha(p)
        path = _write_journal(p, run, f"ka-execute-default-{sha[:12]}.journal", sha,
                              [("events", 0, list(EVENTS_NEW))], cluster=snap)
        with controller_daemon(p, snap) as (d, sup):
            view = d.fleet.view()
            assert view["recovered"] is True
            assert view["recovery"]["resumed"] == 1
            assert view["leases"] == {}
            seen = observe(p, d.fleet, run)
        assert topics_of(snap)["events"]["0"] == EVENTS_NEW
        assert p.journal.ExecutionJournal.load(path).status == "complete"
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_interrupted_forward_action_resumes_at_boot(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        sha = _forward_sha(p)
        path = _write_journal(p, run, f"ka-controller-default-{sha[:12]}.journal", sha,
                              [("events", 0, list(EVENTS_NEW))], cluster=snap)
        _write_record(p, run, sha, aborted=False)
        with controller_daemon(p, snap) as (d, sup):
            assert d.fleet.view()["recovery"]["resumed"] == 1
            assert p.journal.ExecutionJournal.load(path).status == "complete"
            assert not [n for n in _journal_files(run) if n.endswith(".action.json")]
            seen = observe(p, d.fleet, run), scrub(sup.controller_view())
        assert topics_of(snap)["events"]["0"] == EVENTS_NEW
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_killed_mid_rollback_resumes_the_rollback_at_boot(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        before = topics_of(snap)
        sha = _forward_sha(p)
        data = json.loads(open(snap).read())
        data["topics"]["events"]["0"] = list(EVENTS_NEW)
        open(snap, "w").write(json.dumps(data))
        forward = _write_journal(p, run, f"ka-controller-default-{sha[:12]}.journal", sha,
                                 [("events", 0, list(EVENTS_NEW))], cluster=snap,
                                 waves_committed=1)
        _write_journal(p, run, f"ka-controller-default-{sha[:12]}.rollback.journal",
                       _rollback_sha(p), [("events", 0, list(EVENTS_ORIG))], cluster=snap)
        _write_record(p, run, sha, aborted=True)
        with controller_daemon(p, snap) as (d, sup):
            assert d.fleet.view()["recovery"]["rolled_back"] == 1
            assert sup.controller.breaker_view()["state"] == "open"
            seen = observe(p, d.fleet, run), scrub(sup.controller_view())
        assert topics_of(snap) == before
        left = _journal_files(run)
        assert not any(n.endswith(".action.json") for n in left)
        assert forward.split(os.sep)[-1] not in left
        rb = [n for n in left if n.endswith(".rollback.journal")]
        assert len(rb) == 1
        assert p.journal.ExecutionJournal.load(str(run / rb[0])).status == "complete"
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_aborted_action_without_rollback_journal_rolls_back(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        before = topics_of(snap)
        sha = _forward_sha(p)
        data = json.loads(open(snap).read())
        data["topics"]["events"]["0"] = list(EVENTS_NEW)
        open(snap, "w").write(json.dumps(data))
        _write_journal(p, run, f"ka-controller-default-{sha[:12]}.journal", sha,
                       [("events", 0, list(EVENTS_NEW))], cluster=snap, waves_committed=1)
        _write_record(p, run, sha, aborted=True)
        with controller_daemon(p, snap) as (d, sup):
            assert d.fleet.view()["recovery"]["rolled_back"] == 1
            seen = observe(p, d.fleet, run), scrub(sup.controller_view())
        assert topics_of(snap) == before
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_foreign_cluster_journal_is_left_untouched(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        sha = _forward_sha(p)
        path = _write_journal(p, run, f"ka-execute-default-{sha[:12]}.journal", sha,
                              [("events", 0, list(EVENTS_NEW))],
                              cluster="zk-elsewhere:2181/other")
        with controller_daemon(p, snap) as (d, sup):
            assert d.fleet.view()["recovery"]["skipped"] == 1
            seen = observe(p, d.fleet, run)
        assert p.journal.ExecutionJournal.load(path).status == "in-progress"
        assert topics_of(snap)["events"]["0"] == EVENTS_ORIG
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_recovery_crash_seam_retains_the_journal_for_the_next_boot(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        sha = _forward_sha(p)
        path = _write_journal(p, run, f"ka-execute-default-{sha[:12]}.journal", sha,
                              [("events", 0, list(EVENTS_NEW))], cluster=snap)
        install(p, "fleet:0=recovery-crash")
        with controller_daemon(p, snap) as (d, sup):
            view = d.fleet.view()
            assert view["recovery"]["failed"] == 1
            assert view["recovered"] is True
            crashed = observe(p, d.fleet, run)
        assert p.journal.ExecutionJournal.load(path).status == "in-progress"
        p.faults.reset()
        with controller_daemon(p, snap) as (d, sup):
            assert d.fleet.view()["recovery"]["resumed"] == 1
            resumed = observe(p, d.fleet, run)
        assert topics_of(snap)["events"]["0"] == EVENTS_NEW
        assert p.journal.ExecutionJournal.load(path).status == "complete"
        return crashed, resumed, files_of(run)

    seen = both(tmp_path, monkeypatch, body)
    assert seen[0]["series"]["counters:fleet.recovery_failures"] == [((), 1)]
    assert seen[1]["series"]["counters:fleet.recoveries"] == [((), 1)]


def test_orphan_action_record_is_swept_at_boot(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        record = _write_record(p, run, _forward_sha(p), aborted=False)
        with controller_daemon(p, snap) as (d, sup):
            seen = observe(p, d.fleet, run)
        assert not os.path.exists(record)
        assert topics_of(snap)["events"]["0"] == EVENTS_ORIG
        return seen, files_of(run)

    both(tmp_path, monkeypatch, body)


# --- the persisted verdict memory -----------------------------------------------------


def test_hysteresis_streak_survives_a_daemon_restart(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "3")

    def body(p, run):
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            ticks = [scrub(sup.controller.tick()) for _ in range(2)]
            assert [t["streak"] for t in ticks] == [1, 2]
            first = observe(p, d.fleet, run)
        with controller_daemon(p, snap) as (d, sup):
            entry = scrub(sup.controller.tick())
            assert entry["decision"] == "acted", entry
            second = observe(p, d.fleet, run), scrub(sup.controller_view())
        assert topics_of(snap) != {"hot": HOT_ORIG, "events": {"0": EVENTS_ORIG}}
        return ticks, first, entry, second, files_of(run)

    both(tmp_path, monkeypatch, body)


def test_stale_verdict_memory_resets_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")

    def body(p, run):
        (run / "ka-controller-default.verdict.json").write_text(
            json.dumps({"version": 99, "sha": "ff" * 32, "streak": 7}))
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            entry = scrub(sup.controller.tick())
            assert entry["decision"] == "confirmed" and entry["streak"] == 1
            assert "memory-reset" in _decisions(sup.controller_view())
            seen = observe(p, d.fleet, run), scrub(sup.controller_view())
        return entry, seen, files_of(run)

    seen = both(tmp_path, monkeypatch, body)
    assert seen[1][0]["series"]["counters:fleet.memory_resets"] == [((), 1)]


def test_acted_streak_reset_is_persisted(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")

    def body(p, run):
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            entry = scrub(sup.controller.tick())
            assert entry["decision"] == "acted"
            seen = observe(p, d.fleet, run)
        raw = json.loads((run / "ka-controller-default.verdict.json").read_text())
        assert raw["streak"] == 0 and raw["sha"] is None
        return entry, seen, files_of(run)

    both(tmp_path, monkeypatch, body)


# --- the controller's fleet gate ------------------------------------------------------


def test_single_cluster_action_acquires_and_releases_the_lease(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")

    def body(p, run):
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            entry = scrub(sup.controller.tick())
            assert entry["decision"] == "acted"
            view = d.fleet.view()
            assert view["leases"] == {}
            assert {"granted", "released"} <= set(_decisions(view))
            assert view["window"]["moves"] > 0
            seen = observe(p, d.fleet, run)
        return entry, seen, files_of(run)

    seen = both(tmp_path, monkeypatch, body)
    assert seen[1]["series"]["counters:fleet.grants"] == [((), 1)]


def test_fleet_denial_is_a_hold_that_keeps_hysteresis_warm(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")
    monkeypatch.setenv("KA_FLEET_MAX_MOVES", "1")

    def body(p, run):
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            entry = scrub(sup.controller.tick())
            assert entry["decision"] == "hold"
            assert entry["reason"] == "fleet budget-hold"
            assert sup.controller.view()["streak"] >= 1
            seen = observe(p, d.fleet, run), scrub(sup.controller_view())
        assert topics_of(snap)["events"]["0"] == EVENTS_ORIG
        return entry, seen, files_of(run)

    both(tmp_path, monkeypatch, body)


# --- the HTTP surface -----------------------------------------------------------------


def test_get_fleet_endpoint_single_mode(tmp_path, monkeypatch):
    def body(p, run):
        snap = imbalanced_snapshot(run)
        with controller_daemon(p, snap) as (d, sup):
            s, fleet, _ = req(d.http_port, "GET", "/fleet")
            assert s == 200
            assert fleet["recovered"] is True and fleet["leases"] == {}
            assert fleet["max_concurrent"] == 1 and fleet["window"]["max_moves"] == 64
            # The daemon-wide route has no per-cluster twin.
            miss = req(d.http_port, "GET", "/clusters/default/fleet")[:2]
            seen = observe(p, d.fleet, run)
        return s, scrub(fleet), miss, seen

    both(tmp_path, monkeypatch, body)


def test_multi_cluster_state_carries_the_fleet_summary(tmp_path, monkeypatch):
    def body(p, run):
        snap_a = imbalanced_snapshot(run, "a.json")
        snap_b = imbalanced_snapshot(run, "b.json")
        with controller_daemon(p, clusters={"a": snap_a, "b": snap_b}) as (d, _):
            s, state, _ = req(d.http_port, "GET", "/state")
            assert s == 200
            assert state["fleet"]["recovered"] is True and state["fleet"]["leases"] == {}
            s2, fleet, _ = req(d.http_port, "GET", "/fleet")
            assert s2 == 200 and fleet["recovered"] is True
            seen = observe(p, d.fleet, run)
        return scrub(state["fleet"]), sorted(state), scrub(fleet), seen

    got = both(tmp_path, monkeypatch, body)
    assert got[0] == {"recovered": True, "leases": {}, "max_concurrent": 1,
                      "window": {"seconds": 3600.0, "max_moves": 64, "moves": 0}}


# --- the port's own declarations ------------------------------------------------------


@pytest.mark.parametrize("knob", ["KA_FLEET_MAX_MOVES", "KA_FLEET_WINDOW",
                                  "KA_FLEET_MAX_CONCURRENT", "KA_FLEET_LEASE_TTL"])
@pytest.mark.parametrize("raw", [None, "7", "0", "-3", "2.5", "junk"])
def test_fleet_knobs_parse_as_the_reference(knob, raw, monkeypatch):
    """Each ``KA_FLEET_*`` knob: the reference's default, floor and parsing,
    read live."""
    from kafka_assigner_tpu.utils import env as jax_env
    from kafka_assigner_tpu_torch.utils import env as torch_env

    if raw is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, raw)
    read = "env_int" if knob in ("KA_FLEET_MAX_MOVES", "KA_FLEET_MAX_CONCURRENT") else "env_float"
    assert getattr(torch_env, read)(knob) == getattr(jax_env, read)(knob)


def test_every_flight_kind_the_port_records_is_declared():
    """Every literal first argument of ``flight.record`` in the port is a
    declared kind, ``fleet`` among them."""
    import re

    import kafka_assigner_tpu_torch as pkg

    root = os.path.dirname(pkg.__file__)
    kinds = set()
    for base, _dirs, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(base, name), encoding="utf-8") as f:
                    kinds |= set(re.findall(r'flight\.record\(\s*"([a-z]+)"', f.read()))
    assert "fleet" in kinds
    assert kinds <= torch_names.FLIGHT_KINDS, kinds - torch_names.FLIGHT_KINDS
