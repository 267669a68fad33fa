"""The port's rebalance controller against the JAX package's at the daemon
level, on the CPU, over snapshot clusters: the window ledger across a
daemon restart, a pause racing an action in flight, the two abort-to-
rollback paths, two ``auto`` clusters under the fleet scheduler, and the
shared ticker packing two clusters' evaluations into one dispatch.

Each comparison is the one of ``test_torch_controller.py`` (the decision
trail, the fleet's decisions, ``GET /controller``, the ledgers, memory and
journal files, the snapshot's bytes, less times).
"""
from __future__ import annotations

import contextlib
import json
import threading

import pytest

from kafka_assigner_tpu.io import snapshot as jax_snapshot
from kafka_assigner_tpu_torch.io import snapshot as torch_snapshot
from kafka_assigner_tpu_torch.obs import metrics as torch_metrics

from .test_torch_controller import (
    IMBALANCED,
    PKGS,
    _controller_env,  # noqa: F401  (the autouse fixture)
    _reset_planes,
    await_ready,
    controller_daemon,
    decisions,
    fresh_dir,
    record,
    run_both,
    scrub,
)
from .test_torch_daemon import _await

SNAPSHOT = {"torch": torch_snapshot, "jax": jax_snapshot}


@contextlib.contextmanager
def first_write_held(pkg):
    """The block's first replica-list write waits until the test sets
    ``release``: an action stays in flight, with its ``act`` decided, for
    as long as the test needs. ``entered`` is set when the write is held."""
    cls = SNAPSHOT[pkg].SnapshotBackend
    apply = cls.apply_assignment
    entered, release = threading.Event(), threading.Event()
    first = threading.Lock()

    def held(self, *args, **kw):
        if first.acquire(blocking=False):
            entered.set()
            assert release.wait(30), "the held write was never released"
        return apply(self, *args, **kw)

    cls.apply_assignment = held
    try:
        yield entered, release
    finally:
        release.set()
        cls.apply_assignment = apply


def test_window_cap_survives_a_daemon_restart(tmp_path, monkeypatch):
    """A truncated action spends the window; a fresh daemon on the same
    journal directory loads the ledger and holds on the spent budget."""
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")
    monkeypatch.setenv("KA_CONTROLLER_MAX_MOVES", "3")
    # Free movement: the leftover still recommends after the restart, so the
    # hold comes from the window, not the cost model.
    monkeypatch.setenv("KA_HEALTH_MOVE_COST", "0")
    out = {}
    for pkg in PKGS:
        _reset_planes()
        (snap,) = fresh_dir(tmp_path, monkeypatch)
        monkeypatch.setenv("KA_CONTROLLER_MAX_MOVES", "3")
        with controller_daemon(pkg, snap) as d:
            first = scrub(d.supervisor().controller.tick())
            spent = d.supervisor().controller_view()["window"]["moves"]
            rec1 = record(pkg, d, tmp_path / "run", [snap])
        # The live cap pinned to what the first daemon spent: the hold can
        # only come from the persisted ledger.
        monkeypatch.setenv("KA_CONTROLLER_MAX_MOVES", str(spent))
        _reset_planes()
        with controller_daemon(pkg, snap) as d2:
            loaded = d2.supervisor().controller_view()["window"]["moves"]
            second = scrub(d2.supervisor().controller.tick())
            rec2 = record(pkg, d2, tmp_path / "run", [snap])
        out[pkg] = (first, spent, rec1, loaded, second, rec2)
    assert out["torch"] == out["jax"]
    first, spent, rec1, loaded, second, rec2 = out["torch"]
    assert first["decision"] == "acted" and "truncate" in decisions(rec1)
    assert 0 < spent <= 3 and loaded == spent
    assert rec1["files"]["ka-controller-default.window.json"] == {"actions": [spent]}
    assert second["decision"] == "hold" and second["reason"] == "window budget spent"
    assert "controller.actions" not in rec2["counters"]


def test_pause_never_aborts_an_inflight_action(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")

    def body(pkg, d):
        sup = d.supervisor()
        box = {}
        with first_write_held(pkg) as (entered, release):
            t = threading.Thread(target=lambda: box.update(entry=sup.controller.tick()))
            t.start()
            assert entered.wait(20), "action never started"
            assert sup.execution_in_flight()
            paused = sup.controller.pause()["paused"]  # inside the action
            release.set()
            t.join(timeout=60)
        assert not t.is_alive()
        after_pause = sup.controller.tick()
        sup.controller.resume()
        await_ready(sup)
        after_resume = sup.controller.tick()
        return (paused, scrub(box["entry"]), after_pause, scrub(after_resume))

    out = run_both(tmp_path, monkeypatch, body)
    assert out["torch"][0] == out["jax"][0]
    paused, acted, after_pause, after_resume = out["torch"][0]
    # The action completed despite the pause; the pause gated the next tick.
    assert paused is True and acted["decision"] == "acted"
    assert after_pause is None and after_resume is not None
    trail = decisions(out["torch"][1])
    assert trail[:4] == ["act", "paused", "acted", "resumed"]


def test_exec_crash_mid_loop_rolls_back_byte_identically(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")
    monkeypatch.setenv("KA_CONTROLLER_COOLDOWN", "600")
    monkeypatch.setenv("KA_EXEC_WAVE_SIZE", "2")

    def body(pkg, d):
        sup = d.supervisor()
        entry = scrub(sup.controller.tick())
        await_ready(sup)
        held = scrub(sup.controller.tick())
        return entry, held

    # The crash lands at the second wave boundary: wave 0 moved replicas.
    out = run_both(tmp_path, monkeypatch, body, spec="controller:1=exec-crash")
    assert out["torch"][0] == out["jax"][0]
    entry, held = out["torch"][0]
    assert entry["decision"] == "rollback" and entry["ok"] is True
    assert held == {"seq": held["seq"], "decision": "hold",
                    "reason": "controller breaker open"}
    rec = out["torch"][1]
    for expected in ("act", "abort", "rollback", "breaker-open"):
        assert expected in decisions(rec)
    assert rec["views"]["default"]["breaker"] == {"state": "open"}
    # The assignment is the one before the action (the file is rewritten).
    assert json.loads(rec["snapshots"][0])["topics"] == IMBALANCED["topics"]
    # The superseded forward journal is gone, the rollback's is complete, the
    # action record is discarded.
    left = [n for n in rec["files"] if n.endswith(".journal")]
    assert len(left) == 1 and left[0].endswith(".rollback.journal")
    assert rec["files"][left[0]]["status"] == "complete"
    assert not [n for n in rec["files"] if n.endswith(".action.json")]
    assert rec["counters"]["controller.rollbacks"] == 1
    assert rec["counters"]["controller.breaker_opened"] == 1


def test_injected_regression_rolls_back_and_opens_breaker(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_CONTROLLER", "auto")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")
    monkeypatch.setenv("KA_CONTROLLER_COOLDOWN", "600")

    def body(pkg, d):
        return scrub(d.supervisor().controller.tick())

    out = run_both(tmp_path, monkeypatch, body, spec="controller:0=regress")
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["decision"] == "rollback" and out["torch"][0]["ok"] is True
    rec = out["torch"][1]
    abort = next(e for e in rec["views"]["default"]["decisions"] if e["decision"] == "abort")
    assert "regression" in abort["reason"]
    assert abort["delta"] is not None
    assert rec["views"]["default"]["breaker"] == {"state": "open"}
    assert json.loads(rec["snapshots"][0])["topics"] == IMBALANCED["topics"]
    assert rec["counters"]["controller.regressions"] == 1


# --- two auto clusters ------------------------------------------------------------------


def test_two_auto_clusters_act_one_after_the_other_as_the_reference(tmp_path, monkeypatch):
    """Two ``auto`` clusters ticked one after the other: each action's lease
    is released before the next tick, so the reference's fleet grants both
    and the trails compare byte for byte."""
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")

    def body(pkg, d):
        return [scrub(d.supervisors[n].controller.tick()) for n in ("a", "b")]

    run = tmp_path / "run"
    clusters = {"a": f"{run / 'a.json'}#controller=auto",
                "b": f"{run / 'b.json'}#controller=auto"}
    out = run_both(tmp_path, monkeypatch, body, names=("a.json", "b.json"),
                   clusters=clusters)
    assert out["torch"][0] == out["jax"][0]
    assert [e["decision"] for e in out["torch"][0]] == ["acted", "acted"]
    snaps = out["torch"][1]["snapshots"]
    assert snaps[0] == snaps[1] != json.dumps(IMBALANCED)


def test_a_second_auto_cluster_holds_on_the_fleet_cap_as_the_reference(tmp_path, monkeypatch):
    """A daemon of two ``auto`` clusters; ``b`` ticks while ``a``'s action
    is in flight (its first write held). The fleet (``KA_FLEET_MAX_CONCURRENT``
    1) defers ``b`` on its concurrency cap in both packages: ``b`` holds
    with ``fleet deferred`` / ``concurrency cap``, ``a`` acts, and the
    fleet's decisions are the same."""
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "1")
    out = {}
    for pkg in PKGS:
        _reset_planes()
        a, b = fresh_dir(tmp_path, monkeypatch, ("a.json", "b.json"))
        clusters = {"a": f"{a}#controller=auto", "b": f"{b}#controller=auto"}
        with controller_daemon(pkg, clusters=clusters) as d, \
                first_write_held(pkg) as (entered, release):
            sa, sb = d.supervisors["a"], d.supervisors["b"]
            box = {}
            t = threading.Thread(target=lambda: box.update(a=sa.controller.tick()))
            t.start()
            assert entered.wait(20), "a's action never started"
            entry_b = scrub(sb.controller.tick())  # a's first write still held
            release.set()
            t.join(timeout=60)
            assert not t.is_alive()
            out[pkg] = (scrub(box["a"]), entry_b,
                        scrub(sa.controller_view())["decisions"],
                        [e["decision"] for e in d.fleet.view()["decisions"]])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["decision"] == "acted"
    assert out["torch"][1] == {"seq": 1, "decision": "hold", "reason": "fleet deferred",
                               "fleet_reason": "concurrency cap"}
    assert out["torch"][3] == ["recovery-done", "granted", "deferred", "released"]


# --- the shared ticker ------------------------------------------------------------------


def _counter(name):
    """A counter of the daemon's cumulative registry, over its labels."""
    return sum(torch_metrics.cumulative().snapshot()["counters"].get(name, {}).values())


@pytest.mark.parametrize("policy", ["auto", "observe"])
def test_the_shared_ticker_packs_two_clusters_evaluations(tmp_path, monkeypatch, policy):
    """``#controller=auto`` (or ``observe``) on two clusters under
    ``KA_DISPATCH=1``: each round of the daemon's shared ticker releases
    both controllers at once, and their device-lane evaluations pack into
    one placement call (``dispatch.batches`` grows by one a round). Three
    confirmations keep two rounds from acting."""
    monkeypatch.setenv("KA_DISPATCH", "1")
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    monkeypatch.setenv("KA_CONTROLLER_CONFIRMATIONS", "3")
    a, b = fresh_dir(tmp_path, monkeypatch, ("a.json", "b.json"))
    clusters = {"a": f"{a}#controller={policy}", "b": f"{b}#controller={policy}"}
    with controller_daemon("torch", clusters=clusters, solver="device") as d:
        assert d.dispatcher is not None and d.ticker._thread is not None
        ctl = [d.supervisors[n].controller for n in ("a", "b")]
        batches = [_counter("dispatch.batches")]
        for round_ in (1, 2):
            d.ticker.advance()
            assert _await(lambda: all(len(c.view()["decisions"]) >= round_ for c in ctl),
                          timeout=60), [c.view()["decisions"] for c in ctl]
            batches.append(_counter("dispatch.batches"))
        trails = [[scrub(e) for e in c.view()["decisions"]] for c in ctl]
    assert batches[1] >= batches[0] + 1 and batches[2] >= batches[1] + 1, batches
    assert trails[0] == trails[1]
    assert [e["decision"] for e in trails[0]] == ["confirmed", "confirmed"]
    assert [e["streak"] for e in trails[0]] == [1, 2]
