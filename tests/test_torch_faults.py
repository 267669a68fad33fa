"""The port's fault injection and failure policy (``faults/``,
``--failure-policy``) against the JAX package's, on the CPU: the cases of
``tests/test_faults.py`` that need no ZooKeeper wire, kazoo or AdminClient
fake, execution engine or daemon.

- the spec grammar, cluster addressing, the random schedule and its frozen
  order, the env injector cache, the loud ignore of a malformed spec, and
  the hook-level ``wave``, ``write``, ``converge``, ``reply`` and
  ``controller`` cases, each written once and run on both packages; the
  random schedules equal across the packages;
- the per-group greedy fallback of ``TopicAssigner``;
- the exit codes 4, 5 and 6: ``KA_FAULTS_SPEC=solve:0=crash`` under
  ``best-effort`` gives exit 6 with stdout byte-identical to ``--solver
  greedy``, and the report's ``solve.fallbacks`` and ``faults.injected``
  equal the reference's; under ``strict``, exit 4;
- the skipped topic on the one-shot read, the missing topic under strict
  (mode 3 tags it an ingest failure, exit 3; the other modes do not), and
  best-effort with nothing injected byte-identical to strict and to the
  JAX package;
- ``ka-groups`` best-effort plan and sweep against the reference's
  envelopes.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import types

import pytest

from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.cli import run_groups as jax_run_groups
from kafka_assigner_tpu_torch import cli

STRICT_ENV = ("KA_FAILURE_POLICY", "KA_FAULTS_SPEC", "KA_FAULTS_SEED",
              "KA_FAULTS_RATE", "KA_OBS_ENABLE", "KA_OBS_REPORT")


def _package(name: str) -> types.SimpleNamespace:
    root = "kafka_assigner_tpu" if name == "jax" else "kafka_assigner_tpu_torch"
    mod = lambda sub: importlib.import_module(f"{root}.{sub}")  # noqa: E731
    return types.SimpleNamespace(name=name, faults=mod("faults"),
                                 inject=mod("faults.inject"))


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(autouse=True)
def _fresh_injector(monkeypatch):
    """No installed injector and a cold env cache in either package (the
    cache is keyed by (spec, seed) and would leak consumed counters)."""
    for knob in STRICT_ENV:
        monkeypatch.delenv(knob, raising=False)
    for name in ("jax", "torch"):
        _package(name).faults.reset()
    yield
    for name in ("jax", "torch"):
        _package(name).faults.reset()


@pytest.fixture()
def snapshot(tmp_path):
    cluster = {
        "brokers": [
            {"id": 100 + i, "host": f"host{i}", "port": 9092, "rack": f"r{i % 3}"}
            for i in range(6)
        ],
        "topics": {
            "events": {str(p): [100 + (p + i) % 5 for i in range(3)] for p in range(6)},
            "logs": {str(p): [100 + (p + i) % 5 for i in range(2)] for p in range(4)},
        },
        "groups": {
            "g": {"members": {"c-0": 90.0, "c-1": None, "c-2": 25.0},
                  "assignment": {"events": {"0": "c-0", "1": "c-1", "4": "c-9"}},
                  "lag": {"events": {str(p): 10 * (p + 1) for p in range(6)}}},
        },
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return str(path)


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


# --- spec / schedule ------------------------------------------------------------

def test_parse_spec_explicit_events(pkg):
    FaultEvent = pkg.inject.FaultEvent
    events = pkg.faults.parse_spec(
        "reply:3=drop; reply:5=trunc:8 ;connect:0=blackhole;"
        "handshake:1=expire;solve=crash;reply:2=slow:0.01"
    )
    assert FaultEvent("reply", 3, "drop") in events
    assert FaultEvent("reply", 5, "trunc", 8.0) in events
    assert FaultEvent("connect", 0, "blackhole") in events
    assert FaultEvent("handshake", 1, "expire") in events
    assert FaultEvent("solve", 0, "crash") in events
    assert FaultEvent("reply", 2, "slow", 0.01) in events


@pytest.mark.parametrize("bad", [
    "reply:3", "nowhere:0=drop", "reply:0=expire", "reply:x=drop",
    "reply:-1=drop", "reply:0=slow:abc",
    "write:0=stall", "wave:0=drop",
    "session@:0=expire", "session@we st:0=expire", "session@w/e:0=expire",
    "controller:0=drop", "reply:0=verdict-flap",
])
def test_parse_spec_rejects_malformed(pkg, bad):
    with pytest.raises(pkg.faults.FaultSpecError):
        pkg.faults.parse_spec(bad)


@pytest.mark.parametrize("spec", [
    "reply:3=drop;reply:5=trunc:8;connect:0=blackhole;solve=crash",
    "write:0=drop;write:2=lost;converge:1=stall;wave:0=crash",
    "session@west:1=expire;resync@east-2:0=stall;watch@a.b:2=drop",
    "controller:0=verdict-flap;controller:1=exec-crash;controller@west:0=regress",
    "dispatch:0=crash;dispatch:1=stall:0.2;daemon:0=solver-crash",
    "fleet:0=lease-expire;fleet@a:1=ledger-torn;warmup:0=crash",
])
def test_parse_spec_is_the_references(spec):
    ref = _package("jax").faults.parse_spec(spec)
    got = _package("torch").faults.parse_spec(spec)
    assert [str(e) for e in got] == [str(e) for e in ref]
    assert [(e.scope, e.index, e.kind, e.arg, e.cluster) for e in got] \
        == [(e.scope, e.index, e.kind, e.arg, e.cluster) for e in ref]


def test_parse_spec_cluster_addressing_round_trips(pkg):
    FaultEvent = pkg.inject.FaultEvent
    events = pkg.faults.parse_spec(
        "session@west:1=expire;resync@east-2:0=stall;watch@a.b:2=drop"
    )
    assert FaultEvent("session", 1, "expire", None, "west") in events
    assert FaultEvent("resync", 0, "stall", None, "east-2") in events
    assert FaultEvent("watch", 2, "drop", None, "a.b") in events
    for ev in events:
        assert pkg.faults.parse_spec(str(ev)) == [ev]


def test_random_schedule_is_seed_deterministic(pkg):
    random_schedule = pkg.inject.random_schedule
    a = random_schedule(seed=7, rate=0.3)
    assert a == random_schedule(seed=7, rate=0.3)
    assert a != random_schedule(seed=8, rate=0.3)
    assert a


@pytest.mark.parametrize("seed, rate", [(0, 0.05), (7, 0.3), (12345, 0.5), (3, 1.0)])
def test_random_schedule_is_the_references(seed, rate):
    ref = _package("jax").faults.parse_spec("random", seed, rate)
    got = _package("torch").faults.parse_spec("random", seed, rate)
    assert [str(e) for e in got] == [str(e) for e in ref]


def test_random_schedule_order_is_frozen(pkg):
    inject = pkg.inject
    assert inject.RANDOM_ORDER[:5] == ("connect", "handshake", "reply", "solve", "warmup")
    assert set(inject.RANDOM_ORDER) == set(inject.FAULT_SCOPES)
    ref = _package("jax").inject
    assert inject.RANDOM_ORDER == ref.RANDOM_ORDER
    assert inject.FAULT_SCOPES == ref.FAULT_SCOPES
    assert inject.RANDOM_HORIZON == ref.RANDOM_HORIZON


def test_malformed_spec_env_is_ignored_loudly(pkg, monkeypatch, capsys):
    monkeypatch.setenv("KA_FAULTS_SPEC", "reply:0=warp")
    assert pkg.faults.active_injector() is None
    assert "ignoring malformed KA_FAULTS_SPEC" in capsys.readouterr().err


def test_env_injector_cached_per_spec(pkg, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "reply:0=slow:0.001")
    first = pkg.faults.active_injector()
    assert first is not None and pkg.faults.active_injector() is first
    monkeypatch.setenv("KA_FAULTS_SEED", "3")
    assert pkg.faults.active_injector() is not first


def test_install_wins_over_the_env_until_reset(pkg, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    mine = pkg.faults.FaultInjector([])
    pkg.faults.install(mine)
    assert pkg.faults.active_injector() is mine
    pkg.faults.fault_point("solve")  # the installed empty schedule: no crash
    pkg.faults.reset()
    with pytest.raises(pkg.faults.InjectedSolverCrash):
        pkg.faults.fault_point("solve")


# --- hooks ------------------------------------------------------------------------

def test_backend_reply_maps_kinds_to_adapter_failures(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec(
        "reply:0=drop;reply:1=nonode;reply:2=nonode;reply:3=slow:0.001"
    ))
    with pytest.raises(ConnectionResetError):
        inj.backend_reply()
    # The default missing-entity class: the reference's wire client's
    # NoNodeError; the port, which has no wire client, raises KeyError.
    default = (importlib.import_module("kafka_assigner_tpu.io.zkwire").NoNodeError
               if pkg.name == "jax" else KeyError)
    with pytest.raises(default):
        inj.backend_reply()
    with pytest.raises(KeyError):
        inj.backend_reply(missing_exc=KeyError)
    inj.backend_reply()
    inj.backend_reply()
    assert [e.kind for e in inj.fired] == ["drop", "nonode", "nonode", "slow"]


def test_filter_reply_and_handshake_rewrite_frames(pkg):
    import struct

    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec(
        "reply:0=trunc:5;reply:1=nonode;handshake:0=expire"
    ))
    frame = bytes(range(32))
    assert inj.filter_reply(frame, None) == frame[:5]
    got = inj.filter_reply(frame, None)
    assert got[:12] == frame[:12] and struct.unpack(">i", got[12:16])[0] == -101
    assert inj.filter_reply(frame, None) == frame
    assert inj.filter_handshake(b"x" * 40)[:16] == b"\x00" * 16
    with pytest.raises(ConnectionRefusedError):
        pkg.faults.FaultInjector(pkg.faults.parse_spec("connect:0=blackhole")) \
            .connect_attempt()


def test_wave_fault_point_raises_exec_crash(pkg):
    pkg.faults.install(pkg.faults.FaultInjector(pkg.faults.parse_spec("wave:1=crash")))
    pkg.faults.fault_point("wave")
    with pytest.raises(pkg.inject.InjectedExecCrash):
        pkg.faults.fault_point("wave")
    pkg.faults.fault_point("wave")


def test_write_and_converge_hooks(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec(
        "write:0=drop;write:1=lost;converge:0=stall"
    ))
    with pytest.raises(ConnectionResetError):
        inj.write_attempt()
    assert inj.write_attempt() == "lost"
    assert inj.write_attempt() is None
    assert inj.converge_poll() is True
    assert inj.converge_poll() is False


def test_cluster_events_fire_at_per_cluster_indexes(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("session@west:1=expire"))
    assert not inj.session_check(cluster="east")
    assert not inj.session_check(cluster="east")
    assert not inj.session_check(cluster="west")
    assert inj.session_check(cluster="west")
    assert not inj.session_check(cluster="west")


def test_clusterless_events_keep_the_global_counter(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("session:1=expire"))
    assert not inj.session_check(cluster="a")
    assert inj.session_check(cluster="b")
    inj2 = pkg.faults.FaultInjector(pkg.faults.parse_spec("watch:0=drop"))
    assert inj2.watch_delivery()


def test_cluster_scoped_resync_stall_raises_only_for_its_cluster(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("resync@a:0=stall"))
    inj.resync_attempt(cluster="b")
    with pytest.raises(pkg.inject.InjectedResyncStall):
        inj.resync_attempt(cluster="a")


def test_global_event_does_not_swallow_cluster_event(pkg):
    inj = pkg.faults.FaultInjector(
        pkg.faults.parse_spec("session:0=expire;session@west:0=expire"))
    assert inj.session_check(cluster="west")
    assert inj.session_check(cluster="west")
    assert len(inj.fired) == 2


def test_controller_point_keeps_per_kind_counters(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("controller:1=exec-crash"))
    assert inj.controller_point("verdict-flap") is False
    assert inj.controller_point("verdict-flap") is False
    assert inj.controller_point("exec-crash") is False
    with pytest.raises(pkg.inject.InjectedExecCrash):
        inj.controller_point("exec-crash")
    assert [str(e) for e in inj.fired] == ["controller:1=exec-crash"]


def test_controller_point_kind_mismatch_and_cluster_addressing(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("controller:0=regress"))
    assert inj.controller_point("exec-crash") is False
    assert inj.controller_point("verdict-flap") is False
    assert inj.controller_point("regress") is True
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("controller@a:0=verdict-flap"))
    assert inj.controller_point("verdict-flap", cluster="b") is False
    assert inj.controller_point("verdict-flap", cluster="a") is True
    assert inj.controller_point("verdict-flap", cluster="a") is False


def test_dispatch_and_daemon_hooks(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec(
        "dispatch:0=crash;dispatch:1=stall:0.001;daemon:0=solver-crash"))
    with pytest.raises(pkg.faults.InjectedSolverCrash):
        inj.dispatch_attempt()
    inj.dispatch_attempt()
    with pytest.raises(pkg.faults.InjectedSolverCrash):
        inj.daemon_solve()
    assert [e.kind for e in inj.fired] == ["crash", "stall", "solver-crash"]


def test_fault_counters_land_in_the_run(pkg, capsys):
    obs = importlib.import_module(
        ("kafka_assigner_tpu" if pkg.name == "jax" else "kafka_assigner_tpu_torch") + ".obs")
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("solve:0=crash;wave:0=crash"))
    with obs.run_capture() as run:
        with pytest.raises(pkg.faults.InjectedSolverCrash):
            inj.solve_attempt()
        with pytest.raises(pkg.inject.InjectedExecCrash):
            inj.wave_boundary()
    assert run.counters == {"faults.injected": 2, "faults.injected.crash": 2}
    assert capsys.readouterr().err.count("fault injected:") == 2


# --- the per-group fallback -------------------------------------------------------

def test_assigner_falls_back_to_greedy_per_group():
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.solvers.greedy import GreedySolver

    class Crashy(GreedySolver):
        name = "crashy"

        def assign(self, *a, **kw):
            raise RuntimeError("device OOM")

    topics = {"a": {0: [1, 2], 1: [2, 3]}, "b": {0: [3, 1]}}
    brokers = {1, 2, 3}
    oracle = TopicAssigner(solver="greedy").generate_assignments(
        list(topics.items()), brokers, {}, -1)
    best = TopicAssigner(solver=Crashy(), failure_policy="best-effort")
    assert best.generate_assignments(list(topics.items()), brokers, {}, -1) == oracle
    assert best.fallbacks == 2

    strict = TopicAssigner(solver=Crashy())
    with pytest.raises(RuntimeError, match="device OOM"):
        strict.generate_assignments(list(topics.items()), brokers, {}, -1)

    class Infeasible(GreedySolver):
        name = "infeasible"

        def assign(self, *a, **kw):
            raise ValueError("Partition 0 could not be fully assigned!")

    nofb = TopicAssigner(solver=Infeasible(), failure_policy="best-effort")
    with pytest.raises(ValueError, match="fully assigned"):
        nofb.generate_assignments(list(topics.items()), brokers, {}, -1)
    assert nofb.fallbacks == 0


def test_device_crash_falls_back_for_the_whole_batch_and_keeps_the_context():
    """The device solver takes every topic in one batch: one crash is one
    fallback for all of them, and the shared Context the greedy lane
    continues from is the one before the crash."""
    from kafka_assigner_tpu_torch import faults
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.solvers.greedy import GreedySolver

    topics = [("a", {p: [1 + (p + i) % 5 for i in range(3)] for p in range(6)}),
              ("b", {p: [1 + (p + i) % 5 for i in range(2)] for p in range(4)}),
              ("a", {p: [1 + (p + i) % 4 for i in range(3)] for p in range(3)})]
    brokers, racks = set(range(1, 7)), {b: f"r{b % 3}" for b in range(1, 7)}
    oracle = TopicAssigner(solver=GreedySolver()).generate_assignments(topics, brokers, racks)
    faults.install(faults.FaultInjector(faults.parse_spec("solve:0=crash")))
    best = TopicAssigner(device="cpu", failure_policy="best-effort")
    with contextlib.redirect_stderr(io.StringIO()) as err:
        got = best.generate_assignments(topics, brokers, racks)
    assert got == oracle and best.fallbacks == 1
    assert "device solver crashed (InjectedSolverCrash" in err.getvalue()
    assert "falling back to the greedy solver for 3 topic(s)" in err.getvalue()
    faults.install(faults.FaultInjector(faults.parse_spec("solve:0=crash")))
    with pytest.raises(faults.InjectedSolverCrash):
        TopicAssigner(device="cpu").generate_assignments(topics, brokers, racks)


# --- CLI exit codes ---------------------------------------------------------------

def test_exit_code_validation_failure(snapshot, capsys):
    rc = cli.run(["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
                  "--desired_replication_factor", "99", "--device", "cpu"])
    assert rc == cli.EXIT_VALIDATION
    assert "higher replication factor" in capsys.readouterr().err


def test_exit_code_solve_failure_strict(snapshot, monkeypatch, tmp_path):
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    report = tmp_path / "report.json"
    rc, out, err = _run(cli.run, ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
                                  "--device", "cpu", "--report-json", str(report)])
    assert rc == cli.EXIT_SOLVE
    assert "fault injected: solve" in err
    assert "error: solver backend crashed (InjectedSolverCrash)" in err
    assert "NEW ASSIGNMENT" not in out
    rep = json.loads(report.read_text())
    assert rep["status"] == "error" and rep["error"]["type"] == "SolveError"
    assert rep["metrics"]["counters"]["faults.injected"] == 1
    assert "solve.fallbacks" not in rep["metrics"]["counters"]


@pytest.mark.parametrize("how", ["flag", "knob"])
def test_exit_code_degraded_solver_fallback(snapshot, monkeypatch, tmp_path, how):
    """Under best-effort, a crashed device solve exits 6 with stdout
    byte-identical to ``--solver greedy``; the report's ``solve.fallbacks``
    and ``faults.injected`` equal the reference's."""
    base = ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT"]
    greedy = _run(cli.run, base + ["--solver", "greedy", "--device", "cpu"])
    assert greedy[0] == 0
    policy = ["--failure-policy", "best-effort"] if how == "flag" else []
    if how == "knob":
        monkeypatch.setenv("KA_FAILURE_POLICY", "best-effort")
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run, base + ["--solver", "tpu", "--report-json", str(a)] + policy)
    got = _run(cli.run, base + ["--device", "cpu", "--report-json", str(b)] + policy)
    assert ref[0] == got[0] == cli.EXIT_DEGRADED
    assert got[1] == greedy[1] == ref[1]
    assert "falling back to the greedy solver" in got[2]
    assert "degraded success: 0 topic(s) skipped, 1 solver fallback(s); exiting 6" in got[2]
    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    assert rb["status"] == ra["status"] == "degraded"
    for name in ("solve.fallbacks", "faults.injected", "faults.injected.crash",
                 "greedy.assigns", "greedy.partitions"):
        assert rb["metrics"]["counters"][name] == ra["metrics"]["counters"][name], name
    assert rb["metrics"]["counters"]["solve.fallbacks"] == 1
    assert rb["metrics"]["counters"]["faults.injected"] == 1
    assert rb["plan"] == ra["plan"]


def test_exit_code_degraded_skipped_topic(snapshot, monkeypatch, tmp_path):
    """A ``--topics`` entry the snapshot lacks is skipped under best-effort
    (the knob, not the flag): exit 6, the reference's stderr lines, the plan
    covering the surviving topics, stdout and gauges equal to the
    reference's."""
    monkeypatch.setenv("KA_FAILURE_POLICY", "best-effort")
    argv = ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
            "--topics", "events,ghost,logs,ghost"]
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run, argv + ["--solver", "tpu", "--report-json", str(a)])
    got = _run(cli.run, argv + ["--device", "cpu", "--report-json", str(b)])
    assert ref[0] == got[0] == cli.EXIT_DEGRADED
    assert got[1] == ref[1]
    assert got[2].count("topic 'ghost' vanished") == 2
    assert "2 topic read(s) vanished mid-scan; planning the remaining 2 topic(s)" in got[2]
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    payload = got[1].split("NEW ASSIGNMENT:\n", 1)[1].strip()
    assert set(parse_reassignment_json(payload)) == {"events", "logs"}
    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    assert rb["status"] == ra["status"] == "degraded"
    for name in ("ingest.topics", "ingest.topics_skipped", "plan.unplanned_topics"):
        assert rb["metrics"]["gauges"][name] == ra["metrics"]["gauges"][name], name
    assert rb["metrics"]["gauges"]["ingest.topics_skipped"] == 2
    assert rb["plan"]["unplanned_topics"] == ["ghost"]


def test_missing_topic_under_strict_keeps_its_key_error(snapshot, tmp_path):
    """The read keeps the snapshot's ``KeyError`` under strict; mode 3 tags
    it as the reference does: exit 3, stderr ``error: metadata ingest
    failed: ...`` equal to the reference's, the report's error an
    ``IngestError`` with the reference's message, nothing on stdout."""
    from kafka_assigner_tpu_torch.generator import stream_initial_assignment
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend

    with pytest.raises(KeyError, match="ghost"):
        stream_initial_assignment(SnapshotBackend(snapshot), ["events", "ghost"])
    argv = ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT", "--topics", "events,ghost"]
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run, argv + ["--report-json", str(a)])
    got = _run(cli.run, argv + ["--device", "cpu", "--report-json", str(b)])
    assert got[0] == ref[0] == cli.EXIT_INGEST
    assert got[1] == ref[1] == ""
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1] \
        == "error: metadata ingest failed: \"topics not in snapshot: ['ghost']\""
    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    assert rb["status"] == ra["status"] == "error"
    assert rb["error"] == ra["error"]
    assert rb["error"]["type"] == "IngestError"
    plain = argv[:-1] + ["ghost"]
    assert _run(cli.run, plain + ["--device", "cpu"])[2] == _run(jax_run, plain)[2]


@pytest.mark.parametrize("mode", [
    ["--mode", "PRINT_CURRENT_ASSIGNMENT"],
    ["--mode", "RANK_DECOMMISSION", "--integer_broker_ids", "100"],
])
def test_missing_topic_in_other_modes_stays_untagged(snapshot, mode):
    """The reference tags mode 3's read only: the other modes' read of a
    missing topic keeps its ``KeyError`` (exit 5) in both packages, with
    equal stdout and stderr."""
    argv = ["--zk_string", snapshot, "--topics", "events,ghost"] + mode
    ref = _run(jax_run, argv)
    got = _run(cli.run, argv + ["--device", "cpu"])
    assert got[0] == ref[0] == cli.EXIT_VALIDATION
    assert got[1:] == ref[1:]


def test_read_skips_a_missing_topic_as_the_reference_stream_does(snapshot):
    from kafka_assigner_tpu.generator import stream_initial_assignment
    from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JaxSnapshot
    from kafka_assigner_tpu_torch.generator import stream_initial_assignment as port_stream
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend

    topics = ["events", "ghost", "logs", "ghost"]
    ref_skipped, got_skipped = [], []
    with contextlib.redirect_stderr(io.StringIO()) as ref_err:
        ref, _ = stream_initial_assignment(JaxSnapshot(snapshot), topics,
                                           failure_policy="best-effort",
                                           skipped=ref_skipped)
    with contextlib.redirect_stderr(io.StringIO()) as got_err:
        got, _ = port_stream(SnapshotBackend(snapshot), topics,
                             failure_policy="best-effort", skipped=got_skipped)
    assert got == ref and got_skipped == ref_skipped == ["ghost", "ghost"]
    assert got_err.getvalue() == ref_err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--mode", "PRINT_REASSIGNMENT"],
    ["--mode", "PRINT_REASSIGNMENT", "--solver", "greedy"],
    ["--mode", "PRINT_REASSIGNMENT", "--topics", "logs,events"],
])
def test_best_effort_without_injection_is_byte_identical(snapshot, argv):
    """With nothing injected, strict and best-effort give the same stdout
    and exit 0, on the port and the JAX package alike."""
    base = ["--zk_string", snapshot] + argv
    jax_argv = base + ([] if "--solver" in argv else ["--solver", "tpu"])
    outs = []
    for fn, extra in ((jax_run, jax_argv), (cli.run, base + ["--device", "cpu"])):
        for policy in ([], ["--failure-policy", "best-effort"]):
            rc, out, _ = _run(fn, (extra if fn is jax_run else extra) + policy)
            assert rc == 0
            outs.append(out)
    assert len(set(outs)) == 1


def test_failure_policy_flag_is_validated(snapshot):
    with pytest.raises(SystemExit):
        _run(cli.run, ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
                       "--failure-policy", "lenient"])


def test_malformed_policy_knob_is_ignored_loudly(snapshot, monkeypatch):
    monkeypatch.setenv("KA_FAILURE_POLICY", "lenient")
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    rc, _, err = _run(cli.run, ["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
                                "--device", "cpu"])
    assert rc == cli.EXIT_SOLVE
    assert "ignoring unknown KA_FAILURE_POLICY='lenient'" in err


# --- ka-groups best-effort --------------------------------------------------------

@pytest.mark.parametrize("mode", [
    ["--mode", "plan"],
    ["--mode", "sweep", "--counts", "1,2,3", "--scales", "100,150"],
    ["--mode", "sweep", "--synthetic", "--weight", "throughput", "--scales", "100,"],
])
def test_groups_best_effort_matches_the_reference(snapshot, monkeypatch, tmp_path, mode):
    """``ka-groups --failure-policy best-effort`` with a crashed device solve:
    exit 6, the envelope equal to the reference's (``"solver":
    "greedy-fallback"``) and to the ``--solver greedy`` envelope but for that
    marker, the ``groups.*`` counters equal to the reference's."""
    base = ["--zk_string", snapshot] + mode
    greedy = _run(cli.run_groups, base + ["--solver", "greedy", "--device", "cpu"])
    assert greedy[0] == 0
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run_groups, base + ["--failure-policy", "best-effort",
                                       "--report-json", str(a)])
    got = _run(cli.run_groups, base + ["--failure-policy", "best-effort", "--device",
                                       "cpu", "--report-json", str(b)])
    assert ref[0] == got[0] == cli.EXIT_DEGRADED
    assert got[1] == ref[1]
    body, oracle = json.loads(got[1]), json.loads(greedy[1])
    assert body["solver"] == "greedy-fallback" and oracle["solver"] == "greedy"
    assert dict(body, solver="greedy") == oracle
    assert "degraded success" in got[2]
    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    assert rb["status"] == ra["status"] == "degraded"
    for name in ("groups.solve_fallbacks", "faults.injected", "groups.plans",
                 "groups.sweeps", "groups.moves", "groups.candidates"):
        assert rb["metrics"]["counters"].get(name) == ra["metrics"]["counters"].get(name)
    assert rb["metrics"]["counters"]["groups.solve_fallbacks"] == 1


def test_groups_strict_crash_exits_4(snapshot, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "solve:0=crash")
    monkeypatch.setattr("sys.argv", ["ka-groups", "--zk_string", snapshot,
                                     "--device", "cpu"])
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()) as err:
        cli.groups_main()
    assert e.value.code == cli.EXIT_SOLVE
    assert "groups packing solve crashed (InjectedSolverCrash" in err.getvalue()


def test_groups_best_effort_without_injection_is_byte_identical(snapshot):
    base = ["--zk_string", snapshot, "--mode", "plan", "--device", "cpu"]
    strict = _run(cli.run_groups, base)
    best = _run(cli.run_groups, base + ["--failure-policy", "best-effort"])
    assert strict[0] == best[0] == 0 and strict[1] == best[1]
    assert json.loads(best[1])["solver"] == "device"
