"""The port's ZooKeeper write side (``kafka_assigner_tpu_torch/io/zkwire.py``
``create``/``set_data``/``delete`` and ``io/zk.py``'s execution surface)
against the JAX package's, on the CPU over the shared
``tests/jute_server.py`` and its simulated controller:

- the contracts of ``tests/test_zk_write.py`` on the port's
  ``MiniZkClient`` and ``ZkBackend``: the write opcodes over a real socket,
  the write read-back rule (never pipelined, never replayed blindly:
  reconnect, read back, decide), the pipelined ``iter_children`` fan-out
  and its replay, and ``ka-execute`` over ZooKeeper end to end;
- a create whose reply is dropped after the server applied it lands
  exactly once (``JuteZkServer.write_ops``), and writes never enter the
  pipelined window;
- parity: ``ka-execute`` over ZooKeeper by the reference and by the port
  leaves the same tree (``format_reassignment_json`` bytes), journal,
  stderr, exit code and run report (apart from milliseconds) for a forward
  run on both znode layouts, ``--rollback``, a kill at a wave boundary and
  ``--resume`` (also across the packages) and the ``write`` seams under
  both policies;
- the AdminClient's execution surface on the stand-in client of
  ``tests/test_faults.py``, equal to the reference's.
"""
from __future__ import annotations

import contextlib
import io
import json
import os

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import execute as jax_execute
from kafka_assigner_tpu_torch import faults
from kafka_assigner_tpu_torch.cli import EXIT_OK, execute
from kafka_assigner_tpu_torch.errors import ExecuteError
from kafka_assigner_tpu_torch.io.zk import ZkBackend
from kafka_assigner_tpu_torch.io.zkwire import (
    MiniZkClient,
    NodeExistsError,
    NoNodeError,
)
from kafka_assigner_tpu_torch.io.json_io import (
    format_reassignment_json,
    format_reassignment_pairs,
)

from .jute_server import (
    JuteZkServer,
    cluster_tree,
    cluster_tree_with_states,
    exec_snapshot_cluster,
)
from .test_torch_exec import _CLOCK, _MS, PACKAGES
from .test_torch_obs import _comparable


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture()
def zk_server():
    server = JuteZkServer(cluster_tree(), controller_delay_ops=1)
    server.start()
    yield server
    server.shutdown()


def _client(server):
    c = MiniZkClient(f"127.0.0.1:{server.port}")
    c.start()
    return c


# --- the write opcodes over a real socket ------------------------------------

def test_create_set_delete_exists_round_trip(zk_server):
    # A neutral path: /admin/reassign_partitions would wake the server's
    # simulated controller, which deletes the znode after applying it.
    c = _client(zk_server)
    try:
        assert c.exists("/wtest") is None
        path = c.create("/wtest", b'{"version":1}')
        assert path == "/wtest"
        assert c.exists("/wtest") is not None
        data, _ = c.get("/wtest")
        assert data == b'{"version":1}'
        with pytest.raises(NodeExistsError):
            c.create("/wtest", b"other")
        c.set_data("/wtest", b'{"version":2}')
        data, _ = c.get("/wtest")
        assert data == b'{"version":2}'
        c.delete("/wtest")
        assert c.exists("/wtest") is None
        with pytest.raises(NoNodeError):
            c.set_data("/ghost", b"x")
    finally:
        c.stop()
        c.close()
    assert zk_server.write_ops == {"create": 1, "setData": 1, "delete": 1}


def test_dropped_write_reply_is_not_blindly_replayed(zk_server, monkeypatch):
    """A reply-scope drop DURING a setData: the server applied the write,
    the client lost the ack. The write-safety rule demands reconnect →
    read-back → DECIDE: the read-back shows the bytes landed, so the client
    must NOT re-issue — the server sees exactly one setData op."""
    monkeypatch.setenv("KA_ZK_SESSION_RETRIES", "2")
    c = _client(zk_server)
    try:
        c.create("/wnode", b"v1")
        faults.install(faults.FaultInjector(
            faults.parse_spec("reply:0=drop")
        ))
        # fresh client so the injector is picked up at construction
    finally:
        c.stop()
        c.close()
    c = _client(zk_server)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            c.set_data("/wnode", b"v2")
        data, _ = c.get("/wnode")
        assert data == b"v2"
    finally:
        c.stop()
        c.close()
    assert "read-back shows it landed" in err.getvalue()
    assert zk_server.write_ops["setData"] == 1  # applied EXACTLY once
    faults.install(None)


def test_unsent_write_is_reissued_after_readback(zk_server, monkeypatch):
    """The other half of read-back-then-decide: the transport dies BEFORE
    the frame reaches the server, the read-back shows nothing landed, and
    the client re-issues — one applied write, after one visible retry."""
    monkeypatch.setenv("KA_ZK_SESSION_RETRIES", "2")
    c = _client(zk_server)
    real_send = MiniZkClient._send_frame
    state = {"broken": True}

    def flaky_send(self, payload):
        if state["broken"] and b"wnode2" in payload:
            state["broken"] = False
            self._sock.close()
            raise ConnectionResetError("wire cut before send")
        return real_send(self, payload)

    monkeypatch.setattr(MiniZkClient, "_send_frame", flaky_send)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            c.create("/wnode2", b"payload")
        data, _ = c.get("/wnode2")
        assert data == b"payload"
    finally:
        c.stop()
        c.close()
    assert zk_server.write_ops["create"] == 1


def test_create_makepath_materializes_parents(zk_server):
    """Real ZK refuses a create under a missing parent (the jute server
    does too); ``makepath=True`` must materialize the chain shallowest
    first — the semantics ZkBackend.apply_assignment relies on for
    /admin/reassign_partitions on a fresh cluster."""
    c = _client(zk_server)
    try:
        with pytest.raises(NoNodeError):
            c.create("/deep/nested/node", b"x")
        c.create("/deep/nested/node", b"x", makepath=True)
        data, _ = c.get("/deep/nested/node")
        assert data == b"x"
        assert c.exists("/deep") is not None
        assert c.exists("/deep/nested") is not None
    finally:
        c.stop()
        c.close()
    assert zk_server.write_ops["create"] == 3  # two parents + the node


# --- pipelined getChildren fan-out -------------------------------------------

def test_iter_children_matches_serial(zk_server, monkeypatch):
    monkeypatch.setenv("KA_ZK_PIPELINE", "4")
    c = _client(zk_server)
    try:
        paths = ["/brokers/ids", "/brokers/topics", "/brokers",
                 "/brokers/ids", "/brokers/topics"]
        piped = list(c.iter_children(paths))
        serial = [c.get_children(p) for p in paths]
        assert piped == serial
        assert piped[0] == ["1", "2", "3", "4"]
    finally:
        c.stop()
        c.close()


def test_iter_children_missing_ok_yields_none(zk_server):
    c = _client(zk_server)
    try:
        out = list(c.iter_children(
            ["/brokers/ids", "/ghost", "/brokers/topics"], missing_ok=True
        ))
        assert out[0] == ["1", "2", "3", "4"]
        assert out[1] is None
        assert out[2] == ["events", "logs"]
        with pytest.raises(NoNodeError):
            list(c.iter_children(["/brokers/ids", "/ghost"]))
    finally:
        c.stop()
        c.close()


@pytest.mark.parametrize("spec", ["reply:2=drop", "reply:3=trunc"])
def test_iter_children_replays_only_unanswered_reads(
    zk_server, monkeypatch, spec
):
    """Session death mid-window: the fan-out re-establishes and re-issues
    ONLY the not-yet-yielded children reads — output identical to an
    uninterrupted run (the read-path replay contract now covers
    getChildren too)."""
    monkeypatch.setenv("KA_ZK_PIPELINE", "3")
    monkeypatch.setenv("KA_ZK_SESSION_RETRIES", "2")
    paths = ["/brokers/ids", "/brokers/topics", "/brokers",
             "/brokers/ids", "/brokers/topics", "/brokers"]
    c = _client(zk_server)
    try:
        clean = list(c.iter_children(paths))
    finally:
        c.stop()
        c.close()
    faults.install(faults.FaultInjector(faults.parse_spec(spec)))
    c = _client(zk_server)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            healed = list(c.iter_children(paths))
    finally:
        c.stop()
        c.close()
    assert healed == clean
    assert "re-establishing" in err.getvalue()
    faults.install(None)


# --- the live-ZK execution path ----------------------------------------------

def _wire_env(monkeypatch):
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    monkeypatch.setenv("KA_EXEC_WAVE_SIZE", "2")
    monkeypatch.setenv("KA_EXEC_POLL_INTERVAL", "0.01")
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "10")


@pytest.mark.parametrize("treefn", [cluster_tree, cluster_tree_with_states])
def test_ka_execute_against_live_zk(tmp_path, monkeypatch, treefn):
    """End to end over the real wire protocol: plan file → waves written to
    /admin/reassign_partitions → the simulated controller applies them →
    convergence observed (topic znodes; plus ISR state znodes when the
    layout has them) → verify-after-move OK."""
    _wire_env(monkeypatch)
    server = JuteZkServer(treefn(), controller_delay_ops=1)
    server.start()
    try:
        plan = {
            "events": {0: [4, 3, 2], 1: [1, 2, 3]},
            "logs": {0: [2, 1]},
        }
        plan_path = tmp_path / "plan.json"
        plan_path.write_text(format_reassignment_pairs(
            [(t, plan[t]) for t in plan]
        ))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = execute([
                "--zk_string", f"127.0.0.1:{server.port}",
                "--plan", str(plan_path),
                "--journal", str(tmp_path / "j"),
            ])
        assert rc == EXIT_OK, err.getvalue()
        assert "verify-after-move OK" in err.getvalue()
        # The admin znode is cleaned up and the tree shows the targets.
        assert "/admin/reassign_partitions" not in server.tree
        events = json.loads(server.tree["/brokers/topics/events"])
        assert events["partitions"]["0"] == [4, 3, 2]
        if treefn is cluster_tree_with_states:
            state = json.loads(
                server.tree["/brokers/topics/events/partitions/0/state"]
            )
            assert state["isr"] == [4, 3, 2]
        assert server.write_ops["create"] >= 2  # one admin znode per wave
    finally:
        server.shutdown()


def test_apply_assignment_waits_out_a_stuck_admin_znode(monkeypatch):
    """An /admin/reassign_partitions left by another operator that never
    clears: apply_assignment must give up WITHIN the poll budget with the
    resumable ExecuteError, not hang."""
    _wire_env(monkeypatch)
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "0.2")
    tree = cluster_tree()
    tree["/admin/reassign_partitions"] = b'{"version":1,"partitions":[]}'
    server = JuteZkServer(tree, controller_delay_ops=10 ** 9)
    server.start()
    backend = ZkBackend(f"127.0.0.1:{server.port}")
    try:
        with pytest.raises(ExecuteError, match="already in flight"):
            backend.apply_assignment({"events": {0: [4, 3, 2]}})
    finally:
        backend.close()
        server.shutdown()


def test_zk_backend_state_poll_reads_isr_from_state_znodes(monkeypatch):
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    tree = cluster_tree_with_states()
    # A lagging follower: ISR smaller than the replica list.
    tree["/brokers/topics/events/partitions/0/state"] = json.dumps(
        {"isr": [1, 2], "leader": 1}
    ).encode()
    server = JuteZkServer(tree)
    server.start()
    backend = ZkBackend(f"127.0.0.1:{server.port}")
    try:
        state = backend.read_assignment_state(["events", "logs", "ghost"])
        assert state["events"][0].replicas == [1, 2, 3]
        assert state["events"][0].isr == [1, 2]       # from the state znode
        assert state["logs"][0].isr == [3, 4]
        assert "ghost" not in state
    finally:
        backend.close()
        server.shutdown()


# --- the read-back rule on a create, and the serial write path ----------------


def test_a_dropped_create_reply_lands_exactly_once(zk_server, monkeypatch):
    """The server applies the create and the reply is lost with the socket:
    the client re-establishes, reads back that the znode holds the written
    bytes, and does not re-issue. One create reaches the server."""
    monkeypatch.setenv("KA_ZK_SESSION_RETRIES", "2")
    faults.install(faults.FaultInjector(faults.parse_spec("reply:0=drop")))
    c = _client(zk_server)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            assert c.create("/admin_probe", b'{"version":1}') == "/admin_probe"
        assert c.get("/admin_probe")[0] == b'{"version":1}'
    finally:
        c.stop()
        c.close()
        faults.install(None)
    assert "read-back shows it landed; not re-issuing" in err.getvalue()
    assert zk_server.write_ops["create"] == 1


def test_writes_never_enter_the_pipelined_window(zk_server, monkeypatch):
    """Every write is one request and one reply before the next frame: a
    makepath create of a three-deep path, parents probed and created, never
    has two requests in flight."""
    monkeypatch.setenv("KA_ZK_PIPELINE", "8")
    c = _client(zk_server)
    events = []
    real_send, real_recv = MiniZkClient._send_frame, MiniZkClient._recv_reply

    def send(self, payload):
        events.append("send")
        return real_send(self, payload)

    def recv(self):
        events.append("recv")
        return real_recv(self)

    monkeypatch.setattr(MiniZkClient, "_send_frame", send)
    monkeypatch.setattr(MiniZkClient, "_recv_reply", recv)
    try:
        c.create("/a/b/c", b"x", makepath=True)
        c.set_data("/a/b/c", b"y")
        c.delete("/a/b/c")
    finally:
        monkeypatch.setattr(MiniZkClient, "_send_frame", real_send)
        monkeypatch.setattr(MiniZkClient, "_recv_reply", real_recv)
        c.stop()
        c.close()
    assert events and events == ["send", "recv"] * (len(events) // 2)
    assert zk_server.write_ops == {"create": 3, "setData": 1, "delete": 1}


# --- parity with the reference over ZooKeeper ---------------------------------


def _tree_plan_bytes(tree):
    """The topic znodes of a jute tree as canonical reassignment bytes."""
    topics = {}
    for path, raw in tree.items():
        parts = path.split("/")
        if len(parts) == 4 and path.startswith("/brokers/topics/"):
            topics[parts[3]] = {
                int(p): r for p, r in json.loads(raw)["partitions"].items()}
    order = sorted(topics)
    return format_reassignment_json(topics, topic_order=order)


@pytest.mark.parametrize("treefn", [cluster_tree, cluster_tree_with_states])
def test_ka_execute_over_zookeeper_matches_the_reference(tmp_path, monkeypatch,
                                                         treefn):
    _wire_env(monkeypatch)
    plan = {"events": {0: [4, 3, 2], 1: [1, 2, 3]}, "logs": {0: [2, 1]}}
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(format_reassignment_pairs([(t, plan[t]) for t in plan]))
    journal = tmp_path / "j"
    runs = {}
    for name, fn in (("jax", jax_execute), ("torch", execute)):
        for f in (faults, jax_faults):
            f.reset()
        if journal.exists():
            journal.unlink()
        server = JuteZkServer(treefn(), controller_delay_ops=1)
        server.start()
        spec = f"127.0.0.1:{server.port}"
        try:
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = fn(["--zk_string", spec, "--plan", str(plan_path),
                         "--journal", str(journal)])
            tree = dict(server.tree)
            creates = server.write_ops["create"]
        finally:
            server.shutdown()
        runs[name] = (rc, err.getvalue().replace(spec, "<zk>"),
                      journal.read_text().replace(spec, "<zk>"),
                      _tree_plan_bytes(tree), creates,
                      "/admin/reassign_partitions" in tree)
    assert runs["torch"] == runs["jax"]
    rc, err, _, final, _, in_flight = runs["torch"]
    assert rc == EXIT_OK and "verify-after-move OK" in err and not in_flight
    assert json.loads(final)["partitions"][0] == {
        "topic": "events", "partition": 0, "replicas": [4, 3, 2]}


# --- the AdminClient's execution surface (the stand-ins of test_faults.py) ----


def _kip455_client(monkeypatch, calls):
    import sys
    import types

    class KafkaAdminClient:
        def __init__(self, bootstrap_servers):
            pass

        def describe_topics(self, topics):
            data = {"events": [
                {"partition": 0, "replicas": [1, 2], "isr": [1]},
            ]}
            return [{"topic": t, "partitions": data[t]} for t in topics
                    if t in data]

        def alter_partition_reassignments(self, reassignments):
            calls.append(reassignments)

        def close(self):
            pass

    pkg = types.ModuleType("kafka")
    pkg.KafkaAdminClient = KafkaAdminClient
    monkeypatch.setitem(sys.modules, "kafka", pkg)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_admin_exec_surface_with_kip455(monkeypatch, package):
    if package == "jax":
        from kafka_assigner_tpu.io.kafka_admin import KafkaAdminBackend
        flt = jax_faults
    else:
        from kafka_assigner_tpu_torch.io.kafka_admin import KafkaAdminBackend
        flt = faults
    calls = []
    _kip455_client(monkeypatch, calls)
    # The injector is resolved when the backend is built: the second write
    # is acked and lost.
    flt.install(flt.FaultInjector(flt.parse_spec("write:1=lost")))
    try:
        backend = KafkaAdminBackend("b1:9092")
        assert backend.supports_execution() is True
        backend.apply_assignment({"events": {0: [2, 1]}})
        assert calls == [{("events", 0): [2, 1]}]
        state = backend.read_assignment_state(["events", "ghost"])
        assert list(state) == ["events"]
        assert state["events"][0].replicas == [1, 2]
        assert state["events"][0].isr == [1]  # the real ISR
        backend.apply_assignment({"events": {0: [9, 1]}})
        assert len(calls) == 1
    finally:
        flt.install(None)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_admin_without_kip455_refuses_execution(monkeypatch, package):
    from .test_backends import _install_fake_confluent

    if package == "jax":
        from kafka_assigner_tpu.errors import ExecuteError as Err
        from kafka_assigner_tpu.io.kafka_admin import KafkaAdminBackend
    else:
        from kafka_assigner_tpu_torch.errors import ExecuteError as Err
        from kafka_assigner_tpu_torch.io.kafka_admin import KafkaAdminBackend

    _install_fake_confluent(monkeypatch)
    backend = KafkaAdminBackend("b1:9092")
    assert backend.supports_execution() is False
    with pytest.raises(Err, match="cannot execute"):
        backend.apply_assignment({"events": {0: [1]}})
    state = backend.read_assignment_state(["events", "logs"])
    assert state["events"][1].replicas == [2, 1] and state["logs"][0].isr == [2]


def test_ka_execute_refuses_a_read_only_backend_before_any_journal(tmp_path,
                                                                   monkeypatch):
    # A backend without the execution surface is refused up front (exit 5),
    # as the reference refuses it, and no journal is written.
    from kafka_assigner_tpu_torch.cli import EXIT_VALIDATION
    from kafka_assigner_tpu_torch.io import base

    class ReadOnly:
        def close(self):
            pass

    monkeypatch.setattr(base, "open_backend", lambda spec: ReadOnly())
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(format_reassignment_pairs([("events", {0: [1, 2, 3]})]))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", "zk:2181", "--plan", str(plan_path)])
    assert rc == EXIT_VALIDATION and "cannot execute" in err.getvalue()
    assert not (tmp_path / "plan.json.journal").exists()


# --- ka-execute over ZooKeeper, both packages, every path ----------------------


def _exec_tree(states):
    """``exec_snapshot_cluster`` as znodes (9 brokers over 3 racks), with
    the per-partition ``state`` znodes when ``states``."""
    cluster = exec_snapshot_cluster()
    tree = {f"/brokers/ids/{b['id']}": json.dumps(
        {"host": b["host"], "port": b["port"], "rack": b["rack"]}).encode()
        for b in cluster["brokers"]}
    for t, parts in cluster["topics"].items():
        tree[f"/brokers/topics/{t}"] = json.dumps({"partitions": parts}).encode()
        for p, reps in parts.items():
            if states:
                tree[f"/brokers/topics/{t}/partitions/{p}/state"] = json.dumps(
                    {"isr": reps, "leader": reps[0]}).encode()
    return tree


@pytest.fixture(scope="module")
def zk_plan(tmp_path_factory):
    """A saved mode-3 stdout over the tree's cluster: greedy, h9 drained."""
    from kafka_assigner_tpu_torch.cli import run

    d = tmp_path_factory.mktemp("zk_exec_plan")
    src = d / "cluster.json"
    src.write_text(json.dumps(exec_snapshot_cluster()))
    out = io.StringIO()
    assert run(["--zk_string", str(src), "--mode", "PRINT_REASSIGNMENT", "--solver",
                "greedy", "--broker_hosts_to_remove", "h9", "--device", "cpu"],
               out=out) == 0
    plan = d / "plan.txt"
    plan.write_text(out.getvalue())
    return str(plan)


def _zk_drive(monkeypatch, tmp_path, plan, steps, states=False, clock=False):
    """``steps`` (``(package, extra argv, env)``) against one fresh jute
    server with the simulated controller; each step's exit code (or
    ``"crash"``), stderr and comparable report, then the tree's topics as
    canonical bytes and the journal, the server's port masked."""
    _wire_env(monkeypatch)
    monkeypatch.setenv("KA_EXEC_WAVE_SIZE", "3")
    journal, report = tmp_path / "zk.journal", tmp_path / "zk_report.json"
    for path in (journal, report):
        if path.exists():
            path.unlink()
    server = JuteZkServer(_exec_tree(states), controller_delay_ops=1)
    server.start()
    spec = f"127.0.0.1:{server.port}"
    out = {"steps": []}
    try:
        for pkg, extra, env in steps:
            fn, flt, crash = PACKAGES[pkg]
            for key, value in env.items():
                monkeypatch.setenv(key, value)
            for f in (faults, jax_faults):
                f.reset()
            if report.exists():
                report.unlink()
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                try:
                    rc = fn(["--zk_string", spec, "--plan", plan, "--journal",
                             str(journal), "--report-json", str(report), *extra])
                except crash:
                    rc = "crash"
            for key in env:
                monkeypatch.delenv(key)
            text = _MS.sub("<ms>", err.getvalue()).replace(spec, "<zk>")
            rep = _comparable(json.loads(report.read_text()))
            if clock:
                # The polls inside a poll budget, and the reads they make,
                # are the clock's count.
                text = _CLOCK.sub("spans=<n>", text)
                rep["counters"] = {
                    k: v for k, v in rep["counters"].items()
                    if k == "zk.writes" or not k.startswith(("zk.", "exec.retries"))}
            out["steps"].append((rc, text, rep))
        out["tree"] = _tree_plan_bytes(dict(server.tree))
        out["in_flight"] = "/admin/reassign_partitions" in server.tree
        out["journal"] = journal.read_text().replace(spec, "<zk>")
    finally:
        server.shutdown()
    return out


@pytest.mark.parametrize("name", ["forward", "forward-states", "rollback", "kill-resume"])
def test_ka_execute_paths_over_zookeeper_match_the_reference(tmp_path, monkeypatch,
                                                             zk_plan, name):
    steps = {
        "forward": [((), {})],
        "forward-states": [((), {})],
        # The rollback journals apart from the forward run (--journal is
        # given, so both runs name their own).
        "rollback": [((), {}), (("--rollback", "--journal", str(tmp_path / "rb.journal")),
                                {})],
        "kill-resume": [((), {"KA_FAULTS_SPEC": "wave:1=crash"}), (("--resume",), {})],
    }[name]
    runs = {pkg: _zk_drive(monkeypatch, tmp_path, zk_plan,
                           [(pkg, *s) for s in steps], states=name.endswith("states"))
            for pkg in ("jax", "torch")}
    assert runs["torch"] == runs["jax"]
    got = runs["torch"]
    assert not got["in_flight"]
    rcs = [rc for rc, _, _ in got["steps"]]
    assert rcs == (["crash", 0] if name == "kill-resume" else [0] * len(steps))
    plan = open(zk_plan, encoding="utf-8").read()
    section = "CURRENT ASSIGNMENT:" if name == "rollback" else "NEW ASSIGNMENT:"
    want = json.loads(plan.split(section, 1)[1].strip().splitlines()[0])
    final = {(e["topic"], e["partition"]): e["replicas"]
             for e in json.loads(got["tree"])["partitions"]}
    assert all(final[(e["topic"], e["partition"])] == e["replicas"]
               for e in want["partitions"])


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_resume_over_zookeeper_across_the_packages(tmp_path, monkeypatch, zk_plan,
                                                   first, second):
    kill = (first, (), {"KA_FAULTS_SPEC": "wave:1=crash"})
    mixed = _zk_drive(monkeypatch, tmp_path, zk_plan, [kill, (second, ("--resume",), {})])
    own = _zk_drive(monkeypatch, tmp_path, zk_plan, [kill, (first, ("--resume",), {})])
    assert mixed["tree"] == own["tree"] and mixed["journal"] == own["journal"]
    assert [s[0] for s in mixed["steps"]] == ["crash", 0]
    assert mixed["steps"][1][1] == own["steps"][1][1]
    assert json.loads(mixed["journal"])["status"] == "complete"


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
@pytest.mark.parametrize("spec", ["write:0=drop", "write:1=lost"])
def test_write_seams_over_zookeeper_match_the_reference(tmp_path, monkeypatch, zk_plan,
                                                        spec, policy):
    env = {"KA_FAULTS_SPEC": spec}
    clock = "lost" in spec
    if clock:
        env["KA_EXEC_POLL_TIMEOUT"] = "0.3"
    steps = [(("--failure-policy", policy), env)]
    runs = {pkg: _zk_drive(monkeypatch, tmp_path, zk_plan, [(pkg, *s) for s in steps],
                           clock=clock)
            for pkg in ("jax", "torch")}
    assert runs["torch"] == runs["jax"]
    rc, err, report = runs["torch"]["steps"][0]
    if clock:
        assert rc == (8 if policy == "strict" else 6), err
        assert bool(report["plan"].get("skipped_moves")) == (policy == "best-effort")
    else:
        assert rc == 0 and "never a blind replay" in err, err
        assert report["counters"]["exec.write_retries"] == 1
