"""The port's ZooKeeper watch surface (``io/zkwire.py``: the watch flag of
the reads, ``WatchEvent``, ``poll_watches``, ``session_generation``;
``io/zk.py``: ``watch_*``, ``poll_watch_events``, ``supports_watches``)
against the JAX package's, on the CPU:

- the cases of ``tests/test_daemon.py:90-182`` over a real socket to
  ``tests/jute_server.py``: data and child watches, a notification that
  arrives between replies, ``session_generation`` across a restart, each
  run on both packages' clients with equal results;
- a notification that lands inside a pipelined window, and one that lands
  during a write's read-back after a lost reply, on scripted frames: it is
  queued for ``poll_watches`` and never taken for a reply;
- the backend's normalized events and armed reads, equal to the
  reference's.

Every client times out within 5 s and every server is shut down by its
fixture.
"""
from __future__ import annotations

import struct
import time

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.io import zk as jax_zk
from kafka_assigner_tpu.io import zkwire as jax_wire
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.io import base as torch_base
from kafka_assigner_tpu_torch.io import zk as torch_zk
from kafka_assigner_tpu_torch.io import zkwire
from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
from kafka_assigner_tpu_torch.io.zkwire import (
    EVENT_CHILDREN_CHANGED,
    EVENT_DATA_CHANGED,
    EVENT_DELETED,
    MiniZkClient,
    WatchEvent,
)

from .jute_server import JuteZkServer, cluster_tree
from .test_zk_golden_frames import ScriptedSock, _g

TIMEOUT = 5.0
CLIENTS = {"jax": jax_wire.MiniZkClient, "torch": MiniZkClient}


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for knob in ("KA_ZK_PIPELINE", "KA_ZK_SESSION_RETRIES", "KA_FAULTS_SPEC"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
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


def _client(cls, port):
    c = cls(f"127.0.0.1:{port}", timeout=TIMEOUT)
    c.start()
    return c


def _events(events):
    return [(e.type, e.path) for e in events]


def _each_package(server, body):
    """``body(watcher, writer)`` with each package's client as the watcher
    (the port's client writes); returns ``{package: result}``."""
    out = {}
    for name, cls in CLIENTS.items():
        c = _client(cls, server.port)
        w = _client(MiniZkClient, server.port)
        try:
            out[name] = body(c, w)
        finally:
            c.close()
            w.close()
    return out


# --- over a real socket ---------------------------------------------------------


def test_wire_data_watch_fires_on_set_and_delete(server):
    def body(c, w):
        path = "/brokers/topics/events"
        seen = []
        c.get(path, watch=True)
        w.set_data(path, b'{"partitions": {"0": [1]}}')
        seen.append(_events(c.poll_watches(timeout=TIMEOUT)))
        # One-shot: a second change without re-arming fires nothing.
        w.set_data(path, b'{"partitions": {"0": [2]}}')
        seen.append(_events(c.poll_watches(timeout=0.3)))
        c.get(path, watch=True)
        w.delete(path)
        seen.append(_events(c.poll_watches(timeout=TIMEOUT)))
        w.create(path, b'{"partitions": {"0": [1, 2]}}')  # the next package's tree
        return seen

    got = _each_package(server, body)
    assert got["torch"] == got["jax"] == [
        [(EVENT_DATA_CHANGED, "/brokers/topics/events")],
        [],
        [(EVENT_DELETED, "/brokers/topics/events")],
    ]


def test_wire_child_watch_fires_on_create(server):
    def body(c, w):
        kids = c.get_children("/brokers/topics", watch=True)
        name = f"/brokers/topics/zzz{len(kids)}"
        w.create(name, b'{"partitions": {"0": [1, 2]}}')
        return kids[:2], _events(c.poll_watches(timeout=TIMEOUT))

    got = _each_package(server, body)
    assert got["torch"][0] == got["jax"][0] == ["events", "logs"]
    for name in CLIENTS:
        assert (EVENT_CHILDREN_CHANGED, "/brokers/topics") in got[name][1]


def test_wire_watch_notification_between_replies_is_queued(server):
    """A notification that arrives while a read is in flight does not
    disturb xid matching: it is queued for ``poll_watches``."""
    def body(c, w):
        c.get("/brokers/topics/logs", watch=True)
        w.set_data("/brokers/topics/logs", b'{"partitions": {"0": [3]}}')
        time.sleep(0.2)  # the notification reaches c's socket buffer
        data, _ = c.get("/brokers/topics/events")
        return b"partitions" in data, [e.path for e in c.poll_watches(timeout=1.0)]

    got = _each_package(server, body)
    assert got["torch"] == got["jax"] == (True, ["/brokers/topics/logs"])


def test_pipelined_window_over_a_socket_queues_notifications(server, monkeypatch):
    """Watch-armed pipelined reads (the daemon's resync) with notifications
    already on the socket: the window's results equal serial reads, and
    every notification comes out of ``poll_watches``."""
    monkeypatch.setenv("KA_ZK_PIPELINE", "4")
    paths = [f"/brokers/ids/{i}" for i in (1, 2, 3, 4)] + [
        "/brokers/topics/events", "/brokers/topics/logs"]
    c = _client(MiniZkClient, server.port)
    w = _client(MiniZkClient, server.port)
    try:
        serial = [c.get(p) for p in paths]
        assert c.get_many(paths, watch=True) == serial
        w.set_data("/brokers/ids/2", serial[1][0])
        w.set_data("/brokers/topics/logs", serial[5][0])
        time.sleep(0.2)
        assert [d for d, _ in c.get_many(paths, watch=True)] == [d for d, _ in serial]
        got = _events(c.poll_watches(timeout=1.0))
        assert sorted(got) == [(EVENT_DATA_CHANGED, "/brokers/ids/2"),
                               (EVENT_DATA_CHANGED, "/brokers/topics/logs")]
        assert list(c.iter_children(["/brokers/topics"], watch=True)) == [["events", "logs"]]
    finally:
        c.close()
        w.close()


def test_session_generation_bumps_on_restart(server):
    for cls in CLIENTS.values():
        c = _client(cls, server.port)
        try:
            g0 = c.session_generation
            assert g0 == 1
            c.stop()
            c.close()
            c.start()
            assert c.session_generation == g0 + 1
        finally:
            c.close()


def test_transparent_reconnect_bumps_generation(server, monkeypatch, capsys):
    """A read that loses its session and re-establishes it underneath: the
    answer is the same, and the generation tells the caller its watches
    are gone."""
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    monkeypatch.setenv("KA_FAULTS_SPEC", "reply:1=drop")
    torch_faults.reset()
    c = _client(MiniZkClient, server.port)
    try:
        first = c.get("/brokers/ids/1")
        assert c.session_generation == 1
        assert c.get("/brokers/ids/2")[0] != first[0]
        assert c.session_generation == 2
    finally:
        c.close()
    assert "re-establishing" in capsys.readouterr().err


# --- on scripted frames ------------------------------------------------------------


def _frame(xid: int, body: bytes = b"", err: int = 0, zxid: int = 0) -> bytes:
    payload = struct.pack(">iqi", xid, zxid, err) + body
    return struct.pack(">i", len(payload)) + payload


def _notification(ev_type: int, path: str) -> bytes:
    raw = path.encode()
    return _frame(-1, struct.pack(">ii", ev_type, 3) + struct.pack(">i", len(raw)) + raw,
                  zxid=-1)


def _get_reply(xid: int, data: bytes) -> bytes:
    stat = struct.pack(">qqqqiiiqiiq", 1, 1, 0, 0, 0, 0, 0, 0, len(data), 0, 1)
    return _frame(xid, struct.pack(">i", len(data)) + data + stat)


def _scripted(frames):
    client = MiniZkClient("127.0.0.1:2181", timeout=TIMEOUT)
    sock = ScriptedSock([_g("connect_response")] + list(frames))
    client._sock = sock
    client._handshake(10_000)
    sock.sent = b""
    return client, sock


@pytest.mark.parametrize("window", ["8", "1"])
def test_notification_inside_a_pipelined_window_is_queued(monkeypatch, window):
    """Replies for xids 1-3 with notifications before, between and after
    them (and out of order under a window of 8): the results are the
    replies, in request order, and the notifications are queued in
    arrival order."""
    monkeypatch.setenv("KA_ZK_PIPELINE", window)
    replies = [_get_reply(1, b"A"), _get_reply(2, b"B"), _get_reply(3, b"C")]
    if window == "8":
        replies = replies[::-1]
    frames = [_notification(EVENT_DATA_CHANGED, "/t/0"), replies[0],
              _notification(EVENT_CHILDREN_CHANGED, "/t"), replies[1],
              _notification(EVENT_DELETED, "/t/9"), replies[2]]
    client, sock = _scripted(frames)
    got = client.get_many(["/a", "/b", "/c"], watch=True)
    assert [d for d, _ in got] == [b"A", b"B", b"C"]
    assert sock.sent.count(b"\x01") >= 3  # every request carried the watch flag
    assert client.poll_watches(timeout=0) == [
        WatchEvent(EVENT_DATA_CHANGED, 3, "/t/0"),
        WatchEvent(EVENT_CHILDREN_CHANGED, 3, "/t"),
        WatchEvent(EVENT_DELETED, 3, "/t/9"),
    ]
    assert client.poll_watches(timeout=0) == []


def test_notification_during_a_write_readback_is_queued(monkeypatch):
    """A ``setData`` whose reply dies with the socket: the fresh session's
    read-back meets a notification before its reply; the notification is
    queued, the read-back's xid still matches, the write counts as landed
    and is not re-issued."""
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    client, first = _scripted([])  # the write's reply never arrives
    fresh = ScriptedSock([_notification(EVENT_DATA_CHANGED, "/admin/x"),
                          _get_reply(2, b"payload")])

    def reconnect(attempt, retries, err):
        client._sock = fresh
        client.session_generation += 1

    monkeypatch.setattr(client, "_reconnect", reconnect)
    assert client.set_data("/admin/x", b"payload") is None  # confirmed by read-back
    assert fresh.sent.count(b"/admin/x") == 1  # the read-back only, no re-issue
    assert client.poll_watches(timeout=0) == [
        WatchEvent(EVENT_DATA_CHANGED, 3, "/admin/x")]


def test_poll_watches_drops_pings_and_fails_on_a_stray_reply(server):
    c = _client(MiniZkClient, server.port)
    try:
        c.ping()
        assert c.poll_watches(timeout=0.3) == []  # the ping reply, consumed
        c.get("/brokers/ids/1")  # the session is still in step
        c._send_frame(struct.pack(">ii", 99, zkwire.OP_EXISTS)
                      + zkwire._pack_str("/brokers") + b"\x00")
        with pytest.raises(zkwire.ZkConnectionError, match="desynced"):
            c.poll_watches(timeout=TIMEOUT)
    finally:
        c.close()


def test_poll_watches_on_a_dead_socket_raises(server):
    c = _client(MiniZkClient, server.port)
    c._sock.close()
    with pytest.raises(zkwire.ZkConnectionError, match="polling watches"):
        c.poll_watches(timeout=0.1)
    c._sock = None
    assert c.poll_watches(timeout=0.1) == []


# --- the backend ------------------------------------------------------------------------


def test_backend_watch_surface_matches_the_reference():
    """Armed reads and normalized events, port and reference backends each
    on a fresh server: the same lists, assignments and events."""
    out = {}
    for name, mod in (("jax", jax_zk), ("torch", torch_zk)):
        server = JuteZkServer(cluster_tree())
        server.start()
        be = mod.ZkBackend(f"127.0.0.1:{server.port}")
        w = _client(MiniZkClient, server.port)
        try:
            assert be.supports_watches()
            gen = be.session_generation()
            seen = [be.watch_brokers(), be.watch_topic_list(),
                    be.watch_topic("events"), be.watch_topic("ghost"),
                    list(be.fetch_topics(["logs", "ghost"], missing="skip", watch=True))]
            w.set_data("/brokers/topics/logs", b'{"partitions": {"0": [4, 1]}}')
            w.create("/brokers/topics/fresh", b'{"partitions": {"0": [1]}}')
            w.create("/brokers/ids/5", b'{"host": "h5", "port": 9092, "rack": "r1"}')
            events = []
            deadline = time.monotonic() + TIMEOUT
            while len(events) < 3 and time.monotonic() < deadline:
                events += be.poll_watch_events(0.2)
            seen += [sorted(events, key=repr), be.watch_topic("logs"),
                     be.session_generation() == gen]
            out[name] = seen
        finally:
            be.close()
            w.close()
            server.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"][5] == sorted(
        [("brokers", None), ("topic", "logs"), ("topics", None)], key=repr)
    assert out["torch"][6] == {0: [4, 1]} and out["torch"][7] is True


def test_watchless_backends():
    assert torch_base.MetadataBackend.supports_watches(object()) is False
    assert not hasattr(SnapshotBackend, "supports_watches")
