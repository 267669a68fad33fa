"""The port's live cluster I/O (``kafka_assigner_tpu_torch/io/zkwire.py``,
``io/zk.py``, ``io/kafka_admin.py``, ``io/base.py``, ``utils/backoff.py``)
against the JAX package's, on the CPU:

- the wire client over a real TCP socket to the in-repo jute server
  (``tests/jute_server.py``): the cases of ``tests/test_zk_socket.py``, each
  result equal to the reference client's on the same tree;
- the client's request frames against the spec-derived goldens of
  ``tests/golden/zk_jute_frames.json`` (the cases of
  ``tests/test_zk_golden_frames.py``);
- ``JitteredBackoff`` against the reference's on the same seeds;
- the ZooKeeper backend over the socket and over a stand-in kazoo, and the
  Kafka AdminClient bridge over stand-in client modules (``sys.modules``, as
  ``tests/test_backends.py``): brokers, topics, traffic, groups and the
  rack-blind refusal, each equal to the reference's;
- the port's CLI over the jute server, stdout byte-identical to the JAX
  CLI's on every mode-3 lane, the current-state modes, the fresh
  placement and the ranking; the ingest failures' exit codes, stderr and
  run reports; and the read-seam rows of ``scripts/chaos_soak.py
  --matrix`` through ``KA_FAULTS_SPEC``.

Every client uses a timeout of 5 s or less, every server is shut down by
its fixture, and retry sleeps are short or patched out.
"""
from __future__ import annotations

import contextlib
import io
import json
import random
import socket
import sys
import types

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.io import kafka_admin as jax_admin
from kafka_assigner_tpu.io import zk as jax_zk
from kafka_assigner_tpu.io import zkwire as jax_wire
from kafka_assigner_tpu.utils.backoff import JitteredBackoff as JaxBackoff
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.io import base as torch_base
from kafka_assigner_tpu_torch.io import kafka_admin as torch_admin
from kafka_assigner_tpu_torch.io import zk as torch_zk
from kafka_assigner_tpu_torch.io import zkwire
from kafka_assigner_tpu_torch.io.zkwire import (
    MiniZkClient,
    NoNodeError,
    ZkWireError,
    parse_hosts,
)
from kafka_assigner_tpu_torch.utils.backoff import JitteredBackoff

from .jute_server import JuteZkServer, cluster_tree
from .test_zk_golden_frames import GOLDEN, ScriptedSock, _g

TIMEOUT = 5.0
ZK_KNOBS = ("KA_ZK_CLIENT", "KA_ZK_PIPELINE", "KA_ZK_CONNECT_RETRIES",
            "KA_ZK_SESSION_RETRIES", "KA_ZK_INGEST_CHUNK", "KA_ZK_OVERLAP",
            "KA_FAULTS_SPEC", "KA_FAILURE_POLICY", "KA_OBS_REPORT", "KA_OBS_ENABLE")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for knob in ZK_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    jax_faults.reset()
    torch_faults.reset()
    yield
    jax_faults.reset()
    torch_faults.reset()


def _serve(request, tree, **kw):
    server = JuteZkServer(tree, **kw)
    server.start()
    request.addfinalizer(server.shutdown)
    return server


@pytest.fixture()
def zk_server(request):
    return _serve(request, cluster_tree())


def _dead_port() -> int:
    """A port just bound and released: connecting to it is refused."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _both_clients(port, chroot=""):
    """A started client of each package on the same server."""
    out = []
    for cls in (jax_wire.MiniZkClient, MiniZkClient):
        c = cls(f"127.0.0.1:{port}{chroot}", timeout=TIMEOUT)
        c.start()
        out.append(c)
    return out


def _close(*clients):
    for c in clients:
        c.stop()
        c.close()


# --- the wire client over a real socket ----------------------------------------

@pytest.mark.parametrize("hosts", [
    "h1:2181,h2:2182", "h1:2181/kafka", "h1", " h1:1 , ,h2:2/a/b/", "zk:2181/",
])
def test_parse_hosts(hosts):
    assert parse_hosts(hosts) == jax_wire.parse_hosts(hosts)


def test_parse_hosts_refuses_an_empty_quorum():
    with pytest.raises(ZkWireError, match="no ZooKeeper endpoints"):
        parse_hosts(",")


def test_wire_client_reads_over_real_socket(zk_server):
    ref, got = _both_clients(zk_server.port)
    try:
        assert got.get_children("/brokers/ids") == ["1", "2", "3", "4"] \
            == ref.get_children("/brokers/ids")
        data, stat = got.get("/brokers/ids/1")
        assert json.loads(data)["host"] == "h1"
        assert stat.dataLength == len(data)
        assert (data, stat) == ref.get("/brokers/ids/1")
        assert got.exists("/brokers/ids/2") == ref.exists("/brokers/ids/2")
        assert got.exists("/brokers/ids/99") is None
        with pytest.raises(NoNodeError):
            got.get("/brokers/ids/99")
        with pytest.raises(NoNodeError):
            got.get_children("/nope")
        got.ping()  # the ping reply is skipped by the next read
        assert got.get_children("/brokers/topics") == ["events", "logs"]
    finally:
        _close(ref, got)


def test_wire_client_chroot(request):
    server = _serve(request, {f"/kafka{p}": d for p, d in cluster_tree().items()})
    ref, got = _both_clients(server.port, "/kafka")
    try:
        assert got.get_children("/brokers/topics") == ["events", "logs"] \
            == ref.get_children("/brokers/topics")
        assert got.get("/brokers/topics/logs")[0] == ref.get("/brokers/topics/logs")[0]
    finally:
        _close(ref, got)


def test_zk_backend_over_real_socket(zk_server):
    ref = jax_zk.ZkBackend(f"127.0.0.1:{zk_server.port}")
    got = torch_zk.ZkBackend(f"127.0.0.1:{zk_server.port}")
    try:
        assert got.brokers() == [
            torch_base.BrokerInfo(1, "h1", 9092, "ra"),
            torch_base.BrokerInfo(2, "h2", 9093, "rb"),  # endpoint-resolved
            torch_base.BrokerInfo(3, "h3", 9092, "rc"),
            torch_base.BrokerInfo(4, "h4", 9092, "ra"),
        ]
        assert [tuple(vars(b).values()) for b in got.brokers()] \
            == [tuple(vars(b).values()) for b in ref.brokers()]
        assert got.all_topics() == ref.all_topics() == ["events", "logs"]
        topics = ["events", "logs", "events"]
        assert got.partition_assignment(topics) == ref.partition_assignment(topics)
        assert list(got.fetch_topics(topics)) == list(ref.fetch_topics(topics))
        assert list(got.fetch_topics(["ghost", "logs"], missing="skip")) \
            == list(ref.fetch_topics(["ghost", "logs"], missing="skip")) \
            == [("ghost", None), ("logs", {0: [3, 4]})]
        assert not got.supports_traffic()
        assert got.fetch_partition_traffic({"logs": [0]}) \
            == ref.fetch_partition_traffic({"logs": [0]})
    finally:
        ref.close()
        got.close()


@pytest.mark.parametrize("meta", [
    {"host": "h", "port": 9092},
    {"host": None, "endpoints": ["SSL://secure-host:9093"]},
    {"host": None, "endpoints": ["PLAINTEXT://h1:9092", "SSL://h1:9093"]},
    {"host": "h", "port": None},
])
def test_zk_endpoint_resolution(meta):
    assert torch_zk._resolve_endpoint(meta, "1") == jax_zk._resolve_endpoint(meta, "1")


def test_zk_endpoint_resolution_fails_loudly():
    with pytest.raises(ValueError, match="no resolvable host"):
        torch_zk._resolve_endpoint({"host": None, "endpoints": []}, "7")


def test_start_falls_through_refused_endpoint(zk_server):
    client = MiniZkClient(f"127.0.0.1:{_dead_port()},127.0.0.1:{zk_server.port}",
                          timeout=TIMEOUT)
    client.start()
    try:
        assert client.get_children("/brokers/topics") == ["events", "logs"]
    finally:
        _close(client)


def test_start_exhausts_retries_loudly(monkeypatch, capsys):
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "2")
    sleeps = []
    monkeypatch.setattr(zkwire.time, "sleep", sleeps.append)
    client = MiniZkClient(f"127.0.0.1:{_dead_port()},127.0.0.1:{_dead_port()}",
                          timeout=0.5)
    with pytest.raises(ZkWireError, match=r"after 2 pass\(es\)"):
        client.start()
    assert "connect pass 1/2 failed" in capsys.readouterr().err
    assert len(sleeps) == 1


def test_start_succeeds_on_retry_pass(monkeypatch, request):
    # Nothing listens on the port for the first pass; the server comes up
    # during the backoff (the patched sleep brings it up) and a later pass
    # lands the session.
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "5")
    port = _dead_port()

    def bring_up(_delay):
        if not started:
            started.append(_serve(request, cluster_tree(), port=port))

    started: list = []
    monkeypatch.setattr(zkwire.time, "sleep", bring_up)
    client = MiniZkClient(f"127.0.0.1:{port}", timeout=2.0)
    client.start()
    try:
        assert started and client.get_children("/brokers/topics") == ["events", "logs"]
    finally:
        _close(client)


def test_session_expired_handshake_retries_to_success(monkeypatch, request):
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "3")
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    server = _serve(request, cluster_tree(), expire_handshakes=1)
    client = MiniZkClient(f"127.0.0.1:{server.port}", timeout=2.0)
    client.start()
    try:
        assert client.get_children("/brokers/topics") == ["events", "logs"]
    finally:
        _close(client)


def test_session_expired_handshake_exhausts_loudly(monkeypatch, capsys, request):
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "2")
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    server = _serve(request, cluster_tree(), expire_handshakes=99)
    client = MiniZkClient(f"127.0.0.1:{server.port}", timeout=2.0)
    with pytest.raises(ZkWireError, match="session expired during handshake"):
        client.start()
    assert "connect pass 1/2 failed" in capsys.readouterr().err


@pytest.mark.parametrize("u", [0.0, 0.25, 1.0])
def test_connect_backoff_is_jittered_as_the_reference(monkeypatch, u):
    """The pass backoff draws 0.5x-1.5x the nominal step, the reference's
    schedule: the same sleeps for the same draws."""
    sleeps: list = []
    monkeypatch.setattr(zkwire.time, "sleep", sleeps.append)
    monkeypatch.setattr(random, "random", lambda: u)
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "3")
    runs = []
    for cls in (jax_wire.MiniZkClient, MiniZkClient):
        sleeps.clear()
        with pytest.raises(Exception, match="after 3 pass"):
            cls(f"127.0.0.1:{_dead_port()}", timeout=0.2).start()
        runs.append(list(sleeps))
    assert runs[0] == runs[1] == [pytest.approx(0.1 * (0.5 + u)),
                                  pytest.approx(0.2 * (0.5 + u))]


def test_get_many_matches_serial_gets(zk_server, monkeypatch):
    paths = [f"/brokers/ids/{i}" for i in (1, 2, 3, 4)] + [
        "/brokers/topics/events", "/brokers/topics/logs"]
    ref, client = _both_clients(zk_server.port)
    monkeypatch.setenv("KA_ZK_PIPELINE", "1")
    try:
        serial = [client.get(p) for p in paths]
        assert client.get_many(paths) == serial
        assert [d for d, _ in ref.get_many(paths)] == [d for d, _ in serial]
        for window in ("2", "3", "64"):
            monkeypatch.setenv("KA_ZK_PIPELINE", window)
            assert client.get_many(paths) == serial
            assert list(client.iter_children(["/brokers/ids", "/brokers/topics"])) \
                == [["1", "2", "3", "4"], ["events", "logs"]]
        assert client.get_many(["/brokers/ids/1", "/x", "/brokers/ids/2"],
                               missing_ok=True) == [serial[0], None, serial[1]]
        with pytest.raises(NoNodeError, match="/brokers/ids/99"):
            client.get_many(["/brokers/ids/1", "/brokers/ids/99", "/brokers/ids/2"])
        assert client.get("/brokers/ids/3") == serial[2]  # session still usable
    finally:
        _close(ref, client)


def test_iter_get_abandonment_drains_the_window(zk_server, monkeypatch):
    monkeypatch.setenv("KA_ZK_PIPELINE", "8")
    client = MiniZkClient(f"127.0.0.1:{zk_server.port}", timeout=TIMEOUT)
    client.start()
    try:
        paths = [f"/brokers/ids/{i}" for i in (1, 2, 3, 4)]
        for i, _ in enumerate(client.iter_get(paths)):
            if i == 0:
                break  # 3 replies still in flight
        data, _ = client.get("/brokers/ids/3")
        assert json.loads(data)["host"] == "h3"
        assert client.get_children("/brokers/topics") == ["events", "logs"]
    finally:
        _close(client)


def test_session_drop_mid_batch_replays_unanswered_reads(zk_server, monkeypatch, capsys):
    """A reply dropped mid-window re-establishes the session and replays
    only the unanswered reads: the same results as an uninterrupted
    batch."""
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    paths = [f"/brokers/ids/{i}" for i in (1, 2, 3, 4)]
    client = MiniZkClient(f"127.0.0.1:{zk_server.port}", timeout=TIMEOUT)
    client.start()
    try:
        clean = client.get_many(paths)
    finally:
        _close(client)
    monkeypatch.setenv("KA_FAULTS_SPEC", "reply:2=drop")
    torch_faults.reset()
    client = MiniZkClient(f"127.0.0.1:{zk_server.port}", timeout=TIMEOUT)
    client.start()
    try:
        assert client.get_many(paths) == clean
    finally:
        _close(client)
    assert "re-establishing and replaying" in capsys.readouterr().err


# --- frames against the spec-derived goldens -----------------------------------

def _fresh_client(replies):
    client = MiniZkClient("127.0.0.1:2181", timeout=10.0)
    sock = ScriptedSock([_g("connect_response")] + list(replies))
    client._sock = sock
    client._handshake(10_000)
    sock.sent = b""
    return client, sock


def test_client_frames_match_spec_goldens():
    client = MiniZkClient("127.0.0.1:2181", timeout=10.0)
    sock = ScriptedSock([_g("connect_response"), _g("get_children_response"),
                         _g("get_data_response"), _g("close_response")])
    client._sock = sock
    client._handshake(10_000)
    assert sock.sent == _g("connect_request")
    sock.sent = b""
    assert client.get_children("/brokers/ids") == ["1", "2"]
    assert sock.sent == _g("get_children_request")
    sock.sent = b""
    data, stat = client.get("/brokers/ids/1")
    assert data == b"DATA1"
    assert (stat.czxid, stat.dataLength, stat.numChildren) == (1, 5, 0)
    assert sock.sent == _g("get_data_request")
    sock.sent = b""
    client.stop()
    assert sock.sent == _g("close_request")


@pytest.mark.parametrize("window", ["8", "1"])
def test_pipelined_get_many_matches_spec_goldens(monkeypatch, window):
    """Two pipelined gets (replies out of order under a window of 8, in
    order under the serial window of 1): the request bytes are the goldens
    and the decodes equal serial gets on the same frames."""
    monkeypatch.setenv("KA_ZK_PIPELINE", window)
    serial_client, _ = _fresh_client(
        [_g("pipelined_get_response_1"), _g("pipelined_get_response_2")])
    serial = [serial_client.get("/brokers/ids/1"), serial_client.get("/brokers/ids/2")]
    replies = [_g("pipelined_get_response_1"), _g("pipelined_get_response_2")]
    client, sock = _fresh_client(replies[::-1] if window == "8" else replies)
    results = client.get_many(["/brokers/ids/1", "/brokers/ids/2"])
    assert sock.sent == _g("pipelined_get_request_1") + _g("pipelined_get_request_2")
    assert results == serial and [d for d, _ in results] == [b"DATA1", b"DATA2"]


def test_pipelined_mid_batch_error_xid(monkeypatch):
    monkeypatch.setenv("KA_ZK_PIPELINE", "8")
    serial_client, _ = _fresh_client([_g("pipelined_get_response_1")])
    serial_first = serial_client.get("/brokers/ids/1")
    client, sock = _fresh_client([
        _g("pipelined_err_response_3"),        # a later xid lands first
        _g("pipelined_get_response_1"),
        _g("pipelined_err_response_2_nonode"),  # the mid-batch error
    ])
    got = []
    with pytest.raises(NoNodeError, match="/nope"):
        for item in client.iter_get(["/brokers/ids/1", "/nope", "/brokers/ids/2"]):
            got.append(item)
    assert sock.sent == (_g("pipelined_get_request_1") + _g("pipelined_err_request_2_nope")
                         + _g("pipelined_err_request_3"))
    assert got == [serial_first]


def test_goldens_cover_every_client_request():
    requests = {k for k in GOLDEN if k.endswith("_request") or "_request_" in k}
    assert {"connect_request", "get_children_request", "get_data_request",
            "close_request", "pipelined_get_request_1", "pipelined_get_request_2",
            "pipelined_err_request_2_nope", "pipelined_err_request_3"} <= requests


# --- backoff --------------------------------------------------------------------

@pytest.mark.parametrize("seed,base,factor,cap", [
    (42, 0.1, 2.0, 2.0), (7, 0.05, 2.0, 1.0), (0, 0.5, 1.5, 2.5), (3, 0.1, 2.0, None),
])
def test_backoff_equals_the_reference_on_seeds(seed, base, factor, cap):
    ours = JitteredBackoff(base, factor=factor, cap=cap, rng=random.Random(seed))
    ref = JaxBackoff(base, factor=factor, cap=cap, rng=random.Random(seed))
    for _ in range(12):
        assert ours.peek_nominal() == ref.peek_nominal()
        assert ours.next_delay() == ref.next_delay()
    ours = JitteredBackoff(base, factor=factor, cap=cap, rng=random.Random(seed))
    ref = JaxBackoff(base, factor=factor, cap=cap, rng=random.Random(seed))
    for k in (1, 2, 3, 5, 9):
        assert ours.delay_for(k) == ref.delay_for(k)


def test_backoff_bounds_and_errors(monkeypatch):
    b = JitteredBackoff(1.0, cap=1.0)
    assert all(0.5 <= b.next_delay() < 1.5 for _ in range(200))
    for bad in (lambda: JitteredBackoff(-1.0), lambda: JitteredBackoff(1.0, factor=0.5),
                lambda: JitteredBackoff(1.0).delay_for(0)):
        with pytest.raises(ValueError):
            bad()
    slept = []
    monkeypatch.setattr("kafka_assigner_tpu_torch.utils.backoff.time.sleep", slept.append)
    d = JitteredBackoff(0.2, rng=random.Random(1)).sleep()
    assert slept == [d]


# --- backends: dispatch, stand-in kazoo, stand-in admin clients -------------------

def test_open_backend_dispatch(tmp_path, monkeypatch):
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend

    path = tmp_path / "c.json"
    path.write_text(json.dumps({"brokers": [], "topics": {}}))
    assert isinstance(torch_base.open_backend(f"file://{path}"), SnapshotBackend)
    assert isinstance(torch_base.open_backend(str(path)), SnapshotBackend)
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "1")
    with pytest.raises(ZkWireError, match="ZooKeeper session"):
        torch_base.open_backend(f"127.0.0.1:{_dead_port()}")
    with pytest.raises(RuntimeError, match="confluent-kafka|kafka-python"):
        torch_base.open_backend("kafka://broker:9092")
    if "kazoo" not in sys.modules:
        monkeypatch.setenv("KA_ZK_CLIENT", "kazoo")
        with pytest.raises(RuntimeError, match="kazoo"):
            torch_base.open_backend("zkhost:2181")


def _install_fake_kazoo(monkeypatch, znodes, async_window=False):
    """An in-memory kazoo (``znodes``: dir path -> {name: data}); with
    ``async_window`` it also offers ``get_async`` and records the most
    handles outstanding at once."""

    class Handle:
        def __init__(self, owner, path):
            self.owner, self.path = owner, path

        def get(self, timeout=None):
            self.owner.outstanding -= 1
            return self.owner.get(self.path)

    class FakeKazooClient:
        instances: list = []

        def __init__(self, hosts, timeout):
            self.hosts, self.timeout = hosts, timeout
            self.started = self.stopped = self.closed = False
            self.outstanding = self.max_outstanding = 0
            FakeKazooClient.instances.append(self)

        def start(self, timeout=None):
            self.started = True

        def get_children(self, path):
            return list(znodes[path])

        def get(self, path):
            parent, _, name = path.rpartition("/")
            if name not in znodes.get(parent, {}):
                raise type("NoNodeError", (Exception,), {})(path)
            return znodes[parent][name].encode(), object()

        def stop(self):
            self.stopped = True

        def close(self):
            self.closed = True

    if async_window:
        def get_async(self, path):
            self.outstanding += 1
            self.max_outstanding = max(self.max_outstanding, self.outstanding)
            return Handle(self, path)

        FakeKazooClient.get_async = get_async
    pkg = types.ModuleType("kazoo")
    client_mod = types.ModuleType("kazoo.client")
    client_mod.KazooClient = FakeKazooClient
    pkg.client = client_mod
    monkeypatch.setitem(sys.modules, "kazoo", pkg)
    monkeypatch.setitem(sys.modules, "kazoo.client", client_mod)
    return FakeKazooClient


KAZOO_ZNODES = {
    "/brokers/ids": {
        "2": json.dumps({"host": None, "endpoints": ["PLAINTEXT://h2:9093"], "rack": None}),
        "10": json.dumps({"host": "h10", "port": 9092, "rack": "rb"}),
        "1": json.dumps({"host": "h1", "port": 9092, "rack": "ra"}),
    },
    "/brokers/topics": {
        f"t{i}": json.dumps({"partitions": {"1": [2, 1], "0": [1, 10]}}) for i in range(8)
    },
}


@pytest.mark.parametrize("async_window", [False, True])
def test_zk_backend_over_stand_in_kazoo(monkeypatch, async_window):
    monkeypatch.setenv("KA_ZK_CLIENT", "auto")
    monkeypatch.setenv("KA_ZK_PIPELINE", "3")
    fake = _install_fake_kazoo(monkeypatch, KAZOO_ZNODES, async_window)
    got = torch_zk.ZkBackend("zkhost:2181")
    ref = jax_zk.ZkBackend("zkhost:2181")
    client = fake.instances[-2]
    assert client.started and client.timeout == 10.0  # the reference's 10 s
    assert [tuple(vars(b).values()) for b in got.brokers()] \
        == [tuple(vars(b).values()) for b in ref.brokers()] \
        == [(1, "h1", 9092, "ra"), (2, "h2", 9093, None), (10, "h10", 9092, "rb")]
    names = got.all_topics()
    assert names == ref.all_topics() == [f"t{i}" for i in range(8)]
    assert list(got.fetch_topics(names)) == list(ref.fetch_topics(names))
    assert list(got.fetch_topics(["ghost", "t1"], missing="skip")) \
        == [("ghost", None), ("t1", {1: [2, 1], 0: [1, 10]})]
    if async_window:
        assert client.max_outstanding == 3  # the window bound held
    got.close()
    assert client.stopped and client.closed


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _install_fake_confluent(monkeypatch):
    md = _Obj(
        brokers={2: _Obj(id=2, host="h2", port=9093), 1: _Obj(id=1, host="h1", port=9092),
                 3: _Obj(id=3, host="h3", port=9092)},
        topics={
            "events": _Obj(partitions={1: _Obj(replicas=[2, 1]), 0: _Obj(replicas=[1, 2])}),
            "logs": _Obj(partitions={0: _Obj(replicas=[2])}),
        },
    )

    class AdminClient:
        def __init__(self, conf):
            self.conf = conf

        def list_topics(self, timeout=None):
            return md

    pkg = types.ModuleType("confluent_kafka")
    admin_mod = types.ModuleType("confluent_kafka.admin")
    admin_mod.AdminClient = AdminClient
    pkg.admin = admin_mod
    monkeypatch.setitem(sys.modules, "confluent_kafka", pkg)
    monkeypatch.setitem(sys.modules, "confluent_kafka.admin", admin_mod)


def _brokers(backend):
    return [tuple(vars(b).values()) for b in backend.brokers()]


def test_kafka_admin_confluent_branch(monkeypatch, capsys):
    _install_fake_confluent(monkeypatch)
    got = torch_admin.KafkaAdminBackend("b1:9092")
    ref = jax_admin.KafkaAdminBackend("b1:9092")
    assert got._impl == "confluent" and got.rack_blind
    assert _brokers(got) == _brokers(ref) == [(1, "h1", 9092, None), (2, "h2", 9093, None),
                                              (3, "h3", 9092, None)]
    got.brokers()
    err = capsys.readouterr().err
    assert err.count("WARNING") == 2  # once per backend
    assert got.all_topics() == ref.all_topics() == ["events", "logs"]
    both = ["events", "logs"]
    assert got.partition_assignment(both) == ref.partition_assignment(both)
    assert list(got.fetch_topics(["logs", "ghost"], missing="skip")) \
        == list(ref.fetch_topics(["logs", "ghost"], missing="skip")) \
        == [("logs", {0: [2]}), ("ghost", None)]
    with pytest.raises(KeyError):
        list(got.fetch_topics(["ghost"]))
    assert not got.supports_traffic() and not got.supports_groups()
    got.close()


def _kafka_python(monkeypatch, admin_cls):
    import collections

    pkg = types.ModuleType("kafka")
    pkg.KafkaAdminClient = admin_cls
    pkg.TopicPartition = collections.namedtuple("TopicPartition", ("topic", "partition"))
    monkeypatch.setitem(sys.modules, "kafka", pkg)
    return pkg


def test_kafka_admin_kafka_python_branch(monkeypatch):
    closed = []

    class KafkaAdminClient:
        def __init__(self, bootstrap_servers):
            self.bootstrap_servers = bootstrap_servers

        def describe_cluster(self):
            return {"brokers": [{"node_id": 2, "host": "h2", "port": 9093, "rack": "rb"},
                                {"node_id": 1, "host": "h1", "port": 9092}]}

        def list_topics(self):
            return ["logs", "events"]

        def describe_topics(self, topics):
            data = {"events": [{"partition": 1, "replicas": [2, 1]},
                               {"partition": 0, "replicas": [1, 2]}],
                    "logs": [{"partition": 0, "replicas": [2]}]}
            if any(t not in data for t in topics):
                raise type("UnknownTopicOrPartitionError", (Exception,), {})(topics)
            return [{"topic": t, "partitions": data[t]} for t in topics]

        def close(self):
            closed.append(True)

    _kafka_python(monkeypatch, KafkaAdminClient)
    got = torch_admin.KafkaAdminBackend("b1:9092")
    ref = jax_admin.KafkaAdminBackend("b1:9092")
    assert got._impl == "kafka-python" and not got.rack_blind
    assert _brokers(got) == _brokers(ref) == [(1, "h1", 9092, None), (2, "h2", 9093, "rb")]
    assert got.all_topics() == ref.all_topics() == ["events", "logs"]
    assert got.partition_assignment(["events"]) == ref.partition_assignment(["events"])
    topics = ["events", "ghost", "logs"]
    with contextlib.redirect_stderr(io.StringIO()):
        assert list(got.fetch_topics(topics, missing="skip")) \
            == list(ref.fetch_topics(topics, missing="skip"))
    got.close()
    assert closed == [True]


def test_kafka_admin_traffic_lag_gating_and_batching(monkeypatch):
    import collections

    from kafka_assigner_tpu_torch.obs.health import synthetic_partition_traffic

    Meta = collections.namedtuple("Meta", ("offset",))
    end_calls = []

    class BareAdmin:
        def __init__(self, bootstrap_servers):
            pass

        def close(self):
            pass

    pkg = _kafka_python(monkeypatch, BareAdmin)
    TopicPartition = pkg.TopicPartition

    class LagAdmin(BareAdmin):
        def list_consumer_groups(self):
            return [("g1", "consumer"), ("g2", "consumer")]

        def list_consumer_group_offsets(self, group):
            committed = {"g1": 90, "g2": 40}[group]
            return {TopicPartition("events", 0): Meta(committed),
                    TopicPartition("events", 9): Meta(5),
                    TopicPartition("events", 1): Meta(-1)}

        def end_offsets(self, tps):
            end_calls.append(list(tps))
            return {tp: 100 for tp in tps}

    wanted = {"events": [0, 1]}
    bare = torch_admin.KafkaAdminBackend("b1:9092")
    assert not bare.supports_traffic()
    assert bare.fetch_partition_traffic(wanted) == synthetic_partition_traffic(wanted)
    pkg.KafkaAdminClient = LagAdmin
    got = torch_admin.KafkaAdminBackend("b1:9092")
    ref = jax_admin.KafkaAdminBackend("b1:9092")
    assert got.supports_traffic() and ref.supports_traffic()
    out = got.fetch_partition_traffic(wanted)
    assert out["events"][0].lag == 60  # end 100 - the smallest commit, 40
    assert {p: tuple(v) for p, v in out["events"].items()} \
        == {p: tuple(v) for p, v in ref.fetch_partition_traffic(wanted)["events"].items()}
    assert len(end_calls) == 2 and sorted(end_calls[0]) == [TopicPartition("events", 0),
                                                            TopicPartition("events", 1)]


def test_kafka_admin_lag_sweep_failure_degrades_to_synthetic(monkeypatch, capsys):
    from kafka_assigner_tpu_torch.obs.health import synthetic_partition_traffic

    class BrokenLagAdmin:
        def __init__(self, bootstrap_servers):
            pass

        def list_consumer_groups(self):
            raise ConnectionError("coordinator flapping")

        def list_consumer_group_offsets(self, group):
            return {}

        def end_offsets(self, tps):
            return {}

        def close(self):
            pass

    _kafka_python(monkeypatch, BrokenLagAdmin)
    backend = torch_admin.KafkaAdminBackend("b1:9092")
    assert backend.supports_traffic()
    assert backend.fetch_partition_traffic({"t": [0]}) == synthetic_partition_traffic({"t": [0]})
    assert "lag sweep failed" in capsys.readouterr().err


def _group_admin(TopicPartition, attributed=True):
    import collections

    Meta = collections.namedtuple("Meta", ("offset",))

    def member(mid, pairs):
        return _Obj(member_id=mid, member_assignment=_Obj(assignment=pairs))

    descs = {
        "g1": _Obj(members=[member("c-1", [("events", [0, 1])]),
                            member("c-0", [("logs", [0])]),
                            _Obj(member_id="c-2", member_assignment=b"opaque")]),
        "g2": _Obj(members=[member("d-0", [("events", [1])])]),
    }
    if attributed:
        for g, d in descs.items():
            d.group = g

    class GroupAdmin:
        def __init__(self, bootstrap_servers):
            pass

        def list_consumer_groups(self):
            return [("g1", "consumer"), "g2"]

        def describe_consumer_groups(self, groups):
            return [descs[g] for g in groups]

        def list_consumer_group_offsets(self, group):
            return {TopicPartition("events", 0): Meta(10),
                    TopicPartition("events", 1): Meta({"g1": 95, "g2": -1}[group]),
                    TopicPartition("logs", 0): Meta(None)}

        def end_offsets(self, tps):
            return {tp: 100 for tp in tps}

        def close(self):
            pass

    return GroupAdmin


@pytest.mark.parametrize("attributed", [True, False])
@pytest.mark.parametrize("groups", [None, ["g2", "g1", "g2"]])
def test_kafka_admin_consumer_groups_equal_the_reference(monkeypatch, attributed, groups):
    pkg = _kafka_python(monkeypatch, object)
    pkg.KafkaAdminClient = _group_admin(pkg.TopicPartition, attributed)
    got = torch_admin.KafkaAdminBackend("b1:9092")
    ref = jax_admin.KafkaAdminBackend("b1:9092")
    assert got.supports_groups() and ref.supports_groups()
    a, b = got.fetch_consumer_groups(groups), ref.fetch_consumer_groups(groups)
    assert list(a) == list(b)
    for g in a:
        assert (a[g].group, [tuple(m) for m in a[g].members], a[g].assignment, a[g].lags) \
            == (b[g].group, [tuple(m) for m in b[g].members], b[g].assignment, b[g].lags)
    assert a["g1"].lags == {"events": {0: 90, 1: 5}}


def test_kafka_admin_without_groups_refuses_loudly(monkeypatch):
    from kafka_assigner_tpu_torch.errors import IngestError

    _install_fake_confluent(monkeypatch)
    with pytest.raises(IngestError, match="cannot read consumer groups"):
        torch_admin.KafkaAdminBackend("b1:9092").fetch_consumer_groups()


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra", [
    ["--mode", "PRINT_REASSIGNMENT"],
    ["--mode", "RANK_DECOMMISSION"],
    ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "t", "--partition_count", "2",
     "--desired_replication_factor", "1"],
])
def test_cli_refuses_rack_blind_plan_modes(monkeypatch, extra):
    _install_fake_confluent(monkeypatch)
    argv = ["--zk_string", "kafka://b1:9092"] + extra
    ref = _run(jax_run, argv)
    got = _run(cli.run, argv + ["--device", "cpu"])
    assert got[0] == ref[0] == cli.EXIT_USAGE
    assert got[1] == ref[1] == ""
    assert "rack-blind" in got[2]
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]


@pytest.mark.parametrize("mode", [
    ["--mode", "PRINT_REASSIGNMENT", "--disable_rack_awareness"],
    ["--mode", "PRINT_CURRENT_ASSIGNMENT"],
    ["--mode", "PRINT_CURRENT_BROKERS"],
])
def test_cli_over_the_admin_bridge_equals_the_reference(monkeypatch, mode):
    _install_fake_confluent(monkeypatch)
    argv = ["--zk_string", "kafka://b1:9092"] + mode
    ref = _run(jax_run, argv + (["--solver", "tpu"] if "PRINT_REASSIGNMENT" in mode else []))
    got = _run(cli.run, argv + ["--device", "cpu"])
    assert got[0] == ref[0] == 0
    assert got[1] == ref[1] and got[1]
    assert "WARNING" in got[2] and "rack" in got[2]


def test_groups_over_zookeeper_synthetic_and_refusal(zk_server):
    """ZooKeeper has no consumer-group surface: ``ka-groups`` refuses it
    (exit 1) and runs ``--synthetic`` over it, stdout equal to the
    reference's."""
    from kafka_assigner_tpu.cli import run_groups as jax_groups

    argv = ["--zk_string", f"127.0.0.1:{zk_server.port}", "--mode", "plan"]
    ref = _run(jax_groups, argv)
    got = _run(cli.run_groups, argv + ["--device", "cpu"])
    assert got[0] == ref[0] == cli.EXIT_USAGE
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]
    for mode in (["--mode", "plan"], ["--mode", "sweep", "--counts", "1,2"]):
        argv = ["--zk_string", f"127.0.0.1:{zk_server.port}", "--synthetic"] + mode
        ref = _run(jax_groups, argv)
        got = _run(cli.run_groups, argv + ["--device", "cpu"])
        assert got[0] == ref[0] == 0
        assert got[1] == ref[1]


# --- the CLI over the jute server -------------------------------------------------

def _tree_of(topic_map, racks, extra=()):
    """A znode tree of brokers ``racks`` (id -> rack, None = rackless) and
    ``topic_map``, plus broker ids ``extra`` without a rack key."""
    tree = {}
    for b, r in racks.items():
        meta = {"host": f"h{b}", "port": 9092}
        if r is not None:
            meta["rack"] = r
        tree[f"/brokers/ids/{b}"] = json.dumps(meta).encode()
    for b in extra:
        tree[f"/brokers/ids/{b}"] = json.dumps({"host": f"h{b}", "port": 9092}).encode()
    for t, parts in topic_map.items():
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in parts.items()}}).encode()
    return tree


@pytest.fixture()
def medium_server(request):
    """24 brokers in 4 racks and one rackless, 20 topics of 5-13 partitions
    at RF 2 and 3, broker 0 to be removed: enough topics for several ingest
    chunks."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    topic_map = {}
    for rf in (3, 2):
        tm, _, _ = rack_striped_cluster(24, 10, 5 + 4 * rf - 4, rf, 4,
                                        name_fmt=f"rf{rf}-{{:02d}}")
        topic_map.update(tm)
    racks = {b: f"r{b % 4}" for b in range(24)}
    return _serve(request, _tree_of(topic_map, racks, extra=(24,)))


LANES = [("device", "tpu"), ("native", "native"), ("greedy", "greedy")]


@pytest.mark.parametrize("lane,ref_lane", LANES)
def test_mode3_lanes_over_zookeeper_equal_the_reference(medium_server, lane, ref_lane):
    argv = ["--zk_string", f"127.0.0.1:{medium_server.port}", "--mode",
            "PRINT_REASSIGNMENT", "--broker_hosts_to_remove", "h0"]
    ref = _run(jax_run, argv + ["--solver", ref_lane])
    got = _run(cli.run, argv + ["--solver", lane, "--device", "cpu"])
    assert got[0] == ref[0] == 0
    assert got[1] == ref[1] and "NEW ASSIGNMENT:" in got[1]


def test_mode3_output_byte_identical_across_ingest_modes(medium_server, monkeypatch):
    """Pipelining and the ingest/encode overlap only move time: the port's
    stdout equals the reference's with the window of one, the overlap off
    and every chunk size; on the device lane the solve takes the
    preencode whenever the overlap is on."""
    from kafka_assigner_tpu_torch import generator

    argv = ["--zk_string", f"127.0.0.1:{medium_server.port}", "--mode",
            "PRINT_REASSIGNMENT", "--broker_hosts_to_remove", "h0,h5"]
    ref = _run(jax_run, argv + ["--solver", "tpu"])
    assert ref[0] == 0
    for env in ({}, {"KA_ZK_OVERLAP": "0"}, {"KA_ZK_INGEST_CHUNK": "1"},
                {"KA_ZK_INGEST_CHUNK": "7"}, {"KA_ZK_INGEST_CHUNK": "64"},
                {"KA_ZK_PIPELINE": "1", "KA_ZK_INGEST_CHUNK": "7"},
                {"KA_ZK_PIPELINE": "2", "KA_HOSTCODEC": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = _run(cli.run, argv + ["--device", "cpu"])
        assert got[:2] == ref[:2], env
        if env.get("KA_ZK_OVERLAP") == "0":
            assert generator.last_ingest["solve_encode"] in ("c", "numpy")
        else:
            chunk = int(env.get("KA_ZK_INGEST_CHUNK", 64))
            assert generator.last_ingest["chunks"] == -(-20 // chunk), env
            assert generator.last_ingest["solve_encode"] == "preencoded"
            assert generator.last_ingest["codecs"] == (
                ["numpy"] if env.get("KA_HOSTCODEC") == "0" else ["c"])
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("mode", [
    ["--mode", "PRINT_CURRENT_ASSIGNMENT"],
    ["--mode", "PRINT_CURRENT_ASSIGNMENT", "--topics", "rf2-03,rf3-01,rf2-03"],
    ["--mode", "PRINT_CURRENT_BROKERS"],
    ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "x,y", "--partition_count", "16",
     "--desired_replication_factor", "3", "--broker_hosts_to_remove", "h3"],
    ["--mode", "RANK_DECOMMISSION", "--integer_broker_ids", "0,1,2,3,4,5,6,7"],
])
def test_other_modes_over_zookeeper_equal_the_reference(medium_server, mode):
    argv = ["--zk_string", f"127.0.0.1:{medium_server.port}"] + mode
    ref = _run(jax_run, argv)
    got = _run(cli.run, argv + ["--device", "cpu"])
    assert got[0] == ref[0] == 0
    assert got[1] == ref[1] and got[1]


def _reports(tmp_path, argv, jax_extra=(), torch_extra=("--device", "cpu")):
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run, argv + list(jax_extra) + ["--report-json", str(a)])
    got = _run(cli.run, argv + list(torch_extra) + ["--report-json", str(b)])
    return ref, got, json.loads(a.read_text()), json.loads(b.read_text())


def test_dead_endpoint_exits_3_as_the_reference(tmp_path, monkeypatch):
    """A quorum that refuses every connect: exit 3, the reference's stderr
    line and report error (raised at the backend open, so the report names
    the wire client's error, as the reference's does), nothing on stdout,
    and no fallback anywhere."""
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "1")
    argv = ["--zk_string", f"127.0.0.1:{_dead_port()}", "--mode", "PRINT_REASSIGNMENT"]
    ref, got, ra, rb = _reports(tmp_path, argv, ["--solver", "tpu"])
    assert got[0] == ref[0] == cli.EXIT_INGEST
    assert got[1] == ref[1] == ""
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]
    assert got[2].splitlines()[-1].startswith(
        "error: metadata ingest failed: could not establish a ZooKeeper session")
    assert rb["status"] == ra["status"] == "error"
    assert rb["error"] == ra["error"]


@pytest.mark.parametrize("case", ["missing-topic", "dropped-session"])
def test_ingest_failure_under_strict_is_an_ingest_error(zk_server, tmp_path, monkeypatch,
                                                        case):
    """A missing topic, or a session dropped mid-read past its retries,
    under ``strict``: exit 3, ``error: metadata ingest failed: ...`` and an
    ``IngestError`` in the report, equal to the reference's."""
    argv = ["--zk_string", f"127.0.0.1:{zk_server.port}", "--mode", "PRINT_REASSIGNMENT"]
    if case == "missing-topic":
        argv += ["--topics", "events,ghost"]
    else:
        monkeypatch.setenv("KA_ZK_SESSION_RETRIES", "0")
        monkeypatch.setenv("KA_FAULTS_SPEC", "reply:6=drop")
    ref, got, ra, rb = _reports(tmp_path, argv, ["--solver", "tpu"])
    assert got[0] == ref[0] == cli.EXIT_INGEST
    assert got[1] == ref[1] == ""
    assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]
    assert "error: metadata ingest failed: " in got[2]
    assert rb["error"] == ra["error"] and rb["error"]["type"] == "IngestError"
    paths = {s["path"]: s["status"] for s in rb["spans"]}
    assert paths["mode/PRINT_REASSIGNMENT/metadata/assignment/ingest/stream"] == "error"


#: The read-seam rows of ``scripts/chaos_soak.py --matrix``: (spec, {policy:
#: exit code}); the reply indexes follow mode 3's read sequence on the
#: fixture tree (0 the broker list, 1-4 the brokers, 5 the topic list, 6-7
#: the topics).
READ_SEAM_ROWS = {
    "drop": ("reply:3=drop", {"strict": 0, "best-effort": 0}),
    "trunc": ("reply:2=trunc", {"strict": 0, "best-effort": 0}),
    "slow": ("reply:1=slow:0.05", {"strict": 0, "best-effort": 0}),
    "expire": ("handshake:0=expire", {"strict": 0, "best-effort": 0}),
    "blackhole": ("connect:0=blackhole", {"strict": 0, "best-effort": 0}),
    "nonode": ("reply:6=nonode", {"strict": 3, "best-effort": 6}),
}


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
@pytest.mark.parametrize("row", sorted(READ_SEAM_ROWS))
def test_read_seam_faults_as_the_reference(request, monkeypatch, row, policy):
    """Each read-seam fault class drives the port's wire client to the
    reference's exit code, stdout and fired-fault lines; a survived fault
    leaves the plan byte-identical to a clean run's."""
    monkeypatch.setattr(zkwire.time, "sleep", lambda s: None)
    monkeypatch.setattr(jax_wire.time, "sleep", lambda s: None)
    monkeypatch.setenv("KA_ZK_CONNECT_RETRIES", "3")
    spec, rcs = READ_SEAM_ROWS[row]
    results = {}
    for name, fn in (("ref", jax_run), ("port", cli.run)):
        for faulted in (False, True):
            server = _serve(request, cluster_tree())
            if faulted:
                monkeypatch.setenv("KA_FAULTS_SPEC", spec)
            else:
                monkeypatch.delenv("KA_FAULTS_SPEC", raising=False)
            jax_faults.reset()
            torch_faults.reset()
            argv = ["--zk_string", f"127.0.0.1:{server.port}", "--mode",
                    "PRINT_REASSIGNMENT", "--solver", "greedy", "--failure-policy", policy]
            results[name, faulted] = _run(fn, argv + (["--device", "cpu"]
                                                      if fn is cli.run else []))
    ref, got = results["ref", True], results["port", True]
    assert got[0] == ref[0] == rcs[policy]
    assert got[1] == ref[1]
    fired = lambda err: [ln for ln in err.splitlines() if "fault injected" in ln]  # noqa: E731
    assert fired(got[2]) == fired(ref[2]) and fired(got[2])
    if rcs[policy] == 0:
        assert got[1] == results["port", False][1] == results["ref", False][1]
    else:
        assert got[2].splitlines()[-1] == ref[2].splitlines()[-1]
