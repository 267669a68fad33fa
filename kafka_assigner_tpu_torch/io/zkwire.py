"""Minimal pure-python ZooKeeper wire client: the reads, the serial writes,
the watches and the session of the reference's
``kafka_assigner_tpu/io/zkwire.py``, with its frames, retry contract and
fault seams unchanged. ``io/zk.py`` uses it
when ``kazoo`` is not installed (or under ``KA_ZK_CLIENT=wire``).

The planner reads a session, ``getChildren`` of the broker and topic lists
and ``getData`` of each broker and topic znode, then ``closeSession``;
``ka-execute`` also creates ``/admin/reassign_partitions``. That is a
small, stable corner of ZooKeeper's jute protocol:

- frames: a 4-byte big-endian length prefix;
- the session handshake: ``ConnectRequest``/``ConnectResponse``;
- ``getChildren`` (type 8), ``getData`` (type 4), ``exists`` (type 3) and
  ``ping`` (type 11) with ``ReplyHeader{xid, zxid, err}`` replies, the two
  reads optionally arming a one-shot watch;
- ``WatcherEvent`` notifications (xid -1);
- ``create`` (type 1), ``delete`` (type 2) and ``setData`` (type 5);
- ``closeSession`` (type -11).

Timeouts follow the reference tool (``KafkaAssignmentGenerator.java:
273-276``): the caller's timeout bounds each connect attempt and each
in-session read. Session establishment makes up to
``KA_ZK_CONNECT_RETRIES`` passes over the shuffled endpoint list with
jittered backoff, every failed pass warned on stderr.

Pipelined reads: :meth:`MiniZkClient.iter_get`, :meth:`iter_children` and
:meth:`get_many` keep up to ``KA_ZK_PIPELINE`` requests in flight on the
session socket with out-of-order-safe xid matching, so N reads cost about
``ceil(N / window)`` round trips; a window of one is the exact serial frame
sequence (the goldens of ``tests/golden/zk_jute_frames.json`` pin both).

Self-healing reads: a session that dies mid-read (socket drop, truncated or
desynced frame, reply timeout) raises :class:`ZkConnectionError`; the serial
calls and the pipelined window catch it, re-establish the session (up to
``KA_ZK_SESSION_RETRIES`` times, jittered backoff, warned on stderr and
counted as ``zk.session.reestablished``) and re-issue only the unanswered
reads. Reads are idempotent, so the output is the same as an uninterrupted
run's. Server-reported errors (NoNode, NodeExists, bad version) are answers
and never retried.

Writes are serial only: they never enter the pipelined window and are
never replayed blindly. After a transport failure the write path
re-establishes the session, reads back whether the write landed (the
``landed`` probe of :meth:`MiniZkClient._write_call`), and re-issues it
only when it did not.

Fault seams, as the reference's: ``connect_attempt`` before each socket
connect, ``filter_handshake`` on each ConnectResponse and ``filter_reply``
on each in-session reply frame (``faults/inject.py``, ``KA_FAULTS_SPEC``).

Watches, the resident daemon's churn feed: ``get``, ``get_children``,
``iter_get``, ``iter_children`` and ``get_many`` take ``watch=True`` to arm
a one-shot watch per read. A notification frame that arrives while a reply
is awaited (a serial read, the pipelined window, a write or its read-back)
is queued and never taken for a reply, so xid matching is undisturbed;
:meth:`MiniZkClient.poll_watches` drains the queue and waits on an idle
session for more. Watches die with their session: ``session_generation``
counts the sessions established, so a caller that armed watches sees when a
transparent reconnect dropped them.
"""
from __future__ import annotations

import random
import socket
import struct
import sys
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

from ..faults.inject import active_injector
from ..obs.metrics import counter_add, gauge_set, hist_ms, hist_observe

#: ZooKeeper opcodes (zookeeper.ZooDefs.OpCode) of the subset used.
OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GET_DATA = 4
OP_SET_DATA = 5
OP_GET_CHILDREN = 8
OP_PING = 11
OP_CLOSE = -11

#: KeeperException codes: NoNode, NodeExists, BadVersion.
ERR_NONODE = -101
ERR_NODEEXISTS = -110
ERR_BADVERSION = -103

PING_XID = -2
#: The server-initiated notification "xid" (ClientCnxn.NOTIFICATION_XID):
#: a WatcherEvent frame, not a reply to any request.
NOTIFICATION_XID = -1

#: WatcherEvent types (org.apache.zookeeper.Watcher.Event.EventType).
EVENT_CREATED = 1
EVENT_DELETED = 2
EVENT_DATA_CHANGED = 3
EVENT_CHILDREN_CHANGED = 4

#: The world:anyone open ACL (ZooDefs.Ids.OPEN_ACL_UNSAFE), the only ACL the
#: reassignment admin znode needs: a vector of one ACL{perms=ALL(31),
#: Id{scheme="world", id="anyone"}}.
_OPEN_ACL = (
    struct.pack(">i", 1)
    + struct.pack(">i", 31)
    + struct.pack(">i", 5) + b"world"
    + struct.pack(">i", 6) + b"anyone"
)


class ZkWireError(RuntimeError):
    """Connection-level or server-reported failure of the wire client."""


class ZkConnectionError(ZkWireError):
    """Transport-level failure of an open session (socket drop, truncated or
    desynced frame, reply timeout): the socket's state is unknown but no
    read was half-applied, so the unanswered requests may be re-issued on a
    fresh session. The retry layer retries exactly this class."""


class NoNodeError(ZkWireError):
    """The requested znode does not exist (KeeperException.NoNode)."""


class NodeExistsError(ZkWireError):
    """The znode a ``create`` targeted already exists
    (KeeperException.NodeExists); for the reassignment admin znode, another
    reassignment is still in flight."""


class BadVersionError(ZkWireError):
    """A versioned write lost its compare-and-set race
    (KeeperException.BadVersion): somebody else changed the znode."""


class WatchEvent(NamedTuple):
    """One server-pushed WatcherEvent: its type, the keeper state and the
    chroot-stripped path. Watches are one-shot: to stay subscribed the
    caller re-reads with a fresh watch flag, which is also the re-read the
    daemon's delta re-encode needs."""

    type: int
    state: int
    path: str


class ZnodeStat(NamedTuple):
    czxid: int
    mzxid: int
    ctime: int
    mtime: int
    version: int
    cversion: int
    aversion: int
    ephemeralOwner: int
    dataLength: int
    numChildren: int
    pzxid: int


def _pack_buffer(data: Optional[bytes]) -> bytes:
    if data is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(data)) + data


def _pack_str(s: str) -> bytes:
    return _pack_buffer(s.encode("utf-8"))


class _Reader:
    """Sequential jute decoder over one reply frame."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ZkConnectionError("truncated ZooKeeper reply frame")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def read_int(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def read_long(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def read_buffer(self) -> Optional[bytes]:
        n = self.read_int()
        if n < 0:
            return None
        return self._take(n)

    def read_str(self) -> str:
        buf = self.read_buffer()
        return "" if buf is None else buf.decode("utf-8")

    def read_stat(self) -> ZnodeStat:
        return ZnodeStat(*struct.unpack(">qqqqiiiqiiq", self._take(68)))


def parse_hosts(connect_string: str) -> Tuple[List[Tuple[str, int]], str]:
    """``host:port,host:port[/chroot]`` -> (endpoints, chroot). Kafka connect
    strings often carry a chroot suffix (``zk1:2181,zk2:2181/kafka``)."""
    hosts_part, slash, chroot = connect_string.partition("/")
    chroot = (slash + chroot).rstrip("/") if slash else ""
    endpoints = []
    for tok in hosts_part.split(","):
        tok = tok.strip()
        if not tok:
            continue
        host, _, port = tok.rpartition(":")
        if not host:
            host, port = tok, "2181"
        endpoints.append((host, int(port)))
    if not endpoints:
        raise ZkWireError(f"no ZooKeeper endpoints in {connect_string!r}")
    return endpoints, chroot


def _flag(watch: bool) -> bytes:
    """A read request's trailing watch byte."""
    return b"\x01" if watch else b"\x00"


def _decode_get(r: _Reader) -> Tuple[bytes, ZnodeStat]:
    """getData reply body: data buffer and stat."""
    data = r.read_buffer() or b""
    return data, r.read_stat()


def _decode_children(r: _Reader) -> List[str]:
    """getChildren reply body: vector of child names."""
    count = r.read_int()
    if count < 0:
        return []
    return [r.read_str() for _ in range(count)]


class MiniZkClient:
    """Duck-type of the ``kazoo.client.KazooClient`` surface ``ZkBackend``
    uses: ``start`` / ``get_children`` / ``get`` / ``exists`` / ``create``
    / ``set`` / ``delete`` / ``stop`` / ``close``, plus the pipelined
    ``iter_get``, ``iter_children`` and ``get_many`` and the watch surface
    (``poll_watches``, ``session_generation``, ``ping``)."""

    def __init__(self, hosts: str, timeout: float = 10.0) -> None:
        self._endpoints, self._chroot = parse_hosts(hosts)
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._xid = 0
        self._max_in_flight = 0  # high-water mark across this session
        #: Pending server-pushed WatcherEvents (drained by poll_watches).
        self._watch_events: List[WatchEvent] = []
        #: Sessions established so far: watches do not survive a session, so
        #: a caller compares this with the value it saw when it armed them.
        self.session_generation = 0
        # The fault injector (None unless KA_FAULTS_SPEC is set), resolved
        # once per client so a run's schedule is coherent across reconnects.
        self._faults = active_injector()

    # -- session ----------------------------------------------------------

    def start(self, timeout: Optional[float] = None) -> None:
        """Establish a session: up to ``KA_ZK_CONNECT_RETRIES`` passes over
        the endpoint list (shuffled once, so a fleet of callers does not
        pile onto the first quorum member), with jittered exponential
        backoff between passes. Every failed pass is warned on stderr."""
        from ..utils.backoff import JitteredBackoff
        from ..utils.env import env_int

        deadline_t = timeout if timeout is not None else self._timeout
        retries = env_int("KA_ZK_CONNECT_RETRIES")
        endpoints = list(self._endpoints)
        random.shuffle(endpoints)
        last_err: Optional[Exception] = None
        pass_backoff = JitteredBackoff(0.1, cap=2.0)
        for attempt in range(1, retries + 1):
            for host, port in endpoints:
                try:
                    if self._faults is not None:
                        self._faults.connect_attempt()
                    sock = socket.create_connection((host, port), deadline_t)
                    sock.settimeout(deadline_t)
                    # Pipelining sends many small frames back to back; with
                    # Nagle on, each write after the first waits for the
                    # peer's delayed ACK.
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                    self._sock = sock
                    self._handshake(int(deadline_t * 1000))
                    self.session_generation += 1
                    return
                except (OSError, ZkWireError) as e:
                    last_err = e
                    if self._sock is not None:
                        self._sock.close()
                        self._sock = None
            if attempt < retries:
                backoff = pass_backoff.next_delay()
                print(
                    f"kafka-assigner: ZooKeeper connect pass {attempt}/"
                    f"{retries} failed over {len(endpoints)} endpoint(s) "
                    f"({last_err}); retrying in {backoff:.1f}s",
                    file=sys.stderr,
                )
                time.sleep(backoff)
        raise ZkWireError(
            f"could not establish a ZooKeeper session with any of "
            f"{endpoints} after {retries} pass(es): {last_err}"
        )

    def _handshake(self, timeout_ms: int) -> None:
        # ConnectRequest: protocolVersion, lastZxidSeen, timeOut, sessionId,
        # passwd, readOnly (3.4+; servers without it ignore the extra byte).
        req = (
            struct.pack(">iqiq", 0, 0, timeout_ms, 0)
            + _pack_buffer(b"\x00" * 16)
            + b"\x00"
        )
        self._send_frame(req)
        raw = self._recv_frame()
        if self._faults is not None:
            raw = self._faults.filter_handshake(raw)
        r = _Reader(raw)
        r.read_int()               # protocolVersion
        negotiated = r.read_int()  # timeOut
        r.read_long()              # sessionId
        if negotiated <= 0:
            # The expired-session ConnectResponse: negotiated timeout 0.
            raise ZkWireError("ZooKeeper session expired during handshake")

    # -- rpc --------------------------------------------------------------

    def _send_frame(self, payload: bytes) -> None:
        assert self._sock is not None
        counter_add("zk.wire_frames_out")
        counter_add("zk.wire_bytes_out", 4 + len(payload))
        self._sock.sendall(struct.pack(">i", len(payload)) + payload)

    def _recv_frame(self) -> bytes:
        assert self._sock is not None
        header = self._recv_exact(4)
        (n,) = struct.unpack(">i", header)
        if n < 0 or n > (64 << 20):
            raise ZkConnectionError(f"invalid ZooKeeper frame length {n}")
        counter_add("zk.wire_frames_in")
        counter_add("zk.wire_bytes_in", 4 + n)
        return self._recv_exact(n)

    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        chunks = []
        while n:
            chunk = self._sock.recv(n)
            if not chunk:
                raise ZkConnectionError("ZooKeeper connection closed mid-reply")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _reconnect(self, attempt: int, retries: int, err: Exception) -> None:
        """Tear down the dead socket and establish a fresh session (which
        itself retries over the endpoint list). Jittered backoff, loud on
        stderr, counted."""
        from ..utils.backoff import JitteredBackoff

        counter_add("zk.session.reestablished")
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # already dead; the reconnect below recovers
                pass
            self._sock = None
        backoff = JitteredBackoff(0.05, cap=1.0).delay_for(attempt)
        print(
            f"kafka-assigner: ZooKeeper session lost mid-read "
            f"({type(err).__name__}: {err}); re-establishing and replaying "
            f"unanswered reads (attempt {attempt}/{retries}, "
            f"backoff {backoff:.2f}s)",
            file=sys.stderr,
        )
        time.sleep(backoff)
        self.start()

    def _call(self, op: int, payload: bytes) -> _Reader:
        if self._sock is None:
            raise ZkWireError("ZooKeeper session is not started")
        from ..utils.env import env_int

        retries = env_int("KA_ZK_SESSION_RETRIES")
        attempt = 0
        while True:
            self._xid += 1
            xid = self._xid
            try:
                with hist_ms("zk.op_ms"):
                    return self._call_inner(op, xid, payload)
            except (OSError, ZkConnectionError) as e:
                # Transport death only: a serial read is unanswered by
                # definition, so re-issuing it on a fresh session is safe.
                attempt += 1
                if attempt > retries:
                    raise
                self._reconnect(attempt, retries, e)

    def _call_inner(self, op: int, xid: int, payload: bytes) -> _Reader:
        self._send_frame(struct.pack(">ii", xid, op) + payload)
        rxid, err, r = self._recv_reply()
        if rxid != xid:
            raise ZkConnectionError(
                f"ZooKeeper reply xid {rxid} does not match request {xid}"
            )
        if err == ERR_NONODE:
            raise NoNodeError(f"znode does not exist (err {err})")
        if err == ERR_NODEEXISTS:
            raise NodeExistsError(f"znode already exists (err {err})")
        if err == ERR_BADVERSION:
            raise BadVersionError(f"znode version mismatch (err {err})")
        if err != 0:
            raise ZkWireError(f"ZooKeeper error {err}")
        return r

    def _recv_reply(self) -> Tuple[int, int, _Reader]:
        """One reply frame's ``ReplyHeader`` (xid, err) and its body reader,
        skipping ping replies and queueing watch notifications (xid -1) for
        :meth:`poll_watches`."""
        # Bounded by the session socket's timeout (set in start).
        while True:
            raw = self._recv_frame()
            if self._faults is not None:
                raw = self._faults.filter_reply(raw, self._sock)
            r = _Reader(raw)
            rxid = r.read_int()
            r.read_long()  # zxid
            err = r.read_int()
            if rxid == PING_XID:
                continue
            if rxid == NOTIFICATION_XID:
                self._watch_events.append(self._decode_watch_event(r))
                continue
            return rxid, err, r

    def _decode_watch_event(self, r: _Reader) -> WatchEvent:
        ev_type = r.read_int()
        state = r.read_int()
        path = r.read_str()
        if self._chroot and path.startswith(self._chroot):
            path = path[len(self._chroot):] or "/"
        counter_add("zk.watch_events")
        return WatchEvent(ev_type, state, path)

    def _path(self, path: str) -> str:
        return (self._chroot + path) if self._chroot else path

    # -- reads ------------------------------------------------------------

    def get_children(self, path: str, watch: bool = False) -> List[str]:
        """Child listing of ``path``; ``watch=True`` also arms a one-shot
        child watch (NodeChildrenChanged or NodeDeleted, through
        :meth:`poll_watches`)."""
        r = self._call(OP_GET_CHILDREN, _pack_str(self._path(path)) + _flag(watch))
        return _decode_children(r)

    def exists(self, path: str) -> Optional[ZnodeStat]:
        """The znode's stat, or ``None`` when absent (NoNode is the answer
        here, not an error)."""
        try:
            r = self._call(OP_EXISTS, _pack_str(self._path(path)) + b"\x00")
        except NoNodeError:
            return None
        return r.read_stat()

    def get(self, path: str, watch: bool = False) -> Tuple[bytes, ZnodeStat]:
        """``getData`` of ``path``: its bytes and stat; ``watch=True`` also
        arms a one-shot data watch (NodeDataChanged or NodeDeleted, through
        :meth:`poll_watches`)."""
        r = self._call(OP_GET_DATA, _pack_str(self._path(path)) + _flag(watch))
        return _decode_get(r)

    # -- watches ------------------------------------------------------------

    def ping(self) -> None:
        """Session keepalive (opcode 11, xid -2): the daemon's idle watch
        loop sends one now and then so a quiet session does not expire. The
        reply is skipped by whichever read or poll runs next."""
        if self._sock is None:
            raise ZkWireError("ZooKeeper session is not started")
        self._send_frame(struct.pack(">ii", PING_XID, OP_PING))

    def poll_watches(self, timeout: float = 0.25) -> List[WatchEvent]:
        """The pending watch notifications, waiting up to ``timeout``
        seconds for the first when none is queued. Transport death raises
        :class:`ZkConnectionError`: watches die with the session, so the
        caller re-establishes, re-arms and resyncs.

        No request is in flight here, so only server-initiated frames are
        legal: notifications are collected, ping replies are dropped without
        ending the wait, anything else is a desynced session. Readability is
        tested with ``select`` before a byte is read, so a quiet window never
        leaves a frame half-read; a frame whose header arrived is read under
        the session socket's timeout."""
        import select

        events, self._watch_events = self._watch_events, []
        if events or self._sock is None:
            return events
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return events
            try:
                ready, _, _ = select.select([self._sock], [], [], remaining)
            except (OSError, ValueError) as e:
                raise ZkConnectionError(
                    f"ZooKeeper session died while polling watches: {e}"
                ) from e
            if not ready:
                return events
            rxid, r = self._recv_server_frame()
            if rxid == NOTIFICATION_XID:
                events.append(self._decode_watch_event(r))
                events.extend(self._drain_ready_watches())
                return events
            if rxid != PING_XID:
                raise ZkConnectionError(
                    f"unexpected reply xid {rxid} on an idle session while "
                    "polling watches (desynced)"
                )

    def _recv_server_frame(self) -> Tuple[int, _Reader]:
        """One frame on an idle session: its xid and body reader."""
        r = _Reader(self._recv_frame())
        rxid = r.read_int()
        r.read_long()  # zxid
        r.read_int()   # err
        return rxid, r

    def _drain_ready_watches(self) -> List[WatchEvent]:
        """The frames already queued behind a notification just read, by
        zero-timeout readability probes: nothing blocks and no frame is
        half-read."""
        import select

        out: List[WatchEvent] = []
        assert self._sock is not None
        while True:
            ready, _, _ = select.select([self._sock], [], [], 0)
            if not ready:
                return out
            rxid, r = self._recv_server_frame()
            if rxid == NOTIFICATION_XID:
                out.append(self._decode_watch_event(r))
            elif rxid != PING_XID:
                raise ZkConnectionError(
                    f"unexpected reply xid {rxid} while draining watch "
                    "notifications"
                )

    # -- pipelined reads --------------------------------------------------

    def iter_get(
        self, paths: Sequence[str], missing_ok: bool = False, watch: bool = False
    ) -> Iterator[Optional[Tuple[bytes, ZnodeStat]]]:
        """Pipelined ``getData``: up to ``KA_ZK_PIPELINE`` requests in
        flight, replies matched by xid, ``(data, stat)`` yielded in request
        order as they arrive, so callers can overlap downstream work with
        the remaining round trips.

        Failure contract: a per-reply timeout raises, naming the outstanding
        window; a server-reported error (``NoNodeError``) stops new sends,
        drains the already-sent window (the session stays usable) and is
        raised at the failing path's position, after every earlier result
        was yielded. Under ``missing_ok`` a missing znode yields ``None`` at
        its position instead and the pipeline keeps flowing. A transport
        death mid-window re-establishes the session and re-issues only the
        not-yet-yielded reads, up to ``KA_ZK_SESSION_RETRIES`` times.
        Abandoning the iterator early drains the in-flight window on close.

        Pipelined reads report ``zk.pipeline.batch_ms`` only: a reply's
        arrival inside a window is not a per-op latency, so they do not
        feed ``zk.op_ms``.

        ``watch=True`` arms a one-shot data watch per read (the daemon's
        pipelined resync); notifications that land inside the window are
        queued for :meth:`poll_watches`.

        Not thread-safe: one batch (or serial call) at a time per client;
        the streamed ingest hands the whole client to its producer thread
        for the batch.
        """
        yield from self._iter_pipelined(paths, missing_ok, OP_GET_DATA,
                                        _decode_get, watch)

    def iter_children(
        self, paths: Sequence[str], missing_ok: bool = False, watch: bool = False
    ) -> Iterator[Optional[List[str]]]:
        """Pipelined ``getChildren``, with :meth:`iter_get`'s window, replay,
        watch and failure contract."""
        yield from self._iter_pipelined(paths, missing_ok, OP_GET_CHILDREN,
                                        _decode_children, watch)

    def _iter_pipelined(self, paths, missing_ok, op, decode, watch=False):
        """The window/replay loop behind :meth:`iter_get` and
        :meth:`iter_children`, parameterized by read opcode, decoder and
        watch flag."""
        if self._sock is None:
            raise ZkWireError("ZooKeeper session is not started")
        from ..utils.env import env_int

        window = env_int("KA_ZK_PIPELINE")
        retries = env_int("KA_ZK_SESSION_RETRIES")
        n = len(paths)
        if n == 0:
            return
        t0 = time.perf_counter()
        counter_add("zk.pipeline.batches")
        yielded = 0
        attempt = 0
        while yielded < n:
            inner = self._iter_window(paths, yielded, window, missing_ok,
                                      op, decode, watch)
            try:
                try:
                    for res in inner:
                        yielded += 1
                        if yielded == n:
                            # Account before the final yield: consumers like
                            # zip() abandon the generator at its last item.
                            counter_add(
                                "zk.pipeline.rtts_saved", n - -(-n // window)
                            )
                            hist_observe(
                                "zk.pipeline.batch_ms",
                                (time.perf_counter() - t0) * 1e3,
                            )
                        yield res
                finally:
                    # Prompt close on any exit: the window's own finally
                    # drains its in-flight replies.
                    inner.close()
            except (OSError, ZkConnectionError) as e:
                attempt += 1
                if attempt > retries:
                    raise
                self._reconnect(attempt, retries, e)

    def _iter_window(
        self,
        paths: Sequence[str],
        start: int,
        window: int,
        missing_ok: bool,
        op: int,
        decode,
        watch: bool = False,
    ) -> Iterator[object]:
        """One session's attempt at positions ``start..n-1`` of a pipelined
        batch. Yields results in position order; transport failures raise
        :class:`ZkConnectionError`/``OSError`` to the replay loop."""
        n = len(paths)
        pending: dict = {}   # xid -> request position
        ready: dict = {}     # position -> decoded result | None | ZkWireError
        sent = start
        yielded = start
        failed = False       # stop filling the window once an error lands
        desynced = False     # socket state unknown: draining cannot help
        try:
            while yielded < n:
                while sent < n and len(pending) < window and not failed:
                    self._xid += 1
                    self._send_frame(
                        struct.pack(">ii", self._xid, op)
                        + _pack_str(self._path(paths[sent])) + _flag(watch)
                    )
                    pending[self._xid] = sent
                    sent += 1
                    if len(pending) > self._max_in_flight:
                        self._max_in_flight = len(pending)
                        gauge_set(
                            "zk.pipeline.in_flight", self._max_in_flight
                        )
                if pending:
                    try:
                        rxid, err, r = self._recv_reply()
                    except socket.timeout:
                        desynced = True
                        raise ZkConnectionError(
                            f"timed out waiting for {len(pending)} pipelined "
                            f"ZooKeeper replies (window {window}, first "
                            f"outstanding path "
                            f"{paths[min(pending.values())]!r})"
                        ) from None
                    pos = pending.pop(rxid, None)
                    if pos is None:
                        desynced = True
                        raise ZkConnectionError(
                            f"ZooKeeper reply xid {rxid} matches no "
                            f"in-flight pipelined request "
                            f"(window {sorted(pending)})"
                        )
                    if err == ERR_NONODE and missing_ok:
                        ready[pos] = None  # the caller skips this path
                    elif err == ERR_NONODE:
                        ready[pos] = NoNodeError(
                            f"znode does not exist: {paths[pos]!r} "
                            f"(err {err})"
                        )
                        failed = True
                    elif err != 0:
                        ready[pos] = ZkWireError(
                            f"ZooKeeper error {err} for {paths[pos]!r}"
                        )
                        failed = True
                    else:
                        ready[pos] = decode(r)
                while yielded in ready:
                    res = ready[yielded]
                    if isinstance(res, ZkWireError):
                        if pending:  # drain the in-flight window first so
                            break    # the session stays usable after raise
                        raise res
                    del ready[yielded]
                    yielded += 1
                    yield res
        finally:
            # Early abandonment leaves replies for the in-flight window on
            # the socket; the next call would mis-pair them. Drain them,
            # unless the socket is desynced or broken (the original error
            # wins).
            if pending and not desynced:
                try:
                    while pending:
                        rxid, _, _ = self._recv_reply()
                        pending.pop(rxid, None)
                except (OSError, ZkWireError):  # best effort; the original error wins
                    pass

    def get_many(
        self, paths: Sequence[str], missing_ok: bool = False, watch: bool = False
    ) -> List[Optional[Tuple[bytes, ZnodeStat]]]:
        """All results of :meth:`iter_get` at once, in request order
        (``None`` per missing path under ``missing_ok``)."""
        return list(self.iter_get(paths, missing_ok=missing_ok, watch=watch))

    # -- writes (serial only; never pipelined, never replayed blindly) -----

    def _write_call(self, op: int, payload: bytes, landed):
        """One write RPC: one request, one reply, never inside a pipelined
        window.

        After a transport failure the socket's state is unknown: the server
        may or may not have applied the request. So unlike a read this is
        never re-issued blindly: the session is re-established, ``landed``
        (a read on the fresh session: does the server show this write's
        effect?) is asked, and the request is sent again only when it did
        not land. Returns the reply reader, or ``None`` when the read-back
        confirmed the effect (the reply went down with the old socket).
        Server-reported errors (NodeExists, NoNode, BadVersion) are answers
        and propagate."""
        if self._sock is None:
            raise ZkWireError("ZooKeeper session is not started")
        from ..utils.env import env_int

        retries = env_int("KA_ZK_SESSION_RETRIES")
        attempt = 0
        while True:
            self._xid += 1
            xid = self._xid
            try:
                # zk.writes is counted by the backend (once a wave on every
                # backend); the frame counters account the wire traffic.
                with hist_ms("zk.op_ms"):
                    return self._call_inner(op, xid, payload)
            except (OSError, ZkConnectionError) as e:
                attempt += 1
                if attempt > retries:
                    raise
                self._reconnect(attempt, retries, e)
                if landed():
                    counter_add("zk.write_readback_confirmed")
                    print(
                        "kafka-assigner: write reply lost with the session "
                        "but the read-back shows it landed; not re-issuing",
                        file=sys.stderr,
                    )
                    return None

    def create(self, path: str, value: bytes = b"", makepath: bool = False,
               **_kazoo_compat) -> str:
        """Create a persistent znode with the world:anyone ACL (kazoo's
        surface, ``makepath`` included). The read-back counts "exists with
        exactly these bytes" as landed; a node with other bytes raises the
        server's NodeExists on the re-issue, as an uninterrupted race
        would."""
        full = self._path(path)

        def _landed() -> bool:
            try:
                data, _ = self.get(path)
            except NoNodeError:
                return False
            return data == value

        if makepath:
            # Missing parents first, shallowest first, as empty persistent
            # znodes; a parent somebody else created meanwhile is fine. The
            # parents are already chroot-prefixed, so the raw exists opcode
            # probes them.
            segs = full.strip("/").split("/")[:-1]
            parent = ""
            for seg in segs:
                parent = f"{parent}/{seg}"

                def _parent_landed(p: str = parent) -> bool:
                    try:
                        r = self._call(OP_EXISTS, _pack_str(p) + b"\x00")
                    except NoNodeError:
                        return False
                    r.read_stat()
                    return True

                try:
                    if not _parent_landed():
                        self._write_call(
                            OP_CREATE,
                            _pack_str(parent) + _pack_buffer(b"")
                            + _OPEN_ACL + struct.pack(">i", 0),
                            _parent_landed,
                        )
                except NodeExistsError:  # a lost parent race: the parent exists
                    pass
        payload = (
            _pack_str(full) + _pack_buffer(value) + _OPEN_ACL
            + struct.pack(">i", 0)  # flags: persistent, not sequential
        )
        r = self._write_call(OP_CREATE, payload, _landed)
        return r.read_str() if r is not None else full

    def set_data(self, path: str, value: bytes,
                 version: int = -1) -> Optional[ZnodeStat]:
        """``setData`` with kazoo's ``set`` semantics (version -1: any).
        Landed: the znode carries exactly the written bytes."""

        def _landed() -> bool:
            try:
                data, _ = self.get(path)
            except NoNodeError:
                return False
            return data == value

        payload = (
            _pack_str(self._path(path)) + _pack_buffer(value)
            + struct.pack(">i", version)
        )
        r = self._write_call(OP_SET_DATA, payload, _landed)
        return r.read_stat() if r is not None else None

    #: kazoo's name (``KazooClient.set``).
    set = set_data

    def delete(self, path: str, version: int = -1,
               **_kazoo_compat) -> None:
        """Delete a znode. Landed: the znode is gone."""

        def _landed() -> bool:
            return self.exists(path) is None

        payload = _pack_str(self._path(path)) + struct.pack(">i", version)
        self._write_call(OP_DELETE, payload, _landed)

    # -- teardown ---------------------------------------------------------

    def stop(self) -> None:
        """Close the session (``closeSession``), best effort."""
        if self._sock is None:
            return
        try:
            self._xid += 1
            self._send_frame(struct.pack(">ii", self._xid, OP_CLOSE))
            # Read the close ack so the server sees a clean end.
            self._sock.settimeout(1.0)
            try:
                self._recv_frame()
            except (OSError, ZkWireError):  # the session is ending either way
                pass
        except OSError:  # an already-dead socket: nothing to report to
            pass

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
