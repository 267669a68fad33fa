"""The resident assigner daemon, ``ka-daemon``: the port of the reference's
``kafka_assigner_tpu/daemon/service.py``.

One process keeps the torch import, the CUDA context, the kernels' modules
and each cluster's encode resident, fed by ZooKeeper watches
(``supervisor.py``), for one cluster (``zk_string``) or many
(``clusters``: one :class:`~.supervisor.ClusterSupervisor` each, with its
own session, watch loop, cache, inflight gate, watchdog and breaker). One
dispatch plane serves them all (one device): by default the coalescing
:class:`~.dispatch.SolveDispatcher`, under ``KA_DISPATCH=0`` one solve lock.
One :class:`~.fleet.FleetScheduler` arbitrates every cluster's controller
actions and their move budget (``ka-fleet.json`` in the journal directory)
and, at boot, after the first syncs and before the HTTP surface exists,
drives the interrupted executions it finds there to an end.
Requests route by path:

================================ ====== ======================================
endpoint                         method behavior
================================ ====== ======================================
/clusters/<name>/plan            POST   mode 3 against that cluster's cache;
                                        the body mirrors the CLI's flags
                                        (``topics``, ``integer_broker_ids``,
                                        ``broker_hosts``,
                                        ``broker_hosts_to_remove``,
                                        ``desired_replication_factor``,
                                        ``disable_rack_awareness``,
                                        ``solver``, ``failure_policy``); the
                                        response is the schema-v1 run report
                                        of the request with a ``result``
                                        section whose ``stdout`` is
                                        byte-identical to a fresh CLI run
/clusters/<name>/whatif          POST   RANK_DECOMMISSION likewise
                                        (``scenarios``: removal sets)
/clusters/<name>/execute         POST   a plan (``plan_text`` or ``plan``)
                                        driven to convergence by
                                        ``exec/engine.py``, one at a time a
                                        cluster (409 past it), journaled as
                                        ``ka-execute`` journals, its progress
                                        streamed as NDJSON events
/clusters/<name>/recommendations GET    observe only: the cached assignment
                                        scored against a candidate plan's,
                                        the movement priced against
                                        ``KA_HEALTH_MOVE_COST``
                                        (``?move_cost=``), a ``recommend`` or
                                        ``hold`` verdict; never executed
/clusters/<name>/groups/plan     GET,   consumer-group packing plan, or the
/clusters/<name>/groups/sweep    POST   autoscale sweep, over the backend's
                                        group state (``synthetic=true`` opts
                                        into the synthetic family)
/clusters/<name>/controller      GET,   the closed-loop controller
                                 POST   (``controller.py``): GET returns
                                        its policy (``off``, ``observe``,
                                        ``auto``), pause and breaker state,
                                        streak, window budget, last decision
                                        and decision ring; POST ``{"action":
                                        "pause"}`` or ``"resume"`` gates it
/clusters/<name>/healthz         GET    lifecycle, staleness and breaker
/clusters/<name>/readyz          GET    that cluster's readiness
/clusters/<name>/state           GET    that cluster's cache
/clusters/<name>/debug/flight    GET    the flight ring, that cluster's
/healthz /readyz /state          GET    one cluster: its own (``/healthz``
                                        ``{"status", "stale"}``); many: the
                                        worst lifecycle of all, ready while
                                        any cluster serves, every view, and
                                        the fleet's summary
/plan /whatif /execute           POST   one cluster only; with many a 400
/recommendations /groups/...     GET    naming the clusters
/controller                      GET,
                                 POST
/metrics                         GET    Prometheus text of the cumulative
                                        registry (``obs/promtext.py``):
                                        ``@cluster`` names as ``cluster``
                                        labels, request latency by endpoint
                                        and cluster, process gauges
/debug/flight                    GET    the flight ring (``?cluster=`` one
                                        cluster's events)
/fleet                           GET    the fleet scheduler (one cluster or
                                        many): recovery summary, live
                                        leases, the rolling move budget, the
                                        decision ring
/debug/profile?seconds=N         GET    one ``torch.profiler`` window into
                                        ``KA_OBS_PROFILE_DIR`` (400 when
                                        unset, 409 while another runs)
================================ ====== ======================================

Every other path answers 404. The lifecycle is ``syncing``, ``ready``,
``degraded`` (the cache is stale: responses carry ``status: "degraded"``),
``draining`` and ``stopped``. A bad request is a 400, never a 500; past
``KA_DAEMON_MAX_INFLIGHT`` admitted requests of a cluster a 503 with
``Retry-After``. Each request carries a request ID, a sane
``X-Request-Id`` header's or a fresh one, in the response's header, in
``result.request_id`` and on every span of its capture, and gets one
NDJSON access-log line (``--access-log``, ``KA_OBS_ACCESS_LOG``, else
stderr). SIGTERM (or SIGINT) flips ``/readyz`` to 503, lets the requests
and executions in flight finish within ``KA_DAEMON_DRAIN_TIMEOUT``, dumps
the flight ring to ``KA_OBS_FLIGHT_DUMP`` and exits 0; a crashing exit
dumps it too.

The HTTP server hands accepted connections to a bounded pool of
``KA_DAEMON_HTTP_WORKERS`` threads, with a listen backlog of 1,024: a burst
of clients waits in the accept queue instead of forking a thread each. The
drain waits for each handler's reply and access-log line, not only for its
solve; then the dispatcher dispatches what is still queued, and the drain
waits again for the replies of the requests it served.
"""
from __future__ import annotations

import json
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..obs import flight
from ..obs import metrics as obs_metrics
from ..obs.report import REPORT_SCHEMA_VERSION, TOOL_NAME, AccessLog
from .controller import SharedTicker, resolve_policy
from .dispatch import SolveDispatcher
from .fleet import FleetScheduler
from .supervisor import POLL_S, ClusterSupervisor

#: The name of a single-cluster daemon's one cluster.
DEFAULT_CLUSTER = "default"

#: Worst-first lifecycle order of the ``/healthz`` aggregate.
_LIFECYCLE_ORDER = ("stopped", "draining", "syncing", "degraded", "ready")

#: Query parameters whose values are booleans (both spellings map).
_BOOL_QUERY_PARAMS = frozenset({"resume", "synthetic", "disable_rack_awareness"})


def _valid_cluster_name(name: str) -> bool:
    return bool(name) and all(c.isalnum() or c in "_.-" for c in name)


def _split_cluster_spec(name: str, spec) -> Tuple[str, Optional[str]]:
    """``(connect, controller_policy)`` of one cluster's spec: a connect
    string; ``connect#controller=<policy>`` (split on the last ``#``); or the
    object form ``{"connect": ..., "controller": ...}``."""
    if isinstance(spec, dict):
        connect = spec.get("connect")
        if not isinstance(connect, str) or not connect:
            raise ValueError(
                f"cluster {name!r}: object spec needs a non-empty "
                "'connect' string"
            )
        policy = spec.get("controller")
        if policy is not None and not isinstance(policy, str):
            raise ValueError(
                f"cluster {name!r}: 'controller' must be a string policy"
            )
        unknown = set(spec) - {"connect", "controller"}
        if unknown:
            raise ValueError(
                f"cluster {name!r}: unknown spec keys {sorted(unknown)}"
            )
        return connect, policy
    if not isinstance(spec, str) or not spec:
        raise ValueError(
            f"cluster {name!r}: spec must be a connect string or an "
            f"object, got {spec!r}"
        )
    if "#controller=" in spec:
        connect, _, policy = spec.rpartition("#controller=")
        if not connect or not policy:
            raise ValueError(
                f"cluster {name!r}: malformed controller override in "
                f"{spec!r} (expected connect#controller=off|observe|auto)"
            )
        return connect, policy
    return spec, None


def _norm_query_value(key: str, raw: str):
    """A known boolean query parameter's spellings map both ways
    (``?synthetic=0`` is False, not the truthy string); every other
    parameter passes through as its string (``?counts=1`` stays "1")."""
    if key not in _BOOL_QUERY_PARAMS:
        return raw
    low = raw.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    return raw


def _request_id(headers) -> str:
    """The request's correlation ID: a client's ``X-Request-Id`` when it
    is at most 128 printable characters (no control character can forge a
    log line), else a fresh 16-hex-character ID."""
    raw = (headers.get("X-Request-Id") or "").strip()
    if raw and len(raw) <= 128 and raw.isprintable():
        return raw
    return uuid.uuid4().hex[:16]


class AssignerDaemon:
    """The daemon: the clusters' supervisors and the HTTP surface.

    Pass ``zk_string`` for one cluster (the single-cluster surface, bare
    paths) or ``clusters`` (name -> connect spec) for many; a spec may
    carry a controller policy (``connect#controller=auto`` or ``{"connect":
    ..., "controller": ...}``), else ``KA_CONTROLLER`` decides. ``device``
    is where the device solver, the what-if sweep and the group packing run
    (``cuda`` unless the caller asks for the CPU); a ``cuda`` daemon
    without a card raises here, before anything is served.
    ``controller_rng`` draws every controller's jitter (tests seed it)."""

    def __init__(
        self,
        zk_string: Optional[str] = None,
        *,
        clusters: Optional[Dict[str, object]] = None,
        solver: str = "device",
        device: str = "cuda",
        failure_policy: Optional[str] = None,
        bind: Optional[str] = None,
        port: Optional[int] = None,
        access_log: Optional[str] = None,
        controller_rng=None,
        err=None,
    ) -> None:
        from ..solvers.torch_solver import solve_device
        from ..utils.env import env_bool, env_float, env_int, env_str

        if (zk_string is None) == (clusters is None):
            raise ValueError(
                "pass exactly one of zk_string (single-cluster) or "
                "clusters (name -> connect spec)"
            )
        self.single = clusters is None
        if self.single:
            clusters = {DEFAULT_CLUSTER: zk_string}
        if not clusters:
            raise ValueError("clusters must name at least one cluster")
        connects: Dict[str, Tuple[str, str]] = {}
        for name, spec in clusters.items():
            if not _valid_cluster_name(name):
                raise ValueError(
                    f"invalid cluster name {name!r} (letters, digits, "
                    "'_', '.', '-' only)"
                )
            connect, policy = _split_cluster_spec(name, spec)
            connects[name] = (connect, resolve_policy(policy))
        solve_device(device, "ka-daemon")
        self.solver = solver
        self.device = device
        self.bind = bind if bind is not None else env_str("KA_DAEMON_BIND")
        self.port = port if port is not None else env_int("KA_DAEMON_PORT")
        self.drain_timeout = env_float("KA_DAEMON_DRAIN_TIMEOUT")
        self.err = err if err is not None else sys.stderr
        # The telemetry plane, one per daemon lifetime: the cumulative
        # registry (/metrics), the flight ring (/debug/flight) and the
        # access log. The one-shot CLI enables none of them.
        obs_metrics.enable_cumulative()
        flight.enable()
        self.access_log = AccessLog(
            access_log if access_log is not None
            else env_str("KA_OBS_ACCESS_LOG"),
            err=self.err,
        )
        self.draining = threading.Event()
        self.stopped = threading.Event()
        #: One solve at a time across every cluster: one device, one
        #: capture. Admission and shedding stay per cluster.
        self._solve_lock = threading.Lock()
        #: The coalescing dispatcher, one for every cluster (one device);
        #: None under KA_DISPATCH=0, where every solve takes the lock. Read
        #: once a daemon.
        self.dispatcher: Optional[SolveDispatcher] = (
            SolveDispatcher(err=self.err) if env_bool("KA_DISPATCH") else None
        )
        #: One tick generator for every cluster's controller, so their
        #: evaluations start together and pack into one dispatch a round.
        #: Its thread starts with the first controller that is not `off`.
        self.ticker = SharedTicker(self.stopped)
        self.supervisors: Dict[str, ClusterSupervisor] = {
            name: ClusterSupervisor(
                name, connect,
                solver=solver, device=device, failure_policy=failure_policy,
                label="" if self.single else name,
                draining=self.draining, stopped=self.stopped,
                solve_lock=self._solve_lock, dispatcher=self.dispatcher,
                controller_policy=policy, ticker=self.ticker,
                controller_rng=controller_rng, err=self.err,
            )
            for name, (connect, policy) in connects.items()
        }
        #: The daemon-wide fleet scheduler, shared by every cluster's
        #: controller; it also owns the boot-time journal recovery.
        self.fleet = FleetScheduler(err=self.err)
        for sup in self.supervisors.values():
            sup.fleet = self.fleet
        #: HTTP handlers between their request and their access-log line.
        self._handlers = 0
        self._handlers_lock = threading.Lock()
        self.httpd: Optional[HTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    # -- accessors ------------------------------------------------------------------

    def supervisor(self, name: Optional[str] = None) -> ClusterSupervisor:
        """The named cluster's supervisor (one cluster: the only one)."""
        if name is None:
            if not self.single:
                raise KeyError(
                    "multi-cluster daemon: name one of "
                    f"{sorted(self.supervisors)}"
                )
            name = DEFAULT_CLUSTER
        return self.supervisors[name]

    def counters(self) -> Dict[str, int]:
        """The clusters' counters: plain names for one cluster,
        ``name@cluster`` for many."""
        out: Dict[str, int] = {}
        for name, sup in self.supervisors.items():
            for k, v in sup.counters().items():
                key = k if self.single else f"{k}@{name}"
                out[key] = out.get(key, 0) + v
        return out

    def lifecycle(self) -> str:
        """The worst cluster's lifecycle (one cluster: its own)."""
        if self.stopped.is_set():
            return "stopped"
        if self.draining.is_set():
            return "draining"
        states = [sup.lifecycle() for sup in self.supervisors.values()]
        for s in _LIFECYCLE_ORDER:
            if s in states:
                return s
        return "ready"

    def _log(self, msg: str) -> None:
        print(f"ka-daemon: {msg}", file=self.err)

    # -- lifecycle --------------------------------------------------------------------

    def start(self) -> None:
        """Build the native libraries (the solve path only loads them), fail
        fast on a solver that cannot be made (``native`` not built), start
        every supervisor, then serve. One cluster: its first sync must
        complete (bounded retries, then ``IngestError``). Many: a cluster
        that cannot sync starts behind its breaker and the rest serve."""
        from ..native.build import prebuild_native_libraries
        from ..solvers.base import get_solver

        flight.record("daemon", event="start", clusters=sorted(self.supervisors))
        prebuild_native_libraries(err=self.err)
        get_solver(self.solver, device=self.device)
        for sup in self.supervisors.values():
            sup.start(require_sync=self.single)
        # Boot recovery, synchronous and before the HTTP surface exists: a
        # killed daemon's interrupted journals converge first, and the
        # controllers are deferred ("recovery pending") until it ends.
        self.fleet.recover(self.supervisors)
        self.httpd = _build_http_server(self, self.bind, self.port)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": POLL_S},
            name="ka-daemon-http", daemon=True,
        )
        self._serve_thread.start()
        if self.single:
            what = (f"watches="
                    f"{'on' if self.supervisor().uses_watches() else 'off'}")
        else:
            what = f"clusters={','.join(sorted(self.supervisors))}"
        self._log(
            f"listening on http://{self.bind}:{self.httpd.server_address[1]}"
            f" (solver={self.solver}, {what})"
        )

    @property
    def http_port(self) -> int:
        assert self.httpd is not None
        return self.httpd.server_address[1]

    def request_stop(self) -> None:
        """Signal-safe: flip into draining; :meth:`shutdown` (or
        :meth:`serve`) completes the drain."""
        self.draining.set()

    def _active_total(self) -> int:
        return sum(sup.active_requests() for sup in self.supervisors.values())

    def _in_flight(self) -> int:
        with self._handlers_lock:
            return max(self._handlers, self._active_total())

    def shutdown(self) -> None:
        """Drain and stop: refuse new requests, wait up to
        ``KA_DAEMON_DRAIN_TIMEOUT`` for those in flight (executions too) to
        be answered, tear everything down, and dump the flight ring to
        ``KA_OBS_FLIGHT_DUMP``. A journal left mid-execution resumes."""
        self.draining.set()
        flight.record("daemon", event="draining")
        deadline = time.monotonic() + self.drain_timeout
        while time.monotonic() < deadline and self._in_flight():
            time.sleep(0.01)
        left = self._in_flight()
        if left:
            self._log(
                f"drain timeout: {left} request(s) still in flight; exiting anyway"
            )
        if self.dispatcher is not None:
            # After the drain window: a request the drain gave up on may
            # still wait on a queued job. close() dispatches every queued
            # job now (later jobs take their callers' direct paths), and
            # the replies it unblocks get another window to be written.
            self.dispatcher.close()
            deadline = time.monotonic() + self.drain_timeout
            while time.monotonic() < deadline and self._in_flight():
                time.sleep(0.01)
        self.stopped.set()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        for sup in self.supervisors.values():
            sup.teardown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        flight.record("daemon", event="stopped", inflight_at_exit=left)
        flight.flush_to_dump(err=self.err)
        if left == 0:
            # A straggler past the drain may still write its line: the file
            # stays open for it, and the exit closes it.
            self.access_log.close()
        # Back to the CLI's disabled state: a later run in this process
        # records into no dead daemon's registry or ring.
        obs_metrics.disable_cumulative()
        flight.disable()
        self._log("drained; exiting 0")

    def serve(self) -> int:
        """Block until a stop is requested (the SIGTERM handler calls
        :meth:`request_stop`), then drain and return 0."""
        while not self.draining.is_set():
            self.draining.wait(POLL_S)
        self.shutdown()
        return 0

    # -- aggregate views (many clusters) ---------------------------------------------

    def healthz_aggregate(self) -> dict:
        return {
            "status": self.lifecycle(),
            "clusters": {
                name: sup.healthz_view()
                for name, sup in self.supervisors.items()
            },
        }

    def readyz_aggregate(self) -> Tuple[bool, dict]:
        """Ready while any cluster can answer: one dead quorum does not
        unready the others (each cluster's own ``/readyz`` is strict)."""
        per = {n: s.lifecycle() for n, s in self.supervisors.items()}
        ready = not self.draining.is_set() and any(
            s in ("ready", "degraded") for s in per.values()
        )
        return ready, {"ready": ready, "status": self.lifecycle(), "clusters": per}


#: Per-cluster path suffixes of the POST and GET routes.
_POST_SUFFIXES = ("/plan", "/whatif", "/execute", "/groups/plan", "/groups/sweep",
                  "/controller")
_GET_SUFFIXES = ("/healthz", "/readyz", "/state", "/debug/flight",
                 "/recommendations", "/groups/plan", "/groups/sweep",
                 "/controller")
#: The consumer-group endpoints, on GET (query) and POST (body) alike.
_GROUPS_SUFFIXES = ("/groups/plan", "/groups/sweep")


def _render_metrics(daemon: AssignerDaemon) -> str:
    """The ``/metrics`` body: the cumulative registry, and the process and
    build-info gauges."""
    import platform

    from ..obs import promtext

    cum = obs_metrics.cumulative()
    snapshot = cum.snapshot() if cum is not None else {
        "counters": {}, "gauges": {}, "hists": {},
    }
    started = cum.started_at if cum is not None else time.time()
    info = {
        "tool": TOOL_NAME,
        "report_schema": str(REPORT_SCHEMA_VERSION),
        "python": platform.python_version(),
        "mode": "single" if daemon.single else "multi",
    }
    extra = {
        "process_start_time_seconds": started,
        "process_uptime_seconds": round(time.time() - started, 3),
        "daemon_clusters": len(daemon.supervisors),
        "daemon_inflight_requests": daemon._active_total(),
    }
    rec = flight.recorder()
    if rec is not None:
        stats = rec.stats()
        extra["flight_events_recorded"] = stats["recorded"]
        extra["flight_events_dropped"] = stats["dropped"]
    return promtext.render(snapshot, extra_gauges=extra, info=info)


def _flight_view(cluster: Optional[str] = None) -> dict:
    rec = flight.recorder()
    if rec is None:
        return {"error": "flight recorder disabled (KA_OBS_FLIGHT_EVENTS=0)",
                "events": []}
    return rec.view(cluster=cluster)


class _PoolServer(HTTPServer):
    """An HTTP server with a bounded pool of handler threads
    (``KA_DAEMON_HTTP_WORKERS``), the reference's worker-pool ``Server``:
    accepted connections queue to long-lived workers; when the queue is
    full the accept loop blocks and further connections wait in the
    listen backlog (``request_queue_size``), sized for a burst of 1,024
    clients. A stop ends the block: the connection it held closes
    unanswered."""

    request_queue_size = 1024

    def __init__(self, addr, handler) -> None:
        super().__init__(addr, handler)
        from ..utils.env import env_int

        self._closing = False
        n = env_int("KA_DAEMON_HTTP_WORKERS")
        self._work: queue.Queue = queue.Queue(maxsize=max(2 * n, 8))
        self._workers = [
            threading.Thread(target=self._worker, name=f"ka-http-{i}", daemon=True)
            for i in range(n)
        ]
        for t in self._workers:
            t.start()

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            request, client_address = item
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)

    def process_request(self, request, client_address) -> None:
        while True:
            try:
                self._work.put((request, client_address), timeout=0.1)
                return
            except queue.Full:
                if self._closing:
                    self.shutdown_request(request)
                    return

    def shutdown(self) -> None:
        self._closing = True
        super().shutdown()

    def server_close(self) -> None:
        super().server_close()
        # Sentinels without blocking: with every worker busy and the queue
        # full, the workers are daemon threads and die with the process.
        for _ in self._workers:
            try:
                self._work.put_nowait(None)
            except queue.Full:
                break
        # A short join: an idle worker takes its sentinel at once; one still
        # streaming past the drain (a daemon thread) must not hold the exit.
        deadline = time.monotonic() + 1.0
        for t in self._workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


#: Seconds a pooled HTTP worker waits for the next request line of an idle
#: keep-alive connection before it closes the connection.
KEEPALIVE_TIMEOUT_S = 30.0


class _ReplyOrder:
    """Runs each request's telemetry record in the order the replies went
    out. A reply draws a ticket just before its body is written, and its
    record, made after the write, runs once every earlier ticket's has run:
    a client's next request, served by another worker, can then never be
    recorded before the reply that preceded it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._drawn = 0
        self._due = 0
        self._ready: Dict[int, object] = {}

    def ticket(self) -> int:
        with self._lock:
            self._drawn += 1
            return self._drawn - 1

    def emit(self, ticket: int, record) -> None:
        with self._lock:
            self._ready[ticket] = record
            while self._due in self._ready:
                run = self._ready.pop(self._due)
                self._due += 1
                run()


def _build_http_server(daemon: AssignerDaemon, bind: str,
                       port: int) -> HTTPServer:
    order = _ReplyOrder()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        #: The socket's read timeout: an idle keep-alive connection waiting
        #: on its next request line would otherwise pin a pooled worker for
        #: good. After it the read fails and the connection closes.
        timeout = KEEPALIVE_TIMEOUT_S

        def log_message(self, fmt, *args):  # stderr carries the daemon's lines only
            pass

        def _begin(self) -> None:
            """Per-request state (one handler serves a keep-alive
            connection's requests)."""
            self._t0 = time.perf_counter()
            self._rid = _request_id(self.headers)
            self._code: Optional[int] = None
            self._sup: Optional[ClusterSupervisor] = None
            self._endpoint: Optional[str] = None
            self._status: Optional[str] = None
            self._ticket: Optional[int] = None

        def _access(self, method: str, path: str) -> None:
            """One access-log line a request, the routing layer's latency
            histogram and request counter by endpoint, cluster and code, and
            a flight summary of each POST, in the order of the replies."""
            ticket = self._ticket if self._ticket is not None else order.ticket()
            record = None
            try:
                ms = round((time.perf_counter() - self._t0) * 1000.0, 3)
                sup = self._sup
                line = dict(
                    request_id=self._rid,
                    method=method,
                    path=path,
                    cluster=sup.name if sup is not None else None,
                    code=self._code,
                    status=self._status,
                    ms=ms,
                    inflight=sup.active_requests() if sup is not None else 0,
                    stale=sup.stale() if sup is not None else False,
                    degraded=self._status == "degraded",
                )
                endpoint = self._endpoint

                def record() -> None:
                    daemon.access_log.log(**line)
                    cum = obs_metrics.cumulative()
                    if cum is not None and endpoint is not None:
                        labels = {"endpoint": endpoint}
                        if sup is not None:
                            labels["cluster"] = sup.name
                        cum.hist_observe("daemon.http.request_ms", ms, labels=labels)
                        cum.counter_add(
                            "daemon.http.requests", 1,
                            labels={**labels, "code": str(line["code"])},
                        )
                    if method == "POST":
                        flight.record(
                            "request", line["cluster"], request_id=line["request_id"],
                            path=path, code=line["code"], status=line["status"],
                            ms=ms,
                        )
            finally:
                # Every ticket is emitted, or every later record would wait.
                order.emit(ticket, record or (lambda: None))

        def _serve(self, method: str, body) -> None:
            with daemon._handlers_lock:
                daemon._handlers += 1
            try:
                self._begin()
                try:
                    body()
                finally:
                    self._access(method, urlsplit(self.path).path)
            finally:
                with daemon._handlers_lock:
                    daemon._handlers -= 1

        def _send(self, code: int, raw: bytes, content_type: str,
                  headers: Optional[dict] = None) -> None:
            self._code = code
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.send_header("X-Request-Id", self._rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self._ticket is None:
                self._ticket = order.ticket()
            try:
                self.wfile.write(raw)
            except (BrokenPipeError, ConnectionResetError):  # the client went away
                pass

        def _reply(self, code: int, body: dict,
                   headers: Optional[dict] = None) -> None:
            raw = json.dumps(body, sort_keys=True).encode("utf-8")
            self._send(code, raw, "application/json", headers)

        def _route(self, path: str):
            """``(supervisor, suffix)`` of a path, or None once a refusal is
            answered. Bare paths are the one cluster's; with many clusters
            the data paths need the ``/clusters/<name>`` prefix and the
            bare GET views are the aggregates (supervisor None)."""
            if path.startswith("/clusters/"):
                name, slash, suffix = path[len("/clusters/"):].partition("/")
                sup = daemon.supervisors.get(name)
                if sup is None:
                    self._reply(404, {
                        "error": f"unknown cluster {name!r}",
                        "clusters": sorted(daemon.supervisors),
                    })
                    return None
                return sup, "/" + suffix if slash else ""
            if daemon.single:
                return daemon.supervisor(), path
            if path in _POST_SUFFIXES or path == "/recommendations":
                self._reply(400, {
                    "error": "this daemon serves multiple clusters; use "
                             f"/clusters/<name>{path}",
                    "clusters": sorted(daemon.supervisors),
                })
                return None
            return None, path

        def do_GET(self) -> None:
            self._serve("GET", self._do_get)

        def do_POST(self) -> None:
            self._serve("POST", self._do_post)

        def _debug_profile(self, query: str) -> None:
            from ..obs.profile import ProfilerBusy, capture_window

            self._endpoint = "debug/profile"
            raw = parse_qs(query).get("seconds", ["1"])[-1]
            try:
                seconds = float(raw)
            except ValueError:
                self._reply(400, {"error": f"bad seconds value {raw!r}"})
                return
            try:
                artifact = capture_window(seconds)
            except ProfilerBusy as e:
                self._reply(409, {"error": str(e)})
                return
            except (RuntimeError, ValueError) as e:
                self._reply(400, {"error": str(e)})
                return
            flight.record("profile", seconds=seconds, dir=artifact)
            self._reply(200, {"artifact_dir": artifact, "seconds": seconds})

        def _groups(self, sup: ClusterSupervisor, suffix: str,
                    params: dict) -> None:
            code, body, headers = sup.groups_request(
                suffix.rsplit("/", 1)[-1], params, request_id=self._rid,
            )
            self._status = (
                "degraded" if body.get("degraded")
                else body.get("error") and "error" or "ok"
            )
            self._reply(code, body, headers)

        def _do_get(self) -> None:
            split = urlsplit(self.path)
            path = split.path
            query = parse_qs(split.query)
            if path == "/metrics":
                self._endpoint = "metrics"
                raw = _render_metrics(daemon).encode("utf-8")
                self._send(200, raw, "text/plain; version=0.0.4; charset=utf-8")
                return
            if path == "/debug/flight":
                self._endpoint = "debug/flight"
                self._reply(200, _flight_view(query.get("cluster", [None])[-1]))
                return
            if path == "/debug/profile":
                self._debug_profile(split.query)
                return
            if path == "/fleet":
                # Daemon-wide, as /metrics: one fleet for every cluster.
                self._endpoint = "fleet"
                self._reply(200, daemon.fleet.view())
                return
            routed = self._route(path)
            if routed is None:
                return
            sup, suffix = routed
            self._sup = sup
            self._endpoint = suffix.lstrip("/") or None
            if sup is None:  # the aggregates of many clusters
                if suffix == "/healthz":
                    self._reply(200, daemon.healthz_aggregate())
                elif suffix == "/readyz":
                    ready, body = daemon.readyz_aggregate()
                    self._reply(200 if ready else 503, body,
                                None if ready else {"Retry-After": "5"})
                elif suffix == "/state":
                    fv = daemon.fleet.view()
                    self._reply(200, {
                        "lifecycle": daemon.lifecycle(),
                        "fleet": {k: fv[k] for k in ("recovered", "leases", "window",
                                                     "max_concurrent")},
                        "clusters": {n: s.state_view()
                                     for n, s in daemon.supervisors.items()},
                    })
                else:
                    self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            if suffix not in _GET_SUFFIXES:
                self._reply(404, {"error": f"unknown path {self.path!r}"})
            elif suffix == "/healthz":
                if daemon.single and not path.startswith("/clusters/"):
                    self._reply(200, {"status": sup.lifecycle(),
                                      "stale": sup.stale()})
                else:
                    self._reply(200, sup.healthz_view())
            elif suffix == "/readyz":
                life = sup.lifecycle()
                ready = life in ("ready", "degraded")
                self._reply(200 if ready else 503,
                            {"ready": ready, "status": life},
                            None if ready else {"Retry-After": "5"})
            elif suffix == "/state":
                self._reply(200, sup.state_view())
            elif suffix == "/recommendations":
                params = {k: vals[-1] for k, vals in query.items()}
                code, body, headers = sup.recommendations(
                    params, request_id=self._rid)
                self._status = body.get("verdict") or body.get("error")
                self._reply(code, body, headers)
            elif suffix in _GROUPS_SUFFIXES:
                self._groups(sup, suffix, {
                    k: _norm_query_value(k, vals[-1]) for k, vals in query.items()
                })
            elif suffix == "/controller":
                self._reply(200, sup.controller_view())
            else:  # /debug/flight
                self._reply(200, _flight_view(sup.name))

        def _do_post(self) -> None:
            split = urlsplit(self.path)
            routed = self._route(split.path)
            if routed is None:
                return
            sup, suffix = routed
            if sup is None or suffix not in _POST_SUFFIXES:
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            self._sup = sup
            self._endpoint = suffix.lstrip("/")
            try:
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                params = json.loads(raw or b"{}") if raw.strip() else {}
                if not isinstance(params, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            # Query parameters merge under the body.
            for key, vals in parse_qs(split.query).items():
                params.setdefault(key, _norm_query_value(key, vals[-1]))
            if suffix in _GROUPS_SUFFIXES:
                self._groups(sup, suffix, params)
            elif suffix == "/controller":
                code, body, headers = sup.controller_request(params)
                self._status = (
                    body.get("error") and "error"
                    or ("paused" if body.get("paused") else "ok")
                )
                self._reply(code, body, headers)
            elif suffix == "/execute":
                self._status = "stream"
                self._execute(sup, params)
            else:
                code, body, headers = sup.handle(suffix, params,
                                                 request_id=self._rid)
                self._status = body.get("status")
                self._reply(code, body, headers)

        def _execute(self, sup: ClusterSupervisor, params: dict) -> None:
            """The streaming ``/execute``: a refusal answers JSON; an
            admitted run streams NDJSON events until ``exec/done`` or
            ``exec/error``, then closes the connection (no
            Content-Length)."""
            prep = sup.prepare_execute(params)
            if prep[0] == "error":
                _, code, body = prep
                self._reply(code, body)
                return
            _, ctx = prep
            try:
                self._code = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Request-Id", self._rid)
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
            except Exception as e:
                # The client went away before the stream opened: the slot
                # goes back, or this cluster answers 409 for ever.
                sup.abort_execute()
                print(f"ka-daemon: /execute client gone before the stream "
                      f"opened ({type(e).__name__}: {e}); slot released",
                      file=daemon.err)
                return

            def emit(event: dict) -> None:
                line = json.dumps(event, sort_keys=True) + "\n"
                self.wfile.write(line.encode("utf-8"))
                self.wfile.flush()

            try:
                sup.run_execute(ctx, emit)
            except Exception as e:
                # A kill's stand-in (InjectedExecCrash) or an engine escape:
                # the stream ends with no terminal event, as a killed daemon
                # ends it; the journal holds the resume.
                print(f"ka-daemon: /execute aborted ({type(e).__name__}: {e}); "
                      "journal retains every committed wave", file=daemon.err)

    return _PoolServer((bind, port), Handler)


def run_daemon_process(daemon: AssignerDaemon) -> int:
    """Install the signal handlers, start ``daemon``, serve until SIGTERM
    or SIGINT, drain, return 0. ``ka-daemon`` lands here. A crash on the
    way dumps the flight ring (``KA_OBS_FLIGHT_DUMP``) and re-raises."""
    import signal

    def _sig(_signo, _frame):
        daemon.request_stop()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        daemon.start()
        return daemon.serve()
    except BaseException as e:
        flight.record("daemon", event="crash", error=f"{type(e).__name__}: {e}")
        flight.flush_to_dump()
        raise
