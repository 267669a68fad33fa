"""The resident assigner daemon for one cluster, ``ka-daemon``: the port of
the reference's ``kafka_assigner_tpu/daemon/service.py`` in its
single-cluster form (``AssignerDaemon(zk_string=...)`` under
``KA_DISPATCH=0``, the reference's own lock regime).

One process keeps the torch import, the CUDA context, the leadership
kernel's module and the cluster's encode resident, fed by ZooKeeper watches
(``supervisor.py``), and serves:

=========== ====== ==========================================================
endpoint    method behavior
=========== ====== ==========================================================
/plan       POST   mode 3 against the cache; the body mirrors the CLI's
                   flags (``topics``, ``integer_broker_ids``,
                   ``broker_hosts``, ``broker_hosts_to_remove``,
                   ``desired_replication_factor``, ``disable_rack_awareness``,
                   ``solver``, ``failure_policy``); the response is the
                   schema-v1 run report of that request with a ``result``
                   section whose ``stdout`` is byte-identical to a fresh CLI
                   run on the same metadata
/whatif     POST   RANK_DECOMMISSION likewise (``scenarios``: removal sets)
/healthz    GET    ``{"status": lifecycle, "stale": bool}``
/readyz     GET    200 while ready or degraded, else 503 with Retry-After
/state      GET    the cache: lifecycle, version, brokers, topics, the encode
                   shape, watches, solver, policy, breaker and counters
=========== ====== ==========================================================

Every other path answers 404. The lifecycle is ``syncing``, ``ready``,
``degraded`` (the cache is stale: responses carry ``status: "degraded"``),
``draining`` and ``stopped``. A bad request is a 400, never a 500; past
``KA_DAEMON_MAX_INFLIGHT`` admitted requests a 503 with ``Retry-After``.
SIGTERM (or SIGINT) flips ``/readyz`` to 503, lets the requests in flight
finish within ``KA_DAEMON_DRAIN_TIMEOUT`` and exits 0.

The HTTP server is ``ThreadingHTTPServer``, one thread per connection. The
drain waits for each POST's reply to be written, not only for its solve.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from .supervisor import POLL_S, ClusterSupervisor

#: The name of the one cluster (the reference's single-cluster default).
DEFAULT_CLUSTER = "default"

#: Query parameters whose values are booleans (merged into a POST's body).
_BOOL_QUERY_PARAMS = frozenset({"disable_rack_awareness"})


def _norm_query_value(key: str, raw: str):
    """A known boolean query parameter's spellings map both ways
    (``?disable_rack_awareness=0`` is False, not the truthy string); every
    other parameter passes through as its string."""
    if key not in _BOOL_QUERY_PARAMS:
        return raw
    low = raw.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    return raw


class AssignerDaemon:
    """The daemon: the cluster's supervisor and the HTTP surface.

    ``device`` is where the device solver and the what-if sweep run
    (``cuda`` unless the caller asks for the CPU); a ``cuda`` daemon
    without a card raises here, before anything is served."""

    def __init__(
        self,
        zk_string: str,
        *,
        solver: str = "device",
        device: str = "cuda",
        failure_policy: Optional[str] = None,
        bind: Optional[str] = None,
        port: Optional[int] = None,
        err=None,
    ) -> None:
        from ..solvers.torch_solver import solve_device
        from ..utils.env import env_float, env_int, env_str

        solve_device(device, "ka-daemon")
        self.solver = solver
        self.device = device
        self.bind = bind if bind is not None else env_str("KA_DAEMON_BIND")
        self.port = port if port is not None else env_int("KA_DAEMON_PORT")
        self.drain_timeout = env_float("KA_DAEMON_DRAIN_TIMEOUT")
        self.err = err if err is not None else sys.stderr
        self.draining = threading.Event()
        self.stopped = threading.Event()
        #: One solve at a time: one device, one capture.
        self._solve_lock = threading.Lock()
        self._sup = ClusterSupervisor(
            DEFAULT_CLUSTER, zk_string,
            solver=solver, device=device, failure_policy=failure_policy,
            draining=self.draining, stopped=self.stopped,
            solve_lock=self._solve_lock, err=self.err,
        )
        #: POST handlers between their read and their reply's last byte.
        self._posts = 0
        self._posts_lock = threading.Lock()
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    # -- accessors ------------------------------------------------------------------

    def supervisor(self) -> ClusterSupervisor:
        return self._sup

    def counters(self) -> Dict[str, int]:
        return self.supervisor().counters()

    def lifecycle(self) -> str:
        return self.supervisor().lifecycle()

    def _log(self, msg: str) -> None:
        print(f"ka-daemon: {msg}", file=self.err)

    # -- lifecycle --------------------------------------------------------------------

    def start(self) -> None:
        """Build the native libraries (the solve path only loads them), fail
        fast on a solver that cannot be made (``native`` not built), run
        the first sync (bounded retries, then ``IngestError``), then serve."""
        from ..native.build import prebuild_native_libraries
        from ..solvers.base import get_solver

        prebuild_native_libraries(err=self.err)
        get_solver(self.solver, device=self.device)
        sup = self.supervisor()
        sup.start()
        self.httpd = _build_http_server(self, self.bind, self.port)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": POLL_S},
            name="ka-daemon-http", daemon=True,
        )
        self._serve_thread.start()
        self._log(
            f"listening on http://{self.bind}:{self.httpd.server_address[1]}"
            f" (solver={self.solver}, watches="
            f"{'on' if sup.uses_watches() else 'off'})"
        )

    @property
    def http_port(self) -> int:
        assert self.httpd is not None
        return self.httpd.server_address[1]

    def request_stop(self) -> None:
        """Signal-safe: flip into draining; :meth:`shutdown` (or
        :meth:`serve`) completes the drain."""
        self.draining.set()

    def _in_flight(self) -> int:
        with self._posts_lock:
            return max(self._posts, self.supervisor().active_requests())

    def shutdown(self) -> None:
        """Drain and stop: refuse new requests, wait up to
        ``KA_DAEMON_DRAIN_TIMEOUT`` for those in flight to be answered, then
        tear everything down."""
        self.draining.set()
        deadline = time.monotonic() + self.drain_timeout
        while time.monotonic() < deadline and self._in_flight():
            time.sleep(0.01)
        left = self._in_flight()
        if left:
            self._log(
                f"drain timeout: {left} request(s) still in flight; exiting anyway"
            )
        self.stopped.set()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.supervisor().teardown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        self._log("drained; exiting 0")

    def serve(self) -> int:
        """Block until a stop is requested (the SIGTERM handler calls
        :meth:`request_stop`), then drain and return 0."""
        while not self.draining.is_set():
            self.draining.wait(POLL_S)
        self.shutdown()
        return 0


def _build_http_server(daemon: AssignerDaemon, bind: str,
                       port: int) -> ThreadingHTTPServer:
    sup = daemon.supervisor()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # stderr carries the daemon's lines only
            pass

        def _reply(self, code: int, body: dict,
                   headers: Optional[dict] = None) -> None:
            raw = json.dumps(body, sort_keys=True).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(raw)
            except (BrokenPipeError, ConnectionResetError):  # the client went away
                pass

        def do_GET(self) -> None:
            path = urlsplit(self.path).path
            if path == "/healthz":
                self._reply(200, {"status": sup.lifecycle(), "stale": sup.stale()})
            elif path == "/readyz":
                life = sup.lifecycle()
                ready = life in ("ready", "degraded")
                self._reply(
                    200 if ready else 503,
                    {"ready": ready, "status": life},
                    None if ready else {"Retry-After": "5"},
                )
            elif path == "/state":
                self._reply(200, sup.state_view())
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self) -> None:
            with daemon._posts_lock:
                daemon._posts += 1
            try:
                self._do_post()
            finally:
                with daemon._posts_lock:
                    daemon._posts -= 1

        def _do_post(self) -> None:
            split = urlsplit(self.path)
            if split.path not in ("/plan", "/whatif"):
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
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
            code, body, headers = sup.handle(split.path, params)
            self._reply(code, body, headers)

    httpd = ThreadingHTTPServer((bind, port), Handler)
    httpd.daemon_threads = True
    return httpd


def run_daemon_process(daemon: AssignerDaemon) -> int:
    """Install the signal handlers, start ``daemon``, serve until SIGTERM
    or SIGINT, drain, return 0. ``ka-daemon`` lands here."""
    import signal

    def _sig(_signo, _frame):
        daemon.request_stop()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    daemon.start()
    return daemon.serve()
