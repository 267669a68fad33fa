"""``ClusterSupervisor``: one cluster's bulkhead inside the daemon, the port
of the reference's ``kafka_assigner_tpu/daemon/supervisor.py``, under
either dispatch regime. One per cluster; each owns:

- the metadata backend's session and the one watch-loop thread;
- the :class:`~.state.DaemonState` cache and its delta encode store;
- the lifecycle: syncing, then ready or degraded (stale cache), draining,
  stopped;
- the request gate: an inflight limit read per request
  (``KA_DAEMON_MAX_INFLIGHT``; beyond it 503 with ``Retry-After``) and a
  watchdog per request (``KA_DAEMON_REQUEST_TIMEOUT``), so a stalled
  resync or a dead quorum on one cluster sheds or stale-serves that
  cluster's requests only;
- the session's circuit breaker: consecutive resync failures open it
  (``KA_DAEMON_BREAKER_THRESHOLD``); while open, resyncs wait out a
  jittered, doubling cooldown (``KA_DAEMON_BREAKER_COOLDOWN``, capped at the
  resync interval), then one probe closes it or opens it again;
- the post-resync warm hook (``solvers/warmup.py:warm_for_assignments`` on
  the daemon's device);
- the health plane: the cached assignment scored (``obs/health.py``) and
  the per-partition traffic series published on every resync and delta
  re-encode, and ``/recommendations`` (observe only, never executed);
- the groups endpoints over the backend's live consumer-group state;
- ``/execute``: one execution at a time (409 past it), on a fresh backend
  session, journaled as ``ka-execute`` journals (the identity is the
  cluster's connect spec and the plan's hash), its progress streamed;
- the closed-loop controller (``controller.py``), which reaches the cache,
  the solve and ``/execute`` only through this class's ``controller_*``
  members.

Each ``/plan`` runs mode 3's pipeline (``generator.py``) against the cache
under the daemon's dispatch regime (``_solve_lock_scope``). Under
``KA_DISPATCH=0`` that is the one solve lock the service shares with every
request of every cluster (one device). By default it is the dispatcher's
scope (``dispatch.py``): request bodies run concurrently, identical ones
once, and their device rows pack on the dispatcher's thread. Either way a
request's capture is its thread's own, so its run report holds only its
own spans. Where the request keeps the whole broker set and the racks,
the device lane takes the cache's merged preencode; a request that
narrows either encodes for itself. In a daemon of many clusters (``label`` set)
metric and span names carry an ``@cluster`` suffix; for one cluster they
are the plain names.

The reference's ``tpu`` solver is the port's ``device``.
"""
from __future__ import annotations

import io
import json
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..errors import ExecuteError, IngestError, SolveError
from ..faults.inject import (
    InjectedExecCrash,
    InjectedSolverCrash,
    active_injector,
    fault_point,
)
from ..generator import (
    Degradation,
    build_rack_assignment,
    print_decommission_ranking,
    print_least_disruptive_reassignment,
    resolve_broker_ids,
    resolve_excluded_broker_ids,
)
from ..io.base import open_backend
from ..io.zkwire import ZkConnectionError, ZkWireError
from ..obs import flight, health
from ..obs import metrics as obs_metrics
from ..obs.metrics import counter_add, gauge_set, hist_ms, hist_observe
from ..obs.trace import record_span
from ..utils.backoff import JitteredBackoff
from .controller import RebalanceController, resolve_policy
from .dispatch import SolveDispatcher, dispatch_scope
from .state import CacheBackend, DaemonState

#: Watch-poll block per loop iteration (also the drain-check cadence).
POLL_S = 0.25


class CircuitBreaker:
    """The session breaker: closed, then (``threshold`` consecutive
    failures) open, then (cooldown elapsed) half-open for one probe, then
    closed, or open again with a longer cooldown. The cooldowns follow the
    shared :class:`JitteredBackoff` envelope (doubling, 0.5-1.5x jitter,
    capped), so daemons fronting one dead quorum do not probe in lockstep.
    Thread-safe: the watch loop probes, request threads read
    :meth:`snapshot`. ``cluster`` names the flight recorder's events."""

    def __init__(self, threshold: int, cooldown: float, cap: float,
                 cluster: Optional[str] = None) -> None:
        self.threshold = max(1, int(threshold))
        self._cooldown = max(0.05, float(cooldown))
        self._cap = max(self._cooldown, float(cap))
        self.cluster = cluster
        self._lock = threading.Lock()
        self._backoff = self._fresh_backoff()
        self.state = "closed"
        self.consecutive_failures = 0
        self._open_until = 0.0

    def _fresh_backoff(self) -> JitteredBackoff:
        return JitteredBackoff(self._cooldown, cap=self._cap)

    def allow_attempt(self) -> bool:
        """May the caller try the session now? Closed or half-open: yes.
        Open: only once the cooldown elapsed, which half-opens it (the one
        probe)."""
        with self._lock:
            if self.state != "open":
                return True
            if time.monotonic() >= self._open_until:
                self.state = "half-open"
                flight.record("breaker", self.cluster, state="half-open")
                return True
            return False

    def record_failure(self) -> bool:
        """Count one session or resync failure; True when this failure
        opened the breaker (a half-open probe's failure always does)."""
        with self._lock:
            self.consecutive_failures += 1
            opening = (
                self.state == "half-open"
                or (self.state == "closed"
                    and self.consecutive_failures >= self.threshold)
            )
            if opening:
                self.state = "open"
                self._open_until = time.monotonic() + self._backoff.next_delay()
                flight.record(
                    "breaker", self.cluster, state="open",
                    failures=self.consecutive_failures,
                )
            return opening

    def record_success(self) -> bool:
        """A session attempt succeeded: close and restart the cooldown
        progression; True when the breaker was open or half-open."""
        with self._lock:
            was_tripped = self.state != "closed"
            self.state = "closed"
            self.consecutive_failures = 0
            self._open_until = 0.0
            self._backoff = self._fresh_backoff()
            if was_tripped:
                flight.record("breaker", self.cluster, state="closed")
            return was_tripped

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "threshold": self.threshold,
            }
            if self.state == "open":
                out["retry_in_s"] = round(
                    max(0.0, self._open_until - time.monotonic()), 3
                )
            return out


class ClusterSupervisor:
    """One cluster's resident state, lifecycle and request handling."""

    def __init__(
        self,
        name: str,
        spec: str,
        *,
        solver: str = "device",
        device: str = "cuda",
        failure_policy: Optional[str] = None,
        label: str = "",
        draining: threading.Event,
        stopped: threading.Event,
        solve_lock: threading.Lock,
        dispatcher: Optional[SolveDispatcher] = None,
        controller_policy: Optional[str] = None,
        ticker=None,
        controller_rng=None,
        err=None,
    ) -> None:
        from ..utils.env import env_bool, env_choice, env_float, env_int

        self.name = name
        self.spec = spec
        #: Metric and span suffix: empty for one cluster (the plain names),
        #: the cluster's name in a daemon of many.
        self.label = label
        self.solver = solver
        self.device = device
        # The KA_FAILURE_POLICY knob unless given, as the CLI: a device
        # solve that crashes answers 500 under strict, and under best-effort
        # the solver's own greedy re-run answers it degraded.
        self.failure_policy = failure_policy or env_choice("KA_FAILURE_POLICY")
        self.draining = draining
        self.stopped = stopped
        self.err = err if err is not None else sys.stderr
        #: The watchdog's budget for tests; None reads the live
        #: KA_DAEMON_REQUEST_TIMEOUT knob per request.
        self.request_timeout: Optional[float] = None
        self.resync_interval = env_float("KA_DAEMON_RESYNC_INTERVAL")
        self.resync_retries = env_int("KA_DAEMON_RESYNC_RETRIES")
        self.watch_enabled = env_bool("KA_DAEMON_WATCH")
        self.breaker = CircuitBreaker(
            env_int("KA_DAEMON_BREAKER_THRESHOLD"),
            env_float("KA_DAEMON_BREAKER_COOLDOWN"),
            cap=self.resync_interval,
            cluster=name,
        )
        #: The lifecycle the flight recorder last saw (it records changes).
        self._flight_lifecycle: Optional[str] = None
        self.state = DaemonState()
        self.backend = None
        self._watch_thread: Optional[threading.Thread] = None
        #: Shared with the service: one device, one capture at a time.
        self._solve_lock = solve_lock
        #: The daemon's dispatcher, shared like the lock it replaces; None
        #: under KA_DISPATCH=0, where every solve takes the lock.
        self._dispatcher = dispatcher
        #: Admitted requests, gated against the live inflight knob.
        self._active = 0
        self._active_lock = threading.Lock()
        #: One /execute at a time on this cluster (409 past it).
        self._exec_lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._counters_lock = threading.Lock()
        self._faults = active_injector()
        self._use_watches = False
        self._armed_generation = -1
        self._warmed_sig = None
        #: Live warm threads, all joined at teardown: a churn that changes
        #: the buckets can start a second warm-up while the first still runs.
        self._warm_threads: list = []
        #: A prompt resync asked for by the request path (the session
        #: seam), for the watchless case where no poll exists to fail.
        self._prompt_resync = False
        #: A session reopen asked for after a controller action, done by the
        #: watch loop (the one thread that owns the session) before its next
        #: resync: a load-once backend (a snapshot file) would otherwise
        #: never show the cache the action's writes.
        self._reopen_requested = False
        #: The last health scores, in /state.
        self._last_health: Optional[health.HealthScores] = None
        #: The daemon's shared tick generator: every cluster's controller
        #: waits on it, so their evaluations pack in the dispatcher. None for
        #: a supervisor built alone, whose controller keeps its own timer.
        self._ticker = ticker
        #: The daemon-wide fleet scheduler (``daemon/fleet.py``), set by the
        #: daemon on every supervisor: the controller's leases and move
        #: budget, and the boot recovery. None for a supervisor built alone,
        #: whose controller acts ungated, as the reference's.
        self.fleet = None
        #: The closed-loop controller: the --clusters override's policy, else
        #: the KA_CONTROLLER knob's (``off`` by default: no thread starts).
        self.controller = RebalanceController(
            self, resolve_policy(controller_policy), rng=controller_rng
        )

    # -- counters (the daemon's lifetime; mirrored into an active capture) ----

    def _metric(self, name: str) -> str:
        return f"{name}@{self.label}" if self.label else name

    def _count(self, name: str, n: int = 1) -> None:
        with self._counters_lock:
            self._counters[name] = self._counters.get(name, 0) + n
        counter_add(self._metric(name), n)

    def counters(self) -> Dict[str, int]:
        with self._counters_lock:
            return dict(self._counters)

    def _log(self, msg: str) -> None:
        prefix = f"ka-daemon[{self.name}]" if self.label else "ka-daemon"
        print(f"{prefix}: {msg}", file=self.err)

    def note_lifecycle(self) -> None:
        """Record a flight ``lifecycle`` event when the lifecycle changed
        since the last one (called where it can change)."""
        state = self.lifecycle()
        if state != self._flight_lifecycle:
            self._flight_lifecycle = state
            flight.record("lifecycle", self.name, state=state)

    # -- live knobs ---------------------------------------------------------------

    def max_inflight(self) -> int:
        """The backpressure gate, read from the environment per request, so
        an operator can change it on a running daemon."""
        from ..utils.env import env_int

        return env_int("KA_DAEMON_MAX_INFLIGHT")

    def _request_budget(self) -> float:
        from ..utils.env import env_float

        if self.request_timeout is not None:
            return self.request_timeout
        return env_float("KA_DAEMON_REQUEST_TIMEOUT")

    # -- lifecycle ------------------------------------------------------------------

    def lifecycle(self) -> str:
        if self.stopped.is_set():
            return "stopped"
        if self.draining.is_set():
            return "draining"
        if not self.state.synced_once:
            return "syncing"
        return "degraded" if self.state.stale else "ready"

    def stale(self) -> bool:
        return self.state.stale

    def uses_watches(self) -> bool:
        """Whether the backend feeds the watch-driven delta re-encode."""
        return self._use_watches

    def active_requests(self) -> int:
        with self._active_lock:
            return self._active

    def start(self, *, require_sync: bool = True) -> None:
        """Open the backend and run the first sync, then start the watch
        loop. ``require_sync`` (one cluster): bounded retries, then
        :class:`IngestError`, since a daemon that cannot read its one
        cluster has nothing to serve. Otherwise (many clusters) a cluster
        that cannot sync starts in ``syncing`` behind its breaker and keeps
        retrying on the resync cadence while the others serve."""
        try:
            self._open_backend()
            synced = self._resync_with_retries()
        except Exception as e:
            if require_sync:
                raise IngestError(
                    f"daemon could not complete its initial cluster sync: {e}"
                ) from e
            self._log(
                f"cluster backend unavailable at startup "
                f"({type(e).__name__}: {e}); serving others, retrying "
                "on the resync cadence"
            )
            synced = False
        if require_sync and not synced:
            if self.backend is not None:
                self.backend.close()
            raise IngestError(
                "daemon could not complete its initial cluster sync "
                f"for {self.spec!r} (see retries above)"
            )
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name=f"ka-daemon-watch-{self.name}",
            daemon=True,
        )
        self._watch_thread.start()
        # Nothing under the default `off` policy.
        self.controller.start()

    def _open_backend(self) -> None:
        self.backend = open_backend(self.spec)
        self._use_watches = self.watch_enabled and bool(
            getattr(self.backend, "supports_watches", lambda: False)()
        )

    def _reopen_backend(self) -> None:
        """A fresh session: a reconnect that exhausted its passes leaves the
        wire client in a terminal state, so a breaker probe always starts
        from a new one (watches re-arm on the next sync). Raises while the
        quorum is still down; the caller counts that against the breaker."""
        old, self.backend = self.backend, None
        self._armed_generation = -1
        if old is not None:
            try:
                old.close()
            except Exception as e:
                self._log(
                    f"old session close failed ({type(e).__name__}: {e}); "
                    "proceeding with the fresh one"
                )
        self._open_backend()

    def teardown(self) -> None:
        """After the drain: join the watch loop and every warm thread (none
        may outlive the daemon and write into a later run in this
        process), close the backend."""
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
        self.controller.join()
        for t in self._warm_threads:
            t.join(timeout=30.0)
        self._warm_threads = []
        if self.backend is not None:
            self.backend.close()

    # -- sync and the watch loop (the one session-owning thread after start) ------

    def _sync_once(self) -> None:
        """One full resync: re-read the brokers and topics (watch-armed
        where the backend can) and swap the cache. Raises on any failure;
        the callers own the retries and the breaker."""
        t0 = time.perf_counter()
        ok = False
        error: Optional[str] = None
        try:
            fault_point("resync", cluster=self.name)
            backend = self.backend
            if self._use_watches:
                # The generation first: if a read below reconnects
                # transparently, the watches armed before it died with the
                # old session, and the check after the reads retries loudly.
                gen_before = backend.session_generation()
                backend.watch_brokers()
                names = backend.watch_topic_list()
                stream = backend.fetch_topics(names, missing="skip", watch=True)
            else:
                names = backend.all_topics()
                stream = backend.fetch_topics(names, missing="skip")
            brokers = backend.brokers()
            topics = {}
            for t, parts in stream:
                if parts is not None:
                    topics[t] = parts
            if self._use_watches and backend.session_generation() != gen_before:
                raise ZkConnectionError(
                    "session re-established mid-resync; watches from the "
                    "old session are dead — re-arming from scratch"
                )
            self.state.reset(brokers, topics)
            if self._use_watches:
                self._armed_generation = gen_before
            self._count("daemon.resyncs")
            self._maybe_warm()
            self._publish_health()
            self._publish_traffic()
            ok = True
        except BaseException as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            record_span(self._metric("daemon/resync"), ms, ok)
            ev = {"outcome": "ok" if ok else "fail", "ms": round(ms, 3)}
            if error is not None:
                ev["error"] = error
            flight.record("resync", self.name, **ev)
            self.note_lifecycle()

    def _maybe_warm(self) -> None:
        """The post-resync warm hook: the cache pins the buckets of the next
        whole-cluster ``/plan``, so make that solve resident on a background
        thread. A failure only counts ``daemon.warmup_failures``: the next
        solve takes the cold path."""
        if self.solver != "device":
            return
        sig = (
            self.state.encode_shape(),
            len(self.state.topic_names()),
            len(self.state.brokers()),
        )
        if sig == self._warmed_sig:
            return
        self._warmed_sig = sig
        cluster = self.state.encode_cluster()
        topics = self.state.all_assignments()
        if cluster is None or not topics:
            return

        def _warm() -> None:
            try:
                from ..solvers.warmup import warm_for_assignments

                warm_for_assignments(cluster, topics, device=self.device)
                self._count("daemon.warmups")
            except Exception as e:
                self._count("daemon.warmup_failures")
                self._log(
                    f"cache warm-up failed ({type(e).__name__}: {e}); "
                    "the next solve stays on the cold path"
                )

        t = threading.Thread(
            target=_warm, name=f"ka-daemon-warm-{self.name}", daemon=True
        )
        self._warm_threads = [w for w in self._warm_threads if w.is_alive()] + [t]
        t.start()

    # -- the health plane -------------------------------------------------------

    def _publish_health(self) -> None:
        """Score the cached assignment (``obs/health.py``) and publish the
        ``health.*`` gauges, on every resync and every delta re-encode.
        Only while the cumulative registry is on (in a daemon): outside one
        no continuous gauge has anywhere to live."""
        if obs_metrics.cumulative() is None:
            return
        with hist_ms(self._metric("health.score_ms")):
            scores = health.score_assignment(
                self.state.broker_id_set(),
                self.state.all_assignments(),
                self.state.rack_map(),
            )
        self._last_health = scores
        gauge_set(self._metric("health.replica_spread"), scores.replica_spread)
        gauge_set(self._metric("health.replica_stddev"), scores.replica_stddev)
        gauge_set(self._metric("health.leader_spread"), scores.leader_spread)
        gauge_set(self._metric("health.leader_stddev"), scores.leader_stddev)
        gauge_set(self._metric("health.rack_violations"), scores.rack_violations)
        gauge_set(self._metric("health.score"), scores.score)

    def _publish_traffic(self) -> None:
        """Per-partition traffic and lag through the backend's hook
        (``io/base.py:fetch_partition_traffic``, the synthetic series where
        it has no meters), published as gauge series labelled ``{topic,
        partition}`` (and ``cluster`` for many clusters). Each family is
        swapped whole, so a deleted topic's series go with it. At most
        ``KA_OBS_TRAFFIC_SERIES_MAX`` series a cluster, the busiest by
        produce rate; the rest are counted in ``traffic.series_dropped``. A
        failed fetch counts ``traffic.fetch_failures`` and never fails the
        resync."""
        from ..utils.env import env_int

        cum = obs_metrics.cumulative()
        if cum is None:
            return
        partitions = {
            t: sorted(parts)
            for t, parts in self.state.all_assignments().items()
        }
        try:
            fetch = getattr(self.backend, "fetch_partition_traffic", None)
            if fetch is not None:
                stats = fetch(partitions)
            else:  # a backend without the hook
                stats = health.synthetic_partition_traffic(partitions)
        except Exception as e:
            self._count("traffic.fetch_failures")
            self._log(
                f"traffic/lag fetch failed ({type(e).__name__}: {e}); "
                "scrape series keep their last values"
            )
            return
        flat = [
            (t, p, tr)
            for t in sorted(stats)
            for p, tr in sorted(stats[t].items())
        ]
        cap = env_int("KA_OBS_TRAFFIC_SERIES_MAX")
        dropped = 0
        if cap and len(flat) > cap:
            flat.sort(key=lambda row: (-row[2].in_bytes, row[0], row[1]))
            dropped = len(flat) - cap
            flat = sorted(flat[:cap], key=lambda row: (row[0], row[1]))
        base = {"cluster": self.name} if self.label else {}

        def series(field):
            return {
                (("partition", str(p)), ("topic", t)): getattr(tr, field)
                for t, p, tr in flat
            }

        cum.replace_gauges("traffic.in_bytes", series("in_bytes"), base)
        cum.replace_gauges("traffic.out_bytes", series("out_bytes"), base)
        cum.replace_gauges("traffic.lag", series("lag"), base)
        gauge_set(self._metric("traffic.series_dropped"), dropped)

    def recommendations(
        self, params: dict, request_id: Optional[str] = None,
    ) -> Tuple[int, dict, dict]:
        """``/recommendations``: a candidate plan solved against the cache
        under the solve lock, the current and the projected assignment
        scored, and a ``recommend`` or ``hold`` verdict against the cost of
        change (``KA_HEALTH_MOVE_COST``; ``move_cost`` overrides it per
        request). Read-only: computed, flight-recorded, never executed. The
        envelope is byte-stable (no times, request ids or cache versions)."""
        from ..utils.env import env_float

        raw_cost = params.get("move_cost")
        if raw_cost is None:
            move_cost = env_float("KA_HEALTH_MOVE_COST")
        else:
            try:
                move_cost = max(0.0, float(raw_cost))
            except (TypeError, ValueError):
                return 400, {
                    "error": f"move_cost must be a number, got {raw_cost!r}"
                }, {}
        refusal = self._gate()
        if refusal is not None:
            return refusal
        t0 = time.perf_counter()
        ok = False
        watchdog_timer = self._watchdog(
            "/recommendations", self._request_budget(), request_id
        )
        try:
            solver = params.get("solver") or self.solver
            ev = self._score_candidate(solver, move_cost)
            current, projected = ev["current"], ev["projected"]
            moves, leader_moves = ev["moves"], ev["leader_moves"]
            improvement, cost = ev["improvement"], ev["cost"]
            verdict, degraded = ev["verdict"], ev["degraded"]
            gauge_set(self._metric("health.movement_debt"), moves)
            self._count("daemon.recommendations")
            flight.record(
                "recommendation", self.name,
                verdict=verdict, moves=moves, improvement=improvement,
                request_id=request_id,
            )
            ok = True
            body = {
                "schema_version": health.RECOMMENDATION_SCHEMA_VERSION,
                "kind": "recommendations",
                "policy": "observe",
                "cluster": self.name,
                "solver": solver,
                "stale": self.state.stale,
                "degraded": degraded,
                "current": current.as_dict(),
                "candidate": {
                    "projected": projected.as_dict(),
                    "moves_required": moves,
                    "leader_moves": leader_moves,
                },
                "cost_model": {
                    "move_cost": move_cost,
                    "cost": cost,
                    "improvement": improvement,
                },
                "verdict": verdict,
            }
            return 200, body, {}
        except (ValueError, KeyError, IngestError) as e:
            return 400, {"error": f"bad recommendation request: {e}"}, {}
        except SolveError as e:
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        except Exception as e:
            self._count("daemon.request_errors")
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        finally:
            watchdog_timer.cancel()
            record_span(
                self._metric("daemon/recommend"),
                (time.perf_counter() - t0) * 1e3, ok,
            )
            self._release()

    def _score_candidate(self, solver: str, move_cost: float) -> dict:
        """Solve one candidate plan against the cache under the dispatch
        regime, score the current and the projected assignment, and price
        the movement (``/recommendations`` and the controller). The caller
        holds an admission slot."""
        from ..exec.engine import parse_plan_payload
        from ..exec.journal import plan_fingerprint

        out = io.StringIO()
        with self._solve_lock_scope():
            topics = self.state.all_assignments()
            broker_ids = self.state.broker_id_set()
            rack = self.state.rack_map()
            current = health.score_assignment(broker_ids, topics, rack)
            degraded = self._solve_plan({"solver": solver}, out)
        proposed, order = parse_plan_payload(
            out.getvalue(), origin="recommendation plan",
        )
        projected_topics = dict(topics)
        projected_topics.update(proposed)
        projected = health.score_assignment(broker_ids, projected_topics, rack)
        moves, leader_moves = health.movement_debt(topics, proposed)
        improvement = round(current.score - projected.score, 6)
        cost = round(moves * move_cost, 6)
        verdict = "recommend" if moves > 0 and improvement > cost else "hold"
        return {
            "current": current,
            "projected": projected,
            # The evaluation's assignment: the baseline every later overlay
            # score (a truncation's projection, the achieved score) shares
            # with the projection above.
            "topics": topics,
            "moves": moves,
            "leader_moves": leader_moves,
            "improvement": improvement,
            "cost": cost,
            "verdict": verdict,
            "degraded": degraded,
            "plan_text": out.getvalue(),
            "plan_sha": plan_fingerprint(proposed, order),
        }

    # -- the controller's surface ---------------------------------------------------

    def execution_in_flight(self) -> bool:
        """Whether this cluster's one /execute slot is taken (the controller
        does not even evaluate while it is)."""
        return self._exec_lock.locked()

    def controller_evaluate(self) -> Tuple[str, object]:
        """One controller evaluation of the recommendation pipeline, gated
        and watched as every solve-bearing request (the controller takes
        the same inflight slots as clients). Returns ``("ok", evaluation)``
        or ``("skip", reason)``; it never raises: the next tick retries."""
        from ..utils.env import env_float

        refusal = self._gate()
        if refusal is not None:
            return (
                "skip",
                f"admission refused: {refusal[1].get('error', refusal[0])}",
            )
        watchdog_timer = self._watchdog("/controller", self._request_budget(), None)
        try:
            ev = self._score_candidate(self.solver, env_float("KA_HEALTH_MOVE_COST"))
            return ("ok", ev)
        except (InjectedSolverCrash, SolveError, ValueError, KeyError,
                IngestError) as e:
            return ("skip", f"evaluation failed: {type(e).__name__}: {e}")
        except Exception as e:
            self._count("daemon.request_errors")
            return ("skip", f"evaluation error: {type(e).__name__}: {e}")
        finally:
            watchdog_timer.cancel()
            self._release()

    def health_score(self) -> Optional[float]:
        """The last composite health score (lower is healthier), or None
        before the first: the fleet's most-degraded-first priority key (the
        controller and the fleet read it here, never ``_last_health``)."""
        return self._last_health.score if self._last_health is not None else None

    def controller_execute(
        self, plan_text: str, *,
        section: str = "new",
        probe=None,
        heartbeat=None,
        on_verified=None,
        on_start=None,
        journal: Optional[str] = None,
        resume: bool = False,
    ) -> dict:
        """Run one controller action (or its rollback, ``section="current"``)
        through the same one-at-a-time ``/execute`` machinery a client's
        request takes: a refusal comes back as ``{"refused": ...}``, the
        journaling and the fresh write session are the same. ``on_start``
        fires once the run is admitted, never on a refusal. ``resume`` (the
        fleet's boot recovery finishing an interrupted action's journal)
        replays the journal's frozen waves, as a client's ``resume=1`` does;
        ``heartbeat`` runs at each wave boundary before ``probe``. Returns
        the terminal event; :class:`InjectedExecCrash` propagates (the
        controller owns the rollback)."""
        params: dict = {"plan_text": plan_text, "section": section}
        if journal is not None:
            params["journal"] = journal
        if resume:
            params["resume"] = True
        prep = self.prepare_execute(params)
        if prep[0] == "error":
            _, code, body = prep
            return {"refused": body.get("error", f"http {code}")}
        _, ctx = prep
        ctx["probe"] = _wave_probe(probe, heartbeat)
        ctx["on_verified"] = on_verified
        if on_start is not None:
            on_start()
        return self._run_to_terminal(ctx, "execution")

    def controller_refresh(self) -> None:
        """After a controller action or rollback the cache lags the cluster
        it moved: mark it stale and ask the watch loop for a reopen and a
        resync, so the next evaluation scores the world after the move."""
        self.state.mark_stale()
        self.note_lifecycle()
        self._reopen_requested = True
        self._prompt_resync = True

    def score_with_overlay(self, observed, base=None) -> health.HealthScores:
        """Score the cluster as the verify pass read it: the assignment
        overlaid with the executed topics' observed replicas. ``base`` pins
        the baseline to the evaluation's snapshot the projection was scored
        on, so a watch delta landing during the run is not read as this
        plan's regression."""
        topics = (
            {t: dict(parts) for t, parts in base.items()}
            if base is not None else self.state.all_assignments()
        )
        for t, parts in observed.items():
            merged = dict(topics.get(t, {}))
            merged.update({int(p): list(r) for p, r in parts.items() if r})
            topics[t] = merged
        return health.score_assignment(
            self.state.broker_id_set(), topics, self.state.rack_map()
        )

    def controller_view(self) -> dict:
        return self.controller.view()

    def controller_request(self, params: dict) -> Tuple[int, dict, dict]:
        """POST ``/clusters/<name>/controller``: pause or resume."""
        action = params.get("action")
        if action == "pause":
            return 200, self.controller.pause(), {}
        if action == "resume":
            return 200, self.controller.resume(), {}
        return 400, {
            "error": f"unknown controller action {action!r} "
                     "(expected \"pause\" or \"resume\")",
        }, {}

    # -- the consumer-group endpoints ----------------------------------------------

    def groups_request(
        self, kind: str, params: dict, request_id: Optional[str] = None,
    ) -> Tuple[int, dict, dict]:
        """``/groups/plan`` and ``/groups/sweep``: consumer-group packing
        over the backend's live group state (fetched per request: membership
        and lag move fast) and the cache's partitions, admitted and watched
        as every solve-bearing request, the device work under the solve
        lock. A backend without groups refuses (400, ``groups.refusals``)
        unless the request opts into the synthetic family (``synthetic:
        true``, marked ``groups_real: false``). The ``daemon:solver-crash``
        seam re-runs a group on the host packing oracle; a crash of the
        device solve follows the failure policy: under ``strict`` a 500,
        under ``best-effort`` the oracle's plan, marked degraded."""
        from ..groups.model import GROUPS_SCHEMA_VERSION
        from ..groups.solve import (
            build_group_bodies,
            load_group_states,
            parse_int_list,
            subscribed_partitions,
            throughput_weights,
        )
        from ..utils.env import env_float, env_int, env_str

        refusal = self._gate()
        if refusal is not None:
            return refusal
        t0 = time.perf_counter()
        ok = False
        watchdog_timer = self._watchdog(
            f"/groups/{kind}", self._request_budget(), request_id
        )
        try:
            raw_syn = params.get("synthetic", False)
            if isinstance(raw_syn, str):
                # A JSON body may carry a boolean as a string: "false" must
                # never opt into the synthetic family.
                low = raw_syn.strip().lower()
                if low in ("1", "true", "yes", "on"):
                    synthetic = True
                elif low in ("", "0", "false", "no", "off"):
                    synthetic = False
                else:
                    raise ValueError(
                        f"synthetic must be a boolean, got {raw_syn!r}"
                    )
            else:
                synthetic = bool(raw_syn)
            weight = params.get("weight") or "lag"
            raw_groups = params.get("group")
            if isinstance(raw_groups, str):
                group_names = raw_groups.split(",")
            elif raw_groups is None:
                group_names = None
            elif isinstance(raw_groups, list) and all(
                isinstance(g, str) for g in raw_groups
            ):
                group_names = raw_groups
            else:
                raise ValueError("group must be a name or list of names")
            backend = self.backend
            if backend is None:
                # A session being re-established: transient, not a refusal.
                return 503, {
                    "error": "cluster backend unavailable (session "
                             "re-establishment in progress)",
                    "cluster": self.name,
                }, {"Retry-After": "5"}
            supports = bool(
                getattr(backend, "supports_groups", lambda: False)()
            )
            if not synthetic and not supports:
                self._count("groups.refusals")
                flight.record(
                    "groups", self.name, op=kind, outcome="refused",
                    request_id=request_id,
                )
                return 400, {
                    "error": "this cluster's backend cannot read consumer "
                             "groups (no membership/offset surface); pass "
                             "synthetic=true to explicitly opt into the "
                             "deterministic synthetic family (marked "
                             "groups_real=false)",
                    "cluster": self.name,
                }, {}
            part_map = {
                t: sorted(per)
                for t, per in self.state.all_assignments().items()
            }
            headroom = env_float("KA_GROUPS_CAPACITY_HEADROOM")
            max_cand = env_int("KA_GROUPS_MAX_CANDIDATES")
            scales = parse_int_list(
                params.get("scales"), env_str("KA_GROUPS_DEFAULT_SCALES")
            )
            counts = parse_int_list(params.get("counts"))
            # The backend's reads happen before the solve's scope (under
            # KA_DISPATCH=0 the lock that every cluster's requests share).
            states, groups_real = load_group_states(
                backend, part_map, groups=group_names, synthetic=synthetic,
            )
            if not states:
                raise ValueError("the backend reports no consumer groups")
            weight_values = (
                throughput_weights(
                    backend, subscribed_partitions(states, part_map)
                )
                if weight == "throughput" else None
            )
            fallback = (
                "greedy" if self.failure_policy == "best-effort" else "raise"
            )
            # Under the dispatcher the sweep's candidate rows go to its
            # queue, where other requests' rows over the same group join them.
            with self._solve_lock_scope():
                bodies = build_group_bodies(
                    states, groups_real, part_map, kind, weight,
                    weight_values, scales, headroom, max_cand,
                    counts=counts, device=self.device, fallback=fallback,
                    probe=lambda: fault_point("daemon", cluster=self.name),
                )
            degraded_any = False
            for g, body in bodies.items():
                # Per group, as the CLI counts.
                if kind == "sweep":
                    self._count("groups.sweeps")
                else:
                    self._count("groups.plans")
                    self._count("groups.moves", body["moves"])
                if body["solver"] == "greedy-fallback":
                    self._count("groups.solve_fallbacks")
                    degraded_any = True
                    self._log(
                        f"groups solve crashed in-request for group "
                        f"{g!r}; served from the greedy packing oracle"
                    )
            if kind == "sweep":
                hist_observe(
                    self._metric("groups.sweep_ms"),
                    (time.perf_counter() - t0) * 1e3,
                )
            flight.record(
                "groups", self.name, op=kind,
                outcome="degraded" if degraded_any else "ok",
                groups=sorted(bodies), request_id=request_id,
            )
            ok = not degraded_any
            envelope = {
                "schema_version": GROUPS_SCHEMA_VERSION,
                "kind": f"groups-{kind}",
                "cluster": self.name,
                "groups_real": groups_real,
                "stale": self.state.stale,
                "degraded": degraded_any,
                "groups": bodies,
            }
            return 200, envelope, {}
        except (ValueError, KeyError) as e:
            return 400, {"error": f"bad groups request: {e}"}, {}
        except IngestError as e:
            self._count("groups.refusals")
            return 400, {"error": str(e), "cluster": self.name}, {}
        except SolveError as e:
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        except Exception as e:
            self._count("daemon.request_errors")
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        finally:
            watchdog_timer.cancel()
            record_span(
                self._metric("daemon/groups"),
                (time.perf_counter() - t0) * 1e3, ok,
            )
            self._release()

    def _resync_with_retries(self) -> bool:
        """``KA_DAEMON_RESYNC_RETRIES`` prompt attempts with jittered
        backoff, each failure counted against the breaker. On exhaustion
        the cache stays stale (responses degraded) and the breaker and the
        interval keep retrying. Never raises once the backend is open."""
        backoff = JitteredBackoff(0.05, cap=1.0)
        attempts = max(self.resync_retries, 1)
        for attempt in range(attempts):
            try:
                self._sync_once()
            except Exception as e:
                self._count("daemon.resync_failures")
                if self.breaker.record_failure():
                    self._count("daemon.breaker_opened")
                    self._log(
                        "circuit breaker OPEN after "
                        f"{self.breaker.consecutive_failures} consecutive "
                        f"session failure(s) ({type(e).__name__}: {e}); "
                        "probing on the cooldown envelope"
                    )
                else:
                    self._log(
                        f"resync failed ({type(e).__name__}: {e}); cache "
                        "stays stale (responses degraded)"
                    )
                if self.stopped.is_set():
                    return False
                if not self.breaker.allow_attempt():
                    return False  # open: the cooldown owns the cadence now
                if attempt + 1 < attempts:
                    backoff.sleep()
            else:
                if self.breaker.record_success():
                    self._count("daemon.breaker_closed")
                    self._log("circuit breaker CLOSED (session recovered)")
                return True
        return False

    def _probe_or_resync(self, fresh_session: bool = False) -> bool:
        """One breaker-gated recovery: closed, the bounded retry burst;
        half-open (the cooldown elapsed), exactly one probe on a fresh
        session (``fresh_session``: the caller just opened one)."""
        if not self.breaker.allow_attempt():
            return False
        if self.breaker.state == "half-open":
            self._count("daemon.breaker_probes")
            try:
                if not fresh_session:
                    self._reopen_backend()
                self._sync_once()
            except Exception as e:
                self._count("daemon.resync_failures")
                self.breaker.record_failure()  # a half-open failure re-opens
                self._log(
                    f"breaker probe failed ({type(e).__name__}: {e}); "
                    "re-opened with a longer cooldown"
                )
                return False
            if self.breaker.record_success():
                self._count("daemon.breaker_closed")
                self._log("circuit breaker CLOSED (probe succeeded)")
            return True
        return self._resync_with_retries()

    def _watch_loop(self) -> None:
        last_sync = time.monotonic()
        while not self.stopped.is_set():
            try:
                if self.backend is None:
                    # A probe's reopen failed: retry the open on the
                    # breaker's and the interval's cadence.
                    self.stopped.wait(POLL_S)
                    if time.monotonic() - last_sync < self.resync_interval \
                            or not self.breaker.allow_attempt():
                        continue
                    last_sync = time.monotonic()
                    try:
                        self._open_backend()
                    except Exception as e:
                        if self.breaker.record_failure():
                            self._count("daemon.breaker_opened")
                        self._count("daemon.resync_failures")
                        self._log(f"backend still unavailable ({type(e).__name__}: {e})")
                        continue
                    self._probe_or_resync(fresh_session=True)
                    continue
                if self._use_watches and self.state.synced_once:
                    events = self.backend.poll_watch_events(POLL_S)
                    if self.backend.session_generation() != self._armed_generation:
                        # A read while handling events reconnected
                        # transparently: the watches died with the old
                        # session although no poll failed.
                        raise ZkConnectionError(
                            "session re-established underneath; watches lost"
                        )
                    cache_v0 = self.state.version
                    for kind, arg in events:
                        self._count("daemon.watch_events")
                        if (
                            self._faults is not None
                            and self._faults.watch_delivery(cluster=self.name)
                        ):
                            self._count("daemon.watch_dropped")
                            flight.record("watch", self.name, event=kind,
                                          dropped=True)
                            continue
                        flight.record("watch", self.name, event=kind)
                        if self._apply_event(kind, arg):
                            # A broker change ran a full resync: the interval
                            # restarts from it.
                            last_sync = time.monotonic()
                    if self.state.version != cache_v0:
                        # One score for each batch of events that changed
                        # the cache: scoring is O(replicas), so scoring per
                        # event would undo the delta store under churn.
                        self._publish_health()
                else:
                    self.stopped.wait(POLL_S)
                if time.monotonic() - last_sync >= self.resync_interval \
                        or (self._prompt_resync and self.state.stale):
                    prompted = self._prompt_resync
                    self._prompt_resync = False
                    reopened = False
                    if self._reopen_requested:
                        # A controller action moved the cluster: a load-once
                        # backend must read its source again, or the cache
                        # resyncs the world before the move for ever.
                        try:
                            self._reopen_backend()
                            reopened = True
                            self._reopen_requested = False
                        except Exception as e:
                            # The request stays: dropped on a failed reopen,
                            # it would leave the old world cached.
                            self._count("daemon.resync_failures")
                            self._log(
                                f"post-action session reopen failed "
                                f"({type(e).__name__}: {e}); retrying on "
                                "the interval cadence"
                            )
                    if prompted or self.state.stale or not self.state.synced_once:
                        self._probe_or_resync(fresh_session=reopened)
                    else:
                        # The routine resync of a healthy cache, the escape
                        # hatch for lost notifications: not a recovery, so
                        # the breaker does not meter it.
                        self._resync_with_retries()
                    # The cadence runs from this attempt, success or not.
                    last_sync = time.monotonic()
            except (ZkConnectionError, ZkWireError, OSError) as e:
                if self.stopped.is_set():
                    return
                self.state.mark_stale()
                if not self.breaker.allow_attempt():
                    # Open: the dead socket fails every poll; pace at the
                    # poll cadence and probe when the cooldown says so.
                    self.stopped.wait(POLL_S)
                    continue
                self._count("daemon.session_lost")
                flight.record(
                    "session", self.name, event="lost",
                    error=f"{type(e).__name__}: {e}",
                )
                self.note_lifecycle()
                self._log(
                    f"ZooKeeper session lost ({type(e).__name__}: {e}); "
                    "re-establishing, re-arming watches and resyncing "
                    "(stale-marked responses meanwhile)"
                )
                self._probe_or_resync()
                last_sync = time.monotonic()
            except Exception as e:
                # The watch loop never dies: the cache goes stale and the
                # interval resync reconverges it.
                self.state.mark_stale()
                self._count("daemon.watch_errors")
                self._log(
                    f"watch loop error ({type(e).__name__}: {e}); cache "
                    "marked stale"
                )
                self.stopped.wait(POLL_S)

    def _apply_event(self, kind: str, arg) -> bool:
        """Apply one watch event; True when it ran a full resync."""
        backend = self.backend
        if kind == "topic":
            parts = backend.watch_topic(arg)  # re-read and re-arm (one-shot)
            if self.state.apply_topic(arg, parts):
                self._count("daemon.reencode.topics")
        elif kind == "topics":
            names = set(backend.watch_topic_list())  # re-arms the child watch
            cached = set(self.state.topic_names())
            for t in sorted(names - cached):
                if self.state.apply_topic(t, backend.watch_topic(t)):
                    self._count("daemon.reencode.topics")
            for t in sorted(cached - names):
                self.state.apply_topic(t, None)
        elif kind == "brokers":
            # The broker set is in every encoding: a delta cannot express
            # it, so resync in full.
            return self._resync_with_retries()
        return False

    # -- requests ---------------------------------------------------------------------

    def _gate(self) -> Optional[Tuple[int, dict, dict]]:
        """Admission: the drain check, the first-sync check, then the
        backpressure gate against the live inflight knob. Returns the
        refusal ``(code, body, headers)``, or None when the request is
        admitted: the caller then holds one inflight slot and must call
        :meth:`_release`."""
        if self.draining.is_set():
            return 503, {"error": "draining"}, {"Retry-After": "5"}
        if not self.state.synced_once:
            # A cluster of many that has not synced yet (one cluster does
            # not serve before its first sync).
            self._count("daemon.requests_unsynced")
            return (
                503,
                {"error": "cluster not synced yet", "cluster": self.name},
                {"Retry-After": "5"},
            )
        limit = self.max_inflight()
        with self._active_lock:
            admitted = self._active < limit
            if admitted:
                self._active += 1
        if not admitted:
            self._count("daemon.requests_shed")
            return (
                503,
                {"error": "overloaded", "max_inflight": limit},
                {"Retry-After": "1"},
            )
        return None

    def _release(self) -> None:
        with self._active_lock:
            self._active -= 1

    def _solve_lock_scope(self):
        """The regime of one solve-bearing request body: the shared solve
        lock under ``KA_DISPATCH=0``; else the dispatcher's scope, where the
        body runs concurrently with other requests and only its device work
        queues, packed, on the dispatcher's thread. The watchdog arms before
        the scope, so queue wait counts against the request's budget."""
        if self._dispatcher is None:
            return self._solve_lock
        return dispatch_scope(self._dispatcher)

    def _solve_body(self, kind: str, runner, params: dict, out: io.StringIO) -> bool:
        """One solve body under the regime: direct under the lock (the
        caller holds it); under the dispatcher, identical concurrent bodies
        (cluster, cache version, solver, policy and params) run once and
        the leader's stdout serves every waiter, while distinct bodies run
        concurrently. The live cache version splits followers across a
        resync."""
        d = self._dispatcher
        if d is None:
            return runner(params, out)
        res = d.run_job(self._body_job_key(kind, params),
                        lambda buf: runner(params, buf), out,
                        version=lambda: self.state.version)
        if res is None:
            # The dispatcher is closed (a drain): the straggler takes the lock.
            with self._solve_lock:
                return runner(params, out)
        degraded, _coalesced = res
        return degraded

    def _solve_plan(self, params: dict, out: io.StringIO) -> bool:
        return self._solve_body("plan", self._run_plan, params, out)

    def _solve_whatif(self, params: dict, out: io.StringIO) -> bool:
        return self._solve_body("whatif", self._run_whatif, params, out)

    def _body_job_key(self, kind: str, params: dict) -> str:
        """The dedup key of a request body: equal keys give equal stdout."""
        payload = json.dumps(params, sort_keys=True, default=repr)
        return (f"{kind}|{self.name}|{self.state.version}|{self.solver}|"
                f"{self.failure_policy}|{payload}")

    def _watchdog(self, path: str, budget: float,
                  request_id: Optional[str],
                  overran: Optional[threading.Event] = None,
                  ) -> threading.Timer:
        """A started timer that, at the budget's end, counts and records the
        request still running (a check after the fact never sees a solve
        that does not return) and sets ``overran`` when given. The caller
        cancels it on completion."""

        def _overrun() -> None:
            if overran is not None:
                overran.set()
            self._count("daemon.watchdog_exceeded")
            flight.record(
                "watchdog", self.name, path=path, budget_s=budget,
                request_id=request_id,
            )
            self._log(
                f"watchdog: {path} exceeded its {budget:.1f} s budget and is "
                "still running"
            )

        timer = threading.Timer(budget, _overrun)
        timer.daemon = True
        timer.start()
        return timer

    def handle(self, path: str, params: dict,
               request_id: Optional[str] = None) -> Tuple[int, dict, dict]:
        """One POST request: the gate, then the solve under the dispatch
        regime. Returns ``(http_code, body, extra_headers)``. ``request_id``
        is stamped into every span of the request's capture and into
        ``result.request_id``."""
        refusal = self._gate()
        if refusal is not None:
            return refusal
        try:
            return self._handle_admitted(path, params, request_id)
        finally:
            self._release()

    def _handle_admitted(self, path: str, params: dict,
                         request_id: Optional[str] = None,
                         ) -> Tuple[int, dict, dict]:
        from .. import obs

        t0 = time.perf_counter()
        self._count("daemon.requests")
        if self._faults is not None and self._faults.session_check(cluster=self.name):
            self._expire_session()
        out = io.StringIO()
        code = 200
        error: Optional[BaseException] = None
        degraded = False
        budget = self._request_budget()
        # Armed before the solve's scope: a request wedged behind another's
        # solve, or waiting in the dispatcher's queue, is flagged too.
        overran = threading.Event()
        watchdog_timer = self._watchdog(path, budget, request_id, overran)
        # The capture is the handler thread's own: no other request's spans
        # land in it.
        with self._solve_lock_scope(), obs.run_capture(local=True) as run:
            if request_id is not None:
                # First in the capture: every span carries the request id.
                run.annotate("request_id", request_id)
            try:
                with obs.span(self._metric("daemon/request")) as sp:
                    if path == "/plan":
                        degraded = self._solve_plan(params, out)
                    elif path == "/whatif":
                        degraded = self._solve_whatif(params, out)
                    else:
                        raise ValueError(f"unknown endpoint {path!r}")
                    if degraded or self.state.stale:
                        sp.fail()
            except (ValueError, KeyError) as e:
                error, code = e, 400
            except IngestError as e:
                # From the cache, an ingest failure is a topic the daemon
                # never saw: the client's error.
                error, code = e, 400
            except SolveError as e:
                error, code = e, 500
            except Exception as e:  # a bug, not a request problem
                error, code = e, 500
                self._count("daemon.request_errors")
            status = (
                "error" if error is not None
                else "degraded" if degraded or self.state.stale
                else "ok"
            )
            report = obs.build_report(
                run, status=status,
                mode="DAEMON_PLAN" if path == "/plan" else "DAEMON_WHATIF",
                argv=[], error=error,
            )
        watchdog_timer.cancel()
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        watchdog = overran.is_set() or elapsed_ms > budget * 1000.0
        if watchdog and not overran.is_set():
            # Done just past the budget before the timer ran: count it once.
            self._count("daemon.watchdog_exceeded")
            self._log(
                f"watchdog: {path} took {elapsed_ms:.0f} ms (budget {budget:.1f} s)"
            )
        report["result"] = {
            "stdout": out.getvalue(),
            "stale": self.state.stale,
            "cache_version": self.state.version,
            "elapsed_ms": round(elapsed_ms, 3),
        }
        if request_id is not None:
            report["result"]["request_id"] = request_id
        if self.label:
            report["result"]["cluster"] = self.name
        if watchdog:
            report["result"]["watchdog_exceeded"] = True
        if degraded:
            self._count("daemon.requests_degraded")
        from ..utils.env import env_str

        if env_str("KA_OBS_REPORT"):
            # The per-request stderr summary is opt-in; no file is written
            # (the envelope is the report).
            obs.emit_report(report, None, err=self.err)
        return code, report, {}

    def _expire_session(self) -> None:
        """The ``session:expire`` seam: kill the live ZooKeeper socket under
        the client (what a server-side expiry looks like to it). The watch
        loop's next poll fails, re-establishes and resyncs; this request is
        served from the stale-marked cache. The prompt flag covers the
        watchless case, where no poll exists to fail."""
        self.state.mark_stale()
        self.note_lifecycle()
        self._prompt_resync = True
        zk = getattr(self.backend, "_zk", None)
        sock = getattr(zk, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:  # already dead: the state this seam wants
                pass

    def _plan_kwargs(self, params: dict) -> dict:
        live = self.state.brokers()
        broker_ids = resolve_broker_ids(
            live, params.get("integer_broker_ids"), params.get("broker_hosts")
        )
        excluded = resolve_excluded_broker_ids(
            live, params.get("broker_hosts_to_remove")
        )
        rack = build_rack_assignment(
            live, bool(params.get("disable_rack_awareness"))
        )
        topics = params.get("topics")
        if topics is not None and not (
            isinstance(topics, list) and all(isinstance(t, str) for t in topics)
        ):
            raise ValueError("topics must be a list of topic names")
        rf_raw = params.get("desired_replication_factor", -1)
        if rf_raw is None:
            rf_raw = -1  # an explicit JSON null means "infer", as the CLI default
        try:
            rf = int(rf_raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"desired_replication_factor must be an integer, got {rf_raw!r}"
            ) from None
        return {
            "live": live,
            "broker_ids": broker_ids,
            "excluded": excluded,
            "rack": rack,
            "topics": topics,
            "rf": rf,
        }

    def _run_plan(self, params: dict, out: io.StringIO) -> bool:
        """Mode 3's pipeline against the cache: stdout byte-identical to a
        fresh CLI run on the same metadata. Returns whether the request
        degraded. The ``daemon:solver-crash`` seam re-runs this one request
        on the greedy lane; a real crash of the device solve follows the
        failure policy, as in the CLI (a ``SolveError`` under strict, the
        500 of :meth:`_handle_admitted`), so a kernel that fails to launch
        never sends the work to the host on a strict daemon."""
        solver = params.get("solver") or self.solver
        policy = params.get("failure_policy") or self.failure_policy
        pk = self._plan_kwargs(params)
        effective = (pk["broker_ids"] or {b.id for b in pk["live"]}) - pk["excluded"]

        def run_once(chosen_solver: str) -> Degradation:
            # The cached preencode holds the whole broker set and rack map,
            # and only the device lane takes one: a narrowed request (or the
            # greedy re-run) encodes for itself, the same bytes either way.
            want_encode = (
                chosen_solver == "device"
                and effective == self.state.broker_id_set()
                and not params.get("disable_rack_awareness")
            )
            deg = Degradation()
            print_least_disruptive_reassignment(
                CacheBackend(self.state),
                pk["topics"],
                pk["broker_ids"],
                pk["excluded"],
                pk["rack"],
                pk["rf"],
                device=self.device,
                solver=chosen_solver,
                out=out,
                live_brokers=pk["live"],
                failure_policy=policy,
                degradation=deg,
                ingest=lambda topic_list: self.state.plan_inputs(
                    topic_list, want_encode
                ),
            )
            return deg

        try:
            try:
                fault_point("daemon", cluster=self.name)
                deg = run_once(solver)
            except IngestError:
                # A churn race: the topic list was taken, then the watch
                # thread deleted one before the cache read. A whole-cluster
                # request retries once against the new state, the answer a
                # fresh CLI run would now give; a topic the client named
                # stays the client's 400.
                if pk["topics"] is not None:
                    raise
                self._count("daemon.churn_retries")
                out.seek(0)
                out.truncate()
                deg = run_once(solver)
        except InjectedSolverCrash as e:
            self._count("daemon.solve_fallbacks")
            self._log(
                f"solve crashed in-request ({type(e).__name__}: {e}); "
                "re-running this request on the greedy solver"
            )
            out.seek(0)
            out.truncate()
            run_once("greedy")
            return True
        return deg.any()

    def _run_whatif(self, params: dict, out: io.StringIO) -> bool:
        import tempfile

        t0 = time.perf_counter()
        pk = self._plan_kwargs(params)
        scenario_file = None
        scenarios = params.get("scenarios")
        if scenarios is not None:
            tmp = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
            json.dump(scenarios, tmp)
            tmp.close()
            scenario_file = tmp.name
        try:
            live = [b for b in pk["live"] if b.id not in pk["excluded"]]

            def rank_once() -> None:
                print_decommission_ranking(
                    CacheBackend(self.state),
                    pk["topics"],
                    (pk["broker_ids"] - pk["excluded"]) or None,
                    {k: v for k, v in pk["rack"].items() if k not in pk["excluded"]},
                    pk["rf"],
                    device=self.device,
                    out=out,
                    live_brokers=live,
                    scenario_file=scenario_file,
                )

            try:
                rank_once()
            except KeyError:
                # The churn race of /plan: the ranking takes the topic list
                # and the assignments in two cache reads.
                if pk["topics"] is not None:
                    raise
                self._count("daemon.churn_retries")
                out.seek(0)
                out.truncate()
                rank_once()
            # The request's wall over the scenarios it ranked (the
            # candidates when none were named).
            cand = pk["broker_ids"] - pk["excluded"]
            n_scenarios = (
                len(scenarios) if scenarios is not None
                else len(cand) if cand else len(live)
            )
            hist_observe(
                self._metric("whatif.scenario_ms"),
                (time.perf_counter() - t0) * 1e3 / max(1, n_scenarios),
            )
        finally:
            if scenario_file is not None:
                os.unlink(scenario_file)
        return False

    # -- /execute ---------------------------------------------------------------------

    def prepare_execute(self, params: dict):
        """Validate one ``/execute`` request and take the cluster's one
        execution slot. Returns ``("error", code, body)`` for a refusal, or
        ``("run", ctx)``: the caller must then call :meth:`run_execute`
        with ``ctx`` (which releases the slot) or :meth:`abort_execute`."""
        from ..exec.engine import parse_plan_payload
        from ..exec.journal import plan_fingerprint
        from ..utils.env import env_str

        if self.draining.is_set():
            return ("error", 503, {"error": "draining"})
        if not self._exec_lock.acquire(blocking=False):
            self._count("daemon.execute_conflicts")
            return ("error", 409, {
                "error": "an execution is already in flight on this "
                         "cluster (single-flight lock)",
                "cluster": self.name,
            })
        try:
            plan_text = params.get("plan_text")
            plan_obj = params.get("plan")
            if (plan_text is None) == (plan_obj is None):
                raise ValueError(
                    "pass exactly one of 'plan_text' (a saved mode-3 "
                    "stdout or bare reassignment JSON string) or 'plan' "
                    "(the reassignment JSON object)"
                )
            if plan_text is None:
                if not isinstance(plan_obj, dict):
                    raise ValueError("'plan' must be a JSON object")
                plan_text = json.dumps(plan_obj)
            if not isinstance(plan_text, str):
                raise ValueError("'plan_text' must be a string")
            # Which half of a saved mode-3 stdout to drive: "new" (forward)
            # or "current" (the rollback, as ``ka-execute --rollback``).
            section = params.get("section") or "new"
            if section not in ("new", "current"):
                raise ValueError(
                    f"section must be 'new' or 'current', got {section!r}"
                )
            plan, topic_order = parse_plan_payload(plan_text, section=section)
            plan_hash = plan_fingerprint(plan, topic_order)
            journal = params.get("journal")
            if journal is None:
                jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
                journal = os.path.join(
                    jdir, f"ka-execute-{self.name}-{plan_hash[:12]}.journal",
                )
            wave_size = params.get("wave_size")
            if wave_size is not None:
                wave_size = int(wave_size)
            throttle = params.get("throttle")
            if throttle is not None:
                throttle = float(throttle)
            policy = params.get("failure_policy") or self.failure_policy
            if policy not in ("strict", "best-effort"):
                raise ValueError(f"unknown failure_policy {policy!r}")
            ctx = {
                "plan": plan,
                "topic_order": topic_order,
                "plan_hash": plan_hash,
                "journal": journal,
                "resume": bool(params.get("resume")),
                "wave_size": wave_size,
                "throttle": throttle,
                "policy": policy,
            }
        except (TypeError, ValueError) as e:
            self._exec_lock.release()
            return ("error", 400, {"error": f"bad execute request: {e}"})
        except Exception:
            self._exec_lock.release()
            raise
        with self._active_lock:
            self._active += 1  # the drain waits for executions too
        return ("run", ctx)

    def recover_journal(self, path: str, *, probe=None, heartbeat=None) -> dict:
        """Resume one in-progress journal under its own authority (the
        fleet's boot recovery of an orphaned client ``/execute`` journal, or
        of a controller journal whose action record is lost): the plan bytes
        are gone, so the plan is rebuilt from the journal's frozen moves and
        the journal's plan hash is asserted as the executor's identity (the
        rebuilt plan fingerprints otherwise: noops were never journaled).
        Returns the terminal event, or ``{"refused": ...}``;
        :class:`InjectedExecCrash` propagates (the scan leaves the journal
        for the next boot)."""
        from ..exec.journal import (
            ExecutionJournal,
            JournalError,
            journal_resume_payload,
        )

        try:
            journal = ExecutionJournal.load(path)
        except JournalError as e:
            return {"event": "exec/error", "kind": "validation", "message": str(e)}
        if self.draining.is_set():
            return {"refused": "draining"}
        if not self._exec_lock.acquire(blocking=False):
            return {
                "refused": "an execution is already in flight on this "
                           "cluster (single-flight lock)",
            }
        plan, topic_order = journal_resume_payload(journal)
        ctx = {
            "plan": plan,
            "topic_order": topic_order,
            "plan_hash": journal.plan_hash,
            "asserted_hash": journal.plan_hash,
            "journal": path,
            "resume": True,
            "wave_size": None,
            "throttle": None,
            "policy": self.failure_policy,
            "probe": _wave_probe(probe, heartbeat),
        }
        with self._active_lock:
            self._active += 1
        return self._run_to_terminal(ctx, "recovery")

    def _run_to_terminal(self, ctx: dict, what: str) -> dict:
        """:meth:`run_execute` on a prepared ``ctx``, keeping only the
        terminal event (``exec/done`` or ``exec/error``)."""
        terminal: dict = {}

        def collect(event: dict) -> None:
            if event.get("event") in ("exec/done", "exec/error"):
                terminal.update(event)

        self.run_execute(ctx, collect)
        if not terminal:
            terminal.update({
                "event": "exec/error", "kind": "internal",
                "message": f"{what} ended without a terminal event",
            })
        return terminal

    def abort_execute(self) -> None:
        """Give back a taken execution slot without running it (the client
        went away before the stream opened); else every later /execute on
        this cluster would answer 409."""
        with self._active_lock:
            self._active -= 1
        self._exec_lock.release()

    def run_execute(self, ctx: dict, emit: Callable[[dict], None]) -> None:
        """Drive one prepared execution, each progress event through
        ``emit`` (one dict per NDJSON line), on a fresh backend session (the
        writes never share the watch loop's). Journaled as ``ka-execute``
        journals: a daemon killed mid-run resumes through ``/execute`` with
        ``resume`` or offline ``ka-execute --resume``.
        :class:`InjectedExecCrash` (the stand-in for a kill) propagates
        after the cleanup, with no terminal event, as a kill would end it."""
        from ..exec.engine import PlanExecutor
        from ..exec.journal import JournalError

        self._count("daemon.executes")
        flight.record(
            "execute", self.name, event="start",
            plan_hash=ctx["plan_hash"][:12], resume=ctx["resume"],
        )
        safe_emit = _SafeEmitter(emit, self)
        backend = None
        try:
            backend = open_backend(self.spec)
            executor = PlanExecutor(
                backend,
                ctx["plan"],
                ctx["topic_order"],
                ctx["journal"],
                failure_policy=ctx["policy"],
                resume=ctx["resume"],
                wave_size=ctx["wave_size"],
                throttle=ctx["throttle"],
                err=self.err,
                cluster=self.spec,
                on_event=safe_emit,
                probe=ctx.get("probe"),
                on_verified=ctx.get("on_verified"),
                plan_hash=ctx.get("asserted_hash"),
            )
            try:
                outcome = executor.execute()
            except ExecuteError as e:
                self._count("daemon.execute_halts")
                safe_emit({
                    "event": "exec/error", "kind": "execute",
                    "message": str(e), "resumable": True, "exit_code": 8,
                })
                return
            except InjectedExecCrash:
                # A killed daemon emits nothing: the journal carries the run.
                self._count("daemon.execute_interrupted")
                raise
            except (JournalError, ValueError, KeyError) as e:
                safe_emit({
                    "event": "exec/error", "kind": "validation",
                    "message": str(e), "resumable": False, "exit_code": 5,
                })
                return
            except Exception as e:
                self._count("daemon.execute_errors")
                safe_emit({
                    "event": "exec/error", "kind": "internal",
                    "message": f"{type(e).__name__}: {e}",
                    "resumable": True,
                })
                return
            if outcome.mismatches:
                status, exit_code = "verify-mismatch", 7
            elif outcome.skipped:
                status, exit_code = "degraded", 6
            else:
                status, exit_code = "ok", 0
            flight.record(
                "execute", self.name, event="done", status=status,
                plan_hash=ctx["plan_hash"][:12],
            )
            safe_emit({
                "event": "exec/done",
                "status": status,
                "exit_code": exit_code,
                "cluster": self.name,
                "plan": {
                    "waves": outcome.waves_total,
                    "waves_run": outcome.waves_run,
                    "moves_submitted": outcome.moves_submitted,
                    "noops": outcome.noops,
                    "resumed": outcome.resumed,
                    "skipped_moves": [
                        [t, p] for t, p in sorted(set(outcome.skipped))
                    ],
                    "verify_mismatches": outcome.mismatches,
                },
            })
        finally:
            if backend is not None:
                backend.close()
            with self._active_lock:
                self._active -= 1
            self._exec_lock.release()

    # -- views ----------------------------------------------------------------------------

    def healthz_view(self) -> dict:
        return {
            "status": self.lifecycle(),
            "stale": self.state.stale,
            "cluster": self.name,
            "breaker": self.breaker.snapshot(),
        }

    def state_view(self) -> dict:
        shape = self.state.encode_shape()
        return {
            "lifecycle": self.lifecycle(),
            "stale": self.state.stale,
            "cache_version": self.state.version,
            "brokers": len(self.state.brokers()),
            "topics": len(self.state.topic_names()),
            "encode_shape": list(shape) if shape else None,
            "watches": self._use_watches,
            "solver": self.solver,
            "failure_policy": self.failure_policy,
            "cluster": self.name,
            "breaker": self.breaker.snapshot(),
            "execution_in_flight": self._exec_lock.locked(),
            "controller": {
                "policy": self.controller.policy,
                "paused": self.controller.paused(),
                "breaker": self.controller.breaker_view(),
            },
            "health": (
                self._last_health.as_dict()
                if self._last_health is not None else None
            ),
            "traffic_real": bool(
                getattr(self.backend, "supports_traffic", lambda: False)()
            ),
            "counters": self.counters(),
        }


def _wave_probe(probe, heartbeat):
    """The engine's wave-boundary hook: ``heartbeat`` (the fleet lease's
    stamp), then ``probe`` (a fault seam); ``probe`` alone when there is no
    heartbeat."""
    if heartbeat is None:
        return probe

    def _probe():
        heartbeat()
        if probe is not None:
            probe()

    return _probe


class _SafeEmitter:
    """The stream's write callback, made safe: a client that goes away
    mid-stream never aborts the execution (the journal, not the socket,
    holds the run); the first failed write stops the emission, loudly."""

    def __init__(self, emit: Callable[[dict], None],
                 sup: ClusterSupervisor) -> None:
        self._emit = emit
        self._sup = sup

    def __call__(self, event: dict) -> None:
        if self._emit is None:
            return
        try:
            self._emit(event)
        except Exception as e:
            self._emit = None
            self._sup._count("daemon.execute_stream_broken")
            self._sup._log(
                f"/execute progress stream broke ({type(e).__name__}: "
                f"{e}); execution continues, resume state lives in the "
                "journal"
            )
