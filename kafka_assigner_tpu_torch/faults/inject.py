"""Deterministic, seedable fault injection — the port of the reference's
``kafka_assigner_tpu/faults/inject.py``, with its spec grammar, fault
taxonomy and random schedules unchanged (a schedule written for the
reference fires the same events here).

Faults fire at fault points: each hook consults the schedule at its
scope's current index and fires at most one event. In this package the
``solve`` point is consulted by the device solver (``TorchSolver.assign``
and ``assign_many``) and by the consumer-group device calls
(``parallel/whatif.py``); a ``crash`` there raises
:class:`InjectedSolverCrash` before any device work, the stand-in for a
device OOM or a failed kernel build. The metadata seams are consulted by
the live backends: ``connect``, ``handshake`` and ``reply`` by the wire
client (``io/zkwire.py``) at its socket, and ``connect`` and
:meth:`FaultInjector.backend_reply` by the kazoo and AdminClient backends
(``io/zk.py``, ``io/kafka_admin.py``). The hooks of the other scopes
(writes and convergence, execution waves, the resident daemon, the
controller, the fleet scheduler) are here with the reference's semantics;
the modules that consult them are not part of this package yet.

Fault taxonomy (``FAULT_KINDS``; scope: kinds): connect: blackhole;
handshake: expire; reply: drop, trunc, slow, nonode; solve: crash; warmup:
crash; write: drop, lost; converge: stall; wave: crash; watch: drop;
session: expire; resync: stall; daemon: solver-crash; dispatch: crash,
stall; controller: verdict-flap, exec-crash, regress; fleet: lease-expire,
ledger-torn, recovery-crash.

Spec grammar (``KA_FAULTS_SPEC``): semicolon-separated events
``scope[@cluster]:index=kind[:arg]`` — the fault fires the ``index``-th
time that scope's hook runs (0-based, per-scope counters), e.g.::

    KA_FAULTS_SPEC='solve:0=crash'

``@cluster`` addresses one cluster: the event fires only when a hook is
consulted for that cluster, at the cluster's own per-scope index.
Clusterless events keep the global per-scope counter.

Or the single word ``random``: a schedule drawn from
``random.Random(KA_FAULTS_SEED)`` with per-hook probability
``KA_FAULTS_RATE`` over the first :data:`RANDOM_HORIZON` indexes of each
scope (same seed ⇒ same schedule, byte-for-byte).

Activation: :func:`install` (programmatic, wins) or the ``KA_FAULTS_SPEC``
knob (read via :func:`active_injector`, cached per (spec, seed) so every
hook of a run sees one coherent schedule). A malformed spec is ignored
loudly and injection stays off. Every fired fault prints one stderr line,
bumps the ``faults.injected`` (+ ``faults.injected.<kind>``) counters and
records a ``fault`` event in the flight recorder.
"""
from __future__ import annotations

import random
import struct
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..obs import flight
from ..obs.metrics import counter_add

#: Scopes (hook sites) and the kinds each accepts.
FAULT_SCOPES: Dict[str, Tuple[str, ...]] = {
    "connect": ("blackhole",),
    "handshake": ("expire",),
    "reply": ("drop", "trunc", "slow", "nonode"),
    "solve": ("crash",),
    "warmup": ("crash",),
    "write": ("drop", "lost"),
    "converge": ("stall",),
    "wave": ("crash",),
    # The daemon seams: a lost watch notification, a session
    # expiry landing mid-request, a stalled resync attempt, and a solver
    # crash inside a served request — each consulted by the resident
    # assigner daemon (`daemon/service.py`), never by the one-shot CLI.
    "watch": ("drop",),
    "session": ("expire",),
    "resync": ("stall",),
    "daemon": ("solver-crash",),
    # The batched solve dispatcher: consulted once per coalesced
    # device dispatch, ON the dispatcher thread — a crash must fail only
    # that batch's jobs (each degrades per-job), a stall must surface as
    # queue wait, never a hang.
    "dispatch": ("crash", "stall"),
    # The autonomous rebalance controller: three seams, each
    # consulted with its OWN per-kind counter (`controller_point`) —
    # verdict-flap flips one evaluation's verdict (hysteresis must hold),
    # exec-crash kills the supervised forward execution at a wave boundary
    # (abort-to-rollback must restore the pre-action bytes), regress makes
    # the post-move re-score read as a health regression (same rollback
    # path, breaker opens).
    "controller": ("verdict-flap", "exec-crash", "regress"),
    # The fleet scheduler: lease-expire sweeps every live
    # admission lease at a prune point (a crashed holder's TTL elapsing,
    # compressed to now — the fleet must hand the slot on, and the stale
    # holder's release must degrade to a loud no-op), ledger-torn makes
    # one ledger load read as externally damaged (accounting restarts
    # empty, loudly — never a crash, never silent reuse of torn bytes),
    # recovery-crash kills a startup-recovery resume at a wave boundary
    # (the journal stays in-progress; the NEXT boot's scan must converge).
    "fleet": ("lease-expire", "ledger-torn", "recovery-crash"),
}
FAULT_KINDS = tuple(k for kinds in FAULT_SCOPES.values() for k in kinds)

#: ``random`` mode draws events over this many indexes per scope — enough to
#: cover any realistic mode-3 run against the test fixtures while keeping the
#: schedule finite and printable.
RANDOM_HORIZON: Dict[str, int] = {
    "connect": 3, "handshake": 3, "reply": 64, "solve": 2, "warmup": 2,
    "write": 8, "converge": 8, "wave": 4,
    "watch": 8, "session": 4, "resync": 4, "daemon": 4, "dispatch": 4,
    "controller": 4, "fleet": 4,
}

#: The scope iteration order of :func:`random_schedule`. Frozen EXPLICITLY —
#: new scopes append at the end (never alphabetical insertion), so a
#: pre-existing seed keeps drawing the exact same events for the scopes it
#: already covered. (A ``sorted(FAULT_SCOPES)`` walk would have reshuffled
#: every historical schedule the moment ``converge`` landed before
#: ``handshake``.)
RANDOM_ORDER: Tuple[str, ...] = (
    "connect", "handshake", "reply", "solve", "warmup",
    "write", "converge", "wave",
    "watch", "session", "resync", "daemon",
    "dispatch",
    "controller",
    "fleet",
)

ERR_NONODE = -101


class FaultSpecError(ValueError):
    """``KA_FAULTS_SPEC`` does not parse (unknown scope/kind, bad index)."""


class InjectedSolverCrash(RuntimeError):
    """The ``solve`` fault point fired — stands in for an XLA compile
    failure or device OOM (both surface as RuntimeError subclasses)."""


class InjectedWarmupCrash(RuntimeError):
    """The ``warmup`` fault point fired — stands in for anything killing the
    ingest-overlapped warm-up thread (store corruption, compile failure on
    the background thread). The contract under test: the solve must proceed
    on the cold path, byte-identically."""


class InjectedResyncStall(RuntimeError):
    """The ``resync`` fault point fired — one daemon resync attempt dies
    mid-flight (a flapping quorum during the re-read). The contract under
    test: the daemon retries with backoff, keeps serving STALE-MARKED
    responses meanwhile (``status: "degraded"``, never an error), and
    converges once an attempt succeeds."""


class InjectedExecCrash(RuntimeError):
    """The ``wave`` fault point fired — the execution engine "process" dies
    at a wave boundary (the deterministic stand-in for kill -9 between
    waves). Deliberately NOT mapped to a documented exit code: a killed
    process has no exit path, and the harnesses catch this class exactly
    where a supervisor would observe the dead process. The contract under
    test: the journal must resume the run to a byte-identical final state."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires the ``index``-th time ``scope``'s hook
    runs. ``arg`` is kind-specific (trunc: bytes kept; slow: seconds).
    ``cluster`` (None = any) addresses one cluster of the multi-cluster
    daemon: the event fires at that cluster's own per-scope index, only
    when the hook is consulted with a matching cluster."""

    scope: str
    index: int
    kind: str
    arg: Optional[float] = None
    cluster: Optional[str] = None

    def __str__(self) -> str:
        suffix = "" if self.arg is None else f":{self.arg:g}"
        at = "" if self.cluster is None else f"@{self.cluster}"
        return f"{self.scope}{at}:{self.index}={self.kind}{suffix}"


def parse_spec(
    spec: str, seed: int = 0, rate: float = 0.05
) -> List[FaultEvent]:
    """Parse a ``KA_FAULTS_SPEC`` value into a schedule. ``random`` draws a
    seed-deterministic schedule; anything else is the explicit event list."""
    spec = spec.strip()
    if spec == "random":
        return random_schedule(seed, rate)
    events: List[FaultEvent] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, eq, kind_arg = raw.partition("=")
        if not eq:
            raise FaultSpecError(
                f"fault event {raw!r} is not of the form "
                "scope[@cluster]:index=kind"
            )
        scope_part, _, idx_s = head.partition(":")
        scope, at, cluster = scope_part.partition("@")
        scope = scope.strip()
        cluster = cluster.strip() or None
        if at and cluster is None:
            raise FaultSpecError(
                f"empty cluster name after '@' in {raw!r}"
            )
        if cluster is not None and not all(
            c.isalnum() or c in "_.-" for c in cluster
        ):
            raise FaultSpecError(
                f"invalid cluster name {cluster!r} in {raw!r} "
                "(letters, digits, '_', '.', '-' only)"
            )
        if scope not in FAULT_SCOPES:
            raise FaultSpecError(
                f"unknown fault scope {scope!r} in {raw!r} "
                f"(expected one of {sorted(FAULT_SCOPES)})"
            )
        try:
            index = int(idx_s) if idx_s.strip() else 0
        except ValueError:
            raise FaultSpecError(
                f"fault index {idx_s!r} in {raw!r} is not an integer"
            ) from None
        if index < 0:
            raise FaultSpecError(f"fault index must be >= 0 in {raw!r}")
        kind, _, arg_s = kind_arg.partition(":")
        kind = kind.strip()
        if kind not in FAULT_SCOPES[scope]:
            raise FaultSpecError(
                f"fault kind {kind!r} is not valid for scope {scope!r} "
                f"(expected one of {FAULT_SCOPES[scope]})"
            )
        arg = None
        if arg_s.strip():
            try:
                arg = float(arg_s)
            except ValueError:
                raise FaultSpecError(
                    f"fault arg {arg_s!r} in {raw!r} is not a number"
                ) from None
        events.append(FaultEvent(scope, index, kind, arg, cluster))
    return events


def random_schedule(seed: int, rate: float) -> List[FaultEvent]:
    """A seed-deterministic randomized schedule: each (scope, index) slot up
    to :data:`RANDOM_HORIZON` fires with probability ``rate``, the kind drawn
    uniformly from the scope's kinds. Same seed ⇒ identical schedule."""
    rng = random.Random(int(seed))
    events: List[FaultEvent] = []
    for scope in RANDOM_ORDER:
        kinds = FAULT_SCOPES[scope]
        for index in range(RANDOM_HORIZON[scope]):
            if rng.random() < rate:
                events.append(FaultEvent(scope, index, rng.choice(kinds)))
    return events


class FaultInjector:
    """One live schedule: per-scope hook counters plus the fired-event log.

    Hook methods are called from the wire client's socket paths (possibly on
    the ingest producer thread) and from the solver; each consults the
    schedule at the scope's current index and fires at most one event. The
    same instance must serve every hook of a run so the counters stay
    coherent — :func:`active_injector` caches per (spec, seed).
    """

    def __init__(self, events: List[FaultEvent]) -> None:
        self.schedule: Tuple[FaultEvent, ...] = tuple(events)
        self._events = {
            (e.scope, e.cluster, e.index): e for e in events
        }
        self._counts: Dict[str, int] = {}
        #: Per-(scope, cluster) counters for @cluster-addressed events —
        #: a cluster-scoped event fires at that cluster's OWN index, so
        #: schedules stay deterministic however the daemon interleaves its
        #: supervisors' hooks.
        self._cluster_counts: Dict[Tuple[str, str], int] = {}
        self.fired: List[FaultEvent] = []

    def _next(
        self, scope: str, cluster: Optional[str] = None
    ) -> Optional[FaultEvent]:
        i = self._counts.get(scope, 0)
        self._counts[scope] = i + 1
        ev = self._events.get((scope, None, i))
        if ev is not None:
            # A clusterless (global-index) event claims this consult; the
            # per-cluster index is deliberately NOT consumed — a @cluster
            # event colliding with a global one fires at that cluster's
            # next consult instead of being silently lost.
            return ev
        if cluster is not None:
            key = (scope, cluster)
            j = self._cluster_counts.get(key, 0)
            self._cluster_counts[key] = j + 1
            ev = self._events.get((scope, cluster, j))
        return ev

    def _fire(self, ev: FaultEvent) -> None:
        self.fired.append(ev)
        counter_add("faults.injected")
        counter_add(f"faults.injected.{ev.kind}")
        # Flight-recorder correlation: a post-mortem diffs the recorder's
        # `fault` events against the schedule it injected (a no-op while
        # the recorder is not enabled).
        flight.record(
            "fault", ev.cluster, spec=str(ev), scope=ev.scope,
            fault_kind=ev.kind,
        )
        print(f"kafka-assigner: fault injected: {ev}", file=sys.stderr)

    # -- hooks -------------------------------------------------------------

    def connect_attempt(self) -> None:
        """Called before each socket connect attempt; ``blackhole`` refuses."""
        ev = self._next("connect")
        if ev is not None and ev.kind == "blackhole":
            self._fire(ev)
            raise ConnectionRefusedError(
                "injected fault: connect blackhole"
            )

    def filter_handshake(self, frame: bytes) -> bytes:
        """Called with each ConnectResponse frame; ``expire`` rewrites it to
        the session-expired form the real server sends (timeOut=0)."""
        ev = self._next("handshake")
        if ev is not None and ev.kind == "expire":
            self._fire(ev)
            return (
                struct.pack(">iiq", 0, 0, 0)
                + struct.pack(">i", 16) + b"\x00" * 16
            )
        return frame

    def filter_reply(self, frame: bytes, sock) -> bytes:
        """Called with each in-session reply frame (serial and pipelined);
        may delay, corrupt, or kill the read according to the schedule."""
        ev = self._next("reply")
        if ev is None:
            return frame
        if ev.kind == "slow":
            self._fire(ev)
            time.sleep(ev.arg if ev.arg is not None else 0.05)
            return frame
        if ev.kind == "trunc":
            self._fire(ev)
            keep = int(ev.arg) if ev.arg is not None else len(frame) // 2
            return frame[:max(0, keep)]
        if ev.kind == "drop":
            self._fire(ev)
            if sock is not None:
                try:
                    sock.close()
                except OSError:  # already dead; the injected reset below is the signal
                    pass
            raise ConnectionResetError(
                "injected fault: socket dropped mid-frame"
            )
        if ev.kind == "nonode":
            self._fire(ev)
            # ReplyHeader = xid(4) + zxid(8) + err(4); rewrite err, drop the
            # body (a real NoNode reply carries none).
            return frame[:12] + struct.pack(">i", ERR_NONODE)
        return frame

    def solve_attempt(self) -> None:
        """Called at the top of each device solve; ``crash`` raises."""
        ev = self._next("solve")
        if ev is not None and ev.kind == "crash":
            self._fire(ev)
            raise InjectedSolverCrash(
                "injected fault: device solver crash (kernel build failure / "
                "OOM stand-in)"
            )

    def warmup_attempt(self) -> None:
        """Called at the top of the ingest warm-up thread; ``crash`` raises
        (the thread's degradation handler is what's under test)."""
        ev = self._next("warmup")
        if ev is not None and ev.kind == "crash":
            self._fire(ev)
            raise InjectedWarmupCrash(
                "injected fault: warm-up thread crash (store/compile "
                "failure stand-in)"
            )

    def backend_reply(self, missing_exc=KeyError):
        """Backend-level twin of :meth:`filter_reply` for metadata adapters
        that never see raw frames (the kazoo client, the Kafka AdminClient):
        the SAME ``reply`` scope and schedule fire regardless of backend,
        with each kind mapped onto the adapter's failure surface — ``slow``
        delays the op, ``drop``/``trunc`` become a connection loss, and
        ``nonode`` becomes the adapter's missing-entity error
        (``missing_exc``; default ``KeyError``, the snapshot backend's
        missing-topic class)."""
        ev = self._next("reply")
        if ev is None:
            return
        if ev.kind == "slow":
            self._fire(ev)
            time.sleep(ev.arg if ev.arg is not None else 0.05)
            return
        if ev.kind in ("drop", "trunc"):
            self._fire(ev)
            raise ConnectionResetError(
                "injected fault: backend connection lost mid-read"
            )
        if ev.kind == "nonode":
            self._fire(ev)
            raise missing_exc("injected fault: entity vanished mid-read")

    def write_attempt(self) -> Optional[str]:
        """Called by each backend's reassignment-write path (the write
        seam). ``drop`` raises before the write applies — the engine
        must read back and resubmit, never blindly replay. ``lost`` returns
        ``"lost"``: the backend acks the write but never applies it (the
        caller skips the apply), so the convergence poll must time out with
        the OLD assignment still complete."""
        ev = self._next("write")
        if ev is None:
            return None
        if ev.kind == "drop":
            self._fire(ev)
            raise ConnectionResetError(
                "injected fault: reassignment write dropped before apply"
            )
        if ev.kind == "lost":
            self._fire(ev)
            return "lost"
        return None

    def converge_poll(self) -> bool:
        """Called once per convergence-state read; a ``stall`` event freezes
        that one poll (the backend reports no progress), so the engine's
        retry/backoff loop — not its failure path — is what's exercised."""
        ev = self._next("converge")
        if ev is not None and ev.kind == "stall":
            self._fire(ev)
            return True
        return False

    def wave_boundary(self) -> None:
        """Called by the execution engine between waves; ``crash`` raises
        :class:`InjectedExecCrash` — the kill-between-waves stand-in the
        resume contract is proven against."""
        ev = self._next("wave")
        if ev is not None and ev.kind == "crash":
            self._fire(ev)
            raise InjectedExecCrash(
                "injected fault: execution engine killed at a wave boundary"
            )

    # -- daemon seams --------------------------------------------

    def watch_delivery(self, cluster: Optional[str] = None) -> bool:
        """Called by the daemon per received watch notification; a ``drop``
        event makes the daemon DISCARD it (a notification lost between the
        quorum and the client) — the periodic full-resync escape hatch, not
        the watch, must then reconverge the cache. ``cluster`` is the
        consulting supervisor's cluster name (``@cluster`` addressing)."""
        ev = self._next("watch", cluster)
        if ev is not None and ev.kind == "drop":
            self._fire(ev)
            return True
        return False

    def session_check(self, cluster: Optional[str] = None) -> bool:
        """Called by the daemon at the top of each served request; an
        ``expire`` event tells the daemon to kill its own ZooKeeper session
        NOW (the deterministic stand-in for a server-side session expiry
        landing mid-request) — re-establishment, watch re-arm and the
        bounded resync are what's under test. ``@cluster`` addressing
        blackouts one supervisor while the others' requests stay clean."""
        ev = self._next("session", cluster)
        if ev is not None and ev.kind == "expire":
            self._fire(ev)
            return True
        return False

    def resync_attempt(self, cluster: Optional[str] = None) -> None:
        """Called at the top of each daemon resync pass; ``stall`` raises
        :class:`InjectedResyncStall` — the daemon must retry with backoff
        and serve stale-marked responses meanwhile, never an error."""
        ev = self._next("resync", cluster)
        if ev is not None and ev.kind == "stall":
            self._fire(ev)
            raise InjectedResyncStall(
                "injected fault: daemon resync attempt stalled"
            )

    def dispatch_attempt(self, cluster: Optional[str] = None) -> None:
        """Called by the batched solve dispatcher once per coalesced device
        dispatch, on the dispatcher thread. ``crash`` raises
        :class:`InjectedSolverCrash` into THAT batch only — every job in it
        degrades per-job (whatif rows re-run solo, plans fall back through
        their own crash handling) while other batches, other clusters and
        the dispatcher thread itself survive. ``stall`` sleeps ``arg``
        seconds (default 0.05) before the dispatch — the stall shows up as
        queue wait (``daemon.solve.queue_ms``) and watchdog overrun,
        never a hang."""
        ev = self._next("dispatch", cluster)
        if ev is None:
            return
        if ev.kind == "crash":
            self._fire(ev)
            raise InjectedSolverCrash(
                "injected fault: coalesced solve dispatch crashed mid-batch"
            )
        if ev.kind == "stall":
            self._fire(ev)
            time.sleep(ev.arg if ev.arg is not None else 0.05)

    def controller_point(self, kind: str,
                         cluster: Optional[str] = None) -> bool:
        """Called by the autonomous rebalance controller at its
        three seams, each identified by the KIND it consults for:
        ``verdict-flap`` once per evaluation (a firing flips that
        evaluation's verdict — the hysteresis gate must absorb it),
        ``exec-crash`` once per forward-execution wave boundary (raises
        :class:`InjectedExecCrash` mid-loop — abort-to-rollback must
        restore the pre-action assignment bytes), ``regress`` once per
        post-move re-score (a firing makes the achieved score read as a
        regression — same rollback path, controller breaker opens).

        Unlike the single-seam scopes, each kind keeps its OWN consult
        counter, so ``controller:1=exec-crash`` means "the second wave
        boundary" regardless of how many evaluations ran before it. The
        schedule still keys events ``(scope, cluster, index)``, so one
        schedule can carry at most one controller event per index."""
        key = f"controller.{kind}"
        i = self._counts.get(key, 0)
        self._counts[key] = i + 1
        ev = self._events.get(("controller", None, i))
        if ev is not None and ev.kind != kind:
            ev = None
        if ev is None and cluster is not None:
            ckey = (key, cluster)
            j = self._cluster_counts.get(ckey, 0)
            self._cluster_counts[ckey] = j + 1
            ev = self._events.get(("controller", cluster, j))
            if ev is not None and ev.kind != kind:
                ev = None
        if ev is None:
            return False
        self._fire(ev)
        if kind == "exec-crash":
            raise InjectedExecCrash(
                "injected fault: controller forward execution killed at a "
                "wave boundary"
            )
        return True

    def fleet_point(self, kind: str,
                    cluster: Optional[str] = None) -> bool:
        """Called by the fleet scheduler at its three seams,
        each identified by the KIND it consults for: ``lease-expire``
        once per lease-prune sweep (a firing expires every live lease as
        if its holder stopped heartbeating `KA_FLEET_LEASE_TTL` ago — the
        next admission wins the slot, and the stale holder's own release
        degrades to a loud no-op), ``ledger-torn`` once per ledger load
        (a firing makes the read report external damage — accounting
        restarts empty, loudly), ``recovery-crash`` once per startup-
        recovery wave boundary (raises :class:`InjectedExecCrash` — the
        resumed journal stays in-progress and the NEXT boot retries).

        Like ``controller_point``, each kind keeps its OWN consult
        counter, so ``fleet:1=recovery-crash`` means "the second recovery
        wave boundary" regardless of how many prune sweeps ran first."""
        key = f"fleet.{kind}"
        i = self._counts.get(key, 0)
        self._counts[key] = i + 1
        ev = self._events.get(("fleet", None, i))
        if ev is not None and ev.kind != kind:
            ev = None
        if ev is None and cluster is not None:
            ckey = (key, cluster)
            j = self._cluster_counts.get(ckey, 0)
            self._cluster_counts[ckey] = j + 1
            ev = self._events.get(("fleet", cluster, j))
            if ev is not None and ev.kind != kind:
                ev = None
        if ev is None:
            return False
        self._fire(ev)
        if kind == "recovery-crash":
            raise InjectedExecCrash(
                "injected fault: fleet startup-recovery resume killed at "
                "a wave boundary"
            )
        return True

    def daemon_solve(self, cluster: Optional[str] = None) -> None:
        """Called at the daemon's per-request solve dispatch boundary;
        ``solver-crash`` raises :class:`InjectedSolverCrash` — the request
        must degrade to the greedy fallback in isolation (other requests,
        other clusters, and the daemon itself, unaffected)."""
        ev = self._next("daemon", cluster)
        if ev is not None and ev.kind == "solver-crash":
            self._fire(ev)
            raise InjectedSolverCrash(
                "injected fault: solver crash inside a served daemon request"
            )


#: Programmatic override (tests) — wins over the env knob when set.
_INSTALLED: Optional[FaultInjector] = None
#: Env-built injector cache keyed by (spec, seed): the wire client and the
#: solver construct lazily but must share one schedule's counters.
_ENV_CACHE: Optional[Tuple[Tuple[str, int], Optional[FaultInjector]]] = None


def install(injector: Optional[FaultInjector]) -> None:
    """Install an injector programmatically (None uninstalls); overrides the
    ``KA_FAULTS_SPEC`` knob until :func:`reset`."""
    global _INSTALLED
    _INSTALLED = injector


def reset() -> None:
    """Forget the installed injector and the env cache: the next
    :func:`active_injector` call starts a fresh schedule (fresh counters).
    The chaos soak calls this between runs."""
    global _INSTALLED, _ENV_CACHE
    _INSTALLED = None
    _ENV_CACHE = None


def active_injector() -> Optional[FaultInjector]:
    """The injector for the current process, or None (the fast path: one
    global read). Env-driven construction follows the knob house rule — a
    malformed ``KA_FAULTS_SPEC`` warns on stderr and injection stays OFF."""
    if _INSTALLED is not None:
        return _INSTALLED
    from ..utils.env import env_float, env_int, env_str

    spec = env_str("KA_FAULTS_SPEC")
    if not spec:
        return None
    seed = env_int("KA_FAULTS_SEED")
    global _ENV_CACHE
    if _ENV_CACHE is not None and _ENV_CACHE[0] == (spec, seed):
        return _ENV_CACHE[1]
    injector: Optional[FaultInjector] = None
    try:
        injector = FaultInjector(
            parse_spec(spec, seed, env_float("KA_FAULTS_RATE"))
        )
    except FaultSpecError as e:
        print(
            f"kafka-assigner: ignoring malformed KA_FAULTS_SPEC ({e}); "
            "fault injection disabled",
            file=sys.stderr,
        )
    _ENV_CACHE = ((spec, seed), injector)
    return injector


def controller_fault(kind: str, cluster: Optional[str] = None) -> bool:
    """The controller's per-kind fault consult: returns True
    when the scheduled ``controller`` event of this ``kind`` fired
    (``verdict-flap``/``regress``); ``exec-crash`` raises
    :class:`InjectedExecCrash` instead. No-op False without an active
    injector."""
    inj = active_injector()
    if inj is None:
        return False
    return inj.controller_point(kind, cluster)


def fleet_fault(kind: str, cluster: Optional[str] = None) -> bool:
    """The fleet scheduler's per-kind fault consult: returns
    True when the scheduled ``fleet`` event of this ``kind`` fired
    (``lease-expire``/``ledger-torn``); ``recovery-crash`` raises
    :class:`InjectedExecCrash` instead. No-op False without an active
    injector."""
    inj = active_injector()
    if inj is None:
        return False
    return inj.fleet_point(kind, cluster)


def fault_point(scope: str, cluster: Optional[str] = None) -> None:
    """Generic crash-style fault point for non-wire call sites (``solve`` in
    the device solver, ``warmup`` in the ingest warm-up thread, ``wave`` at the
    execution engine's wave boundaries). ``cluster`` forwards the daemon
    supervisor's cluster name for ``@cluster``-addressed schedules. No-op
    without an active injector."""
    inj = active_injector()
    if inj is None:
        return
    if scope == "solve":
        inj.solve_attempt()
    elif scope == "warmup":
        inj.warmup_attempt()
    elif scope == "wave":
        inj.wave_boundary()
    elif scope == "resync":
        inj.resync_attempt(cluster)
    elif scope == "daemon":
        inj.daemon_solve(cluster)
    elif scope == "dispatch":
        inj.dispatch_attempt(cluster)
