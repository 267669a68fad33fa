"""The closed-loop rebalance controller: the port of the reference's
``kafka_assigner_tpu/daemon/controller.py`` (``resolve_policy``,
``SharedTicker``, ``RebalanceController``), the auto-execute rung of the
observe, recommend, auto-execute ladder.

One controller per cluster, owned by its
:class:`~.supervisor.ClusterSupervisor`. On each tick it runs the same
evaluation as ``/recommendations`` (a candidate plan solved against the
cache under the dispatch regime, current and projected assignment scored,
the movement priced) and, only under the ``auto`` policy, executes the
recommended plan through the supervisor's one-at-a-time ``/execute``
machinery. Its safety rails, each visible in the decision trail:

- **Policy** (``off``, ``observe``, ``auto``; the ``KA_CONTROLLER`` knob,
  overridden per cluster in the ``--clusters`` spec): ``off`` starts no
  thread; ``observe`` evaluates and records, down to the ``would-act``
  decision ``auto`` would take, and never writes; ``auto`` acts.
- **Hysteresis**: ``KA_CONTROLLER_CONFIRMATIONS`` consecutive ``recommend``
  verdicts for the same plan bytes before an action; a flap or a changed
  plan resets the streak. The streak persists beside the window ledger.
- **Blast radius**: ``KA_CONTROLLER_MAX_MOVES`` replica moves per action
  (an oversize plan is truncated to a prefix of whole partitions, or
  held) and per ``KA_CONTROLLER_WINDOW`` rolling window, whose ledger
  persists in the journal directory, so a restart does not reset it.
- **Cooldown**: ``KA_CONTROLLER_COOLDOWN`` between actions, jittered
  0.5-1.5x; evaluations go on during it.
- **Refusals**: no action while the cluster is syncing or degraded, its
  session breaker is not closed, the daemon drains, or an execution is in
  flight.
- **Abort to rollback**: a crash mid-run, a terminal status other than
  ``ok``, or an achieved score worse than the projection by more than
  ``KA_CONTROLLER_REGRESSION_TOL`` (re-scored from the verify pass's read,
  through the engine's ``on_verified`` hook) drives the plan's own
  ``CURRENT ASSIGNMENT:`` back through the wave engine and opens the
  controller's breaker.
- **The fleet** (``daemon/fleet.py``, ``ClusterSupervisor.fleet``): a
  daemon-wide lease before acting, denied on the fleet's concurrency cap,
  its move budget or a worse-off cluster's want (a hold like any other),
  stamped at every wave boundary and released after; a rollback charges
  its moves to the fleet's window too. A supervisor built alone has no
  fleet and acts ungated, as the reference's.

Every decision is a flight ``controller`` event and an entry of the ring
served at ``/clusters/<name>/controller`` (POST ``{"action": "pause"}`` or
``"resume"``). The ``controller:{verdict-flap,exec-crash,regress}`` seams
(``faults/inject.py``) sit where the reference's do.

The per-action record is written before an action's first wave and
discarded after it. A daemon killed mid-action leaves it for the fleet's
boot-time recovery, which reads it back (:meth:`load_action_record`),
finishes the action the way this controller would have
(:meth:`resume_recovery`) and sweeps what no journal needs any more
(:meth:`discard_superseded`, :meth:`discard_orphan_records`).

This module never touches a supervisor's cache or session: everything goes
through the supervisor's methods (``controller_evaluate``,
``controller_execute``, ``score_with_overlay``, ``lifecycle``, ...).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..faults.inject import InjectedExecCrash, controller_fault
from ..io.json_io import format_reassignment_json
from ..obs import flight
from ..obs.metrics import counter_add, gauge_set
from ..obs.trace import record_span
from ..utils.atomicwrite import atomic_write_text
from ..utils.backoff import JitteredBackoff
from ..utils.env import env_choice, env_float, env_int, env_str

#: Capacity of the decision ring (the ``/controller`` view).
DECISION_RING = 64

#: The policies, weakest first.
POLICIES = ("off", "observe", "auto")

#: Schema version of the persisted verdict memory
#: (``ka-controller-<cluster>.verdict.json``). A memory of another version
#: resets loudly: its confirmations were made under other rules.
VERDICT_MEMORY_VERSION = 1

#: Schema version of the per-action record
#: (``ka-controller-<cluster>-<sha12>.action.json``): the plan bytes (the
#: rollback's anchor) and whether the controller had aborted.
ACTION_RECORD_VERSION = 1


def resolve_policy(override: Optional[str]) -> str:
    """A cluster's policy: its ``--clusters`` override when given, else the
    ``KA_CONTROLLER`` knob (default ``off``)."""
    if override is not None:
        if override not in POLICIES:
            raise ValueError(
                f"unknown controller policy {override!r} "
                f"(expected one of {list(POLICIES)})"
            )
        return override
    return env_choice("KA_CONTROLLER")


class SharedTicker:
    """One tick generator for every controller of a daemon. Timers of their
    own would drift apart, and N clusters would cost N solves one after
    another; waiting on one generation counter releases every controller at
    once, so their evaluations meet in the dispatcher's gather window and
    pack into one placement call a round.

    The timer thread starts with the first controller's ``ensure_started``
    (a daemon whose clusters are all ``off`` starts none), reads
    ``KA_CONTROLLER_INTERVAL`` each cycle, and bumps the generation once
    more when the daemon stops, so no waiter outlives the stop."""

    def __init__(self, stopped: threading.Event) -> None:
        self._stopped = stopped
        self._cv = threading.Condition()
        self._gen = 0
        self._thread: Optional[threading.Thread] = None

    def ensure_started(self) -> None:
        with self._cv:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="ka-ticker", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stopped.wait(env_float("KA_CONTROLLER_INTERVAL")):
            self.advance()
        # The last bump releases every waiter into its stop check.
        self.advance()

    def advance(self) -> None:
        """Start a round now: bump the generation and release every waiting
        controller (the timer's own step; a harness calls it to drive
        rounds without waiting out the interval)."""
        with self._cv:
            self._gen += 1
            self._cv.notify_all()

    @property
    def generation(self) -> int:
        with self._cv:
            return self._gen

    def wait_next(self, last_gen: int) -> int:
        """Block until the generation passes ``last_gen`` or the daemon
        stops; returns the new generation. Wakes every 0.5 s to check the
        stop flag."""
        with self._cv:
            while self._gen <= last_gen and not self._stopped.is_set():
                self._cv.wait(0.5)
            return self._gen


class RebalanceController:
    """One cluster's closed-loop rebalance controller. ``rng`` draws the
    cooldown's and the breaker's jitter (the module-global generator unless
    given; tests pass a seeded ``random.Random``)."""

    def __init__(self, sup, policy: str, rng=None) -> None:
        self.sup = sup
        self.policy = policy
        self._rng = rng
        self._mutex = threading.Lock()
        self._paused = False
        self._thread: Optional[threading.Thread] = None
        #: The decision ring and the decisions' running sequence number.
        self._decisions: Deque[dict] = collections.deque(maxlen=DECISION_RING)
        self._seq = 0
        #: Hysteresis: consecutive agreeing ``recommend`` verdicts.
        self._streak = 0
        self._last_sha: Optional[str] = None
        #: The cooldown's monotonic deadline (0: no action yet).
        self._next_action_at = 0.0
        #: The controller's own breaker (apart from the session breaker).
        self._breaker = "closed"
        self._breaker_until = 0.0
        self._breaker_backoff = self._fresh_breaker_backoff()
        #: The rolling window's ledger, [(epoch seconds, moves)], persisted
        #: in the journal directory.
        self._ledger: List[Tuple[float, int]] = []
        self._ledger_loaded = False
        #: The persisted verdict memory (the streak across a restart).
        self._memory_loaded = False

    # -- plumbing -----------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self.sup._count(name, n)

    def _metric(self, name: str) -> str:
        return self.sup._metric(name)

    def _log(self, msg: str) -> None:
        self.sup._log(f"controller: {msg}")

    def _fresh_breaker_backoff(self) -> JitteredBackoff:
        base = max(
            env_float("KA_CONTROLLER_COOLDOWN"),
            env_float("KA_CONTROLLER_INTERVAL"),
            0.05,
        )
        return JitteredBackoff(base, cap=env_float("KA_CONTROLLER_WINDOW"),
                               rng=self._rng)

    def _decide(self, decision: str, **fields) -> dict:
        """Record one decision: a ring entry and a flight event (and the
        holds counter; the other decision counters are counted where the
        decision is made, once)."""
        clean = {k: v for k, v in fields.items() if v is not None}
        with self._mutex:
            self._seq += 1
            entry = {
                "seq": self._seq,
                "t": round(time.time(), 3),
                "decision": decision,
            }
            entry.update(clean)
            self._decisions.append(entry)
        flight.record("controller", self.sup.name, decision=decision, **clean)
        if decision == "hold":
            self._count("controller.holds")
        return entry

    # -- lifecycle ------------------------------------------------------------------

    def start(self) -> None:
        """Start the evaluation loop (nothing under ``off``: a cluster that
        never opted in pays no thread and no solve)."""
        if self.policy == "off" or self._thread is not None:
            return
        self._load_ledger()
        self._load_memory()
        # The daemon's shared ticker starts here too, so a daemon of `off`
        # clusters keeps no timer thread either.
        ticker = getattr(self.sup, "_ticker", None)
        if ticker is not None:
            ticker.ensure_started()
        self._thread = threading.Thread(
            target=self._loop, name=f"ka-controller-{self.sup.name}",
            daemon=True,
        )
        self._thread.start()

    def join(self, timeout: float = 30.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        # Under the shared ticker every controller waits on one generation,
        # so every tick body starts together and their evaluation solves
        # pack in the dispatcher. A supervisor built alone (tests) has no
        # ticker and keeps an interval timer of its own.
        ticker = getattr(self.sup, "_ticker", None)
        gen = ticker.generation if ticker is not None else 0
        while not self.sup.stopped.is_set():
            if ticker is not None:
                gen = ticker.wait_next(gen)
                if self.sup.stopped.is_set():
                    return
            elif self.sup.stopped.wait(env_float("KA_CONTROLLER_INTERVAL")):
                return
            try:
                self.tick()
            except Exception as e:
                # The loop never dies: an unexpected error costs one
                # evaluation, loudly.
                self._log(
                    f"evaluation loop error ({type(e).__name__}: {e}); "
                    "next interval continues"
                )

    # -- pause and resume ---------------------------------------------------------------

    def pause(self) -> dict:
        """Stop evaluations and actions after the current tick. An action in
        flight runs to its end: the journal, not this flag, owns execution
        safety."""
        with self._mutex:
            already = self._paused
            self._paused = True
        if not already:
            self._decide("paused")
        return self.view()

    def resume(self) -> dict:
        with self._mutex:
            was = self._paused
            self._paused = False
        if was:
            self._decide("resumed")
        return self.view()

    def paused(self) -> bool:
        with self._mutex:
            return self._paused

    # -- the rolling window's move ledger -------------------------------------------

    def _ledger_path(self) -> str:
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        return os.path.join(jdir, f"ka-controller-{self.sup.name}.window.json")

    def _load_ledger(self) -> None:
        """Load the window's ledger once (the budget belongs to the
        cluster's recent history, not to one process). A missing ledger
        starts empty, a corrupt one too, loudly. Guarded by the mutex: the
        loop and the HTTP threads all load on first touch, and a second load
        would overwrite an entry appended in between."""
        err: Optional[Exception] = None
        with self._mutex:
            if self._ledger_loaded:
                return
            self._ledger_loaded = True
            path = self._ledger_path()
            try:
                with open(path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
                self._ledger = [
                    (float(t), int(n)) for t, n in raw.get("actions", [])
                ]
            except FileNotFoundError:
                self._ledger = []
            except (OSError, ValueError, TypeError) as e:
                self._ledger = []
                err = e
        if err is not None:
            # Logged outside the mutex: the supervisor's log has locking of
            # its own.
            self._log(
                f"window ledger {self._ledger_path()!r} unreadable "
                f"({err}); budget accounting restarts empty"
            )

    def _save_ledger(self) -> None:
        with self._mutex:
            actions = [[t, n] for t, n in self._ledger]
        try:
            atomic_write_text(
                self._ledger_path(),
                json.dumps({"actions": actions}),
                prefix=".ka_controller_",
            )
        except OSError as e:
            self._log(
                f"window ledger persist failed ({e}); accounting is "
                "in-memory only until the next action"
            )

    def _window_moves(self) -> int:
        """The moves executed inside the rolling window, pruning as time
        passes. Forward actions and rollbacks both count."""
        # tick() and view() may run without start(): load before reading.
        self._load_ledger()
        horizon = time.time() - env_float("KA_CONTROLLER_WINDOW")
        with self._mutex:
            self._ledger = [(t, n) for t, n in self._ledger if t >= horizon]
            total = sum(n for _t, n in self._ledger)
        if self.policy != "off":
            # A cluster that never opted in mints no controller series.
            gauge_set(self._metric("controller.window_moves"), total)
        return total

    def _record_moves(self, moves: int) -> None:
        if moves <= 0:
            return
        self._load_ledger()
        ts = round(time.time(), 3)
        with self._mutex:
            self._ledger.append((ts, int(moves)))
        self._count("controller.moves", moves)
        self._save_ledger()
        self._window_moves()

    # -- the persisted verdict memory ----------------------------------------------

    def _memory_path(self) -> str:
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        return os.path.join(jdir, f"ka-controller-{self.sup.name}.verdict.json")

    def _load_memory(self) -> None:
        """Load the hysteresis streak once: a restart neither forces a
        confirmed plan to confirm again nor lets an operator reset the
        streak by restarting. Loaded as the ledger is. A memory of another
        schema version resets loudly."""
        err: Optional[Exception] = None
        stale: Optional[object] = None
        with self._mutex:
            if self._memory_loaded:
                return
            self._memory_loaded = True
            path = self._memory_path()
            try:
                with open(path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
                if not isinstance(raw, dict):
                    raise ValueError("not a JSON object")
                if raw.get("version") != VERDICT_MEMORY_VERSION:
                    stale = raw.get("version")
                else:
                    sha = raw.get("sha")
                    self._last_sha = str(sha) if sha else None
                    self._streak = (
                        max(0, int(raw.get("streak", 0)))
                        if self._last_sha is not None else 0
                    )
            except FileNotFoundError:  # a first start: no memory yet
                pass
            except (OSError, ValueError, TypeError) as e:
                err = e
        if stale is not None:
            counter_add("fleet.memory_resets")
            self._decide(
                "memory-reset", found_version=stale,
                expected_version=VERDICT_MEMORY_VERSION,
            )
            self._log(
                f"verdict memory {self._memory_path()!r} was written "
                f"under schema version {stale!r} (this controller runs "
                f"{VERDICT_MEMORY_VERSION}); its confirmations no longer "
                "mean the same thing — hysteresis restarts from scratch"
            )
        elif err is not None:
            counter_add("fleet.memory_resets")
            self._log(
                f"verdict memory {self._memory_path()!r} unreadable "
                f"({err}); hysteresis restarts from scratch"
            )

    def _save_memory(self) -> None:
        """Written through at every change of the streak."""
        with self._mutex:
            payload = {
                "version": VERDICT_MEMORY_VERSION,
                "sha": self._last_sha,
                "streak": self._streak,
            }
        try:
            atomic_write_text(
                self._memory_path(),
                json.dumps(payload, sort_keys=True),
                prefix=".ka_controller_",
            )
        except OSError as e:
            self._log(
                f"verdict memory persist failed ({e}); hysteresis is "
                "in-memory only until the next verdict"
            )

    # -- the per-action record --------------------------------------------------------

    def _record_path(self, sha: str) -> str:
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        return os.path.join(
            jdir, f"ka-controller-{self.sup.name}-{sha[:12]}.action.json"
        )

    def _write_action_record(self, sha: str, plan_text: str, moves: int,
                             *, aborted: bool = False) -> None:
        """Persist the action's identity before its first wave: a daemon
        that dies mid-action leaves the plan bytes (the rollback's anchor)
        and the abort decision, which nothing else keeps."""
        payload = {
            "version": ACTION_RECORD_VERSION,
            "cluster": self.sup.name,
            "sha": sha,
            "moves": int(moves),
            "aborted": bool(aborted),
            "plan_text": plan_text,
        }
        try:
            atomic_write_text(
                self._record_path(sha),
                json.dumps(payload, sort_keys=True),
                prefix=".ka_controller_",
            )
        except OSError as e:
            self._log(
                f"action record persist failed ({e}); a kill during this "
                "action recovers under journal authority instead"
            )

    def load_action_record(self, sha: str) -> Optional[dict]:
        """One action record read back (the boot recovery's view); None when
        it is missing or unusable, and recovery falls back to the journal's
        authority."""
        path = self._record_path(sha)
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            if not isinstance(raw, dict) \
                    or raw.get("version") != ACTION_RECORD_VERSION \
                    or not isinstance(raw.get("plan_text"), str):
                raise ValueError("not a valid action record")
            return raw
        except FileNotFoundError:
            return None
        except (OSError, ValueError, TypeError) as e:
            self._log(
                f"action record {path!r} unusable ({e}); recovery falls "
                "back to journal authority"
            )
            return None

    def _discard_action_record(self, sha: str) -> None:
        try:
            os.unlink(self._record_path(sha))
        except FileNotFoundError:  # already gone: the state wanted
            pass
        except OSError as e:
            self._log(
                f"could not remove action record "
                f"{self._record_path(sha)!r} ({e})"
            )

    def discard_superseded(self, sha: str) -> None:
        """Remove an action's forward journal and its record once a rollback
        superseded them (the boot recovery's cleanup after a rollback
        resumed under the journal's authority): left in progress, the
        forward journal would refuse a later run of the same plan bytes."""
        forward = self._journal_path(sha)
        try:
            os.unlink(forward)
        except FileNotFoundError:  # already gone: the state wanted
            pass
        except OSError as e:
            self._log(
                f"could not remove superseded forward journal "
                f"{forward!r} ({e})"
            )
        self._discard_action_record(sha)

    def discard_orphan_records(self, active_shas) -> None:
        """The boot sweep (the fleet's recovery scan calls it): remove this
        cluster's action records whose sha has no in-progress journal left.
        The kill came before the journal existed (nothing moved) or after
        the action ended but before its record went; either way nothing is
        left to recover."""
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        prefix = f"ka-controller-{self.sup.name}-"
        suffix = ".action.json"
        try:
            names = sorted(os.listdir(jdir))
        except OSError:
            return
        for fname in names:
            if not (fname.startswith(prefix) and fname.endswith(suffix)):
                continue
            sha = fname[len(prefix):-len(suffix)]
            if len(sha) == 12 and sha not in active_shas:
                self._log(
                    f"dropping orphan action record {fname!r}: no "
                    "in-progress journal references it (the action never "
                    "moved a replica, or already completed)"
                )
                self._discard_action_record(sha)

    def resume_recovery(
        self, record: dict, journal_path: Optional[str], *,
        what: str, moves: int = 0, probe=None, heartbeat=None,
    ) -> dict:
        """Finish an interrupted action as this controller would have (the
        fleet's boot scan calls it, holding the recovery lease):

        - ``what="rollback-resume"``: the rollback journal ``journal_path``
          in flight completes;
        - ``what="rollback-fresh"``: the record says the controller had
          aborted, but the kill came before the rollback journal existed:
          the record's ``CURRENT`` snapshot runs back through the engine
          under a fresh rollback journal;
        - ``what="forward"``: the forward journal ``journal_path`` resumes
          to the verified plan.

        On success the files the live path would have removed go, the
        window's ledger charges the resumed moves, and after a rollback the
        controller's breaker opens (the plan failed before the kill; a
        restart grants it no free probe). :class:`InjectedExecCrash` (the
        ``fleet:recovery-crash`` seam) propagates: the journal stays in
        progress for the next boot."""
        sha = str(record["sha"])
        plan_text = record["plan_text"]
        rollback = what in ("rollback-resume", "rollback-fresh")
        if journal_path is None:
            journal_path = self._journal_path(sha, rollback=True)
        terminal = self.sup.controller_execute(
            plan_text,
            section="current" if rollback else "new",
            journal=journal_path,
            resume=what != "rollback-fresh",
            probe=probe,
            heartbeat=heartbeat,
        )
        if "refused" in terminal:
            return terminal
        ok = (
            terminal.get("event") == "exec/done"
            and terminal.get("status") in ("ok", "degraded")
        )
        self._decide(
            "recovered" if ok else "recovery-failed", what=what,
            plan_sha=sha[:12],
            status=terminal.get("status") or terminal.get("kind"),
        )
        if ok:
            self._record_moves(max(0, int(moves)))
            self.sup.controller_refresh()
            if rollback:
                self.discard_superseded(sha)
                self._breaker_open("recovered rollback")
            else:
                self._discard_action_record(sha)
        return terminal

    # -- the controller's breaker -------------------------------------------------------

    def breaker_view(self) -> dict:
        with self._mutex:
            out = {"state": self._breaker}
            if self._breaker == "open":
                out["retry_in_s"] = round(
                    max(0.0, self._breaker_until - time.monotonic()), 3
                )
            return out

    def _breaker_allow(self) -> bool:
        """Closed or half-open: evaluate. Open: only once the cooldown has
        passed, which half-opens it for one probe action."""
        with self._mutex:
            if self._breaker != "open":
                return True
            if time.monotonic() < self._breaker_until:
                return False
            self._breaker = "half-open"
        self._decide("breaker-half-open")
        return True

    def _breaker_open(self, reason: str) -> None:
        with self._mutex:
            self._breaker = "open"
            self._breaker_until = (
                time.monotonic() + self._breaker_backoff.next_delay()
            )
        self._count("controller.breaker_opened")
        self._decide("breaker-open", reason=reason)
        self._log(
            f"breaker OPEN ({reason}); actions gated on the cooldown "
            "envelope"
        )

    def _breaker_close(self) -> None:
        with self._mutex:
            was = self._breaker
            self._breaker = "closed"
            self._breaker_until = 0.0
            self._breaker_backoff = self._fresh_breaker_backoff()
        if was != "closed":
            self._count("controller.breaker_closed")
            self._decide("breaker-closed")

    # -- one evaluation -------------------------------------------------------------------

    def tick(self) -> Optional[dict]:
        """One iteration: the refusals, the evaluation, hysteresis, then
        (``auto`` only) the blast-radius gates and the action. Returns the
        decision recorded, or None when nothing was decided (off, paused,
        draining)."""
        if self.policy == "off" or self.paused():
            return None
        if self.sup.draining.is_set() or self.sup.stopped.is_set():
            return None
        # tick() may run without start(): load the streak before comparing.
        self._load_memory()
        lifecycle = self.sup.lifecycle()
        if lifecycle != "ready":
            # Syncing or degraded: advice from a suspect cache moves no data.
            return self._decide("hold", reason=f"cluster {lifecycle}")
        if self.sup.breaker.snapshot()["state"] != "closed":
            return self._decide("hold", reason="session breaker not closed")
        if self.sup.execution_in_flight():
            return self._decide("hold", reason="execution in flight")
        if not self._breaker_allow():
            return self._decide("hold", reason="controller breaker open")

        t0 = time.perf_counter()
        status, ev = self.sup.controller_evaluate()
        record_span(
            self._metric("controller/evaluate"),
            (time.perf_counter() - t0) * 1e3,
            status == "ok",
        )
        if status != "ok":
            return self._decide("hold", reason=str(ev))
        self._count("controller.evaluations")

        verdict = ev["verdict"]
        flapped = controller_fault("verdict-flap", self.sup.name)
        if flapped:
            verdict = "hold" if verdict == "recommend" else "recommend"
        if verdict != "recommend":
            with self._mutex:
                self._streak = 0
                self._last_sha = None
            gauge_set(self._metric("controller.streak"), 0)
            self._save_memory()
            return self._decide(
                "hold", reason="verdict hold", verdict=verdict,
                flapped=flapped or None, improvement=ev["improvement"],
                moves=ev["moves"],
            )
        sha = ev["plan_sha"]
        with self._mutex:
            if sha == self._last_sha:
                self._streak += 1
            else:
                self._streak = 1
                self._last_sha = sha
            streak = self._streak
        gauge_set(self._metric("controller.streak"), streak)
        self._save_memory()
        need = env_int("KA_CONTROLLER_CONFIRMATIONS")
        if streak < need:
            return self._decide(
                "confirmed", verdict=verdict, streak=streak,
                required=need, plan_sha=sha[:12], moves=ev["moves"],
                flapped=flapped or None,
            )

        max_moves = env_int("KA_CONTROLLER_MAX_MOVES")
        window_moves = self._window_moves()
        budget = max_moves - window_moves
        if self.policy == "observe":
            # Everything up to the decision auto would take, and no write:
            # this path never reaches controller_execute.
            return self._decide(
                "would-act", verdict=verdict, streak=streak,
                plan_sha=sha[:12], moves=ev["moves"],
                window_budget=budget,
            )
        now = time.monotonic()
        with self._mutex:
            cooling = now < self._next_action_at
            retry_in = round(max(0.0, self._next_action_at - now), 3)
        if cooling:
            return self._decide(
                "hold", reason="cooldown", retry_in_s=retry_in,
                streak=streak,
            )
        if budget <= 0:
            return self._decide(
                "hold", reason="window budget spent",
                window_moves=window_moves, max_moves=max_moves,
            )

        plan_text, moves, act_sha = ev["plan_text"], ev["moves"], sha
        projected = ev["projected"]
        # budget <= max_moves: the action's cap and the window's meet here.
        cap = budget
        if moves > cap:
            plan_text, moves, act_sha = self._truncate(plan_text, cap)
            if moves == 0:
                return self._decide(
                    "hold",
                    reason="oversize plan has no prefix inside the cap",
                    cap=cap,
                )
            # A truncated action is judged against its own projection.
            from ..exec.engine import parse_plan_payload

            new_sub, _ = parse_plan_payload(
                plan_text, origin="truncated controller plan"
            )
            projected = self.sup.score_with_overlay(new_sub, base=ev["topics"])
            self._count("controller.truncations")
            self._decide(
                "truncate", moves=moves, cap=cap,
                full_moves=ev["moves"], plan_sha=act_sha[:12],
            )
        fleet = getattr(self.sup, "fleet", None)
        if fleet is not None:
            # A daemon-wide lease before acting; a denial holds like any
            # other, with the cooldown armed and the streak kept.
            status, info = fleet.acquire(
                self.sup.name, moves=moves, sha=act_sha,
                score=self.sup.health_score(),
            )
            if status != "granted":
                self._arm_cooldown()
                return self._decide(
                    "hold", reason=f"fleet {status}",
                    fleet_reason=info.get("reason"),
                    winner=info.get("winner"),
                )
        return self._act(ev, plan_text, moves, act_sha, projected)

    # -- acting ---------------------------------------------------------------------------

    def _arm_cooldown(self) -> None:
        cooldown = env_float("KA_CONTROLLER_COOLDOWN")
        jittered = JitteredBackoff(cooldown, factor=1.0,
                                   rng=self._rng).next_delay()
        with self._mutex:
            self._next_action_at = time.monotonic() + jittered

    def _journal_path(self, sha: str, rollback: bool = False) -> str:
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        suffix = ".rollback.journal" if rollback else ".journal"
        return os.path.join(
            jdir, f"ka-controller-{self.sup.name}-{sha[:12]}{suffix}"
        )

    def _act(self, ev: dict, plan_text: str, moves: int,
             sha: str, projected) -> dict:
        """One action: the forward run through the ``/execute`` machinery,
        the post-move re-score, and the abort to rollback on a failure or a
        regression."""
        with self._mutex:
            half_open = self._breaker == "half-open"
        journal = self._journal_path(sha)
        achieved_box: Dict[str, object] = {}
        fleet = getattr(self.sup, "fleet", None)
        #: A lease won in tick() is released once: refunded when the run was
        #: refused (nothing moved), dropped otherwise.
        lease_box = {"held": fleet is not None}

        def release_lease(refund: bool = False) -> None:
            if lease_box["held"]:
                lease_box["held"] = False
                fleet.release(self.sup.name, refund=refund)

        def probe():
            # Wave boundaries are the lease's heartbeats.
            if fleet is not None:
                fleet.heartbeat(self.sup.name)
            return controller_fault("exec-crash", self.sup.name)

        def on_start() -> None:
            # The run was admitted and is about to start: only now does the
            # action exist. A refusal leaves no `act` and keeps the streak.
            with self._mutex:
                # The world changes: the next recommendation confirms anew.
                self._streak = 0
                self._last_sha = None
            gauge_set(self._metric("controller.streak"), 0)
            self._save_memory()
            self._write_action_record(sha, plan_text, moves)
            self._decide(
                "act", plan_sha=sha[:12], moves=moves,
                probe=half_open or None,
            )
            self._count("controller.actions")

        def on_verified(observed) -> None:
            # Overlaid on the evaluation's baseline, the one the projection
            # was scored on: unrelated churn in the live cache during the
            # run must not read as this plan's regression.
            achieved_box["scores"] = self.sup.score_with_overlay(
                observed, base=ev["topics"]
            )

        t0 = time.perf_counter()
        ok = False
        try:
            try:
                terminal = self.sup.controller_execute(
                    plan_text,
                    probe=probe,
                    on_verified=on_verified,
                    on_start=on_start,
                    journal=journal,
                )
            except InjectedExecCrash as e:
                # The kill's stand-in fired mid-run: the forward journal
                # keeps every committed wave; the answer is the rollback.
                self._count("controller.exec_failures")
                self._record_moves(moves)
                self._arm_cooldown()
                self.sup.controller_refresh()
                self._decide("abort", reason=f"execution crashed: {e}")
                return self._rollback(sha, plan_text, journal, moves,
                                      reason="exec-crash")
            if "refused" in terminal:
                # Lost the race for the execution slot, or a drain began:
                # not the plan's failure. Hold and confirm again later.
                release_lease(refund=True)
                return self._decide(
                    "hold", reason=f"execute refused: {terminal['refused']}"
                )
            # The ledger counts replica moves (the cap's unit), planned ones
            # included where they turned out to be noops.
            self._record_moves(moves)
            self._arm_cooldown()
            self.sup.controller_refresh()
            if terminal.get("event") != "exec/done" \
                    or terminal.get("status") != "ok":
                self._count("controller.exec_failures")
                why = (
                    terminal.get("status")
                    or terminal.get("kind")
                    or "unknown execution failure"
                )
                self._decide("abort", reason=f"execution {why}")
                return self._rollback(sha, plan_text, journal, moves,
                                      reason=f"execution {why}")

            achieved = achieved_box.get("scores")
            delta = None
            regressed = False
            if achieved is not None:
                tol = env_float("KA_CONTROLLER_REGRESSION_TOL")
                delta = round(achieved.score - projected.score, 6)
                regressed = delta > tol
            if controller_fault("regress", self.sup.name):
                regressed = True
            if regressed:
                self._count("controller.regressions")
                self._decide(
                    "abort",
                    reason="post-move health regression",
                    achieved=achieved.score if achieved is not None else None,
                    projected=projected.score, delta=delta,
                )
                return self._rollback(sha, plan_text, journal, moves,
                                      reason="regression")
            ok = True
            if half_open:
                self._breaker_close()
            self._discard_action_record(sha)
            return self._decide(
                "acted", plan_sha=sha[:12], moves=moves,
                achieved=achieved.score if achieved is not None else None,
                projected=projected.score, delta=delta,
            )
        finally:
            release_lease()
            record_span(
                self._metric("controller/act"),
                (time.perf_counter() - t0) * 1e3, ok,
            )

    def _rollback(self, sha: str, plan_text: str, forward_journal: str,
                  moves: int, reason: str) -> dict:
        """Drive the plan's own CURRENT snapshot back through the wave engine
        (``ka-execute --rollback``), then open the breaker. The window's
        ledger charges the rollback's moves too."""
        self._count("controller.rollbacks")
        fleet = getattr(self.sup, "fleet", None)
        # The abort persists before the rollback runs: a kill from here on
        # rolls back at the next start instead of resuming the plan.
        self._write_action_record(sha, plan_text, moves, aborted=True)
        try:
            terminal = self.sup.controller_execute(
                plan_text, section="current",
                journal=self._journal_path(sha, rollback=True),
                probe=(
                    (lambda: fleet.heartbeat(self.sup.name))
                    if fleet is not None else None
                ),
            )
        except InjectedExecCrash as e:
            terminal = {"event": "exec/error", "kind": "crash",
                        "message": str(e)}
        except Exception as e:
            terminal = {"event": "exec/error", "kind": "internal",
                        "message": f"{type(e).__name__}: {e}"}
        rolled = (
            terminal.get("event") == "exec/done"
            and terminal.get("status") == "ok"
        )
        if rolled:
            self._record_moves(moves)
            if fleet is not None:
                fleet.charge(self.sup.name, moves)
            self.sup.controller_refresh()
            self._discard_action_record(sha)
            # The forward journal is superseded: left in progress, it would
            # refuse a later run of the same plan bytes.
            try:
                os.unlink(forward_journal)
            except FileNotFoundError:  # already gone: the state wanted
                pass
            except OSError as e:
                self._log(
                    f"could not remove superseded forward journal "
                    f"{forward_journal!r} ({e})"
                )
        else:
            why = terminal.get("message") or terminal.get("status")
            self._log(
                f"ROLLBACK DID NOT COMPLETE ({why}); journals retained — "
                f"finish with ka-execute --resume "
                f"(forward: {forward_journal!r})"
            )
        decision = self._decide(
            "rollback", reason=reason, ok=rolled,
            status=terminal.get("status") or terminal.get("kind"),
        )
        self._breaker_open(reason)
        return decision

    # -- truncation ---------------------------------------------------------------------

    @staticmethod
    def _truncate(plan_text: str, cap: int) -> Tuple[str, int, str]:
        """A prefix of the plan of at most ``cap`` replica moves: whole
        partitions in plan order, stopping at the first that would overflow.
        A partition absent from the CURRENT section has no rollback anchor
        and is left out (an action the controller cannot undo it does not
        take). Returns ``(plan_text, moves, plan_sha)``; ``moves == 0``
        means nothing fit."""
        from ..exec.engine import parse_plan_payload
        from ..exec.journal import plan_fingerprint

        new_plan, order = parse_plan_payload(plan_text, origin="controller plan")
        cur_plan, _ = parse_plan_payload(
            plan_text, section="current", origin="controller plan"
        )
        new_sub: Dict[str, Dict[int, List[int]]] = {}
        cur_sub: Dict[str, Dict[int, List[int]]] = {}
        sub_order: List[str] = []
        spent = 0
        full = False
        for t in order:
            if full:
                break
            for p in sorted(new_plan[t]):
                cur = cur_plan.get(t, {}).get(p)
                if cur is None:
                    continue  # no rollback anchor
                new = new_plan[t][p]
                n = len(set(new) - set(cur)) if new else len(set(cur))
                if n == 0:
                    continue  # a noop: nothing to run or roll back
                if spent + n > cap:
                    full = True
                    break
                if t not in new_sub:
                    new_sub[t] = {}
                    cur_sub[t] = {}
                    sub_order.append(t)
                new_sub[t][p] = list(new)
                cur_sub[t][p] = list(cur)
                spent += n
        if spent == 0:
            return plan_text, 0, ""
        text = (
            "CURRENT ASSIGNMENT:\n"
            + format_reassignment_json(cur_sub, topic_order=sub_order)
            + "\nNEW ASSIGNMENT:\n"
            + format_reassignment_json(new_sub, topic_order=sub_order)
            + "\n"
        )
        return text, spent, plan_fingerprint(new_sub, sub_order)

    # -- the view -------------------------------------------------------------------------

    def view(self) -> dict:
        """The ``/clusters/<name>/controller`` body: the policy and the
        rails' state, the last decision and the decision ring."""
        now = time.monotonic()
        with self._mutex:
            decisions = list(self._decisions)
            streak = self._streak
            paused = self._paused
            cooldown = round(max(0.0, self._next_action_at - now), 3)
        return {
            "cluster": self.sup.name,
            "policy": self.policy,
            "paused": paused,
            "breaker": self.breaker_view(),
            "streak": streak,
            "confirmations_required": env_int("KA_CONTROLLER_CONFIRMATIONS"),
            "interval_s": env_float("KA_CONTROLLER_INTERVAL"),
            "cooldown_remaining_s": cooldown,
            "window": {
                "seconds": env_float("KA_CONTROLLER_WINDOW"),
                "max_moves": env_int("KA_CONTROLLER_MAX_MOVES"),
                "moves": self._window_moves(),
            },
            "last_decision": decisions[-1] if decisions else None,
            "decisions": decisions,
        }
