"""The fleet scheduler: the port of the reference's
``kafka_assigner_tpu/daemon/fleet.py`` (``FleetScheduler``), one daemon-wide
arbiter of every cluster's controller actions and their move budget, and
the daemon's boot-time recovery of interrupted executions.

Each cluster's :class:`~.controller.RebalanceController` bounds its own
blast radius; the fleet bounds the daemon's:

- **Admission leases**: a controller wins a lease here before it acts. At
  most ``KA_FLEET_MAX_CONCURRENT`` leases (default 1) are live at once;
  contention goes to the most degraded cluster first, by composite health
  score (higher is worse; ties by cluster name). A denial is a ``fleet``
  decision, ``deferred`` (slots full, or recovery pending), ``budget-hold``
  (the window's budget spent) or ``preempted`` (a worse-off cluster is
  waiting), which the controller holds on with its streak kept.
- **The fleet move budget**: a grant charges its replica moves to a rolling
  ``KA_FLEET_WINDOW`` ledger capped by ``KA_FLEET_MAX_MOVES``, across every
  cluster of the daemon.
- **Crash safety**: the leases and the ledger persist as one JSON file,
  ``ka-fleet.json`` in ``KA_DAEMON_JOURNAL_DIR``, written atomically (a
  reader never sees torn bytes; a restart does not reset the accounting).
  A lease is stamped at every wave boundary and expires
  ``KA_FLEET_LEASE_TTL`` seconds after its last stamp, so a holder that
  died never wedges the fleet.
- **Boot recovery**: :meth:`recover` scans the journal directory (sorted,
  so the recovery plan is the same on every boot) for this daemon's
  in-progress journals and drives each to an end under a recovery lease:
  a rollback in flight completes, a forward action the controller had
  aborted rolls back, any other forward or client ``/execute`` journal
  resumes forward. A daemon killed at any wave boundary converges with no
  operator ``--resume``. Admissions are deferred (``recovery pending``)
  until the scan ends.

The ``fleet:{lease-expire,ledger-torn,recovery-crash}`` seams
(``faults/inject.py``) sit where the reference's do. The ledger file is
read and written here and nowhere else.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..faults.inject import InjectedExecCrash, fleet_fault
from ..obs import flight
from ..obs.metrics import counter_add, gauge_set
from ..utils.atomicwrite import atomic_write_text
from ..utils.env import env_float, env_int, env_str

#: Capacity of the decision ring (the ``GET /fleet`` view).
FLEET_RING = 64

#: The one ledger file of a daemon, in its journal directory.
FLEET_LEDGER_BASENAME = "ka-fleet.json"

#: Schema version of the ledger. Another version starts fresh, loudly.
FLEET_LEDGER_VERSION = 1


class FleetScheduler:
    """The daemon-wide admission arbiter: one a daemon
    (:class:`~.service.AssignerDaemon`), shared by every cluster's
    controller through ``ClusterSupervisor.fleet``."""

    def __init__(self, err=None) -> None:
        self.err = err if err is not None else sys.stderr
        self._mutex = threading.Lock()
        #: The rolling budget: [(epoch seconds, moves, cluster)].
        self._actions: List[Tuple[float, int, str]] = []
        #: cluster -> {"sha", "kind", "granted", "heartbeat"}.
        self._leases: Dict[str, Dict[str, object]] = {}
        self._loaded = False
        #: Pending wants, in memory only (live controllers ask again every
        #: tick): cluster -> (score, monotonic time).
        self._wants: Dict[str, Tuple[Optional[float], float]] = {}
        #: Set once the boot-time scan has run (even when it found nothing):
        #: a daemon that never calls recover() never admits.
        self._recovered = threading.Event()
        self._recovery_summary: Dict[str, int] = {}
        self._decisions: Deque[dict] = collections.deque(maxlen=FLEET_RING)
        self._seq = 0
        self._expired_last: List[str] = []

    # -- plumbing ---------------------------------------------------------------------

    def _log(self, msg: str) -> None:
        print(f"ka-daemon: fleet: {msg}", file=self.err)

    def _decide(self, decision: str, cluster: Optional[str], **fields) -> dict:
        """Record one decision: a ring entry and a flight ``fleet`` event."""
        clean = {k: v for k, v in fields.items() if v is not None}
        with self._mutex:
            self._seq += 1
            entry = {
                "seq": self._seq,
                "t": round(time.time(), 3),
                "decision": decision,
            }
            if cluster is not None:
                entry["cluster"] = cluster
            entry.update(clean)
            self._decisions.append(entry)
        # The lease's "kind" would collide with flight.record's first
        # parameter: it travels as lease_kind on the event.
        ev = dict(clean)
        if "kind" in ev:
            ev["lease_kind"] = ev.pop("kind")
        flight.record("fleet", cluster, decision=decision, **ev)
        return entry

    # -- the persisted ledger (leases and the rolling budget) -------------------------

    def _ledger_path(self) -> str:
        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        return os.path.join(jdir, FLEET_LEDGER_BASENAME)

    def _load(self) -> None:
        """Load the ledger once, under the mutex (every admission thread and
        the view load on first touch; a second load would overwrite a grant
        made in between). A missing ledger starts empty quietly, a corrupt
        one (or the ``fleet:ledger-torn`` seam) empty and loudly: torn bytes
        are never half trusted."""
        err: Optional[str] = None
        with self._mutex:
            if self._loaded:
                return
            self._loaded = True
            path = self._ledger_path()
            try:
                if fleet_fault("ledger-torn"):
                    raise ValueError("injected fault: ledger read as torn")
                with open(path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
                if not isinstance(raw, dict) \
                        or raw.get("version") != FLEET_LEDGER_VERSION:
                    raise ValueError(
                        f"unsupported ledger version "
                        f"{raw.get('version') if isinstance(raw, dict) else '?'!r}"
                    )
                self._actions = [
                    (float(t), int(n), str(c))
                    for t, n, c in raw.get("actions", [])
                ]
                self._leases = {
                    str(c): {
                        "sha": str(lease["sha"]),
                        "kind": str(lease.get("kind", "action")),
                        "granted": float(lease["granted"]),
                        "heartbeat": float(lease["heartbeat"]),
                    }
                    for c, lease in raw.get("leases", {}).items()
                }
            except FileNotFoundError:
                self._actions, self._leases = [], {}
            except (OSError, ValueError, TypeError, KeyError) as e:
                self._actions, self._leases = [], {}
                err = str(e)
        if err is not None:
            self._log(
                f"ledger {self._ledger_path()!r} unreadable ({err}); "
                "fleet accounting restarts empty"
            )

    def _save_locked(self) -> Tuple[str, str]:
        """The ledger's bytes, taken under the caller's mutex; the write
        happens outside it (file I/O never serializes admissions)."""
        payload = {
            "version": FLEET_LEDGER_VERSION,
            "actions": [[t, n, c] for t, n, c in self._actions],
            "leases": {c: dict(lease) for c, lease in self._leases.items()},
        }
        return self._ledger_path(), json.dumps(payload, sort_keys=True)

    def _persist(self, path: str, text: str) -> None:
        try:
            atomic_write_text(path, text, prefix=".ka_fleet_")
        except OSError as e:
            self._log(
                f"ledger persist failed ({e}); fleet accounting is "
                "in-memory only until the next admission event"
            )

    def _prune_locked(self, now: float) -> None:
        """Drop the budget entries past the window and the leases past their
        TTL (the caller holds the mutex)."""
        horizon = time.time() - env_float("KA_FLEET_WINDOW")
        self._actions = [(t, n, c) for t, n, c in self._actions if t >= horizon]
        stale_before = time.time() - env_float("KA_FLEET_LEASE_TTL")
        expired = [
            c for c, lease in self._leases.items()
            if float(lease["heartbeat"]) < stale_before
        ]
        for c in expired:
            del self._leases[c]
        if expired:
            counter_add("fleet.lease_expired", len(expired))
        self._expired_last = expired

    def _gauges_locked(self) -> None:
        gauge_set("fleet.leases", len(self._leases))
        gauge_set("fleet.window_moves", sum(n for _t, n, _c in self._actions))

    # -- admission ------------------------------------------------------------------

    def acquire(
        self, cluster: str, *,
        moves: int,
        sha: str,
        score: Optional[float] = None,
        kind: str = "action",
    ) -> Tuple[str, dict]:
        """One admission request: ``("granted", lease)`` or a typed denial
        ``("deferred"|"budget-hold"|"preempted", info)``. A grant charges
        ``moves`` to the window at once (a crash mid-action has already moved
        replicas) and persists the lease before returning.

        ``kind="recovery"`` is the boot scan taking a lease for an
        interrupted run: it passes the recovery gate, the budget and the
        priority contest (finishing a half-done reassignment restores
        safety; the scan is serial), and still charges its moves."""
        self._load()
        now_mono = time.monotonic()
        recovery = kind == "recovery"
        expired: List[str] = []
        with self._mutex:
            if not recovery:
                self._wants[cluster] = (score, now_mono)
            if not recovery and not self._recovered.is_set():
                status, info = "deferred", {"reason": "recovery pending"}
            else:
                if fleet_fault("lease-expire", cluster):
                    for c in list(self._leases):
                        del self._leases[c]
                        expired.append(c)
                    counter_add("fleet.lease_expired", len(expired))
                self._prune_locked(now_mono)
                expired.extend(self._expired_last)
                status, info = self._admit_locked(
                    cluster, moves=moves, sha=sha, score=score,
                    kind=kind, now_mono=now_mono, recovery=recovery,
                )
            if status == "granted":
                self._gauges_locked()
            path, text = self._save_locked()
        for c in expired:
            self._log(
                f"lease held by {c!r} expired (no heartbeat inside "
                "KA_FLEET_LEASE_TTL); the slot moves on, and that holder's "
                "release, if it lives, will be a no-op"
            )
            self._decide("lease-expired", c)
        if status == "granted":
            counter_add("fleet.grants")
            self._persist(path, text)
        elif status == "preempted":
            counter_add("fleet.preemptions")
            counter_add("fleet.deferrals")
        else:
            counter_add("fleet.deferrals")
        extra = {
            k: v for k, v in info.items()
            if k not in ("sha", "kind", "granted", "heartbeat", "holders")
        }
        self._decide(
            status, cluster, sha=sha[:12] if sha else None,
            moves=moves, kind=None if kind == "action" else kind, **extra,
        )
        return status, info

    def _admit_locked(
        self, cluster: str, *, moves: int, sha: str,
        score: Optional[float], kind: str, now_mono: float,
        recovery: bool,
    ) -> Tuple[str, dict]:
        """The admission ladder (the caller holds the mutex): concurrency,
        then priority, then budget. A grant takes the lease and charges the
        budget."""
        cap = env_int("KA_FLEET_MAX_CONCURRENT")
        held = cluster in self._leases
        if not held and len(self._leases) >= cap and not recovery:
            return "deferred", {
                "reason": "concurrency cap",
                "holders": sorted(self._leases),
                "max_concurrent": cap,
            }
        if not recovery:
            # Most degraded first: of the fresh wants, the worst score (higher
            # is worse) wins, ties by name. A want ages out after three tick
            # intervals: a cluster that stopped asking blocks nobody.
            horizon = 3.0 * env_float("KA_CONTROLLER_INTERVAL")
            self._wants = {
                c: (s, t) for c, (s, t) in self._wants.items()
                if now_mono - t <= horizon
            }
            contenders = [
                (s if s is not None else float("-inf"), c)
                for c, (s, _t) in self._wants.items()
                if c not in self._leases
            ]
            if contenders:
                worst_score, worst = max(contenders)
                if worst != cluster:
                    return "preempted", {
                        "reason": "a worse-off cluster is waiting",
                        "winner": worst,
                        "winner_score": (
                            None if worst_score == float("-inf")
                            else round(worst_score, 6)
                        ),
                        "score": round(score, 6) if score is not None else None,
                    }
        max_moves = env_int("KA_FLEET_MAX_MOVES")
        window = sum(n for _t, n, _c in self._actions)
        if window + moves > max_moves and not recovery:
            return "budget-hold", {
                "reason": "fleet window budget",
                "window_moves": window,
                "requested": moves,
                "max_moves": max_moves,
            }
        now = time.time()
        lease = {
            "sha": sha, "kind": kind,
            "granted": round(now, 3), "heartbeat": round(now, 3),
        }
        self._leases[cluster] = lease
        if moves > 0:
            self._actions.append((round(now, 3), int(moves), cluster))
        self._wants.pop(cluster, None)
        return "granted", dict(lease)

    def heartbeat(self, cluster: str) -> None:
        """Stamp the holder's lease (at every wave boundary of its run): only
        a holder that died ages past ``KA_FLEET_LEASE_TTL``. A lease that
        already expired stays gone."""
        self._load()
        ts = round(time.time(), 3)
        with self._mutex:
            lease = self._leases.get(cluster)
            if lease is not None:
                lease["heartbeat"] = ts
            path, text = self._save_locked()
        if lease is not None:
            self._persist(path, text)

    def release(self, cluster: str, *, refund: bool = False) -> bool:
        """Drop the holder's lease; ``refund`` gives back the grant's moves
        (the run never started). Returns False, loudly, when no lease was
        held (it expired, or was released already): idempotent."""
        self._load()
        with self._mutex:
            lease = self._leases.pop(cluster, None)
            if lease is not None and refund:
                granted = float(lease["granted"])
                for i in range(len(self._actions) - 1, -1, -1):
                    t, _n, c = self._actions[i]
                    if c == cluster and t >= granted:
                        del self._actions[i]
                        break
            self._wants.pop(cluster, None)
            self._gauges_locked()
            path, text = self._save_locked()
        self._persist(path, text)
        if lease is None:
            self._log(
                f"release by {cluster!r} found no lease (expired or "
                "already released); nothing to do"
            )
            return False
        self._decide(
            "released", cluster, refunded=refund or None,
            kind=None if lease.get("kind") == "action" else lease.get("kind"),
        )
        return True

    def charge(self, cluster: str, moves: int) -> None:
        """Charge more moves to the window under a held lease (a rollback's:
        undoing a rebalance moves replicas like any other)."""
        if moves <= 0:
            return
        self._load()
        ts = round(time.time(), 3)
        with self._mutex:
            self._actions.append((ts, int(moves), cluster))
            self._gauges_locked()
            path, text = self._save_locked()
        self._persist(path, text)

    # -- boot recovery ----------------------------------------------------------------

    def recover(self, supervisors: Dict[str, object]) -> Dict[str, int]:
        """The boot-time scan: this daemon's in-progress journals, each
        driven to an end under a recovery lease, so a kill at any wave
        boundary converges without an operator:

        - a rollback journal in flight completes (its frozen moves are the
          assignment before the action) and supersedes its forward twin;
        - a forward controller journal whose action record says the
          controller had aborted rolls back;
        - any other forward or ``/execute`` journal resumes forward, an
          orphaned client ``/execute`` one under the journal's authority
          (its plan bytes left with the client).

        This daemon's clusters' leases left by a previous boot are swept
        first (one daemon a journal directory). Serial; every outcome is a
        ``fleet`` decision. A resume that crashes (the
        ``fleet:recovery-crash`` seam) leaves its journal for the next boot.
        Admission opens when the scan ends, whatever it found."""
        from ..exec.journal import scan_journal_dir

        jdir = env_str("KA_DAEMON_JOURNAL_DIR") or "."
        summary = {"resumed": 0, "rolled_back": 0, "failed": 0, "skipped": 0}
        self._load()
        with self._mutex:
            stale = [c for c in self._leases if c in supervisors]
            for c in stale:
                del self._leases[c]
            self._gauges_locked()
            path, text = self._save_locked()
        if stale:
            counter_add("fleet.lease_expired", len(stale))
            self._persist(path, text)
            self._log(
                f"swept {len(stale)} boot-stale lease(s) "
                f"({', '.join(sorted(stale))}): no other process may "
                "hold this daemon's clusters"
            )
        try:
            scan = scan_journal_dir(jdir, sorted(supervisors))
            for name in sorted(scan):
                self._recover_cluster(name, supervisors[name], scan[name], summary)
        finally:
            # Admission opens even when the scan failed half-way: what it
            # could not finish stays on disk for the next boot, and one bad
            # journal must not wedge every cluster.
            self._recovery_summary = dict(summary)
            self._recovered.set()
        if any(summary.values()):
            self._log(
                "recovery scan: "
                f"{summary['resumed']} resumed, "
                f"{summary['rolled_back']} rolled back, "
                f"{summary['failed']} failed (retained for next boot), "
                f"{summary['skipped']} skipped"
            )
        self._decide("recovery-done", None, **summary)
        return summary

    def _recover_cluster(self, name: str, sup, entries: List[dict],
                         summary: Dict[str, int]) -> None:
        """One cluster's recovery: controller journals first (a rollback
        and its forward twin carry the abort), then orphaned ``/execute``
        journals."""
        from ..exec.journal import ExecutionJournal, JournalError

        by_sha: Dict[str, Dict[str, dict]] = {}
        executes: List[dict] = []
        for entry in entries:
            try:
                journal = ExecutionJournal.load(entry["path"])
            except JournalError as e:
                self._log(
                    f"[{name}] journal {entry['path']!r} unusable ({e}); "
                    "left in place for an operator"
                )
                summary["skipped"] += 1
                continue
            if journal.cluster is not None and journal.cluster != sup.spec:
                self._log(
                    f"[{name}] journal {entry['path']!r} belongs to a "
                    f"DIFFERENT cluster ({journal.cluster!r}); left "
                    "untouched"
                )
                summary["skipped"] += 1
                continue
            if journal.status != "in-progress":
                continue
            entry = dict(entry, journal=journal)
            if entry["kind"] == "execute":
                executes.append(entry)
            else:
                by_sha.setdefault(entry["sha"], {})[entry["kind"]] = entry
        for sha in sorted(by_sha):
            self._recover_action(name, sup, sha, by_sha[sha], summary)
        for entry in executes:
            self._recover_execute(name, sup, entry, summary)
        # A record with no in-progress journal left (the kill came before
        # wave 0, or after the end) vouches for nothing to recover.
        sup.controller.discard_orphan_records(set(by_sha))

    def _remaining_moves(self, journal) -> int:
        return max(0, len(journal.moves) - journal.waves_committed * journal.wave_size)

    def _resume_outcome(self, name: str, terminal: dict,
                        summary: Dict[str, int], what: str) -> bool:
        ok = (
            terminal.get("event") == "exec/done"
            and terminal.get("status") in ("ok", "degraded")
        )
        if ok:
            counter_add("fleet.recoveries")
            summary["rolled_back" if what == "rollback" else "resumed"] += 1
        else:
            counter_add("fleet.recovery_failures")
            summary["failed"] += 1
            why = (
                terminal.get("refused") or terminal.get("message")
                or terminal.get("status") or "unknown"
            )
            self._log(
                f"[{name}] {what} recovery did not complete ({why}); "
                "journal retained, the next boot retries"
            )
        self._decide(
            "recovered" if ok else "recovery-failed", name, what=what,
            status=terminal.get("status") or terminal.get("kind")
            or terminal.get("refused"),
        )
        return ok

    def _recover_action(self, name: str, sup, sha: str,
                        pair: Dict[str, dict],
                        summary: Dict[str, int]) -> None:
        """One interrupted controller action: its rollback completes if one
        was in flight or the record says the controller had aborted; else
        the forward run resumes."""
        record = sup.controller.load_action_record(sha)
        rollback = pair.get("rollback")
        forward = pair.get("forward")
        anchor = rollback or forward
        remaining = self._remaining_moves(anchor["journal"])
        self.acquire(
            name, moves=remaining, sha=anchor["journal"].plan_hash,
            kind="recovery",
        )
        try:
            def probe():
                return fleet_fault("recovery-crash", name)

            def heartbeat():
                self.heartbeat(name)

            if rollback is not None and record is not None:
                terminal = sup.controller.resume_recovery(
                    record, rollback["path"], what="rollback-resume",
                    moves=remaining, probe=probe, heartbeat=heartbeat,
                )
                self._resume_outcome(name, terminal, summary, "rollback")
            elif rollback is not None:
                # No record, but the rollback journal froze every move: a
                # resume under its authority, then the forward twin goes.
                terminal = sup.recover_journal(
                    rollback["path"], probe=probe, heartbeat=heartbeat,
                )
                if self._resume_outcome(name, terminal, summary, "rollback"):
                    sup.controller.discard_superseded(sha)
            elif record is not None and record.get("aborted"):
                # The abort persisted before the kill: honour it, driving the
                # record's CURRENT snapshot back under a fresh rollback
                # journal.
                terminal = sup.controller.resume_recovery(
                    record, None, what="rollback-fresh",
                    moves=remaining, probe=probe, heartbeat=heartbeat,
                )
                self._resume_outcome(name, terminal, summary, "rollback")
            elif record is not None:
                terminal = sup.controller.resume_recovery(
                    record, forward["path"], what="forward",
                    moves=remaining, probe=probe, heartbeat=heartbeat,
                )
                self._resume_outcome(name, terminal, summary, "forward")
            else:
                # A forward journal without its record: resumed under the
                # journal's authority, as an orphan is.
                terminal = sup.recover_journal(
                    forward["path"], probe=probe, heartbeat=heartbeat,
                )
                self._resume_outcome(name, terminal, summary, "forward")
        except InjectedExecCrash as e:
            counter_add("fleet.recovery_failures")
            summary["failed"] += 1
            self._log(
                f"[{name}] recovery resume crashed at a wave boundary "
                f"({e}); journal retained, the next boot retries"
            )
            self._decide("recovery-failed", name, what="crash")
        finally:
            self.release(name)

    def _recover_execute(self, name: str, sup, entry: dict,
                         summary: Dict[str, int]) -> None:
        """One orphaned client ``/execute`` journal, resumed under its own
        authority: its frozen moves are the run."""
        journal = entry["journal"]
        self.acquire(
            name, moves=self._remaining_moves(journal),
            sha=journal.plan_hash, kind="recovery",
        )
        try:
            terminal = sup.recover_journal(
                entry["path"],
                probe=lambda: fleet_fault("recovery-crash", name),
                heartbeat=lambda: self.heartbeat(name),
            )
            self._resume_outcome(name, terminal, summary, "execute")
        except InjectedExecCrash as e:
            counter_add("fleet.recovery_failures")
            summary["failed"] += 1
            self._log(
                f"[{name}] orphan resume crashed at a wave boundary "
                f"({e}); journal retained, the next boot retries"
            )
            self._decide("recovery-failed", name, what="crash")
        finally:
            self.release(name)

    # -- views ------------------------------------------------------------------------

    def recovered(self) -> bool:
        return self._recovered.is_set()

    def view(self) -> dict:
        """The ``GET /fleet`` body: the live leases, the rolling budget, the
        recovery summary and the decision ring."""
        self._load()
        with self._mutex:
            self._prune_locked(time.monotonic())
            leases = {c: dict(lease) for c, lease in self._leases.items()}
            window_moves = sum(n for _t, n, _c in self._actions)
            decisions = list(self._decisions)
            summary = dict(self._recovery_summary)
        return {
            "recovered": self._recovered.is_set(),
            "recovery": summary or None,
            "max_concurrent": env_int("KA_FLEET_MAX_CONCURRENT"),
            "lease_ttl_s": env_float("KA_FLEET_LEASE_TTL"),
            "leases": leases,
            "window": {
                "seconds": env_float("KA_FLEET_WINDOW"),
                "max_moves": env_int("KA_FLEET_MAX_MOVES"),
                "moves": window_moves,
            },
            "last_decision": decisions[-1] if decisions else None,
            "decisions": decisions,
        }
