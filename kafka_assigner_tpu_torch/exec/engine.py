"""The plan execution engine, ``ka-execute``: a copy of the reference's
``kafka_assigner_tpu/exec/engine.py``, the write half of the loop (observe,
solve, execute, observe). It drives an emitted plan to convergence under
three invariants:

1. **Never under-replicated.** A move is one replica-list write per
   partition (the backend contract), and a wave is committed only after
   every partition's ISR covers its target. No injected failure leaves a
   partition with a partial replica list.
2. **Always resumable.** The journal (``exec/journal.py``) commits each
   converged wave atomically; a killed run resumes with ``--resume`` and
   ends byte-identical to an uninterrupted run (submitting a wave is
   idempotent, so the one wave that may have been in flight runs again).
3. **Writes are never blind.** A transport failure during a wave write is
   followed by a read-back (``KA_EXEC_WRITE_RETRIES``): a write is issued
   again only when the cluster does not show it, the wire client's own
   rule.

Waves are ``KA_EXEC_WAVE_SIZE`` moves, ``KA_EXEC_THROTTLE`` seconds apart;
convergence polls back off from ``KA_EXEC_POLL_INTERVAL`` with 0.5-1.5x
jitter up to ``KA_EXEC_POLL_TIMEOUT`` a wave. A wave that never converges
halts a ``strict`` run resumably (exit 8) or is recorded as skipped under
``best-effort`` (exit 6, the moves in the run report's
``plan.skipped_moves``). After the last wave a verify pass re-reads the
cluster and compares it, as canonical ``format_reassignment_json`` bytes,
with the plan less the skipped moves (a mismatch exits 7).

Execution does no device work: nothing here imports ``torch``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

from ..errors import ExecuteError
from ..faults.inject import fault_point
from ..io.json_io import format_reassignment_json, parse_reassignment_json
from ..io.zkwire import ZkConnectionError
from ..obs import gauge_set, obs_active, span
from ..obs.metrics import counter_add, hist_observe
from .journal import ExecutionJournal, Move, plan_fingerprint


def _is_transport_error(e: BaseException) -> bool:
    """Failure classes the write-safety read-back path may retry: transport
    deaths only, matched structurally (OSError — ConnectionError and
    TimeoutError included — plus the wire client's ZkConnectionError) or by
    ancestor NAME for kazoo's connection tree, so the rule holds whether or
    not the optional kazoo package is importable here. Server-REPORTED
    errors (NodeExists, NoNode, bad version) are answers — never retried."""
    if isinstance(e, (OSError, ZkConnectionError)):
        return True
    names = {c.__name__ for c in type(e).__mro__}
    return bool(names & {
        "ConnectionLoss", "ConnectionClosedError", "SessionExpiredError",
        "OperationTimeoutError", "ConnectionDropped",
    })


def parse_plan_payload(
    text: str, section: str = "new", origin: str = "plan payload",
) -> Tuple[Dict[str, Dict[int, List[int]]], List[str]]:
    """Parse a plan PAYLOAD (the text of a plan file, or the body of a
    daemon ``/execute`` request) into ``({topic: {partition: replicas}},
    topic order)``. Accepts the bare reassignment JSON object, or a saved
    mode-3 stdout: ``section="new"`` (default) takes the ``NEW
    ASSIGNMENT:`` payload, ``section="current"`` takes the ``CURRENT
    ASSIGNMENT:`` rollback snapshot above it — the target ``ka-execute
    --rollback`` drives the cluster BACK to. Topic order is the payload's
    own entry order, which the verify pass reproduces byte-for-byte."""
    marker = (
        "NEW ASSIGNMENT:" if section == "new" else "CURRENT ASSIGNMENT:"
    )
    had_marker = marker in text
    if section != "new" and not had_marker:
        raise ValueError(
            f"{origin} carries no {marker!r} snapshot to roll "
            "back to (a saved mode-3 stdout does; a bare plan JSON does "
            "not)"
        )
    if had_marker:
        # Take the payload line itself: our emitter writes it as one line,
        # and anything after it (trailing logs in a captured session) must
        # not reach the parser.
        text = text.split(marker, 1)[1]
    start = text.find("{")
    if start < 0:
        raise ValueError(f"{origin} contains no JSON object")
    text = text[start:]
    if had_marker:
        text = text.strip().splitlines()[0]
    plan = parse_reassignment_json(text)
    if not plan:
        raise ValueError(f"{origin} describes no partitions")
    return plan, list(plan)


def load_plan_file(
    path: str, section: str = "new",
) -> Tuple[Dict[str, Dict[int, List[int]]], List[str]]:
    """Read a plan file into ``({topic: {partition: replicas}}, topic
    order)`` — :func:`parse_plan_payload` over the file's text."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return parse_plan_payload(
        text, section=section, origin=f"plan file {path!r}"
    )


@dataclasses.dataclass
class ExecOutcome:
    """What one engine run did — the CLI maps this to the documented exit
    codes and the run report's ``plan`` section."""

    waves_total: int = 0
    waves_run: int = 0
    moves_submitted: int = 0
    noops: int = 0                      # plan entries already in place
    skipped: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    mismatches: List[dict] = dataclasses.field(default_factory=list)
    resumed: bool = False

    @property
    def status(self) -> str:
        if self.mismatches:
            return "verify-mismatch"
        if self.skipped:
            return "degraded"
        return "ok"


class PlanExecutor:
    """One plan's throttled, journaled drive to convergence."""

    def __init__(
        self,
        backend,
        plan: Dict[str, Dict[int, List[int]]],
        topic_order: Sequence[str],
        journal_path: str,
        *,
        failure_policy: str = "strict",
        resume: bool = False,
        wave_size: Optional[int] = None,
        throttle: Optional[float] = None,
        err: Optional[TextIO] = None,
        cluster: Optional[str] = None,
    ) -> None:
        from ..utils.env import env_float, env_int

        self.backend = backend
        self.plan = {
            t: {int(p): [int(r) for r in reps] for p, reps in parts.items()}
            for t, parts in plan.items()
        }
        self.topic_order = list(topic_order)
        self.journal_path = journal_path
        self.best_effort = failure_policy == "best-effort"
        self.resume = resume
        self.wave_size = (
            wave_size if wave_size and wave_size > 0
            else env_int("KA_EXEC_WAVE_SIZE")
        )
        self.throttle = (
            throttle if throttle is not None and throttle >= 0
            else env_float("KA_EXEC_THROTTLE")
        )
        self.err = err if err is not None else sys.stderr
        #: Executing-cluster identity (the backend connect spec), written
        #: into the journal so two clusters executing the same plan bytes
        #: never cross-resume. None: journals that resume under any
        #: cluster.
        self.cluster = cluster
        #: Plan identity ``--resume`` validates.
        self.plan_hash = plan_fingerprint(self.plan, self.topic_order)
        self.outcome = ExecOutcome()

    # -- setup -------------------------------------------------------------

    def _plan_moves(self) -> List[Move]:
        """The fresh-run move list: plan entries whose CURRENT assignment
        differs from the target, in plan order (topics in payload order,
        partitions ascending). Entries already in place are noops — counted,
        never submitted, still verified."""
        state = self.backend.read_assignment_state(self.topic_order)
        moves: List[Move] = []
        for t in self.topic_order:
            topic_state = state.get(t)
            if topic_state is None:
                if self.best_effort:
                    for p in sorted(self.plan[t]):
                        self._note_skip(t, p, "topic unresolvable")
                    continue
                # ValueError, not ExecuteError: this is a plan/cluster
                # VALIDATION failure raised before any journal exists —
                # the resumable-halt exit code (8) would promise a
                # --resume that has nothing to resume.
                raise ValueError(
                    f"plan topic {t!r} does not exist on the cluster "
                    "(strict policy; re-plan or use best-effort)"
                )
            for p in sorted(self.plan[t]):
                target = self.plan[t][p]
                st = topic_state.get(p)
                if st is None:
                    if self.best_effort:
                        self._note_skip(t, p, "partition unknown")
                        continue
                    raise ValueError(
                        f"plan partition {t!r}/{p} does not exist on the "
                        "cluster (strict policy; re-plan or use "
                        "best-effort)"
                    )
                if list(st.replicas) == target and set(st.isr) >= set(target):
                    self.outcome.noops += 1
                    continue
                moves.append((t, p, list(target)))
        return moves

    def _same_cluster(self, journal_cluster: Optional[str]) -> bool:
        """Journal identity is (cluster, plan sha): a journal stamped with
        a DIFFERENT cluster never matches. A journal with no stamp (written
        before the field existed) — or a caller with no identity — matches
        any cluster (legacy tolerance)."""
        return (
            journal_cluster is None
            or self.cluster is None
            or journal_cluster == self.cluster
        )

    def _open_journal(self) -> ExecutionJournal:
        if self.resume:
            journal = ExecutionJournal.load(self.journal_path)
            if journal.plan_hash != self.plan_hash:
                from .journal import JournalError

                raise JournalError(
                    f"journal {self.journal_path!r} belongs to a different "
                    f"plan (journal {journal.plan_hash[:12]}…, this plan "
                    f"{self.plan_hash[:12]}…); refusing to resume across "
                    "plans"
                )
            if not self._same_cluster(journal.cluster):
                from .journal import JournalError

                raise JournalError(
                    f"journal {self.journal_path!r} belongs to a DIFFERENT "
                    f"cluster ({journal.cluster!r}, this run "
                    f"{self.cluster!r}); two clusters executing the same "
                    "plan bytes must never cross-resume — point --journal "
                    "at this cluster's own journal"
                )
            self.outcome.resumed = True
            self.outcome.skipped.extend(journal.skipped)
            print(
                f"ka-execute: resuming from journal "
                f"{self.journal_path!r}: {journal.waves_committed}/"
                f"{journal.waves_total} wave(s) already committed",
                file=self.err,
            )
            return journal
        if os.path.exists(self.journal_path):
            prior = ExecutionJournal.load(self.journal_path)
            if prior.status != "complete":
                from .journal import JournalError

                if prior.plan_hash == self.plan_hash \
                        and self._same_cluster(prior.cluster):
                    raise JournalError(
                        f"journal {self.journal_path!r} records an "
                        "interrupted run of THIS plan — pass --resume to "
                        "continue it (or delete the journal to force a "
                        "fresh run)"
                    )
                # An interrupted run of ANOTHER plan (or of this plan on a
                # DIFFERENT cluster): overwriting would destroy its
                # committed-wave record and make it unresumable. Never
                # clobber silently.
                what = (
                    f"a DIFFERENT plan ({prior.plan_hash[:12]}…)"
                    if prior.plan_hash != self.plan_hash
                    else f"this plan on a DIFFERENT cluster "
                         f"({prior.cluster!r})"
                )
                raise JournalError(
                    f"journal {self.journal_path!r} records an interrupted "
                    f"run of {what}; finish that run with --resume "
                    "against its own plan/cluster, or point --journal "
                    "elsewhere"
                )
        moves = self._plan_moves()
        journal = ExecutionJournal.fresh(
            self.journal_path, self.plan_hash, self.wave_size, moves,
            cluster=self.cluster,
        )
        if self.outcome.skipped:
            # Plan-time best-effort skips (unresolvable topics/partitions)
            # must survive a crash: a resumed run rebuilds its skip set
            # from the journal, and an unpersisted skip would resurface as
            # a verify MISMATCH instead of a named degradation.
            journal.commit_wave(0, skipped=self.outcome.skipped)
        return journal

    def _note_skip(self, topic: str, partition: int, why: str) -> None:
        key = (topic, int(partition))
        if key not in self.outcome.skipped:
            self.outcome.skipped.append(key)
        counter_add("exec.skipped")
        print(
            f"ka-execute: best-effort: skipping {topic!r}/{partition} "
            f"({why})",
            file=self.err,
        )

    # -- wave submit + converge --------------------------------------------

    @staticmethod
    def _wave_target(wave: Sequence[Move]) -> Dict[str, Dict[int, List[int]]]:
        target: Dict[str, Dict[int, List[int]]] = {}
        for t, p, reps in wave:
            target.setdefault(t, {})[p] = list(reps)
        return target

    def _unconverged(self, wave: Sequence[Move]) -> List[Move]:
        state = self.backend.read_assignment_state(
            list(dict.fromkeys(t for t, _, _ in wave))
        )
        pending: List[Move] = []
        for t, p, reps in wave:
            st = state.get(t, {}).get(p)
            if st is None or list(st.replicas) != list(reps) \
                    or not set(st.isr) >= set(reps):
                pending.append((t, p, list(reps)))
        return pending

    def _submit_wave(self, index: int, wave: Sequence[Move]) -> None:
        """One wave write under the write-safety rule: a transport failure
        is followed by a read-back — resubmit ONLY when the cluster does
        not already show the wave's targets (``KA_EXEC_WRITE_RETRIES``
        budget). Server-reported errors propagate untouched."""
        from ..utils.env import env_int

        target = self._wave_target(wave)
        retries = env_int("KA_EXEC_WRITE_RETRIES")
        attempt = 0
        while True:
            try:
                with span("exec/submit"):
                    self.backend.apply_assignment(target)
                counter_add("exec.moves", len(wave))
                self.outcome.moves_submitted += len(wave)
                return
            except Exception as e:
                if not _is_transport_error(e):
                    raise
                counter_add("exec.write_retries")
                print(
                    f"ka-execute: wave {index}: write failed in transit "
                    f"({type(e).__name__}: {e}); reading state back before "
                    "deciding (never a blind replay)",
                    file=self.err,
                )
                if not self._unconverged(wave):
                    # The write landed (or was already in place): the ack
                    # was lost, not the write. Nothing to re-issue.
                    counter_add("exec.moves", len(wave))
                    self.outcome.moves_submitted += len(wave)
                    return
                attempt += 1
                if attempt > retries:
                    raise ExecuteError(
                        f"wave {index}: reassignment write failed "
                        f"{attempt} time(s) and the read-back shows it "
                        f"never landed ({e}); journal retains "
                        "every committed wave — re-run with --resume"
                    ) from e

    def _await_convergence(self, index: int,
                           wave: Sequence[Move]) -> List[Move]:
        """Poll until the wave's partitions all show target replicas with a
        covering ISR, with jittered exponential backoff (the shared
        ``utils/backoff.py`` progression — 0.5-1.5x jitter so many operators
        polling one recovering controller never re-arrive in lockstep);
        returns the moves still unconverged at the poll deadline (empty =
        converged)."""
        from ..utils.backoff import JitteredBackoff
        from ..utils.env import env_float

        timeout = env_float("KA_EXEC_POLL_TIMEOUT")
        interval = env_float("KA_EXEC_POLL_INTERVAL")
        backoff = JitteredBackoff(
            interval, factor=1.5, cap=max(timeout / 4.0, interval)
        )
        deadline = time.monotonic() + timeout
        while True:
            with span("exec/poll"):
                pending = self._unconverged(wave)
            if not pending:
                return []
            now = time.monotonic()
            if now >= deadline:
                return pending
            counter_add("exec.retries")
            time.sleep(min(backoff.next_delay(), max(0.0, deadline - now)))

    # -- verify ------------------------------------------------------------

    def _verify(self, journal: ExecutionJournal) -> List[dict]:
        """Verify-after-move: re-read the cluster and compare CANONICAL
        BYTES against the plan. Skipped moves (best-effort unconverged) are
        excluded from the byte diff — they are reported as skipped, not as
        mismatches — and everything else must match exactly, including the
        noop entries never submitted. Under-replication (ISR not covering a
        target) is a mismatch even when the replica list matches."""
        counter_add("exec.verify")
        state = self.backend.read_assignment_state(self.topic_order)
        skipped = set(journal.skipped) | set(self.outcome.skipped)
        expected: Dict[str, Dict[int, List[int]]] = {}
        observed: Dict[str, Dict[int, List[int]]] = {}
        mismatches: List[dict] = []
        for t in self.topic_order:
            expected[t] = {}
            observed[t] = {}
            for p in sorted(self.plan[t]):
                st = state.get(t, {}).get(p)
                cur = list(st.replicas) if st is not None else []
                observed[t][p] = cur
                if (t, p) in skipped:
                    # Unexecuted by policy: whatever is there is "expected";
                    # the degradation is accounted in plan.skipped_moves.
                    expected[t][p] = cur
                    continue
                expected[t][p] = self.plan[t][p]
                want = self.plan[t][p]
                if cur != want:
                    mismatches.append({
                        "topic": t, "partition": p,
                        "expected": want, "observed": cur,
                        "kind": "replicas",
                    })
                elif st is not None and not set(st.isr) >= set(want):
                    mismatches.append({
                        "topic": t, "partition": p,
                        "expected": want, "observed": sorted(st.isr),
                        "kind": "under-replicated",
                    })
        # The headline check is BYTE identity over the canonical plan
        # serialization; the per-partition walk above exists to NAME the
        # offending partitions. If the bytes ever diverge without a named
        # culprit (a serializer regression), report that loudly too.
        want_bytes = format_reassignment_json(
            expected, topic_order=self.topic_order
        )
        got_bytes = format_reassignment_json(
            observed, topic_order=self.topic_order
        )
        if want_bytes != got_bytes and not any(
            m["kind"] == "replicas" for m in mismatches
        ):
            mismatches.append({
                "topic": "", "partition": -1,
                "expected": want_bytes, "observed": got_bytes,
                "kind": "byte-diff",
            })
        return mismatches

    # -- drive -------------------------------------------------------------

    def execute(self) -> ExecOutcome:
        if not getattr(self.backend, "supports_execution", lambda: False)():
            # Pre-journal refusal: validation (exit 5), not the resumable
            # halt (8) — there is no journal to resume yet.
            raise ValueError(
                f"{type(self.backend).__name__} cannot execute "
                "reassignments; point --zk_string at a writable backend"
            )
        journal = self._open_journal()
        out = self.outcome
        out.waves_total = journal.waves_total
        first = journal.waves_committed
        for i in range(first, journal.waves_total):
            # The kill-between-waves seam (`wave:i=crash`): fires BEFORE the
            # wave submits, exactly where a process kill leaves the journal.
            fault_point("wave")
            if i > first and self.throttle > 0:
                time.sleep(self.throttle)
            wave = journal.wave(i)
            t0 = time.perf_counter()
            with span("exec/wave"):
                counter_add("exec.waves")
                out.waves_run += 1
                self._submit_wave(i, wave)
                pending = self._await_convergence(i, wave)
            hist_observe("exec.wave_ms",
                         (time.perf_counter() - t0) * 1000.0)
            if pending:
                if not self.best_effort:
                    raise ExecuteError(
                        f"wave {i}: {len(pending)} partition(s) failed to "
                        "converge within the poll budget "
                        f"(first: {pending[0][0]!r}/{pending[0][1]}); "
                        f"{journal.waves_committed} committed wave(s) are "
                        "journaled — re-run with --resume"
                    )
                for t, p, _ in pending:
                    self._note_skip(t, p, "did not converge in the "
                                          "poll budget")
            journal.commit_wave(
                i + 1, skipped=[(t, p) for t, p, _ in pending]
            )
            print(
                f"ka-execute: wave {i + 1}/{journal.waves_total} committed "
                f"({len(wave) - len(pending)}/{len(wave)} move(s) "
                "converged)",
                file=self.err,
            )
        with span("exec/verify"):
            out.mismatches = self._verify(journal)
        journal.complete()
        if obs_active():
            gauge_set("plan.waves", journal.waves_total)
            gauge_set("plan.moves_submitted", out.moves_submitted)
            gauge_set("plan.noops", out.noops)
            gauge_set("plan.skipped_moves",
                      [[t, p] for t, p in sorted(set(out.skipped))])
            gauge_set("plan.verify_mismatches", out.mismatches)
        return out
