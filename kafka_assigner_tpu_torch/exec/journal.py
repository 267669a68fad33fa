"""The crash-safe execution journal, ``ka-execute``'s resume contract: a
copy of the reference's ``kafka_assigner_tpu/exec/journal.py``, schema
version 1, byte for byte.

One JSON file per run, written atomically (``utils/atomicwrite.py``): a
reader never observes a torn journal, only the state before or after a wave
commit. It is written once before the first wave (the frozen wave
partition) and again after every converged wave, so at any kill point it
answers the two questions a resume asks:

- *which plan, on which cluster?* ``plan`` is the SHA-256 of the plan's
  canonical bytes (``format_reassignment_json`` over the parsed plan) and
  ``cluster`` the executing cluster's connect spec. ``--resume`` with
  another plan, or with the same plan on another cluster, is refused. A
  journal without a ``cluster`` field resumes under any cluster;
- *how far did it get?* ``waves_committed`` counts fully converged waves.
  A crash between a wave's submit and its commit resumes by submitting
  that wave again, which is safe because submission is idempotent
  (``io/base.py:apply_assignment``).

The move list is frozen into the journal (``moves``), not recomputed on
resume: the resumed run continues the wave partition the interrupted run
committed against, though the cluster moved under it meanwhile.

Schema (version 1)::

    {
      "version": 1,
      "plan": "<sha256 hex>",
      "cluster": "<connect spec>" | null,
      "wave_size": 8,
      "status": "in-progress" | "complete",
      "waves_committed": 2,
      "moves": [["topic", 0, [1, 2, 3]], ...],   # frozen wave partition
      "skipped": [["topic", 0], ...]             # best-effort unconverged
    }
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

JOURNAL_VERSION = 1

Move = Tuple[str, int, List[int]]

#: The journal-directory file names every journal writer uses: a daemon's
#: ``/execute`` default (``ka-execute-<cluster>-<sha12>.journal``), the
#: controller's forward journal (``ka-controller-<cluster>-<sha12>.journal``)
#: and its rollback twin (``….rollback.journal``). The cluster segment is
#: greedy (cluster names may contain ``-``); the 12-hex sha anchors the
#: split.
_JOURNAL_FILE_RE = re.compile(
    r"^ka-(?P<origin>controller|execute)-(?P<cluster>.+)-"
    r"(?P<sha>[0-9a-f]{12})(?P<rollback>\.rollback)?\.journal$"
)


def scan_journal_dir(
    jdir: str, clusters: Sequence[str]
) -> Dict[str, List[Dict[str, str]]]:
    """The journal files one daemon owns in ``jdir``: names that match the
    journal grammar with a cluster segment in ``clusters``. Returns
    ``{cluster: [entry, ...]}``, each entry ``{"path", "sha", "kind"}``
    with ``kind`` ``"forward"`` (a controller action), ``"rollback"`` (its
    abort twin) or ``"execute"`` (a client ``/execute`` run), in sorted
    directory order, so a recovery plan made from the listing is the same
    on every boot. Other clusters' files are left alone; an unreadable
    directory scans empty."""
    out: Dict[str, List[Dict[str, str]]] = {name: [] for name in clusters}
    try:
        names = sorted(os.listdir(jdir))
    except OSError:
        return out
    for fname in names:
        m = _JOURNAL_FILE_RE.match(fname)
        if m is None or m.group("cluster") not in out:
            continue
        if m.group("rollback"):
            kind = "rollback"
        elif m.group("origin") == "controller":
            kind = "forward"
        else:
            kind = "execute"
        out[m.group("cluster")].append({
            "path": os.path.join(jdir, fname),
            "sha": m.group("sha"),
            "kind": kind,
        })
    return out


def journal_resume_payload(
    journal: "ExecutionJournal",
) -> Tuple[Dict[str, Dict[int, List[int]]], List[str]]:
    """A resumable ``(plan, topic_order)`` rebuilt from a journal's own
    frozen move list: an orphaned journal whose plan bytes are gone still
    holds every move the interrupted run committed against, so a daemon's
    startup recovery can finish the run from the journal alone. The rebuilt
    plan fingerprints differently from the original (entries already in
    place were never journaled): a resume from it must be held to the
    journal's own ``plan_hash``, not to this plan's fingerprint."""
    plan: Dict[str, Dict[int, List[int]]] = {}
    order: List[str] = []
    for t, p, reps in journal.moves:
        if t not in plan:
            plan[t] = {}
            order.append(t)
        plan[t][int(p)] = [int(r) for r in reps]
    return plan, order


class JournalError(ValueError):
    """The journal cannot be used: an unreadable or corrupt file, or a schema
    or plan mismatch. A ``ValueError``, so the CLI exits with the validation
    code."""


def plan_fingerprint(
    plan: Dict[str, Dict[int, List[int]]], topic_order: Sequence[str]
) -> str:
    """SHA-256 over the plan's canonical reassignment-JSON bytes: the
    identity ``--resume`` checks, blind to the whitespace and key order
    ``parse_reassignment_json`` forgives on input."""
    from ..io.json_io import format_reassignment_json

    canonical = format_reassignment_json(plan, topic_order=list(topic_order))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


class ExecutionJournal:
    """In-memory handle over one journal file; every change is persisted
    atomically before the engine goes on (commit, then advance)."""

    def __init__(
        self,
        path: str,
        plan_hash: str,
        wave_size: int,
        moves: List[Move],
        *,
        waves_committed: int = 0,
        skipped: List[Tuple[str, int]] | None = None,
        status: str = "in-progress",
        cluster: Optional[str] = None,
    ) -> None:
        self.path = path
        self.plan_hash = plan_hash
        self.cluster = cluster
        self.wave_size = max(1, int(wave_size))
        self.moves = [(t, int(p), [int(r) for r in reps])
                      for t, p, reps in moves]
        self.waves_committed = int(waves_committed)
        self.skipped: List[Tuple[str, int]] = [
            (t, int(p)) for t, p in (skipped or [])
        ]
        self.status = status

    # -- wave partition ----------------------------------------------------

    @property
    def waves_total(self) -> int:
        return -(-len(self.moves) // self.wave_size) if self.moves else 0

    def wave(self, index: int) -> List[Move]:
        lo = index * self.wave_size
        return self.moves[lo:lo + self.wave_size]

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def fresh(
        cls, path: str, plan_hash: str, wave_size: int, moves: List[Move],
        *, cluster: Optional[str] = None,
    ) -> "ExecutionJournal":
        """Start a new run: the journal is persisted before the first wave
        is submitted, so even a kill inside wave 0 leaves a resumable
        record.

        The move list is frozen in (topic, partition) order, so the wave
        partition depends only on the plan's content. ``load`` keeps the
        file's order as written: an in-flight journal's committed wave
        boundaries replay exactly, never re-sorted under a resume."""
        moves = sorted(moves, key=lambda m: (m[0], int(m[1])))
        j = cls(path, plan_hash, wave_size, moves, cluster=cluster)
        j.save()
        return j

    @classmethod
    def load(cls, path: str) -> "ExecutionJournal":
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except OSError as e:
            raise JournalError(f"cannot read journal {path!r}: {e}") from e
        except ValueError as e:
            raise JournalError(
                f"journal {path!r} is corrupt (not JSON: {e}); a torn "
                "write is impossible by construction — this file was "
                "damaged externally"
            ) from e
        if not isinstance(data, dict) \
                or data.get("version") != JOURNAL_VERSION:
            raise JournalError(
                f"journal {path!r} has unsupported version "
                f"{data.get('version') if isinstance(data, dict) else '?'!r}"
            )
        try:
            j = cls(
                path,
                str(data["plan"]),
                int(data["wave_size"]),
                [(t, int(p), [int(r) for r in reps])
                 for t, p, reps in data["moves"]],
                waves_committed=int(data["waves_committed"]),
                skipped=[(t, int(p)) for t, p in data.get("skipped", [])],
                status=str(data.get("status", "in-progress")),
                cluster=(
                    str(data["cluster"])
                    if data.get("cluster") is not None else None
                ),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise JournalError(
                f"journal {path!r} is structurally invalid: {e}"
            ) from e
        if not 0 <= j.waves_committed <= j.waves_total:
            raise JournalError(
                f"journal {path!r} claims {j.waves_committed} committed "
                f"wave(s) of {j.waves_total}"
            )
        return j

    def commit_wave(
        self, waves_committed: int,
        skipped: Sequence[Tuple[str, int]] = (),
    ) -> None:
        """Persist a wave boundary: ``waves_committed`` waves are converged
        (or, under best-effort, recorded as skipped). The engine goes on
        only after the atomic rename."""
        self.waves_committed = int(waves_committed)
        for t, p in skipped:
            key = (t, int(p))
            if key not in self.skipped:
                self.skipped.append(key)
        self.save()

    def complete(self) -> None:
        self.status = "complete"
        self.save()

    def save(self) -> None:
        from ..utils.atomicwrite import atomic_write_text

        payload = {
            "version": JOURNAL_VERSION,
            "plan": self.plan_hash,
            "cluster": self.cluster,
            "wave_size": self.wave_size,
            "status": self.status,
            "waves_committed": self.waves_committed,
            "moves": [[t, p, reps] for t, p, reps in self.moves],
            "skipped": [[t, p] for t, p in self.skipped],
        }
        text = json.dumps(payload, indent=1, sort_keys=True) + "\n"
        atomic_write_text(self.path, text, prefix=".ka_journal_")
