"""The hermetic ``file://`` cluster snapshot (the reference's
``kafka_assigner_tpu/io/snapshot.py``, format and behaviour):

.. code-block:: json

    {
      "brokers": [{"id": 0, "host": "b0", "port": 9092, "rack": "r0"}, ...],
      "topics": {"events": {"0": [0, 1, 2], "1": [1, 2, 3]}}
    }

``rack`` is optional per broker. Two optional sections are read as the
reference reads them (``kafka_assigner_tpu/io/snapshot.py:68-114``):

.. code-block:: json

    "traffic": {"events": {"0": {"in_bytes": 1e6, "out_bytes": 2e6, "lag": 40}}},
    "groups": {"analytics": {
        "members": {"c-0": 120.0, "c-1": null},
        "assignment": {"events": {"0": "c-0"}},
        "lag": {"events": {"0": 500}}}}

A member's capacity ``null`` means unknown (the encoder's fair-share
default applies). Other sections of the file are ignored.
:func:`open_snapshot` opens a snapshot only; the CLI opens every backend
through ``io/base.py:open_backend``.

The snapshot is also ``ka-execute``'s hermetic cluster, with the
reference's simulated convergence: ``apply_assignment`` records each move
as pending, and each ``read_assignment_state`` poll ticks a countdown of
``KA_EXEC_SIM_POLLS`` polls per move (the stand-in for replica catch-up),
after which the move is applied in memory and the whole snapshot is
persisted back to its file (:func:`write_snapshot`, atomic and fsynced),
the ``traffic`` and ``groups`` sections as they were read. So a killed and
resumed run sees what a real cluster shows: converged waves survive the
crash, in-flight ones do not. The ``write`` and ``converge`` fault seams
(``faults/inject.py``) fire here as on the live backends.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Sequence, Tuple

from ..faults.inject import active_injector
from ..obs.metrics import counter_add
from .base import (
    BrokerInfo,
    ConsumerGroupState,
    GroupMember,
    PartitionState,
    PartitionTraffic,
)


class SnapshotBackend:
    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            raw = f.read()
        # zk.* counts metadata reads for every backend, as the reference's.
        counter_add("zk.reads")
        counter_add("zk.bytes", len(raw))
        data = json.loads(raw)
        self._brokers = [
            BrokerInfo(
                id=int(b["id"]),
                host=str(b.get("host", f"broker-{b['id']}")),
                port=int(b.get("port", 9092)),
                rack=b.get("rack"),
            )
            for b in data.get("brokers", [])
        ]
        self._topics: Dict[str, Dict[int, List[int]]] = {
            topic: {int(p): [int(x) for x in reps] for p, reps in parts.items()}
            for topic, parts in data.get("topics", {}).items()
        }
        # Topics and partitions absent from "traffic" take the synthetic
        # series (fetch_partition_traffic). The raw sections are kept so a
        # persist writes them back as they were read.
        self._traffic_raw: Dict = dict(data.get("traffic", {}) or {})
        self._traffic: Dict[str, Dict[int, PartitionTraffic]] = {
            t: {
                int(p): PartitionTraffic(
                    in_bytes=float(v.get("in_bytes", 0.0)),
                    out_bytes=float(v.get("out_bytes", 0.0)),
                    lag=int(v.get("lag", 0)),
                )
                for p, v in per.items()
            }
            for t, per in self._traffic_raw.items()
        }
        self._groups_raw: Dict = dict(data.get("groups", {}) or {})
        self._groups: Dict[str, ConsumerGroupState] = {}
        for g, spec in self._groups_raw.items():
            members = tuple(
                GroupMember(str(m), float(c) if c is not None else 0.0)
                for m, c in sorted((spec.get("members") or {}).items())
            )
            assignment = {
                t: {int(p): (str(m) if m is not None else None)
                    for p, m in per.items()}
                for t, per in (spec.get("assignment") or {}).items()
            }
            lags = {
                t: {int(p): int(v) for p, v in per.items()}
                for t, per in (spec.get("lag") or {}).items()
            }
            self._groups[str(g)] = ConsumerGroupState(
                group=str(g), members=members,
                assignment=assignment, lags=lags,
            )
        # Simulated convergence: pending moves and their remaining poll
        # countdowns. The injector is resolved once per backend, so a run's
        # fault schedule is coherent.
        self._pending: Dict[Tuple[str, int], List[int]] = {}
        self._pending_polls: Dict[Tuple[str, int], int] = {}
        self._faults = active_injector()

    def brokers(self) -> List[BrokerInfo]:
        return list(self._brokers)

    def all_topics(self) -> List[str]:
        # Sorted, like every reference backend: topic order is part of the
        # stdout byte contract.
        return sorted(self._topics)

    def fetch_topics(
        self, topics: Sequence[str], missing: str = "raise"
    ) -> Iterator[Tuple[str, Dict[int, List[int]]]]:
        """The streaming read, from memory: ``(topic, {partition:
        [replicas]})`` per input entry in input order. Missing topics raise
        up front, as :meth:`partition_assignment` does, or yield ``(topic,
        None)`` under ``missing="skip"``."""
        topics = list(topics)
        if missing != "skip":
            absent = [t for t in topics if t not in self._topics]
            if absent:
                raise KeyError(f"topics not in snapshot: {absent}")
        for t in topics:
            if t not in self._topics:
                yield t, None
                continue
            yield t, {p: list(r) for p, r in self._topics[t].items()}

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        missing = [t for t in topics if t not in self._topics]
        if missing:
            raise KeyError(f"topics not in snapshot: {missing}")
        return {t: {p: list(r) for p, r in self._topics[t].items()} for t in topics}

    def supports_traffic(self) -> bool:
        """True only when the file carried a ``traffic`` section."""
        return bool(self._traffic)

    def fetch_partition_traffic(self, partitions):
        """Recorded observations where present, the synthetic series for
        every other topic and partition."""
        from ..obs.health import synthetic_partition_traffic

        synth = synthetic_partition_traffic(partitions)
        out = {}
        for topic, parts in partitions.items():
            recorded = self._traffic.get(topic, {})
            out[topic] = {
                int(p): recorded.get(int(p), synth[topic][int(p)])
                for p in parts
            }
        return out

    def supports_groups(self) -> bool:
        """True only when the file carried a ``groups`` section: the
        synthetic family is an explicit opt-in, never a fallback."""
        return bool(self._groups)

    def fetch_consumer_groups(self, groups=None):
        """``{group: ConsumerGroupState}`` for the named groups (all, sorted,
        when ``groups`` is None). Raises :class:`IngestError` when the file
        has no ``groups`` section and ``KeyError`` for an unknown group."""
        counter_add("zk.reads")
        if not self._groups:
            from ..errors import IngestError

            raise IngestError(
                f"snapshot {self.path!r} carries no \"groups\" section; "
                "record one, or opt into the deterministic synthetic "
                "family explicitly (--synthetic)"
            )
        if groups is None:
            return {g: st for g, st in sorted(self._groups.items())}
        missing = [g for g in groups if g not in self._groups]
        if missing:
            raise KeyError(f"groups not in snapshot: {missing}")
        return {g: self._groups[g] for g in dict.fromkeys(groups)}

    def supports_execution(self) -> bool:
        return True

    def apply_assignment(
        self, moves: Dict[str, Dict[int, List[int]]]
    ) -> None:
        """Record one wave's moves as pending. ``write:i=drop`` raises
        before anything applies; ``write:i=lost`` acks the call and records
        nothing (a quorum member died after the ack), so the convergence
        poll times out. Resubmitting a move restarts its countdown; a move
        already applied re-applies the same value."""
        from ..utils.env import env_int

        lost = False
        if self._faults is not None:
            lost = self._faults.write_attempt() == "lost"
        counter_add("zk.writes")
        unknown = [t for t in moves if t not in self._topics]
        if unknown:
            raise KeyError(f"topics not in snapshot: {unknown}")
        if lost:
            return
        sim_polls = env_int("KA_EXEC_SIM_POLLS")
        for t, parts in moves.items():
            for p, reps in parts.items():
                key = (t, int(p))
                self._pending[key] = [int(r) for r in reps]
                self._pending_polls[key] = sim_polls

    def read_assignment_state(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, PartitionState]]:
        """One convergence poll: tick every pending move's countdown, apply
        the moves that are due (and persist them), and report the named
        topics with ``isr == replicas``. ``converge:i=stall`` freezes one
        poll: nothing ticks and due moves stay invisible, as a busy
        controller would."""
        stalled = self._faults is not None and self._faults.converge_poll()
        if not stalled:
            applied = False
            for key in sorted(self._pending_polls):
                if self._pending_polls[key] > 0:
                    self._pending_polls[key] -= 1
                    continue
                t, p = key
                self._topics[t][p] = self._pending.pop(key)
                del self._pending_polls[key]
                applied = True
            if applied:
                self._persist()
        return {
            t: {
                p: PartitionState(list(r), list(r))
                for p, r in self._topics[t].items()
            }
            for t in dict.fromkeys(topics)
            if t in self._topics
        }

    def _persist(self) -> None:
        """Write the applied assignment back to the file: a converged wave
        survives a crash as a real cluster's state does. An unwritable file
        warns, and the state stays correct in this process's memory."""
        import sys

        try:
            write_snapshot(self.path, self._brokers, self._topics,
                           traffic=self._traffic_raw,
                           groups=self._groups_raw)
        except OSError as e:
            print(
                f"kafka-assigner: snapshot persist failed for "
                f"{self.path!r} ({e}); converged state is in-memory only",
                file=sys.stderr,
            )

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""


def write_snapshot(
    path: str,
    brokers: Sequence[BrokerInfo],
    topics: Dict[str, Dict[int, List[int]]],
    traffic: Dict | None = None,
    groups: Dict | None = None,
) -> None:
    """Serialize cluster metadata to a snapshot file, the inverse of the
    loader and the reference's bytes (``json.dumps(indent=1)``), with the
    optional ``traffic`` and ``groups`` sections when given. Atomic and
    fsynced (``utils/atomicwrite.py``): a torn snapshot would be a corrupt
    cluster after a crash."""
    from ..utils.atomicwrite import atomic_write_text

    data = {
        "brokers": [
            {
                "id": b.id,
                "host": b.host,
                "port": b.port,
                **({"rack": b.rack} if b.rack is not None else {}),
            }
            for b in brokers
        ],
        "topics": {
            t: {str(p): list(r) for p, r in sorted(parts.items())}
            for t, parts in topics.items()
        },
    }
    if traffic:
        data["traffic"] = traffic
    if groups:
        data["groups"] = groups
    atomic_write_text(path, json.dumps(data, indent=1),
                      prefix=".ka_snapshot_")


def open_snapshot(connect_string: str) -> SnapshotBackend:
    """``file:///path.json`` or a path ending in ``.json``; any other
    connect string is refused (``io/base.py:open_backend`` opens those)."""
    if connect_string.startswith("file://"):
        return SnapshotBackend(connect_string[len("file://"):])
    if connect_string.endswith(".json"):
        return SnapshotBackend(connect_string)
    raise ValueError(
        f"--zk_string {connect_string!r} is not a snapshot (a file:// "
        "URL or a .json path)"
    )
