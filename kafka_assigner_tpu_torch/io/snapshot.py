"""Read-only loader for the hermetic ``file://`` cluster snapshot (the
reference's ``kafka_assigner_tpu/io/snapshot.py`` format, brokers and topics
only):

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
default applies). Other sections of the file are ignored; the backend is
read-only. :func:`open_snapshot` opens a snapshot only; the CLI opens every
backend through ``io/base.py:open_backend``.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Sequence, Tuple

from ..obs.metrics import counter_add
from .base import BrokerInfo, ConsumerGroupState, GroupMember, PartitionTraffic


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
        # series (fetch_partition_traffic).
        self._traffic: Dict[str, Dict[int, PartitionTraffic]] = {
            t: {
                int(p): PartitionTraffic(
                    in_bytes=float(v.get("in_bytes", 0.0)),
                    out_bytes=float(v.get("out_bytes", 0.0)),
                    lag=int(v.get("lag", 0)),
                )
                for p, v in per.items()
            }
            for t, per in dict(data.get("traffic", {}) or {}).items()
        }
        self._groups: Dict[str, ConsumerGroupState] = {}
        for g, spec in dict(data.get("groups", {}) or {}).items():
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

    def close(self) -> None:
        """Nothing to release: the file was read whole at open."""


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
