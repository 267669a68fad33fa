"""Read-only loader for the hermetic ``file://`` cluster snapshot (the
reference's ``kafka_assigner_tpu/io/snapshot.py`` format, brokers and topics
only):

.. code-block:: json

    {
      "brokers": [{"id": 0, "host": "b0", "port": 9092, "rack": "r0"}, ...],
      "topics": {"events": {"0": [0, 1, 2], "1": [1, 2, 3]}}
    }

``rack`` is optional per broker. Other sections of the file are ignored.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class BrokerInfo:
    """One live broker: id/host/port and optional rack."""

    id: int
    host: str
    port: int
    rack: Optional[str] = None


class SnapshotBackend:
    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            data = json.loads(f.read())
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

    def brokers(self) -> List[BrokerInfo]:
        return list(self._brokers)

    def all_topics(self) -> List[str]:
        # Sorted, like every reference backend: topic order is part of the
        # stdout byte contract.
        return sorted(self._topics)

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        missing = [t for t in topics if t not in self._topics]
        if missing:
            raise KeyError(f"topics not in snapshot: {missing}")
        return {t: {p: list(r) for p, r in self._topics[t].items()} for t in topics}


def open_snapshot(connect_string: str) -> SnapshotBackend:
    """``file:///path.json`` or a path ending in ``.json``; live ZooKeeper
    and Kafka-admin backends are not part of this package yet."""
    if connect_string.startswith("file://"):
        return SnapshotBackend(connect_string[len("file://"):])
    if connect_string.endswith(".json"):
        return SnapshotBackend(connect_string)
    raise ValueError(
        f"--zk_string {connect_string!r}: this package reads file:// "
        "snapshots only (live ZooKeeper is not ported yet)"
    )
