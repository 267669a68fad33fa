"""Kafka reassignment-JSON formatting, byte-compatible with the reference
(a copy of ``kafka_assigner_tpu/io/json_io.py``'s serializers of the
plan and the live broker list).

- The rollback section ("CURRENT ASSIGNMENT") follows Kafka 0.10's
  ``Json.encode``: insertion key order, ``{"version":1,"partitions":[{"topic":
  …,"partition":…,"replicas":[…]},…]}`` (:func:`format_reassignment_json`).
- "NEW ASSIGNMENT" is hand-built with org.json, whose ``JSONObject`` keeps
  keys in a ``java.util.HashMap``: ``toString()`` walks HashMap bucket order.
  For a default-capacity-16 JDK8 HashMap (bucket ``(h ^ h>>>16) & 15`` over
  ``String.hashCode``) that is ``partitions, version`` and ``partition,
  replicas, topic`` (:func:`format_reassignment_pairs`).

Compact separators, non-ASCII written raw (as org.json does).
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Sequence

from .base import BrokerInfo

KAFKA_FORMAT_VERSION = 1  # KafkaAssignmentGenerator.java:49


def format_reassignment_json(
    assignments: Mapping[str, Mapping[int, Sequence[int]]],
    topic_order: Sequence[str] | None = None,
) -> str:
    """``{topic: {partition: [replicas]}}`` as Kafka reassignment JSON;
    topics follow ``topic_order``, partitions ascend within a topic."""
    topics = list(topic_order) if topic_order is not None else sorted(assignments)
    partitions = [
        {"topic": t, "partition": p, "replicas": list(assignments[t][p])}
        for t in topics
        for p in sorted(assignments[t])
    ]
    return json.dumps(
        {"version": KAFKA_FORMAT_VERSION, "partitions": partitions},
        separators=(",", ":"),
        ensure_ascii=False,
    )


def format_reassignment_pairs(pairs: Sequence) -> str:
    """The "NEW ASSIGNMENT" payload over ``[(topic, {partition: [replicas]})]``
    (a topic listed twice is emitted twice), in org.json-on-JDK8 key order."""
    partitions = [
        {"partition": p, "replicas": list(assignment[p]), "topic": t}
        for t, assignment in pairs
        for p in sorted(assignment)
    ]
    return json.dumps(
        {"partitions": partitions, "version": KAFKA_FORMAT_VERSION},
        separators=(",", ":"),
        ensure_ascii=False,
    )


def parse_reassignment_json(payload: str) -> Dict[str, Dict[int, List[int]]]:
    """Inverse of the formatters (any Kafka-parseable key order/whitespace)."""
    data = json.loads(payload)
    version = data.get("version")
    if version != KAFKA_FORMAT_VERSION:
        raise ValueError(f"unsupported reassignment JSON version: {version!r}")
    out: Dict[str, Dict[int, List[int]]] = {}
    for entry in data.get("partitions", []):
        out.setdefault(entry["topic"], {})[int(entry["partition"])] = [
            int(r) for r in entry["replicas"]
        ]
    return out


def format_brokers_json(brokers: Sequence[BrokerInfo]) -> str:
    """PRINT_CURRENT_BROKERS payload: JSON array, one object per live broker,
    rack omitted when undefined (``KafkaAssignmentGenerator.java:113-129``).

    Key order is org.json-on-JDK8 bucket order (module docstring):
    ``rack`` (when defined), ``port``, ``host``, ``id``."""
    entries = []
    for b in brokers:
        entry = {} if b.rack is None else {"rack": b.rack}
        entry.update({"port": b.port, "host": b.host, "id": b.id})
        entries.append(entry)
    return json.dumps(entries, separators=(",", ":"), ensure_ascii=False)
