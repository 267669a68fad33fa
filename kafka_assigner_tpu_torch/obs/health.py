"""Cluster-health scoring from cached metadata, and the deterministic
synthetic traffic series: the port of the reference's
``kafka_assigner_tpu/obs/health.py``.

Pure host arithmetic over the ``{topic: {partition: [replica ids]}}`` dicts
the daemon's cache holds. The supervisor scores the cached assignment on
every resync and delta re-encode and publishes the result as ``health.*``
gauges; ``/recommendations`` compares two scores and a
:func:`movement_debt` against a cost of change.

- **replica spread / stddev**: per-broker replica counts over every cached
  partition; ``spread = max - min``, ``stddev`` the population standard
  deviation. Brokers that host nothing count: an empty broker is the
  imbalance.
- **leader spread / stddev**: the same over preferred leaders (the first
  replica of each partition).
- **rack violations**: partitions with two replicas on one known rack.
  Brokers with no known rack never count.
- **score**: ``replica_spread + 0.5 * leader_spread + 10 *
  rack_violations``, fixed weights, lower is healthier.

:func:`movement_debt` is the cost side: the replica placements (and the
preferred leaders) a proposed assignment changes against the current one.
The consumer-group family's synthetic members and its throughput weight
column read :func:`synthetic_partition_traffic`.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

from ..io.base import PartitionTraffic

#: Version stamp of the ``/recommendations`` response envelope. Bump on any
#: breaking shape change, exactly like the run report's schema version.
RECOMMENDATION_SCHEMA_VERSION = 1

#: Composite-score weights (module docstring): replicas, leaders, rack
#: violations.
SCORE_WEIGHTS: Tuple[float, float, float] = (1.0, 0.5, 10.0)


@dataclass(frozen=True)
class HealthScores:
    """One assignment's quality scores (see module docstring for the
    definitions). ``as_dict`` is the deterministic, rounded form that goes
    into gauges and the ``/recommendations`` envelope — byte-stable for
    identical inputs."""

    brokers: int
    topics: int
    partitions: int
    replicas: int
    replica_spread: int
    replica_stddev: float
    leader_spread: int
    leader_stddev: float
    rack_violations: int
    score: float

    def as_dict(self) -> dict:
        return {
            "brokers": self.brokers,
            "topics": self.topics,
            "partitions": self.partitions,
            "replicas": self.replicas,
            "replica_spread": self.replica_spread,
            "replica_stddev": self.replica_stddev,
            "leader_spread": self.leader_spread,
            "leader_stddev": self.leader_stddev,
            "rack_violations": self.rack_violations,
            "score": self.score,
        }


def _spread_stddev(counts: Sequence[int]) -> Tuple[int, float]:
    if not counts:
        return 0, 0.0
    spread = max(counts) - min(counts)
    mean = sum(counts) / len(counts)
    var = sum((c - mean) ** 2 for c in counts) / len(counts)
    return spread, round(math.sqrt(var), 6)


def score_assignment(
    broker_ids: Iterable[int],
    topics: Mapping[str, Mapping[int, Sequence[int]]],
    rack_of: Mapping[int, str],
) -> HealthScores:
    """Score one assignment snapshot. ``broker_ids`` is the LIVE broker
    set (empty brokers count toward imbalance); ``rack_of`` maps broker id
    to rack for the brokers that have one. Replicas on brokers outside
    ``broker_ids`` (a decommissioned-but-not-yet-drained broker) still
    count in that broker's bucket — a plan-deviating assignment must not
    score as balanced by dropping its strays."""
    replica_counts: Dict[int, int] = {int(b): 0 for b in broker_ids}
    leader_counts: Dict[int, int] = {int(b): 0 for b in broker_ids}
    partitions = 0
    replicas = 0
    rack_violations = 0
    for _topic, parts in topics.items():
        for _p, reps in parts.items():
            partitions += 1
            seen_racks: set = set()
            violated = False
            for i, r in enumerate(reps):
                r = int(r)
                replicas += 1
                replica_counts[r] = replica_counts.get(r, 0) + 1
                if i == 0:
                    leader_counts[r] = leader_counts.get(r, 0) + 1
                rack = rack_of.get(r)
                if rack is not None:
                    if rack in seen_racks:
                        violated = True
                    seen_racks.add(rack)
            if violated:
                rack_violations += 1
    r_spread, r_std = _spread_stddev(list(replica_counts.values()))
    l_spread, l_std = _spread_stddev(list(leader_counts.values()))
    w_r, w_l, w_v = SCORE_WEIGHTS
    score = round(
        w_r * r_spread + w_l * l_spread + w_v * rack_violations, 6
    )
    return HealthScores(
        brokers=len(replica_counts),
        topics=len(topics),
        partitions=partitions,
        replicas=replicas,
        replica_spread=r_spread,
        replica_stddev=r_std,
        leader_spread=l_spread,
        leader_stddev=l_std,
        rack_violations=rack_violations,
        score=score,
    )


def movement_debt(
    current: Mapping[str, Mapping[int, Sequence[int]]],
    proposed: Mapping[str, Mapping[int, Sequence[int]]],
) -> Tuple[int, int]:
    """``(replica_moves, leader_moves)`` between two assignments: how many
    replica placements the proposal adds that the current state lacks
    (per partition, set difference — a reordered replica list moves no
    data), and how many preferred leaders change (a leadership move is
    metadata-cheap but client-visible, so it is reported separately, not
    folded into the replica count). Partitions present on only one side
    charge their full replica set — appearing or vanishing IS movement."""
    moves = 0
    leader_moves = 0
    # Commutative sums: the set iteration order cannot reach the result.
    for topic in set(current) | set(proposed):
        cur_parts = current.get(topic, {})
        new_parts = proposed.get(topic, {})
        for p in set(cur_parts) | set(new_parts):
            cur = [int(r) for r in cur_parts.get(p, ())]
            new = [int(r) for r in new_parts.get(p, ())]
            moves += len(set(new) - set(cur)) if new else len(set(cur))
            cur_lead = cur[0] if cur else None
            new_lead = new[0] if new else None
            if cur_lead != new_lead:
                leader_moves += 1
    return moves, leader_moves


#: Required top-level keys of the ``/recommendations`` envelope (v1).
_RECOMMENDATION_KEYS = (
    "schema_version", "kind", "policy", "cluster", "solver", "stale",
    "degraded", "current", "candidate", "cost_model", "verdict",
)
_SCORE_KEYS = tuple(
    HealthScores(0, 0, 0, 0, 0, 0.0, 0, 0.0, 0, 0.0).as_dict()
)


def validate_recommendation(obj) -> List[str]:
    """Structural schema check for one ``/recommendations`` envelope; the
    empty list means valid. The envelope is a public schema-versioned
    surface, so its validator lives next to its schema constant, as
    ``obs/report.py:validate_report`` does."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return ["recommendation envelope is not a JSON object"]
    for key in _RECOMMENDATION_KEYS:
        if key not in obj:
            problems.append(f"missing required key {key!r}")
    if obj.get("schema_version") != RECOMMENDATION_SCHEMA_VERSION:
        problems.append(
            f"schema_version {obj.get('schema_version')!r} != emitter's "
            f"{RECOMMENDATION_SCHEMA_VERSION}"
        )
    if obj.get("kind") != "recommendations":
        problems.append(f"kind {obj.get('kind')!r} != 'recommendations'")
    if obj.get("policy") != "observe":
        problems.append(
            f"policy {obj.get('policy')!r} != 'observe' (this envelope "
            "must never describe an executed change)"
        )
    if obj.get("verdict") not in ("recommend", "hold"):
        problems.append(f"unknown verdict {obj.get('verdict')!r}")
    for section, owner in (
        (obj.get("current"), "current"),
        ((obj.get("candidate") or {}).get("projected"),
         "candidate.projected"),
    ):
        if not isinstance(section, dict):
            problems.append(f"{owner} is not a scores object")
            continue
        for key in _SCORE_KEYS:
            if key not in section:
                problems.append(f"{owner} missing score {key!r}")
    cand = obj.get("candidate")
    if isinstance(cand, dict):
        for key in ("moves_required", "leader_moves"):
            if not isinstance(cand.get(key), int):
                problems.append(f"candidate.{key} missing or non-integer")
    cost = obj.get("cost_model")
    if isinstance(cost, dict):
        for key in ("move_cost", "cost", "improvement"):
            if not isinstance(cost.get(key), (int, float)):
                problems.append(f"cost_model.{key} missing or non-number")
    else:
        problems.append("cost_model is not an object")
    return problems


def synthetic_partition_traffic(
    partitions: Mapping[str, Iterable[int]],
) -> Dict[str, Dict[int, PartitionTraffic]]:
    """Per partition, a stable ``PartitionTraffic`` derived from a CRC of
    ``topic/partition``: identical across calls, processes and machines,
    and skewed over orders of magnitude like a real cluster's."""
    out: Dict[str, Dict[int, PartitionTraffic]] = {}
    for topic, parts in partitions.items():
        per: Dict[int, PartitionTraffic] = {}
        for p in parts:
            h = zlib.crc32(f"{topic}/{int(p)}".encode("utf-8"))
            # 2^(h mod 11) scales 1x..1024x over a 100 B/s base; lag
            # correlates loosely with traffic.
            scale = float(2 ** (h % 11))
            per[int(p)] = PartitionTraffic(
                in_bytes=round(100.0 * scale, 3),
                out_bytes=round(250.0 * scale, 3),
                lag=int((h >> 8) % 1000),
            )
        out[topic] = per
    return out
