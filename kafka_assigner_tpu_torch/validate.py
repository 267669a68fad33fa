"""Up-front feasibility validation, a copy of
``kafka_assigner_tpu/validate.py``.

The reference only discovers infeasibility mid-solve ("Partition N could not
be fully assigned!", ``KafkaAssignmentStrategy.java:183-184``). These
necessary-condition checks run before solving and name the structural
cause; the solver's hard error remains the backstop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Set


@dataclass
class FeasibilityIssue:
    topic: str
    severity: str  # "error" (provably infeasible) | "warning" (at risk)
    message: str


def validate_topic_feasibility(
    topic: str,
    n_partitions: int,
    replication_factor: int,
    brokers: Set[int],
    rack_assignment: Mapping[int, str],
) -> List[FeasibilityIssue]:
    """Necessary-condition checks for one topic's solve."""
    issues: List[FeasibilityIssue] = []
    n = len(brokers)
    if n == 0 or n_partitions == 0:
        return issues
    rf = replication_factor
    racks: Dict[str, int] = {}
    for b in brokers:
        rack = rack_assignment.get(b)
        key = str(b) if rack is None else rack
        racks[key] = racks.get(key, 0) + 1
    n_racks = len(racks)
    if rf > n_racks:
        issues.append(
            FeasibilityIssue(
                topic, "error",
                f"replication factor {rf} exceeds rack count {n_racks}: each "
                "replica of a partition must land on a distinct rack "
                "(KafkaAssignmentStrategy.java:17-24)",
            )
        )
        return issues
    cap = math.ceil(n_partitions * rf / n)
    # Each rack can take at most min(size * cap, P) replicas.
    placeable = sum(min(size * cap, n_partitions) for size in racks.values())
    if placeable < n_partitions * rf:
        issues.append(
            FeasibilityIssue(
                topic, "error",
                f"rack capacities cannot host P*RF={n_partitions * rf} "
                f"replicas (max placeable {placeable} with per-node cap "
                f"{cap}): racks are too unbalanced "
                "(KafkaAssignmentStrategy.java:29-30)",
            )
        )
    elif rf == n_racks:
        smallest = min(racks.values())
        if smallest * cap < n_partitions:
            issues.append(
                FeasibilityIssue(
                    topic, "error",
                    f"RF equals rack count, so every rack must carry every "
                    f"partition, but the smallest rack ({smallest} brokers x "
                    f"cap {cap}) cannot hold {n_partitions} partitions",
                )
            )
    # First-fit placement is known to strand replicas near zero slack.
    slack = n * cap - n_partitions * rf
    if not any(i.severity == "error" for i in issues) and slack < max(1, n // 100):
        issues.append(
            FeasibilityIssue(
                topic, "warning",
                f"capacity slack is only {slack} replica slots; first-fit "
                "placement may fail on skewed current assignments",
            )
        )
    return issues


def validate_cluster_feasibility(
    topic_assignments: Sequence,
    brokers: Set[int],
    rack_assignment: Mapping[int, str],
    desired_replication_factor: int = -1,
) -> List[FeasibilityIssue]:
    """Validate every (topic, current) pair before a reassignment run."""
    from .assigner import infer_topic_rf

    issues: List[FeasibilityIssue] = []
    for topic, current in topic_assignments:
        try:
            rf = infer_topic_rf(topic, current, desired_replication_factor)
        except ValueError as e:
            issues.append(FeasibilityIssue(topic, "error", str(e)))
            continue
        if rf <= 0:
            continue
        issues.extend(
            validate_topic_feasibility(
                topic, len(current), rf, brokers, rack_assignment
            )
        )
    return issues
