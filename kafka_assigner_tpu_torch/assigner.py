"""Per-topic orchestration, the counterpart of
``kafka_assigner_tpu/assigner.py`` (``KafkaTopicAssigner.java:18-72``): RF
inference with the uniformity assertion, ``0 < RF <= |brokers|`` checks,
and one cross-topic ``Context`` per assigner so leadership balancing spans
every topic solved through it.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Set, Tuple

from .solvers.base import Context, Solver, get_solver


def infer_topic_rf(
    topic: str,
    current_assignment: Mapping[int, Sequence[int]],
    desired_replication_factor: int,
) -> int:
    """A negative desired RF means "keep the existing one", which must agree
    across partitions (``KafkaTopicAssigner.java:49-62``). Returns the
    desired RF unchanged (possibly negative) for an empty assignment."""
    replication_factor = desired_replication_factor
    for partition, replicas in sorted(current_assignment.items()):
        if replication_factor < 0:
            replication_factor = len(replicas)
        elif desired_replication_factor < 0 and replication_factor != len(replicas):
            raise ValueError(
                f"Topic {topic} has partition {partition} with unexpected "
                f"replication factor {len(replicas)}"
            )
    return replication_factor


class TopicAssigner:
    """Minimal-movement assignments through one shared ``Context``.

    ``solver``: a name of ``solvers/base.py:get_solver`` (``device``, the
    default, on ``device``: ``cuda`` unless the caller says ``cpu``;
    ``native``; ``greedy``) or a solver object."""

    def __init__(self, solver: str | Solver = "device", device: str = "cuda") -> None:
        self.solver = get_solver(solver, device) if isinstance(solver, str) else solver
        self.context = Context()

    def _infer_replication_factor(
        self,
        topic: str,
        current_assignment: Mapping[int, Sequence[int]],
        brokers: Set[int],
        desired_replication_factor: int,
    ) -> int:
        replication_factor = infer_topic_rf(
            topic, current_assignment, desired_replication_factor
        )
        if replication_factor <= 0:
            raise ValueError(
                f"Topic {topic} does not have a positive replication factor!"
            )
        if replication_factor > len(brokers):
            raise ValueError(
                f"Topic {topic} has a higher replication factor "
                f"({replication_factor}) than available brokers!"
            )
        return replication_factor

    def generate_assignment(
        self,
        topic: str,
        current_assignment: Mapping[int, Sequence[int]],
        brokers: Set[int],
        rack_assignment: Mapping[int, str],
        desired_replication_factor: int = -1,
    ) -> Dict[int, List[int]]:
        """One topic (``KafkaTopicAssigner.java:42-72``)."""
        replication_factor = self._infer_replication_factor(
            topic, current_assignment, brokers, desired_replication_factor
        )
        return self.solver.assign(
            topic, current_assignment, rack_assignment, set(brokers),
            set(current_assignment), replication_factor, self.context,
        )

    def generate_assignments(
        self,
        topic_assignments: (
            Mapping[str, Mapping[int, Sequence[int]]]
            | Sequence[Tuple[str, Mapping[int, Sequence[int]]]]
        ),
        brokers: Set[int],
        rack_assignment: Mapping[int, str],
        desired_replication_factor: int = -1,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        """Solve many topics through one shared Context, returning
        ``[(topic, assignment), ...]`` in input order; a repeated topic name
        is solved per occurrence, like the reference's topic loop
        (``KafkaAssignmentGenerator.java:173-176``). As the reference's
        (``kafka_assigner_tpu/assigner.py:213``): a solver without
        ``assign_many`` solves topic by topic; one that declares
        ``supports_mixed_rf`` (the device solver) takes every topic in one
        batch; any other gets one batch per run of consecutive topics of
        one replication factor."""
        items = (
            list(topic_assignments.items())
            if isinstance(topic_assignments, Mapping)
            else list(topic_assignments)
        )
        rfs = [
            self._infer_replication_factor(
                topic, cur, brokers, desired_replication_factor
            )
            for topic, cur in items
        ]
        if not items:
            return []
        assign_many = getattr(self.solver, "assign_many", None)
        if assign_many is None:
            return [
                (topic, self.solver.assign(topic, cur, rack_assignment, set(brokers),
                                           set(cur), rf, self.context))
                for (topic, cur), rf in zip(items, rfs)
            ]
        if getattr(self.solver, "supports_mixed_rf", False):
            return list(assign_many(items, rack_assignment, set(brokers), rfs,
                                    self.context))
        out: List[Tuple[str, Dict[int, List[int]]]] = []
        i = 0
        while i < len(items):
            j = i
            while j < len(items) and rfs[j] == rfs[i]:
                j += 1
            out.extend(assign_many(items[i:j], rack_assignment, set(brokers),
                                   rfs[i], self.context))
            i = j
        return out
