"""Per-topic orchestration, the counterpart of
``kafka_assigner_tpu/assigner.py`` (``KafkaTopicAssigner.java:18-72``): RF
inference with the uniformity assertion, ``0 < RF <= |brokers|`` checks,
and one cross-topic ``Context`` per assigner so leadership balancing spans
every topic solved through it.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Mapping, Sequence, Set, Tuple

from .obs.metrics import counter_add
from .obs.profile import dispatch_trace
from .obs.trace import collector_pauses, span
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
    ``native``; ``greedy``) or a solver object.

    ``failure_policy="best-effort"`` arms the reference's fallback
    (``kafka_assigner_tpu/assigner.py:57-110``): a solver other than the
    greedy one that crashes (any exception but ``ValueError``, which is
    validation or infeasibility) is re-run on the greedy lane for the
    crashed group, loudly on stderr and counted in ``solve.fallbacks``. The
    shared ``Context`` is untouched by the crash: the solvers apply their
    leadership counter updates only after a solve succeeds. ``strict``, the
    default, re-raises."""

    def __init__(self, solver: str | Solver = "device", device: str = "cuda",
                 failure_policy: str = "strict") -> None:
        self.solver = get_solver(solver, device) if isinstance(solver, str) else solver
        self.context = Context()
        self.failure_policy = failure_policy
        #: How many groups fell back to the greedy lane in the most recent
        #: ``generate_assignments`` call.
        self.fallbacks = 0
        self._greedy_fallback: Solver | None = None

    def _should_fallback(self, exc: Exception) -> bool:
        """Crash classes only: a ``ValueError`` is input validation or
        infeasibility (the greedy lane would refuse it the same way), and a
        greedy solver has no lane left to fall back to."""
        return (
            self.failure_policy == "best-effort"
            and not isinstance(exc, ValueError)
            and getattr(self.solver, "name", None) != "greedy"
        )

    def _fallback_group(
        self,
        items: Sequence[Tuple[str, Mapping[int, Sequence[int]]]],
        rfs: Sequence[int],
        rack_assignment: Mapping[int, str],
        brokers: Set[int],
        exc: Exception,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        """Re-solve one crashed group on the greedy lane, loudly."""
        counter_add("solve.fallbacks")
        self.fallbacks += 1
        print(
            f"kafka-assigner: best-effort: "
            f"{getattr(self.solver, 'name', type(self.solver).__name__)} "
            f"solver crashed ({type(exc).__name__}: {exc}); falling back to "
            f"the greedy solver for {len(items)} topic(s)",
            file=sys.stderr,
        )
        if self._greedy_fallback is None:
            from .solvers.greedy import GreedySolver

            self._greedy_fallback = GreedySolver()
        return [
            (
                topic,
                self._greedy_fallback.assign(
                    topic, cur, rack_assignment, set(brokers), set(cur),
                    rf, self.context,
                ),
            )
            for (topic, cur), rf in zip(items, rfs)
        ]

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
        preencoded: tuple | None = None,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        """Solve many topics through one shared Context, returning
        ``[(topic, assignment), ...]`` in input order; a repeated topic name
        is solved per occurrence, like the reference's topic loop
        (``KafkaAssignmentGenerator.java:173-176``). As the reference's
        (``kafka_assigner_tpu/assigner.py:213``): a solver without
        ``assign_many`` solves topic by topic; one that declares
        ``supports_mixed_rf`` (the device solver) takes every topic in one
        batch; any other gets one batch per run of consecutive topics of
        one replication factor. Each batch is a crash group of the
        best-effort fallback.

        ``preencoded``: an ``encode_topic_group`` result for exactly these
        topics in this order (mode 3's streamed ingest builds it,
        ``generator.py``), forwarded to a mixed-RF batching solver so it
        skips its own encode (``kafka_assigner_tpu/assigner.py:176-219``);
        ignored by solvers that cannot take it.

        Under ``KA_OBS_PROFILE_DIR`` (or ``KA_PROFILE``) the call is one
        ``torch.profiler`` trace (``obs/profile.py:dispatch_trace``).

        After the solves, the solver's ``last_timers`` (where it keeps them)
        gain ``infer``, the RF inference's ms (the span ``infer``), and,
        under a ``torch.profiler`` session on this thread, ``gc``, the
        collector's pauses inside the call
        (``obs/trace.py:collector_pauses``)."""
        with dispatch_trace():
            timers: Dict[str, float] = {}
            with collector_pauses(timers):
                out = self._generate_assignments(
                    topic_assignments, brokers, rack_assignment,
                    desired_replication_factor, preencoded, timers,
                )
            last = getattr(self.solver, "last_timers", None)
            if out and last is not None:
                last.update(timers)
            return out

    def _generate_assignments(
        self, topic_assignments, brokers, rack_assignment,
        desired_replication_factor, preencoded, timers,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        items = (
            list(topic_assignments.items())
            if isinstance(topic_assignments, Mapping)
            else list(topic_assignments)
        )
        with span("infer", sink=timers, report=False):
            rfs = [
                self._infer_replication_factor(
                    topic, cur, brokers, desired_replication_factor
                )
                for topic, cur in items
            ]
        self.fallbacks = 0
        if not items:
            return []
        assign_many = getattr(self.solver, "assign_many", None)
        if assign_many is None:
            groups = [([it], [rf]) for it, rf in zip(items, rfs)]
        elif getattr(self.solver, "supports_mixed_rf", False):
            groups = [(items, rfs)]
        else:
            groups = []
            i = 0
            while i < len(items):
                j = i
                while j < len(items) and rfs[j] == rfs[i]:
                    j += 1
                groups.append((items[i:j], rfs[i:j]))
                i = j
        out: List[Tuple[str, Dict[int, List[int]]]] = []
        for group, group_rfs in groups:
            try:
                if assign_many is None:
                    (topic, cur), = group
                    solved = [(topic, self.solver.assign(
                        topic, cur, rack_assignment, set(brokers), set(cur),
                        group_rfs[0], self.context))]
                elif getattr(self.solver, "supports_mixed_rf", False):
                    # The keyword only when there is a preencode: a mixed-RF
                    # solver predating the parameter keeps working.
                    kwargs = {} if preencoded is None else {"preencoded": preencoded}
                    solved = list(assign_many(group, rack_assignment, set(brokers),
                                              group_rfs, self.context, **kwargs))
                else:
                    solved = list(assign_many(group, rack_assignment, set(brokers),
                                              group_rfs[0], self.context))
            except Exception as e:
                if not self._should_fallback(e):
                    raise
                solved = self._fallback_group(group, group_rfs, rack_assignment,
                                              brokers, e)
            out.extend(solved)
        return out
