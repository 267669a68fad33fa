"""The greedy oracle (``--solver greedy``): a semantics-faithful
reimplementation of the reference's five-phase algorithm
(``KafkaAssignmentStrategy.java:40-63``), a copy of
``kafka_assigner_tpu/solvers/greedy.py`` with its ``greedy.*`` counters.

This is the correctness oracle for differential testing, in Python; the C++
greedy (``solvers/native.py``) is the baseline whose moved-replica count and
wall-clock the device solver is measured against (``scripts/torch_bench.py``).
It reproduces the reference's *choices*, not just its invariants:
same TreeMap/TreeSet iteration orders, same topic-hash rotation of the node
processing order, same first-minimum tie-breaking.

Phase map (reference line numbers):
  1. capacity        ``getMaxReplicasPerNode``     KafkaAssignmentStrategy.java:65-71
  2. node/rack graph ``createNodeMap``             KafkaAssignmentStrategy.java:73-99
  3. sticky fill     ``fillNodesFromAssignment``   KafkaAssignmentStrategy.java:101-131
  4. orphan spread   ``getOrphanedReplicas`` +
                     ``assignOrphans``             KafkaAssignmentStrategy.java:133-186
  5. leadership      ``computePreferenceLists``    KafkaAssignmentStrategy.java:202-302

Known reference behaviors intentionally preserved (documented, bug-compatible):
  - When lowering the replication factor, the sticky fill has no per-partition
    replica limit (``canAccept`` checks only node/rack/capacity,
    ``KafkaAssignmentStrategy.java:320-324``), so partitions can retain more
    replicas than the new RF and the emitted lists are then non-uniform.
  - Infeasible spreads (e.g. RF > #racks, uneven racks) fail hard with
    "Partition N could not be fully assigned!" (``KafkaAssignmentStrategy.java:183-184``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set

from ..obs.metrics import counter_add
from ..utils.javahash import topic_start_index
from .base import Context


class _Rack:
    """Rack exclusivity gate (``KafkaAssignmentStrategy.java:337-355``): a rack
    accepts any given partition at most once — the hard rack-diversity rule."""

    __slots__ = ("rack_id", "assigned")

    def __init__(self, rack_id: str) -> None:
        self.rack_id = rack_id
        self.assigned: Set[int] = set()

    def can_accept(self, partition: int) -> bool:
        return partition not in self.assigned

    def accept(self, partition: int) -> None:
        if not self.can_accept(partition):
            raise AssertionError(
                f"Attempted to accept unacceptable partition {partition}"
            )
        self.assigned.add(partition)


class _Node:
    """Node capacity/rack gate (``KafkaAssignmentStrategy.java:307-332``)."""

    __slots__ = ("node_id", "capacity", "rack", "assigned")

    def __init__(self, node_id: int, capacity: int, rack: _Rack) -> None:
        self.node_id = node_id
        self.capacity = capacity
        self.rack = rack
        self.assigned: Set[int] = set()

    def can_accept(self, partition: int) -> bool:
        return (
            partition not in self.assigned
            and len(self.assigned) < self.capacity
            and self.rack.can_accept(partition)
        )

    def accept(self, partition: int) -> None:
        if not self.can_accept(partition):
            raise AssertionError(
                f"Attempted to accept unacceptable partition {partition}"
            )
        self.assigned.add(partition)
        self.rack.accept(partition)


def max_replicas_per_node(
    n_nodes: int, n_partitions: int, replication_factor: int
) -> int:
    """Per-node capacity ``ceil(P * RF / N)`` (``KafkaAssignmentStrategy.java:65-71``)."""
    return math.ceil(n_partitions * replication_factor / n_nodes)


def node_processing_order(topic: str, node_ids: Iterable[int]) -> List[int]:
    """Topic-hash-rotated node order (``KafkaAssignmentStrategy.java:188-200``).

    Ascending node ids are written into an array starting at
    ``abs(hash(topic)) % N`` with wraparound; iterating the array start-to-end
    therefore yields the sorted ids rotated so low-id brokers are not favored
    for every topic.
    """
    ordered = sorted(node_ids)
    n = len(ordered)
    start = topic_start_index(topic, n)
    out: List[Optional[int]] = [None] * n
    idx = start
    for nid in ordered:
        out[idx] = nid
        idx += 1
        if idx == n:
            idx = 0
    return out  # type: ignore[return-value]


def _create_node_map(
    rack_assignment: Mapping[int, str], nodes: Iterable[int], capacity: int
) -> Dict[int, _Node]:
    """Build the node/rack graph (``KafkaAssignmentStrategy.java:73-99``).

    A node without a rack gets its own id as rack id, so rack-unaware runs
    degenerate gracefully to per-node exclusivity.
    """
    racks: Dict[str, _Rack] = {}
    node_map: Dict[int, _Node] = {}
    for nid in sorted(nodes):
        rack_id = rack_assignment.get(nid)
        if rack_id is None:
            rack_id = str(nid)
        rack = racks.get(rack_id)
        if rack is None:
            rack = _Rack(rack_id)
            racks[rack_id] = rack
        node_map[nid] = _Node(nid, capacity, rack)
    return node_map


def _fill_nodes_from_assignment(
    assignment: Mapping[int, Sequence[int]], node_map: Dict[int, _Node]
) -> None:
    """Sticky fill (``KafkaAssignmentStrategy.java:101-131``): round-robin over
    partitions (ascending), one replica-list entry per pass, re-accepting each
    current replica iff the node survives, is under capacity, and its rack has
    no replica of that partition. The round-robin order keeps at most one
    replica of any partition in flight — the movement-minimization mechanism.
    """
    iters = {p: iter(replicas) for p, replicas in sorted(assignment.items())}
    while iters:
        exhausted: List[int] = []
        for partition, it in iters.items():
            nid = next(it, None)
            if nid is None:
                exhausted.append(partition)
                continue
            node = node_map.get(nid)
            if node is not None and node.can_accept(partition):
                node.accept(partition)
        for partition in exhausted:
            del iters[partition]


def _orphaned_replicas(
    node_map: Dict[int, _Node], partitions: Iterable[int], replication_factor: int
) -> Dict[int, int]:
    """Per-partition replica deficit vs RF (``KafkaAssignmentStrategy.java:133-160``)."""
    counts: Dict[int, int] = {}
    for node in node_map.values():
        for partition in node.assigned:
            counts[partition] = counts.get(partition, 0) + 1
    orphans: Dict[int, int] = {}
    for partition in sorted(partitions):
        remaining = replication_factor - counts.get(partition, 0)
        if remaining > 0:
            orphans[partition] = remaining
    return orphans


def _assign_orphans(
    topic: str, node_map: Dict[int, _Node], orphans: Mapping[int, int]
) -> None:
    """Greedy first-fit spread of unplaced replicas in topic-rotated node order
    (``KafkaAssignmentStrategy.java:162-186``). Hard-fails when a replica cannot
    be placed (e.g. RF > #racks or uneven racks — the documented caveat at
    ``KafkaAssignmentStrategy.java:29-30``)."""
    order = node_processing_order(topic, node_map.keys())
    for partition in sorted(orphans):
        remaining = orphans[partition]
        for nid in order:
            if remaining <= 0:
                break
            node = node_map[nid]
            if node.can_accept(partition):
                node.accept(partition)
                remaining -= 1
        if remaining != 0:
            raise ValueError(f"Partition {partition} could not be fully assigned!")


class _PreferenceListOrderTracker:
    """Least-seen-node selection per replica slot
    (``KafkaAssignmentStrategy.java:244-302``). Counters live in the shared
    ``Context`` so leadership balances across partitions *and topics*."""

    def __init__(self, topic: str, context: Context) -> None:
        self.topic = topic
        self.context = context

    def least_seen_node(self, replica_slot: int, nodes: Set[int]) -> int:
        # Scan in topic-rotated order; the first strict minimum wins
        # (KafkaAssignmentStrategy.java:263-278).
        min_count: Optional[int] = None
        min_node: Optional[int] = None
        for nid in node_processing_order(self.topic, nodes):
            count = self.context.get(nid, replica_slot)
            if min_count is None or count < min_count:
                min_count = count
                min_node = nid
        assert min_node is not None
        return min_node

    def update_counters(self, preference_list: Sequence[int]) -> None:
        for slot, nid in enumerate(preference_list):
            self.context.increment(nid, slot)


def _compute_preference_lists(
    topic: str, node_map: Dict[int, _Node], context: Context
) -> Dict[int, List[int]]:
    """Leadership ordering (``KafkaAssignmentStrategy.java:202-239``): for each
    partition (ascending), pick for slot r the assigned node least often seen at
    slot r so far; slot 0 is the leader, so leaders (and fallback leaders)
    balance cluster-wide via the persistent Context."""
    unordered: Dict[int, List[int]] = {}
    for nid in sorted(node_map):
        for partition in sorted(node_map[nid].assigned):
            unordered.setdefault(partition, []).append(nid)

    tracker = _PreferenceListOrderTracker(topic, context)
    preferences: Dict[int, List[int]] = {}
    for partition in sorted(unordered):
        candidates = set(unordered[partition])
        ordered: List[int] = []
        for slot in range(len(unordered[partition])):
            chosen = tracker.least_seen_node(slot, candidates)
            candidates.remove(chosen)
            ordered.append(chosen)
        preferences[partition] = ordered
        tracker.update_counters(ordered)
    return preferences


def rack_aware_assignment(
    topic: str,
    current_assignment: Mapping[int, Sequence[int]],
    rack_assignment: Mapping[int, str],
    nodes: Set[int],
    partitions: Set[int],
    replication_factor: int,
    context: Context | None = None,
) -> Dict[int, List[int]]:
    """The full 5-phase greedy solve (``KafkaAssignmentStrategy.java:40-63``)."""
    capacity = max_replicas_per_node(len(nodes), len(partitions), replication_factor)
    node_map = _create_node_map(rack_assignment, nodes, capacity)
    _fill_nodes_from_assignment(current_assignment, node_map)
    orphans = _orphaned_replicas(node_map, partitions, replication_factor)
    _assign_orphans(topic, node_map, orphans)
    if context is None:
        context = Context()
    return _compute_preference_lists(topic, node_map, context)


class GreedySolver:
    """Solver-protocol wrapper over :func:`rack_aware_assignment`."""

    name = "greedy"

    def assign(
        self,
        topic: str,
        current_assignment: Mapping[int, Sequence[int]],
        rack_assignment: Mapping[int, str],
        nodes: Set[int],
        partitions: Set[int],
        replication_factor: int,
        context: Context | None = None,
    ) -> Dict[int, List[int]]:
        # Counters, not per-topic spans: mode 3 loops this over every topic,
        # and the span log is capped.
        counter_add("greedy.assigns")
        counter_add("greedy.partitions", len(partitions))
        return rack_aware_assignment(
            topic,
            current_assignment,
            rack_assignment,
            nodes,
            partitions,
            replication_factor,
            context,
        )
