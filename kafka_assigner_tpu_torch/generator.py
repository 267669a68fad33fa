"""Plan entry points — the counterparts of ``kafka_assigner_tpu/generator.py``:

- mode 3 (``PRINT_REASSIGNMENT``), ``print_least_disruptive_reassignment``
  (``KafkaAssignmentGenerator.java:131-187``): broker-set resolution, rack
  map, the rollback snapshot, the feasibility report, one shared-context
  solve and the byte-compatible "NEW ASSIGNMENT" emission;
- ``PRINT_FRESH_ASSIGNMENT``, ``print_fresh_assignment`` (:254): new topics
  placed from scratch through one fresh ``Context``.

JSON goes to stdout, diagnostics to stderr.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Set, TextIO

from .assigner import TopicAssigner
from .io.json_io import format_reassignment_json, format_reassignment_pairs
from .io.snapshot import BrokerInfo
from .solvers.base import Context
from .solvers.torch_solver import TorchSolver
from .validate import validate_cluster_feasibility


def broker_hostnames_to_ids(
    brokers: Sequence[BrokerInfo], hostnames: Set[str], check_presence: bool
) -> Set[int]:
    """Hostname -> broker-id resolution (``KafkaAssignmentGenerator.java:
    189-204``): strict for inclusion sets, lenient for exclusion sets."""
    ids = {b.id for b in brokers if b.host in hostnames}
    if check_presence and len(hostnames) != len(ids):
        raise ValueError(f"Some hostnames could not be found! We found: {sorted(ids)}")
    return ids


def resolve_broker_ids(
    brokers: Sequence[BrokerInfo],
    integer_broker_ids: Optional[str],
    broker_hostnames: Optional[str],
) -> Set[int]:
    """``--integer_broker_ids`` parse or ``--broker_hosts`` lookup
    (``KafkaAssignmentGenerator.java:206-225``)."""
    if integer_broker_ids:
        out = set()
        for tok in integer_broker_ids.split(","):
            try:
                out.add(int(tok))
            except ValueError:
                raise ValueError(f"Invalid broker ID: {tok}") from None
        return out
    if broker_hostnames:
        return broker_hostnames_to_ids(brokers, set(broker_hostnames.split(",")), True)
    return set()


def resolve_excluded_broker_ids(
    brokers: Sequence[BrokerInfo], broker_hosts_to_remove: Optional[str]
) -> Set[int]:
    """``--broker_hosts_to_remove`` lookup, lenient on unknown hosts
    (``KafkaAssignmentGenerator.java:227-236``)."""
    if broker_hosts_to_remove:
        return broker_hostnames_to_ids(
            brokers, set(broker_hosts_to_remove.split(",")), False
        )
    return set()


def build_rack_assignment(
    brokers: Sequence[BrokerInfo], disable_rack_awareness: bool
) -> Dict[int, str]:
    """Broker-id -> rack map; empty when rack awareness is disabled
    (``KafkaAssignmentGenerator.java:238-250``)."""
    if disable_rack_awareness:
        return {}
    return {b.id: b.rack for b in brokers if b.rack is not None}


def print_least_disruptive_reassignment(
    backend,
    topics: Optional[Sequence[str]],
    specified_brokers: Set[int],
    excluded_brokers: Set[int],
    rack_assignment: Dict[int, str],
    desired_replication_factor: int,
    device: str = "cuda",
    out: Optional[TextIO] = None,
    live_brokers: Optional[Sequence[BrokerInfo]] = None,
    context_file: Optional[str] = None,
) -> Dict[str, Dict[int, List[int]]]:
    """Mode 3: resolve the broker set (all live brokers by default, minus
    exclusions), print the current assignment for rollback, solve every
    topic through one shared-context assigner in CLI order and emit the
    combined reassignment JSON. Metadata is read once; the rollback snapshot
    and the solver see the same read."""
    out = out if out is not None else sys.stdout
    broker_set = set(specified_brokers)
    if not broker_set:
        if live_brokers is None:
            live_brokers = backend.brokers()
        broker_set = {b.id for b in live_brokers}
    brokers = broker_set - excluded_brokers
    rack_assignment = {k: v for k, v in rack_assignment.items() if k in brokers}

    topic_list = list(topics) if topics is not None else backend.all_topics()
    initial = backend.partition_assignment(topic_list)

    print("CURRENT ASSIGNMENT:", file=out)
    print(format_reassignment_json(initial, topic_order=topic_list), file=out)

    for issue in validate_cluster_feasibility(
        [(t, initial[t]) for t in topic_list], brokers, rack_assignment,
        desired_replication_factor,
    ):
        print(
            f"feasibility {issue.severity}: topic {issue.topic}: {issue.message}",
            file=sys.stderr,
        )

    assigner = TopicAssigner(device=device)
    if context_file is not None and os.path.exists(context_file):
        try:
            assigner.context = Context.load(context_file)
        except (ValueError, KeyError, TypeError, AttributeError, OSError) as e:
            raise ValueError(
                f"invalid leadership context file {context_file!r}: {e}"
            ) from e
    final_pairs = assigner.generate_assignments(
        [(topic, initial[topic]) for topic in topic_list],
        brokers, rack_assignment, desired_replication_factor,
    )
    print("NEW ASSIGNMENT:\n" + format_reassignment_pairs(final_pairs), file=out)
    # Save after the payload is out: a failing save never discards a solve.
    if context_file is not None:
        assigner.context.save(context_file)
    return dict(final_pairs)


def print_fresh_assignment(
    topics: Sequence[str],
    partition_count: int,
    replication_factor: int,
    live_brokers: Sequence[BrokerInfo],
    rack_assignment: Dict[int, str],
    device: str = "cuda",
    out: Optional[TextIO] = None,
) -> None:
    """PRINT_FRESH_ASSIGNMENT: place each topic's ``partition_count``
    partitions from scratch on ``live_brokers``, in order, through one
    fresh ``Context`` (a ``--leadership_context`` file is not read), and
    print "FRESH ASSIGNMENT:" and the plan."""
    out = out if out is not None else sys.stdout
    brokers = {b.id for b in live_brokers}
    solver = TorchSolver(device)
    context = Context()
    pairs = [
        (
            topic,
            solver.fresh_assignment(
                topic, partition_count, brokers, rack_assignment,
                replication_factor, context,
            ),
        )
        for topic in topics
    ]
    print("FRESH ASSIGNMENT:\n" + format_reassignment_pairs(pairs), file=out)
