"""Plan entry points — the counterparts of ``kafka_assigner_tpu/generator.py``:

- mode 3 (``PRINT_REASSIGNMENT``), ``print_least_disruptive_reassignment``
  (``KafkaAssignmentGenerator.java:131-187``): broker-set resolution, rack
  map, the rollback snapshot, the feasibility report, one shared-context
  solve and the byte-compatible "NEW ASSIGNMENT" emission;
- ``PRINT_FRESH_ASSIGNMENT``, ``print_fresh_assignment`` (:254): new topics
  placed from scratch through one fresh ``Context``;
- the host-only modes ``PRINT_CURRENT_ASSIGNMENT`` and
  ``PRINT_CURRENT_BROKERS`` (:90-115);
- ``RANK_DECOMMISSION``, ``print_decommission_ranking`` (:167): one batched
  what-if sweep over candidate removals (``parallel/whatif.py``), with
  ``load_scenario_file`` (:118) for ``--scenario_file``.

JSON goes to stdout, diagnostics to stderr.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Set, TextIO

from .assigner import TopicAssigner
from .io.json_io import (
    format_brokers_json,
    format_reassignment_json,
    format_reassignment_pairs,
)
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


def print_current_assignment(
    backend,
    topics: Optional[Sequence[str]],
    out: Optional[TextIO] = None,
) -> None:
    """Mode 1 (``KafkaAssignmentGenerator.java:103-111``): the existing
    assignment in Kafka-parseable JSON, the rollback artifact."""
    out = out if out is not None else sys.stdout
    topic_list = list(topics) if topics is not None else backend.all_topics()
    assignment = backend.partition_assignment(topic_list)
    print("CURRENT ASSIGNMENT:", file=out)
    print(format_reassignment_json(assignment, topic_order=topic_list), file=out)


def print_current_brokers(
    backend,
    out: Optional[TextIO] = None,
    live_brokers: Optional[Sequence[BrokerInfo]] = None,
) -> None:
    """Mode 2 (``KafkaAssignmentGenerator.java:113-129``)."""
    out = out if out is not None else sys.stdout
    if live_brokers is None:
        live_brokers = backend.brokers()
    print("CURRENT BROKERS:", file=out)
    print(format_brokers_json(live_brokers), file=out)


def load_scenario_file(
    path: str, live_brokers: Sequence[BrokerInfo]
) -> List[List[int]]:
    """Parse a ``--scenario_file``: a JSON array of removal scenarios, each
    an array of broker ids (integers) and/or hostnames (strings), e.g.
    ``[[1,2],[3],["kafka7.example.com","kafka8.example.com"]]``.

    Hostnames resolve strictly against the live broker list (the contract
    of ``--broker_hosts``, ``KafkaAssignmentGenerator.java:189-204``);
    unknown ids or hosts are errors — a silently dropped broker would rank
    a different scenario than the operator asked about.
    """
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list) or not all(isinstance(s, list) for s in data):
        raise ValueError(
            f"scenario file {path!r} must be a JSON array of arrays of "
            "broker ids or hostnames"
        )
    by_host = {b.host: b.id for b in live_brokers}
    known = {b.id for b in live_brokers}
    scenarios: List[List[int]] = []
    for s in data:
        ids: List[int] = []
        for entry in s:
            if isinstance(entry, bool) or not isinstance(entry, (int, str)):
                raise ValueError(
                    f"scenario file {path!r}: invalid broker entry {entry!r}"
                )
            if isinstance(entry, str):
                if entry not in by_host:
                    raise ValueError(
                        f"scenario file {path!r}: unknown broker host {entry!r}"
                    )
                ids.append(by_host[entry])
            else:
                if entry not in known:
                    raise ValueError(
                        f"scenario file {path!r}: unknown broker id {entry}"
                    )
                ids.append(int(entry))
        scenarios.append(sorted(set(ids)))
    return scenarios


def print_decommission_ranking(
    backend,
    topics: Optional[Sequence[str]],
    candidate_brokers: Optional[Set[int]],
    rack_assignment: Dict[int, str],
    desired_replication_factor: int,
    device: str = "cuda",
    out: Optional[TextIO] = None,
    live_brokers: Optional[Sequence[BrokerInfo]] = None,
    scenario_file: Optional[str] = None,
) -> None:
    """RANK_DECOMMISSION: one batched what-if sweep over candidate broker
    removals on ``device``, printed least-disruptive-first as a JSON array.
    Default: every live broker (or each of ``candidate_brokers``) as a
    singleton scenario; ``scenario_file`` ranks arbitrary removal sets in
    the same sweep."""
    from .parallel.whatif import (
        evaluate_removal_scenarios,
        rank_decommission_candidates,
    )

    out = out if out is not None else sys.stdout
    if live_brokers is None:
        live_brokers = backend.brokers()
    brokers = {b.id for b in live_brokers}
    topic_list = list(topics) if topics is not None else backend.all_topics()
    initial = backend.partition_assignment(topic_list)
    topic_map = {t: initial[t] for t in topic_list}
    racks = {k: v for k, v in rack_assignment.items() if k in brokers}
    if scenario_file is not None:
        scenarios = load_scenario_file(scenario_file, live_brokers)
        results = evaluate_removal_scenarios(
            topic_map, brokers, racks, scenarios, desired_replication_factor,
            device=device,
        )
        ranked = sorted(
            results, key=lambda r: (not r.feasible, r.moved_replicas, r.removed)
        )
        rows = [
            {
                "brokers": list(r.removed),
                "moved_replicas": r.moved_replicas,
                "feasible": r.feasible,
                "max_node_load": r.max_node_load,
            }
            for r in ranked
        ]
    else:
        ranked = rank_decommission_candidates(
            topic_map, brokers, racks,
            sorted(candidate_brokers) if candidate_brokers else None,
            desired_replication_factor, device=device,
        )
        rows = [
            {
                "broker": r.removed[0],
                "moved_replicas": r.moved_replicas,
                "feasible": r.feasible,
                "max_node_load": r.max_node_load,
            }
            for r in ranked
        ]
    print("DECOMMISSION RANKING:", file=out)
    print(json.dumps(rows, separators=(",", ":")), file=out)


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
    solver: str = "device",
) -> Dict[str, Dict[int, List[int]]]:
    """Mode 3: resolve the broker set (all live brokers by default, minus
    exclusions), print the current assignment for rollback, solve every
    topic through one shared-context assigner in CLI order with ``solver``
    (``device`` on ``device``, ``native`` or ``greedy``) and emit the
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

    assigner = TopicAssigner(solver, device=device)
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
