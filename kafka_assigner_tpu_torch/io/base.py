"""Cluster-metadata backends (layer L3), the read surface of the reference's
``kafka_assigner_tpu/io/base.py``: the data types, the ``MetadataBackend``
protocol with its real defaults, and :func:`open_backend`, which picks a
backend from the reference's single ``--zk_string`` flag:

- ``file:///path.json`` or a path ending in ``.json``: the hermetic
  snapshot (``io/snapshot.py``);
- ``kafka://host:port,...``: the Kafka AdminClient bridge
  (``io/kafka_admin.py``);
- anything else: a live ZooKeeper quorum (``io/zk.py``), the reference
  tool's only mode (``KafkaAssignmentGenerator.java:273-276``).

The protocol also carries the execution surface of ``ka-execute``
(``supports_execution``, ``apply_assignment``, ``read_assignment_state``)
with the reference's defaults: a read-only backend refuses to execute, and
the convergence poll reads over :meth:`MetadataBackend.fetch_topics` with
``isr == replicas``. The watch surface of the resident daemon is not here
(ROADMAP queue 1, item 2).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import (
    Dict, Iterator, List, Mapping, NamedTuple, Optional, Protocol, Sequence,
    Tuple,
)


@dataclass(frozen=True)
class BrokerInfo:
    """One live broker: id/host/port and optional rack, as read from broker
    metadata (``KafkaAssignmentGenerator.java:116-126``)."""

    id: int
    host: str
    port: int
    rack: Optional[str] = None


class PartitionTraffic(NamedTuple):
    """One partition's traffic and lag: produce and consume byte rates and
    the worst consumer-group lag. Backends without real meters serve the
    deterministic synthetic series (``obs/health.py:
    synthetic_partition_traffic``); ``supports_traffic()`` says which."""

    in_bytes: float   # produced bytes/s into this partition
    out_bytes: float  # consumed bytes/s out of this partition
    lag: int          # worst consumer-group lag, in messages


class GroupMember(NamedTuple):
    """One consumer-group member: a stable id and a capacity estimate in
    the weight column's units. ``capacity <= 0`` means unknown, and the
    encoder substitutes the fair-share default (``groups/encode.py``)."""

    member_id: str
    capacity: float = 0.0


class ConsumerGroupState(NamedTuple):
    """One consumer group's packing problem: members, the current
    ``topic -> partition -> member_id`` ownership (``None`` = unowned) and
    ``topic -> partition -> messages`` lag. Partitions may appear in
    ``lags`` without an owner and the other way round; the encoder
    reconciles both against the caller's partition universe."""

    group: str
    members: Tuple[GroupMember, ...]
    assignment: Dict[str, Dict[int, Optional[str]]]
    lags: Dict[str, Dict[int, int]]


class PartitionState(NamedTuple):
    """One partition's assigned replicas and their in-sync subset. Backends
    without ISR visibility report ``isr == replicas``."""

    replicas: List[int]
    isr: List[int]


class MetadataBackend(Protocol):
    """The metadata reads the generator performs, as the reference tool's
    ZkUtils usage (``KafkaAssignmentGenerator.java:106,114,163``).

    ``rack_blind``: True when the backend structurally cannot report broker
    racks (not a cluster that has none configured). Plan-producing CLI
    modes refuse a blind backend unless ``--disable_rack_awareness`` makes
    the opt-out explicit."""

    rack_blind: bool = False

    def brokers(self) -> List[BrokerInfo]: ...

    def all_topics(self) -> List[str]: ...

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]: ...

    def fetch_topics(
        self, topics: Sequence[str], missing: str = "raise"
    ) -> Iterator[Tuple[str, Dict[int, List[int]]]]:
        """Streaming :meth:`partition_assignment`: yield ``(topic,
        {partition: [replica ids]})`` per input entry, in input order, as
        results become available; live backends pipeline the reads
        (``KA_ZK_PIPELINE``) so callers overlap the host encode with the
        remaining round trips.

        ``missing="skip"``: a topic the backend cannot resolve (deleted
        between the listing and the read) yields ``(topic, None)`` and the
        stream keeps flowing; ``--failure-policy best-effort`` skips it.
        The default ``"raise"`` fails fast.

        A real default, not a stub: a backend that subclasses this Protocol
        without overriding it streams over :meth:`partition_assignment`.
        Duck-typed backends without the method are handled by the caller
        (``generator.stream_initial_assignment``)."""
        topics = list(topics)
        if missing == "skip":
            try:
                assignment = self.partition_assignment(topics)
            except Exception as batch_err:
                # Probe per topic; but a backend where nothing resolves is a
                # transport outage, not a cluster with every topic deleted:
                # re-raise the original error.
                assignment = {}
                for t in dict.fromkeys(topics):
                    try:
                        assignment.update(self.partition_assignment([t]))
                    except Exception as per_topic_err:
                        print(
                            f"kafka-assigner: topic {t!r} unresolvable "
                            f"({type(per_topic_err).__name__}: "
                            f"{per_topic_err}); treating as vanished",
                            file=sys.stderr,
                        )
                if not assignment:
                    raise batch_err
            for t in topics:
                yield t, assignment.get(t)
            return
        assignment = self.partition_assignment(topics)
        for t in topics:
            yield t, assignment[t]

    def supports_traffic(self) -> bool:
        """True when :meth:`fetch_partition_traffic` reports real
        observations; False (the default) when the synthetic series
        stands in."""
        return False

    def fetch_partition_traffic(
        self, partitions: Mapping[str, Sequence[int]]
    ) -> Dict[str, Dict[int, PartitionTraffic]]:
        """Per-partition traffic and lag for ``{topic: [partition ids]}``.
        The default is the deterministic synthetic series."""
        from ..obs.health import synthetic_partition_traffic

        return synthetic_partition_traffic(partitions)

    def supports_groups(self) -> bool:
        """True when :meth:`fetch_consumer_groups` reports real group state.
        There is no synthetic fallback behind False: callers refuse, or take
        the synthetic family by explicit opt-in (``--synthetic``)."""
        return False

    def fetch_consumer_groups(
        self, groups: Optional[Sequence[str]] = None
    ) -> Dict[str, ConsumerGroupState]:
        """Consumer-group membership, ownership and lag. The default is a
        loud refusal (``IngestError``), never a synthetic stand-in."""
        from ..errors import IngestError

        raise IngestError(
            f"{type(self).__name__} cannot read consumer groups (no group "
            "membership/offset surface on this backend); use a snapshot "
            "with a \"groups\" section, a Kafka AdminClient with consumer-"
            "group offset support, or opt into the deterministic "
            "synthetic family explicitly (--synthetic)"
        )

    def supports_execution(self) -> bool:
        """True when this backend can write a reassignment and report
        convergence. Default False: ``ka-execute`` refuses a read-only
        backend before it writes a journal."""
        return False

    def apply_assignment(
        self, moves: Dict[str, Dict[int, List[int]]]
    ) -> None:
        """Submit one wave, ``{topic: {partition: [target replicas]}}``.
        Must be idempotent (setting a target twice is a no-op): the engine
        resubmits a wave after a crash or a dropped write. Transport
        failures raise ``OSError`` or ``ZkWireError``; the engine then reads
        the state back before it decides, never replaying blindly."""
        from ..errors import ExecuteError

        raise ExecuteError(
            f"{type(self).__name__} cannot execute reassignments (read-only "
            "metadata backend)"
        )

    def read_assignment_state(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, PartitionState]]:
        """The convergence poll: per topic, per partition, the assigned
        replicas and the in-sync subset. Topics the backend cannot resolve
        are absent from the result. Over the streaming read, with
        ``isr == replicas`` (no ISR visibility)."""
        out: Dict[str, Dict[int, PartitionState]] = {}
        for t, parts in self.fetch_topics(
            list(dict.fromkeys(topics)), missing="skip"
        ):
            if parts is None:
                continue
            out[t] = {
                p: PartitionState(list(r), list(r))
                for p, r in parts.items()
            }
        return out

    def close(self) -> None: ...


def open_backend(connect_string: str) -> MetadataBackend:
    """Open a metadata backend from a ``--zk_string`` connect string:
    ``file:///path.json`` or a ``*.json`` path opens a snapshot,
    ``kafka://host:port,...`` the Kafka AdminClient bridge, and anything
    else a ZooKeeper quorum (``host:port,...[/chroot]``)."""
    if connect_string.startswith("file://"):
        from .snapshot import SnapshotBackend

        return SnapshotBackend(connect_string[len("file://"):])
    if connect_string.endswith(".json"):
        from .snapshot import SnapshotBackend

        return SnapshotBackend(connect_string)
    if connect_string.startswith("kafka://"):
        from .kafka_admin import KafkaAdminBackend

        return KafkaAdminBackend(connect_string[len("kafka://"):])
    from .zk import ZkBackend

    return ZkBackend(connect_string)
