"""Kafka AdminClient bridge (``--zk_string kafka://host:port,...``): the
read, traffic and consumer-group surfaces of the reference's
``kafka_assigner_tpu/io/kafka_admin.py``, for clusters that deny direct
ZooKeeper access.

Needs ``confluent_kafka`` or ``kafka-python`` (``kafka``) at run time and
raises a clear error when neither is installed.

confluent-kafka's AdminClient metadata carries no broker racks, so that
path is rack-blind (``rack_blind = True``): plan-producing CLI modes refuse
it unless ``--disable_rack_awareness`` makes the opt-out explicit, and
``brokers()`` warns once on stderr for the inspection modes. kafka-python's
``describe_cluster`` carries racks.

``ka-execute`` writes through KIP-455's ``alter_partition_reassignments``
where the client has it (kafka-python); confluent-kafka has no
reassignment API, so that backend refuses to execute. Both clients report
per-partition ISR for the convergence poll.
"""
from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..faults.inject import active_injector
from ..obs.metrics import counter_add, hist_ms
from .base import BrokerInfo, PartitionState


class KafkaAdminBackend:
    rack_blind = False  # set below when the confluent client is chosen

    def __init__(self, bootstrap_servers: str) -> None:
        self._impl = None
        self._warned_rack_blind = False
        # The AdminClient never exposes wire frames, so the backend-level
        # twin hooks fire the KA_FAULTS_SPEC schedule here: connect at
        # construction, reply per metadata RPC (nonode maps to KeyError,
        # the missing-topic class `_is_unknown_topic` recognizes).
        self._faults = active_injector()
        if self._faults is not None:
            self._faults.connect_attempt()
        try:
            from confluent_kafka.admin import AdminClient  # type: ignore

            self._impl = "confluent"
            self.rack_blind = True
            self._admin = AdminClient({"bootstrap.servers": bootstrap_servers})
        except ImportError:
            try:
                from kafka import KafkaAdminClient  # type: ignore

                self._impl = "kafka-python"
                self._admin = KafkaAdminClient(bootstrap_servers=bootstrap_servers)
            except ImportError as e:
                raise RuntimeError(
                    "Kafka AdminClient access requires 'confluent-kafka' or "
                    "'kafka-python'; use a file://cluster.json snapshot for "
                    "offline runs"
                ) from e

    def _fault_reply(self) -> None:
        """Per-RPC ``reply`` hook: ``nonode`` becomes ``KeyError`` (the
        unknown-topic class), ``drop``/``trunc`` a connection loss."""
        if self._faults is not None:
            self._faults.backend_reply(missing_exc=KeyError)

    def brokers(self) -> List[BrokerInfo]:
        counter_add("zk.reads")  # the metadata-read namespace of every backend
        self._fault_reply()
        if self._impl == "confluent":
            with hist_ms("zk.op_ms"):
                md = self._admin.list_topics(timeout=10)
            if not self._warned_rack_blind:
                self._warned_rack_blind = True
                print(
                    "WARNING: confluent-kafka's AdminClient metadata carries "
                    "no broker rack info; every broker is treated as its own "
                    "rack and rack-aware assignment CANNOT guarantee rack "
                    "diversity. Use the zk:// or file:// backend (or install "
                    "kafka-python) when racks matter.",
                    file=sys.stderr,
                )
            return [
                BrokerInfo(id=b.id, host=b.host, port=b.port, rack=None)
                for b in sorted(md.brokers.values(), key=lambda b: b.id)
            ]
        with hist_ms("zk.op_ms"):
            cluster = self._admin.describe_cluster()
        return [
            BrokerInfo(
                id=int(b["node_id"]), host=b["host"], port=int(b["port"]),
                rack=b.get("rack"),
            )
            for b in sorted(cluster["brokers"], key=lambda b: int(b["node_id"]))
        ]

    def all_topics(self) -> List[str]:
        counter_add("zk.reads")
        self._fault_reply()
        if self._impl == "confluent":
            with hist_ms("zk.op_ms"):
                md = self._admin.list_topics(timeout=10)
            return sorted(md.topics)
        with hist_ms("zk.op_ms"):
            names = self._admin.list_topics()
        return sorted(names)

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        counter_add("zk.reads")
        self._fault_reply()
        out: Dict[str, Dict[int, List[int]]] = {}
        if self._impl == "confluent":
            with hist_ms("zk.op_ms"):
                md = self._admin.list_topics(timeout=10)
            for topic in topics:
                tmeta = md.topics[topic]
                out[topic] = {
                    int(p): list(pm.replicas) for p, pm in tmeta.partitions.items()
                }
            return out
        with hist_ms("zk.op_ms"):
            described = self._admin.describe_topics(topics)
        for t in described:
            out[t["topic"]] = {
                int(p["partition"]): [int(r) for r in p["replicas"]]
                for p in t["partitions"]
            }
        return out

    def fetch_topics(
        self, topics: Sequence[str], missing: str = "raise"
    ) -> Iterator[Tuple[str, Optional[Dict[int, List[int]]]]]:
        """The AdminClient's metadata call is one batched RPC, so this
        fetches once and yields per input entry in input order. Under
        ``missing="skip"`` a topic absent from the metadata yields
        ``(topic, None)`` instead of raising ``KeyError``."""
        topics = list(topics)
        if missing == "skip":
            for t, parts in zip(topics, self._fetch_skip_missing(topics)):
                yield t, parts
            return
        assignment = self.partition_assignment(topics)
        for t in topics:
            yield t, assignment[t]

    @staticmethod
    def _is_unknown_topic(e: Exception) -> bool:
        """Missing-topic errors only (``KeyError`` from the confluent
        metadata map, kafka-python's ``UnknownTopicOrPartitionError`` by
        name): a transport failure must stay an ingest failure."""
        return isinstance(e, KeyError) or "UnknownTopic" in type(e).__name__

    def _fetch_skip_missing(self, topics):
        """One batched RPC first; per-topic probes only when the batch fails
        on a missing topic. Returns per-entry assignments (None = gone)."""
        unique = list(dict.fromkeys(topics))
        try:
            assignment = self.partition_assignment(unique)
        except Exception as e:
            if not self._is_unknown_topic(e):
                raise
            assignment = {}
            for t in unique:
                try:
                    assignment.update(self.partition_assignment([t]))
                except Exception as per_topic_err:
                    if not self._is_unknown_topic(per_topic_err):
                        raise
                    print(
                        f"kafka-assigner: topic {t!r} unknown to the "
                        "AdminClient; treating as vanished",
                        file=sys.stderr,
                    )
        return [assignment.get(t) for t in topics]

    # -- traffic and lag ---------------------------------------------------

    def supports_traffic(self) -> bool:
        """Real consumer-group lag only when the whole chain is present:
        group listing, committed offsets per group, and an end-offset
        source (``end_offsets`` on the admin object or an attached
        ``_client``). Byte rates need JMX, which no AdminClient exposes:
        they stay synthetic either way."""
        return (
            self._impl == "kafka-python"
            and hasattr(self._admin, "list_consumer_groups")
            and hasattr(self._admin, "list_consumer_group_offsets")
            and self._end_offsets_fn() is not None
        )

    def _end_offsets_fn(self):
        """The batched ``end_offsets(list[TP]) -> {TP: offset}`` callable
        of the admin object or its ``_client``, or None."""
        for holder in (self._admin, getattr(self._admin, "_client", None)):
            fn = getattr(holder, "end_offsets", None)
            if callable(fn):
                return fn
        return None

    def fetch_partition_traffic(self, partitions):
        """Synthetic byte rates always; the lag column is the real worst
        group lag when the client carries the offset chain. A failed lag
        sweep degrades loudly to the synthetic column."""
        from ..obs.health import synthetic_partition_traffic

        out = synthetic_partition_traffic(partitions)
        if not self.supports_traffic():
            return out
        try:
            lags = self._real_lags(partitions)
        except Exception as e:
            print(
                f"kafka-assigner: consumer-group lag sweep failed "
                f"({type(e).__name__}: {e}); serving synthetic lag",
                file=sys.stderr,
            )
            return out
        for topic, per in out.items():
            for p, tr in per.items():
                if (topic, p) in lags:
                    per[p] = tr._replace(lag=lags[(topic, p)])
        return out

    def _real_lags(self, partitions):
        """Worst lag per (topic, partition) over every group the client
        reports; the end offsets are one batched call over the wanted set."""
        from kafka import TopicPartition  # type: ignore

        wanted = {
            (t, int(p)) for t, parts in partitions.items() for p in parts
        }
        ends_raw = self._end_offsets_fn()(
            [TopicPartition(t, p) for t, p in sorted(wanted)]
        )
        ends = {
            (tp.topic, int(tp.partition)): off
            for tp, off in ends_raw.items() if off is not None
        }
        lags = {}
        groups = [
            g[0] if isinstance(g, tuple) else g
            for g in self._admin.list_consumer_groups()
        ]
        for group in groups:
            offsets = self._admin.list_consumer_group_offsets(group)
            for tp, meta in offsets.items():
                key = (tp.topic, int(tp.partition))
                if key not in wanted or key not in ends:
                    continue
                committed = getattr(meta, "offset", None)
                if committed is None or committed < 0:
                    continue
                lag = max(0, int(ends[key]) - int(committed))
                lags[key] = max(lags.get(key, 0), lag)
        return lags

    # -- consumer groups ---------------------------------------------------

    def supports_groups(self) -> bool:
        """The lag chain of :meth:`supports_traffic` plus group description
        for membership; anything less keeps the loud refusal."""
        return self.supports_traffic() and hasattr(
            self._admin, "describe_consumer_groups"
        )

    def fetch_consumer_groups(self, groups=None):
        """Membership from one batched ``describe_consumer_groups`` (member
        assignments taken as parsed ``(topic, partitions)`` pairs, skipped
        when only opaque bytes are exposed), ownership from those
        assignments, and each group's own lag from its committed offsets
        against one batched end-offset read. Capacities are not observable
        over an admin connection: members report 0 (unknown)."""
        from ..errors import IngestError
        from .base import ConsumerGroupState, GroupMember

        if not self.supports_groups():
            raise IngestError(
                "this Kafka AdminClient cannot read consumer groups (needs "
                "kafka-python with list/describe_consumer_groups, "
                "list_consumer_group_offsets and an end_offsets source); "
                "use a snapshot with a \"groups\" section or --synthetic"
            )
        self._fault_reply()
        counter_add("zk.reads")
        if groups is None:
            groups = [
                g[0] if isinstance(g, tuple) else g
                for g in self._admin.list_consumer_groups()
            ]
        wanted_groups = list(dict.fromkeys(groups))
        with hist_ms("zk.op_ms"):
            all_described = self._admin.describe_consumer_groups(
                wanted_groups
            )
        described_of: Dict[str, list] = {g: [] for g in wanted_groups}
        unattributed = False
        for desc in all_described:
            gid = str(getattr(desc, "group", getattr(desc, "group_id", "")))
            if gid:
                described_of.setdefault(gid, []).append(desc)
            else:
                unattributed = True
        if unattributed:
            # Descriptions without a group id come back in request order.
            described_of = {
                g: [d] for g, d in zip(wanted_groups, all_described)
            }
        out = {}
        for group in wanted_groups:
            members = []
            assignment: Dict[str, Dict[int, str]] = {}
            for desc in described_of.get(group, []):
                for m in getattr(desc, "members", []) or []:
                    member_id = str(getattr(m, "member_id", m))
                    members.append(GroupMember(member_id, 0.0))
                    massign = getattr(m, "member_assignment", None)
                    pairs = getattr(massign, "assignment", None)
                    if not pairs:
                        continue  # opaque bytes: ownership unknown
                    for topic, parts in pairs:
                        per = assignment.setdefault(str(topic), {})
                        for p in parts:
                            per[int(p)] = member_id
            offsets = self._admin.list_consumer_group_offsets(group)
            lags: Dict[str, Dict[int, int]] = {}
            if offsets:
                ends_raw = self._end_offsets_fn()(sorted(
                    offsets, key=lambda tp: (tp.topic, int(tp.partition))
                ))
                ends = {
                    (tp.topic, int(tp.partition)): off
                    for tp, off in ends_raw.items() if off is not None
                }
                for tp, meta in offsets.items():
                    key = (tp.topic, int(tp.partition))
                    committed = getattr(meta, "offset", None)
                    if key not in ends or committed is None \
                            or committed < 0:
                        continue
                    lags.setdefault(key[0], {})[key[1]] = max(
                        0, int(ends[key]) - int(committed)
                    )
            out[group] = ConsumerGroupState(
                group=group,
                members=tuple(sorted(members)),
                assignment=assignment,
                lags=lags,
            )
        return out

    def supports_execution(self) -> bool:
        """True when the client has KIP-455's
        ``alter_partition_reassignments`` (kafka-python); confluent-kafka
        has no reassignment API. ``ka-execute`` refuses a backend that
        cannot write before it writes a journal."""
        return self._impl == "kafka-python" and hasattr(
            self._admin, "alter_partition_reassignments"
        )

    def apply_assignment(
        self, moves: Dict[str, Dict[int, List[int]]]
    ) -> None:
        from ..errors import ExecuteError

        if not self.supports_execution():
            raise ExecuteError(
                "this Kafka AdminClient cannot execute reassignments "
                "(no KIP-455 alter_partition_reassignments support); "
                "execute against the zk:// backend instead"
            )
        counter_add("zk.writes")
        if self._faults is not None \
                and self._faults.write_attempt() == "lost":
            return
        # KIP-455: {(topic, partition): [target replicas]}.
        with hist_ms("zk.op_ms"):
            self._admin.alter_partition_reassignments({
                (t, int(p)): [int(r) for r in reps]
                for t, parts in moves.items()
                for p, reps in parts.items()
            })

    def read_assignment_state(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, PartitionState]]:
        """The convergence poll over the AdminClient's metadata, with each
        partition's real ISR (confluent ``isrs``, kafka-python ``isr``).
        The ``converge`` stall seam is the snapshot backend's only (it
        freezes pending state, which this backend does not hold); the
        ``reply`` seam covers this RPC."""
        self._fault_reply()
        unique = list(dict.fromkeys(topics))
        out: Dict[str, Dict[int, PartitionState]] = {}
        if self._impl == "confluent":
            with hist_ms("zk.op_ms"):
                md = self._admin.list_topics(timeout=10)
            for t in unique:
                tmeta = md.topics.get(t)
                if tmeta is None:
                    continue
                out[t] = {
                    int(p): PartitionState(
                        [int(r) for r in pm.replicas],
                        [int(r) for r in getattr(pm, "isrs", pm.replicas)],
                    )
                    for p, pm in tmeta.partitions.items()
                }
            return out
        try:
            with hist_ms("zk.op_ms"):
                described = self._admin.describe_topics(unique)
        except Exception as e:
            if not self._is_unknown_topic(e):
                raise
            # One vanished topic must not blank the whole poll: probe per
            # topic and leave out only the vanished ones.
            described = []
            for t in unique:
                try:
                    described.extend(self._admin.describe_topics([t]))
                except Exception as per_topic_err:
                    if not self._is_unknown_topic(per_topic_err):
                        raise
        for t in described:
            out[t["topic"]] = {
                int(p["partition"]): PartitionState(
                    [int(r) for r in p["replicas"]],
                    [int(r) for r in p.get("isr", p["replicas"])],
                )
                for p in t["partitions"]
            }
        return out

    def close(self) -> None:
        if self._impl == "kafka-python":
            self._admin.close()
