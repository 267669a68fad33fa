"""Live ZooKeeper backend, the read surface of the reference's
``kafka_assigner_tpu/io/zk.py`` (itself the counterpart of the reference
tool's ``ZkClient``/``ZkUtils`` layer, ``KafkaAssignmentGenerator.java:
273-276``). It reads the znodes Kafka's ZkUtils reads:

- ``/brokers/ids/<id>``      -> ``{"host": ..., "port": ..., "rack": ...}``
- ``/brokers/topics``        -> the topic list
- ``/brokers/topics/<name>`` -> ``{"partitions": {"0": [ids...]}}``

Client: ``kazoo`` when installed, else the in-tree wire client
(``io/zkwire.py``), so a live run needs no third-party package;
``KA_ZK_CLIENT={auto,kazoo,wire}`` overrides. Reads are pipelined through
the wire client's xid-matched window, or a window of kazoo's async handles.

``ka-execute`` writes through Kafka's classic reassignment protocol: one
``/admin/reassign_partitions`` znode per wave, which the controller applies
and deletes; the convergence poll reads the topic znodes and, where the
cluster has them, the per-partition ``state`` znodes' ISR.

Not here: the watch methods of the resident daemon (ROADMAP queue 1,
item 2).
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..faults.inject import active_injector
from ..obs.metrics import counter_add, gauge_set
from ..obs.trace import span
from .base import BrokerInfo, PartitionState

# Session and connect timeouts follow the reference tool: new
# ZkClient(zk, 10000, 10000) (KafkaAssignmentGenerator.java:273-274).
ZK_TIMEOUT_S = 10.0

#: Kafka's classic reassignment znode: the controller watches it, moves the
#: replicas it describes and deletes it when every partition has caught
#: up. One reassignment is in flight at a time.
ADMIN_REASSIGN_PATH = "/admin/reassign_partitions"


def _resolve_endpoint(meta: dict, broker_id: str) -> tuple:
    """(host, port) of a broker znode.

    Kafka >= 0.9 brokers with non-PLAINTEXT or several listeners register
    ``host: null`` and an ``endpoints`` list (``"SSL://host:9093"``); the
    reference tool resolves the PLAINTEXT endpoint and fails loudly when
    there is none (``KafkaAssignmentGenerator.java:117,194``). The top-level
    host wins, then the first parseable endpoint; nothing resolvable
    raises rather than returning an unmatchable empty hostname.
    """
    host = meta.get("host")
    if host:
        return host, int(meta.get("port") or 9092)
    for ep in meta.get("endpoints", []):
        rest = ep.split("://", 1)[-1]
        if ":" in rest:
            h, _, p = rest.rpartition(":")
            if h:
                return h, int(p)
    raise ValueError(
        f"broker {broker_id} has no resolvable host (host=null and no "
        f"parseable endpoints in {meta.get('endpoints')!r})"
    )


class ZkBackend:
    def __init__(self, connect_string: str) -> None:
        from ..utils.env import env_choice

        choice = env_choice("KA_ZK_CLIENT")
        client_cls = None
        if choice in ("auto", "kazoo"):
            try:
                from kazoo.client import KazooClient as client_cls
            except ImportError:
                if choice == "kazoo":
                    raise RuntimeError(
                        "KA_ZK_CLIENT=kazoo but the 'kazoo' package is not "
                        "installed"
                    ) from None
        if client_cls is None:
            from .zkwire import MiniZkClient as client_cls
        # The wire client hooks the fault injector at its own socket seams;
        # any other client (kazoo) gets the backend-level twin hooks here,
        # so one KA_FAULTS_SPEC schedule fires whatever the client. The
        # write and converge seams are the backend's for every client.
        self._wire = client_cls.__module__.endswith("zkwire")
        self._faults = active_injector()
        self._binj = None if self._wire else self._faults
        if self._binj is not None:
            self._binj.connect_attempt()  # kazoo's connect seam
        self._zk = client_cls(hosts=connect_string, timeout=ZK_TIMEOUT_S)
        self._zk.start(timeout=ZK_TIMEOUT_S)

    @staticmethod
    def _is_nonode(e: Exception) -> bool:
        """True for any client's missing-znode error: the wire client's
        ``NoNodeError`` or kazoo's (matched by name: kazoo may be absent)."""
        return type(e).__name__ == "NoNodeError"

    def _fault_reply(self) -> None:
        """Backend-level ``reply`` hook for clients that never expose raw
        frames (kazoo); a no-op for the wire client, which injects at the
        socket itself. ``getattr``: harnesses build this backend with
        ``__new__`` and a fake client."""
        binj = getattr(self, "_binj", None)
        if binj is not None:
            binj.backend_reply()

    def _iter_gets(
        self, paths: Sequence[str], missing_ok: bool = False
    ) -> Iterator[Optional[Tuple[bytes, object]]]:
        """``(data, stat)`` per path, in path order, pipelined where the
        client allows: the wire client's ``iter_get`` window; kazoo's async
        handles in a sliding window of ``KA_ZK_PIPELINE``; anything else
        serial gets. Under ``missing_ok`` a missing znode yields ``None``.

        Runs on whatever thread consumes the iterator (the streamed
        ingest's producer thread): metrics only, no spans."""
        if not paths:
            return
        iter_get = getattr(self._zk, "iter_get", None)
        if iter_get is not None:
            yield from iter_get(paths, missing_ok=missing_ok)
            return
        get_async = getattr(self._zk, "get_async", None)
        if get_async is not None:
            from ..utils.env import env_int

            window = env_int("KA_ZK_PIPELINE")
            counter_add("zk.pipeline.batches")
            gauge_set("zk.pipeline.in_flight", min(window, len(paths)))
            counter_add(
                "zk.pipeline.rtts_saved",
                len(paths) - -(-len(paths) // window),
            )

            def _resolve(handle):
                try:
                    self._fault_reply()
                    return handle.get(timeout=ZK_TIMEOUT_S)
                except Exception as e:
                    if missing_ok and self._is_nonode(e):
                        return None
                    raise

            handles: deque = deque()
            for path in paths:
                handles.append(get_async(path))
                if len(handles) >= window:
                    yield _resolve(handles.popleft())
            while handles:
                yield _resolve(handles.popleft())
            return
        for path in paths:
            try:
                self._fault_reply()
                yield self._zk.get(path)
            except Exception as e:
                if missing_ok and self._is_nonode(e):
                    yield None
                else:
                    raise

    def _iter_children(
        self, paths: Sequence[str], missing_ok: bool = False
    ) -> Iterator[Optional[List[str]]]:
        """Child listings per path, in path order: the wire client's
        pipelined ``iter_children`` (the same replay contract as
        ``iter_get``), else serial calls. Under ``missing_ok`` a missing
        znode yields ``None``."""
        if not paths:
            return
        iter_children = getattr(self._zk, "iter_children", None)
        if iter_children is not None:
            yield from iter_children(paths, missing_ok=missing_ok)
            return
        for path in paths:
            try:
                self._fault_reply()
                yield self._zk.get_children(path)
            except Exception as e:
                if missing_ok and self._is_nonode(e):
                    yield None
                else:
                    raise

    def brokers(self) -> List[BrokerInfo]:
        out = []
        with span("zk/brokers"):
            self._fault_reply()
            children = sorted(self._zk.get_children("/brokers/ids"), key=int)
            counter_add("zk.reads")
            paths = [f"/brokers/ids/{bid}" for bid in children]
            for bid, (raw, _) in zip(children, self._iter_gets(paths)):
                counter_add("zk.reads")
                counter_add("zk.bytes", len(raw))
                meta = json.loads(raw)
                host, port = _resolve_endpoint(meta, bid)
                out.append(
                    BrokerInfo(
                        id=int(bid), host=host, port=port,
                        rack=meta.get("rack"),
                    )
                )
        return out

    def all_topics(self) -> List[str]:
        counter_add("zk.reads")
        self._fault_reply()
        return sorted(self._zk.get_children("/brokers/topics"))

    def fetch_topics(
        self, topics: Sequence[str], missing: str = "raise"
    ) -> Iterator[Tuple[str, Optional[Dict[int, List[int]]]]]:
        """Yields ``(topic, {partition: [replica ids]})`` per input entry,
        in input order, as pipelined replies arrive. Duplicates are fetched
        per occurrence. A missing topic (deleted during the scan) raises the
        client's ``NoNodeError`` at its position, or under
        ``missing="skip"`` yields ``(topic, None)`` and keeps streaming."""
        topics = list(topics)
        paths = [f"/brokers/topics/{topic}" for topic in topics]
        stream = self._iter_gets(paths, missing_ok=(missing == "skip"))
        for topic, res in zip(topics, stream):
            if res is None:
                counter_add("zk.topics_missing")
                yield topic, None
                continue
            raw, _ = res
            counter_add("zk.reads")
            counter_add("zk.bytes", len(raw))
            meta = json.loads(raw)
            yield topic, {
                int(p): [int(x) for x in replicas]
                for p, replicas in meta.get("partitions", {}).items()
            }

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        out: Dict[str, Dict[int, List[int]]] = {}
        with span("zk/partition_assignment"):
            for topic, parts in self.fetch_topics(topics):
                out[topic] = parts
        return out

    def supports_traffic(self) -> bool:
        """ZooKeeper stores topology, not meters (byte rates live in the
        brokers' JMX, lag in the consumer coordinators): always False."""
        return False

    def fetch_partition_traffic(self, partitions):
        """The deterministic synthetic series (``obs/health.py``)."""
        from ..obs.health import synthetic_partition_traffic

        return synthetic_partition_traffic(partitions)

    def supports_execution(self) -> bool:
        return True

    def apply_assignment(
        self, moves: Dict[str, Dict[int, List[int]]]
    ) -> None:
        """Submit one wave: create ``/admin/reassign_partitions`` with the
        wave's target in Kafka's reassignment JSON. One reassignment may be
        in flight at a time, so an existing znode (the previous wave's tail,
        another operator's) is waited out within the poll budget
        (``KA_EXEC_POLL_TIMEOUT``), then ours is created. Idempotent:
        re-creating a target after a crash re-describes moves the
        controller has already applied."""
        from ..errors import ExecuteError
        from ..utils.env import env_float
        from .json_io import format_reassignment_json

        payload = format_reassignment_json(
            moves, topic_order=list(moves)
        ).encode("utf-8")
        counter_add("zk.writes")
        # The write seam: `drop` raises before anything reaches the quorum,
        # `lost` acks without applying.
        if self._faults is not None \
                and self._faults.write_attempt() == "lost":
            return
        deadline = time.monotonic() + env_float("KA_EXEC_POLL_TIMEOUT")
        interval = env_float("KA_EXEC_POLL_INTERVAL")
        while True:
            if self._zk.exists(ADMIN_REASSIGN_PATH) is None:
                try:
                    self._zk.create(
                        ADMIN_REASSIGN_PATH, payload, makepath=True
                    )
                    return
                except Exception as e:
                    # A lost create race (another writer): wait and retry.
                    # Any other error propagates.
                    if type(e).__name__ != "NodeExistsError":
                        raise
            if time.monotonic() >= deadline:
                raise ExecuteError(
                    "a partition reassignment is already in flight "
                    f"({ADMIN_REASSIGN_PATH} never cleared within the poll "
                    "budget); re-run with --resume once it completes"
                )
            time.sleep(
                min(interval, max(0.0, deadline - time.monotonic()))
            )

    def read_assignment_state(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, PartitionState]]:
        """The convergence poll: assigned replicas from the topic znodes,
        and the in-sync subset from the per-partition ``state`` znodes, the
        children and the states each read in one pipelined window. Where
        the ``partitions/<p>/state`` layout is absent, ``isr ==
        replicas``."""
        unique = list(dict.fromkeys(topics))
        replicas: Dict[str, Dict[int, List[int]]] = {}
        for t, parts in self.fetch_topics(unique, missing="skip"):
            if parts is not None:
                replicas[t] = parts
        present = [t for t in unique if t in replicas]
        kid_paths = [f"/brokers/topics/{t}/partitions" for t in present]
        isr: Dict[Tuple[str, int], List[int]] = {}
        keys: List[Tuple[str, int]] = []
        state_paths: List[str] = []
        for t, kids in zip(
            present, self._iter_children(kid_paths, missing_ok=True)
        ):
            for kid in kids or ():
                if not kid.lstrip("-").isdigit():
                    continue
                p = int(kid)
                if p in replicas[t]:
                    keys.append((t, p))
                    state_paths.append(
                        f"/brokers/topics/{t}/partitions/{kid}/state"
                    )
        for (t, p), res in zip(
            keys, self._iter_gets(state_paths, missing_ok=True)
        ):
            if res is None:
                continue
            raw, _ = res
            counter_add("zk.reads")
            counter_add("zk.bytes", len(raw))
            try:
                got = json.loads(raw).get("isr")
            except ValueError:  # unparsable: replicas stand in, below
                continue
            if isinstance(got, list):
                isr[(t, p)] = [int(x) for x in got]
        return {
            t: {
                p: PartitionState(
                    list(reps), isr.get((t, p), list(reps))
                )
                for p, reps in parts.items()
            }
            for t, parts in replicas.items()
        }

    def close(self) -> None:
        self._zk.stop()
        self._zk.close()
