"""The daemon's resident cluster state: the metadata cache and the
incremental group encode, the port of the reference's
``kafka_assigner_tpu/daemon/state.py``.

One :class:`DaemonState` lives as long as the daemon. It holds what a fresh
CLI run would derive from scratch (the broker list, every topic's partition
assignment and the batched group encode) and keeps it fresh by deltas: a
watch event names the touched topic, the daemon re-reads that znode alone,
and :meth:`DaemonState.apply_topic` re-encodes that topic alone into the
``GroupEncodeAccumulator`` delta store (``models/problem.py``). A served
``/plan`` then takes its encode from ``merge(topic_order)``, the same bytes
as a from-scratch ``encode_topic_group`` of the same state, instead of
re-reading and re-encoding the cluster.

Threads: the watch thread mutates, request threads read, one lock guards
both. :meth:`DaemonState.plan_inputs` copies what it returns under the lock,
so the solve runs on private arrays.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..io.base import BrokerInfo
from ..models.problem import GroupEncodeAccumulator

#: Topics per batched encode chunk when a full resync seeds the delta store
#: (the chunk size of the streamed ingest's encode).
RESYNC_CHUNK = 64


class CacheBackend:
    """A read-only metadata backend over the daemon's cache: ``/plan`` and
    ``/whatif`` run the CLI's own pipeline (``generator.py``) against it,
    only the metadata reads answered from memory."""

    rack_blind = False

    def __init__(self, state: "DaemonState") -> None:
        self._state = state

    def brokers(self) -> List[BrokerInfo]:
        return self._state.brokers()

    def all_topics(self) -> List[str]:
        return self._state.topic_names()

    def partition_assignment(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        return self._state.assignments(topics)

    def fetch_topics(
        self, topics: Sequence[str], missing: str = "raise"
    ) -> Iterator[Tuple[str, Optional[Dict[int, List[int]]]]]:
        if missing == "skip":
            # Filter and copy in one locked read: a watch-thread delete
            # between a membership check and the read would turn the skip
            # path into a KeyError.
            known = self._state.assignments_present(topics)
            for t in topics:
                yield t, known.get(t)
            return
        assignment = self._state.assignments(list(topics))
        for t in topics:
            yield t, assignment[t]

    def close(self) -> None:
        pass


class DaemonState:
    """The cache and the delta encode behind one coarse lock (module
    docstring)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._brokers: List[BrokerInfo] = []
        self._topics: Dict[str, Dict[int, List[int]]] = {}
        self._acc: Optional[GroupEncodeAccumulator] = None
        #: Bumped by every applied change; ``/state`` shows it.
        self.version = 0
        #: True while the cache is known or suspected to lag the cluster (a
        #: session loss, a failed resync); a completed resync clears it.
        #: Served responses carry it as ``status: "degraded"``.
        self.stale = True
        self.synced_once = False
        #: The wall, in ms, of the last full resync's delta-store seeding
        #: (the rest of a ``daemon/resync`` span is the metadata reads).
        self.seed_ms: Optional[float] = None

    # -- readers --------------------------------------------------------------

    def brokers(self) -> List[BrokerInfo]:
        with self._lock:
            return list(self._brokers)

    def topic_names(self) -> List[str]:
        with self._lock:
            return sorted(self._topics)

    def assignments(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        with self._lock:
            missing = [t for t in topics if t not in self._topics]
            if missing:
                raise KeyError(f"topics not in the daemon cache: {missing}")
            return {
                t: {p: list(r) for p, r in self._topics[t].items()}
                for t in topics
            }

    def assignments_present(
        self, topics: Sequence[str]
    ) -> Dict[str, Dict[int, List[int]]]:
        """The known subset of ``topics``, filtered and copied under one
        lock acquisition (the skip path's atomic read)."""
        with self._lock:
            return {
                t: {p: list(r) for p, r in self._topics[t].items()}
                for t in topics if t in self._topics
            }

    def broker_id_set(self) -> Set[int]:
        with self._lock:
            return {b.id for b in self._brokers}

    def rack_map(self) -> Dict[int, str]:
        with self._lock:
            return {
                b.id: b.rack for b in self._brokers if b.rack is not None
            }

    def encode_cluster(self):
        """The broker and rack encoding under the delta store (the warm
        hook predicts the solve's signature from it)."""
        with self._lock:
            return self._acc.cluster if self._acc is not None else None

    def all_assignments(self) -> Dict[str, Dict[int, List[int]]]:
        with self._lock:
            return {
                t: {p: list(r) for p, r in parts.items()}
                for t, parts in self._topics.items()
            }

    def encode_shape(self) -> Optional[tuple]:
        with self._lock:
            if self._acc is None:
                return None
            return self._acc.delta_shape() or (0, 0)

    # -- mutations (the watch thread) ------------------------------------------

    def reset(
        self,
        brokers: Sequence[BrokerInfo],
        topics: Dict[str, Dict[int, List[int]]],
    ) -> None:
        """Full resync: replace the cache and seed a new delta store, in
        :data:`RESYNC_CHUNK`-topic chunks of the batched encode. The seeding
        runs outside the lock and the swap under it: a concurrent
        :meth:`plan_inputs` sees the old state or the new, never a mix."""
        t0 = time.perf_counter()
        acc = GroupEncodeAccumulator(
            {b.id: b.rack for b in brokers if b.rack is not None},
            {b.id for b in brokers},
        )
        items = list(topics.items())
        for i in range(0, len(items), RESYNC_CHUNK):
            acc.update_topics(items[i:i + RESYNC_CHUNK])
        seed_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.seed_ms = seed_ms
            self._brokers = list(brokers)
            self._topics = {
                t: {int(p): [int(r) for r in reps] for p, reps in parts.items()}
                for t, parts in topics.items()
            }
            self._acc = acc
            self.version += 1
            self.stale = False
            self.synced_once = True

    def apply_topic(
        self, topic: str, parts: Optional[Dict[int, List[int]]]
    ) -> bool:
        """One delta: a topic added or changed (``parts``) or deleted
        (None). Re-encodes the touched topic alone; returns True when a
        re-encode happened (counted as ``daemon.reencode.topics``)."""
        with self._lock:
            if self._acc is None:
                return False  # never synced: the pending full resync covers it
            if parts is None:
                self._topics.pop(topic, None)
                self._acc.delete_topic(topic)
                self.version += 1
                return False
            clean = {
                int(p): [int(r) for r in reps] for p, reps in parts.items()
            }
            self._topics[topic] = clean
            self._acc.update_topics([(topic, clean)])
            self.version += 1
            return True

    def mark_stale(self) -> None:
        with self._lock:
            self.stale = True

    # -- the request side --------------------------------------------------------

    def plan_inputs(self, topic_list: Sequence[str], want_encode: bool):
        """The ``(initial, preencoded)`` pair ``stream_initial_assignment``
        would give for this topic order: ``initial`` copied out and
        ``preencoded`` assembled by ``merge`` (fresh arrays), both under the
        lock so a concurrent delta cannot tear them."""
        with self._lock:
            initial = self.assignments(topic_list)
            preencoded = None
            if want_encode and self._acc is not None:
                preencoded = self._acc.merge(list(topic_list))
            return initial, preencoded
