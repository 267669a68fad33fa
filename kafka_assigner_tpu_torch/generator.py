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

Each entry records the reference's spans (``metadata/assignment``,
``ingest/stream``, ``feasibility``, ``plan/solve``, ``plan/emit``,
``plan/fresh``, ``whatif/rank``) and ``plan.*`` gauges
(:func:`record_plan_stats`) while an obs capture is active. Mode 3 reads
its metadata through :func:`stream_initial_assignment`, the reference's
streamed ingest (:446-629): pipelined reads on a live backend, and on the
device lane the group encode built while the replies arrive, handed to the
solve as its ``preencoded`` group; the first encoded chunk also starts the
warm-up thread (:func:`_start_warmup_thread`, ``solvers/warmup.py``), which
makes the predicted solve resident on the device while the rest of the
metadata arrives. Mode 3 takes the reference's failure
policy (:684-790): under ``best-effort`` a topic that vanished mid-scan is
skipped and a crashed solve falls back to the greedy lane; what the run
survived lands in a :class:`Degradation`. Under ``strict`` a failed metadata
read (a missing topic, a refused endpoint, a dropped session) is an
:class:`~.errors.IngestError` as in the reference (:688-702), and a solver
crash is a :class:`~.errors.SolveError`. The other modes leave their read's
``KeyError`` untagged, as the reference does.

JSON goes to stdout, diagnostics to stderr.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import sys
import threading
from typing import Dict, List, Optional, Sequence, Set, TextIO, Tuple

from .assigner import TopicAssigner
from .errors import IngestError, SolveError
from .io.json_io import (
    format_brokers_json,
    format_reassignment_json,
    format_reassignment_pairs,
)
from .io.base import BrokerInfo
from .io.zkwire import ZkWireError
from .obs.metrics import gauge_set, obs_active
from .obs.trace import span
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
    the same sweep. The sweep spreads over every visible card of
    ``device`` (and every rank of a process group) on the scenario axis, as
    the reference's CLI does (``generator.py:201-209``); on one card the
    path does not change."""
    from .parallel import mesh as mesh_mod
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
    # The scenario axis is embarrassingly parallel (sharded == unsharded is
    # test-pinned); only the CLI auto-meshes, the library call stays
    # explicit.
    mesh = mesh_mod.auto_mesh(device)

    topic_map = {t: initial[t] for t in topic_list}
    racks = {k: v for k, v in rack_assignment.items() if k in brokers}
    if scenario_file is not None:
        scenarios = load_scenario_file(scenario_file, live_brokers)
        with span("whatif/rank"):
            results = evaluate_removal_scenarios(
                topic_map, brokers, racks, scenarios,
                desired_replication_factor, device=device, mesh=mesh,
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
        with span("whatif/rank"):
            ranked = rank_decommission_candidates(
                topic_map, brokers, racks,
                sorted(candidate_brokers) if candidate_brokers else None,
                desired_replication_factor, device=device, mesh=mesh,
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


def record_plan_stats(
    initial: Dict[str, Dict[int, List[int]]],
    final_pairs: Sequence[tuple],
) -> None:
    """The plan gauges (``plan.*``, the run report's ``plan`` section), as
    the reference's (``generator.py:295-312``): moved replicas (new broker
    acquisitions), leader churn (partitions whose replica slot 0 changed)
    and plan size. Call sites gate on ``obs_active`` so the disabled mode
    never pays the diff."""
    moves = churn = partitions = 0
    for topic, new in final_pairs:
        old = initial.get(topic, {})
        for p, replicas in new.items():
            partitions += 1
            before = list(old.get(p, []))
            moves += len(set(replicas) - set(before))
            lead_new = replicas[0] if replicas else None
            lead_old = before[0] if before else None
            if lead_new != lead_old:
                churn += 1
    gauge_set("plan.moves", moves)
    gauge_set("plan.leader_churn", churn)
    gauge_set("plan.topics", len(final_pairs))
    gauge_set("plan.partitions", partitions)


@dataclasses.dataclass
class Degradation:
    """What a ``best-effort`` run survived: the record the CLI turns into
    the degraded-success exit code."""

    topics_skipped: List[str] = dataclasses.field(default_factory=list)
    solve_fallbacks: int = 0

    def any(self) -> bool:
        return bool(self.topics_skipped or self.solve_fallbacks)


def _note_skipped(topic: str, skipped: List[str]) -> None:
    """Record one vanished topic, loud on stderr per occurrence (the
    operator must see what the plan will not cover)."""
    skipped.append(topic)
    print(
        f"kafka-assigner: best-effort: topic {topic!r} vanished during the "
        "metadata scan; skipping it",
        file=sys.stderr,
    )


def _is_ingest_failure(e: BaseException) -> bool:
    """Failure classes mode 3's metadata read tags as :class:`IngestError`,
    as ``kafka_assigner_tpu/generator.py:315-322`` does: the wire client's
    errors, socket and file errors, the snapshot's ``KeyError``, and kazoo's
    exception tree, matched by ancestor name (kazoo may not be installed)."""
    if isinstance(e, (ZkWireError, OSError, KeyError)):
        return True
    return any(c.__name__ == "KazooException" for c in type(e).__mro__)


#: Warm-up threads still running (a thread that outlives its run would
#: write metrics into the next run's capture; :func:`join_warmup_threads`
#: drains them).
_LIVE_WARMUPS: List[threading.Thread] = []
_WARMUP_LOCK = threading.Lock()


def join_warmup_threads(timeout: float = 60.0) -> None:
    """Wait for any still-running warm-up threads (a no-op in the common
    case: a rightly predicted warm-up ends before its own solve does). The
    CLI calls it at the end of every run, before the report is built. A
    thread still running after ``timeout`` stays listed for the next join,
    with a stderr warning that its metrics may land in a later capture."""
    with _WARMUP_LOCK:
        threads, _LIVE_WARMUPS[:] = list(_LIVE_WARMUPS), []
    for t in threads:
        t.join(timeout)
    alive = [t for t in threads if t.is_alive()]
    if alive:
        with _WARMUP_LOCK:
            _LIVE_WARMUPS[:0] = alive
        print(
            f"kafka-assigner: {len(alive)} warm-up thread(s) still running after "
            f"{timeout:g} s; their metrics may land in a later run's report",
            file=sys.stderr,
        )


def _start_warmup_thread(acc, n_topics: int, desired_rf: int, device):
    """Start the ingest-overlapped warm-up (the reference's
    ``generator.py:542-600``) once the first encoded chunk reveals the
    partition and width buckets: a daemon thread makes the predicted solve
    resident on ``device`` while the rest of the metadata is in flight.

    A crash of any kind (the injected ``warmup:i=crash`` included, consumed
    here on the orchestration thread so a process's fault indexes stay
    coherent) degrades to the cold path with a stderr warning and a
    ``warmup.failures`` count, never to a failed solve. Returns the thread,
    or None when the warm-up is off (``KA_WARMUP=0``), no ``device`` was
    named, nothing was encoded yet, or the injected crash fired."""
    import time

    from .obs.metrics import counter_add
    from .obs.trace import record_span
    from .utils.env import env_bool

    if device is None or not env_bool("KA_WARMUP"):
        return None
    shape = acc.peek_shape()
    if shape is None:
        return None
    p_pad, width = shape
    rf = desired_rf if desired_rf > 0 else width

    try:
        from .faults.inject import fault_point

        fault_point("warmup")
    except BaseException as e:
        counter_add("warmup.failures")
        print(
            f"kafka-assigner: warm-up failed ({type(e).__name__}: {e}); "
            "continuing on the cold compile path",
            file=sys.stderr,
        )
        return None

    def _warm() -> None:
        t0 = time.perf_counter()
        ok = True
        try:
            from .solvers.warmup import warm_solver_programs

            outcomes = warm_solver_programs(
                acc.cluster, n_topics, p_pad, width, rf, device=device
            )
            for outcome in outcomes.values():
                counter_add(f"warmup.{outcome}")
                if outcome == "error":
                    ok = False
        except BaseException as e:
            ok = False
            counter_add("warmup.failures")
            print(
                f"kafka-assigner: warm-up failed ({type(e).__name__}: {e}); "
                "continuing on the cold compile path",
                file=sys.stderr,
            )
        finally:
            record_span("warmup", (time.perf_counter() - t0) * 1000.0, ok)

    t = threading.Thread(target=_warm, name="ka-warmup", daemon=True)
    with _WARMUP_LOCK:
        _LIVE_WARMUPS.append(t)
    t.start()
    return t


#: Sentinel closing the ingest stream (the producer finished cleanly).
_INGEST_DONE = object()

#: What the latest streamed ingest of this process did: ``topics``
#: streamed, encode ``chunks`` and the ``codecs`` they took, ``encode_ms``
#: and ``overlap_ms`` (the share of it done while replies were still in
#: flight), whether a ``preencoded`` group came out, and ``solve_encode``,
#: what the solve's encode then did (``"preencoded"`` when it took the
#: group; set by mode 3 after its solve).
last_ingest: Dict[str, object] = {}


def stream_initial_assignment(
    backend,
    topic_list: Sequence[str],
    brokers: Optional[Set[int]] = None,
    rack_assignment: Optional[Dict[int, str]] = None,
    want_encode: bool = False,
    failure_policy: str = "strict",
    skipped: Optional[List[str]] = None,
    desired_rf: int = -1,
    device: Optional[str] = None,
) -> Tuple[Dict[str, Dict[int, List[int]]], Optional[tuple]]:
    """Metadata ingest overlapped with the host encode, as the reference's
    (``kafka_assigner_tpu/generator.py:446-629``).

    A producer thread drains ``backend.fetch_topics`` (pipelined reads on a
    live backend, ``KA_ZK_PIPELINE``) into a queue, while this thread folds
    arrived topics into the batched host encode in ``KA_ZK_INGEST_CHUNK``
    chunks (:class:`~.models.problem.GroupEncodeAccumulator`), so the encode
    hides inside the fetch. The producer only reads sockets: nothing on it
    touches torch or the card. Returns ``(initial, preencoded)``:
    ``initial`` is exactly ``backend.partition_assignment(topic_list)``,
    ``preencoded`` the ``encode_topic_group`` result for the same topic
    order, or None when no encode was asked for (``want_encode`` with
    ``brokers``), the backend has no ``fetch_topics``, or ``KA_ZK_OVERLAP=0``
    (the solver then encodes; the output is the same either way).

    The first encoded chunk (or the tail chunk, when the run fit in one)
    starts the warm-up thread on ``device``, the solve's device (mode 3
    passes it; without one no warm-up starts), at most once per run;
    ``desired_rf`` (the CLI's ``--desired_replication_factor``, -1 to
    infer) is only its hint for the replica width and never changes the
    returned data.

    ``failure_policy="best-effort"``: a topic that vanished mid-scan is
    appended to ``skipped`` (warned per occurrence on stderr), left out of
    ``initial`` and of the preencode, and the stream keeps flowing. A
    backend whose ``fetch_topics`` predates ``missing=`` degrades to strict
    with a stderr notice.

    A producer-side exception (missing znode, wire error, missing snapshot
    topic) is re-raised here, on the consumer thread, so spans and the run
    report see it as they would a serial read's. A consumer-side abort
    leaves the daemon producer blocked on its socket; the CLI's
    ``backend.close()`` on the unwind path errors it out.
    """
    from .utils.env import env_bool, env_int

    best_effort = failure_policy == "best-effort"
    if skipped is None:
        skipped = []
    fetch = getattr(backend, "fetch_topics", None)
    last_ingest.clear()

    def _open_stream():
        if best_effort:
            try:
                return fetch(topic_list, missing="skip")
            except TypeError:
                print(
                    "kafka-assigner: this metadata backend predates the "
                    "missing-topic degradation contract; --failure-policy "
                    "best-effort degrades to strict for ingest",
                    file=sys.stderr,
                )
        return fetch(topic_list)

    if fetch is None or not env_bool("KA_ZK_OVERLAP"):
        if fetch is not None and best_effort:
            # Overlap off but degradation asked for: drain the stream
            # inline so vanished topics can still be skipped per entry.
            initial = {}
            with span("ingest/stream"):
                for topic, parts in _open_stream():
                    if parts is None:
                        _note_skipped(topic, skipped)
                        continue
                    initial[topic] = parts
            if obs_active():
                gauge_set("ingest.topics", len(initial))
                gauge_set("ingest.topics_skipped", len(skipped))
            return initial, None
        return backend.partition_assignment(topic_list), None

    acc = None
    if want_encode and brokers is not None:
        from .models.problem import GroupEncodeAccumulator

        acc = GroupEncodeAccumulator(rack_assignment or {}, brokers)

    if acc is None:
        # Nothing to overlap: the pipelined fetch is the whole gain, so
        # drain the stream inline (no producer thread, no queue hops).
        initial = {}
        streamed = 0
        with span("ingest/stream"):
            for topic, parts in _open_stream():
                if parts is None:
                    _note_skipped(topic, skipped)
                    continue
                initial[topic] = parts
                streamed += 1
        last_ingest.update(topics=streamed, preencoded=False)
        if obs_active():
            gauge_set("ingest.topics", streamed)
            if best_effort:
                gauge_set("ingest.topics_skipped", len(skipped))
        return initial, None

    q: "queue.Queue" = queue.Queue()
    producer_done = threading.Event()

    def _produce() -> None:
        try:
            for item in _open_stream():
                q.put(item)
            q.put(_INGEST_DONE)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)
        finally:
            producer_done.set()

    t = threading.Thread(target=_produce, name="zk-ingest", daemon=True)
    chunk_size = env_int("KA_ZK_INGEST_CHUNK")
    initial: Dict[str, Dict[int, List[int]]] = {}
    chunk: List[tuple] = []
    streamed = 0
    overlap_ms = 0.0
    # At most one start attempt per run: a crashed attempt (the injected
    # warmup:i=crash) stays cold, and the tail site does not retry it.
    warmup_attempted = False
    with span("ingest/stream"):
        t.start()
        while True:
            item = q.get()
            if item is _INGEST_DONE:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            topic, parts = item
            if parts is None:  # vanished mid-scan (best-effort stream)
                _note_skipped(topic, skipped)
                continue
            initial[topic] = parts
            streamed += 1
            chunk.append((topic, parts))
            if len(chunk) >= chunk_size:
                overlapping = not producer_done.is_set()
                before = acc.encode_ms
                acc.add(chunk)
                if overlapping:
                    overlap_ms += acc.encode_ms - before
                chunk = []
                if not warmup_attempted:
                    # The first chunk is encoded: the signature is
                    # predictable now.
                    warmup_attempted = True
                    _start_warmup_thread(acc, len(topic_list), desired_rf, device)
        t.join()
        if chunk:
            acc.add(chunk)
        if not warmup_attempted:
            # The whole run fit in the tail chunk: still warm, beside the
            # feasibility pass and the rollback emission.
            warmup_attempted = True
            _start_warmup_thread(acc, len(topic_list), desired_rf, device)
    chunks = len(acc.codecs)
    preencoded = acc.finish()
    last_ingest.update(
        topics=streamed, chunks=chunks, codecs=sorted(set(acc.codecs)),
        encode_ms=acc.encode_ms, overlap_ms=overlap_ms, preencoded=True,
    )
    if obs_active():
        gauge_set("ingest.topics", streamed)
        if best_effort:
            gauge_set("ingest.topics_skipped", len(skipped))
        gauge_set("ingest.encode_ms", round(acc.encode_ms, 3))
        gauge_set("ingest.overlap_ms", round(overlap_ms, 3))
    return initial, preencoded


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
    failure_policy: str = "strict",
    degradation: Optional[Degradation] = None,
    ingest=None,
) -> Dict[str, Dict[int, List[int]]]:
    """Mode 3: resolve the broker set (all live brokers by default, minus
    exclusions), print the current assignment for rollback, solve every
    topic through one shared-context assigner in CLI order with ``solver``
    (``device`` on ``device``, ``native`` or ``greedy``) and emit the
    combined reassignment JSON. Metadata is read once; the rollback snapshot
    and the solver see the same read.

    ``failure_policy="best-effort"`` skips topics the snapshot lacks and
    re-runs a crashed solve on the greedy lane; what the run survived is
    written into ``degradation``. A solver crash that no fallback caught is
    re-raised as :class:`~.errors.SolveError`.

    ``ingest`` replaces the metadata read, as the reference's
    (``generator.py:645``): a callable ``(topic_list) -> (initial,
    preencoded)`` with :func:`stream_initial_assignment`'s return contract.
    The resident daemon passes its watch-fed cache and delta encode, so a
    served ``/plan`` runs this same pipeline without re-reading or
    re-encoding the cluster; no warm-up thread starts under it."""
    out = out if out is not None else sys.stdout
    broker_set = set(specified_brokers)
    if not broker_set:
        if live_brokers is None:
            live_brokers = backend.brokers()
        broker_set = {b.id for b in live_brokers}
    brokers = broker_set - excluded_brokers
    rack_assignment = {k: v for k, v in rack_assignment.items() if k in brokers}

    topic_list = list(topics) if topics is not None else backend.all_topics()
    skipped: List[str] = []
    with span("metadata/assignment"):
        # The streamed ingest: the device lane gets its group encode built
        # while the replies arrive (the solve then skips its own encode);
        # the other lanes still get the pipelined fetch.
        try:
            if ingest is not None:
                last_ingest.clear()
                initial, preencoded = ingest(topic_list)
                last_ingest["preencoded"] = preencoded is not None
            else:
                initial, preencoded = stream_initial_assignment(
                    backend, topic_list, brokers, rack_assignment,
                    want_encode=(solver == "device"),
                    failure_policy=failure_policy, skipped=skipped,
                    desired_rf=desired_replication_factor, device=device,
                )
        except Exception as e:
            if not _is_ingest_failure(e):
                raise
            raise IngestError(f"metadata ingest failed: {e}") from e
    if skipped:
        # The plan covers what survived the scan (filtered by presence in
        # the ingested map, duplicate-occurrence safe).
        topic_list = [t for t in topic_list if t in initial]
        if any(t in initial for t in skipped):
            # A name that both vanished and resolved within one scan: the
            # preencode's occurrence list no longer matches the filtered
            # one, so drop it and let the solver encode. A name wholly
            # vanished keeps the preencode: the accumulator only saw the
            # surviving occurrences, which is the filtered list.
            preencoded = None
        # Count only the occurrences the plan lost.
        skipped = [t for t in skipped if t not in initial]
        if obs_active():
            gauge_set("ingest.topics_skipped", len(skipped))
            gauge_set("plan.unplanned_topics", sorted(set(skipped)))
    if skipped:
        print(
            f"kafka-assigner: best-effort: {len(skipped)} topic read(s) "
            f"vanished mid-scan; planning the remaining "
            f"{len(topic_list)} topic(s)",
            file=sys.stderr,
        )

    print("CURRENT ASSIGNMENT:", file=out)
    print(format_reassignment_json(initial, topic_order=topic_list), file=out)

    with span("feasibility"):
        issues = validate_cluster_feasibility(
            [(t, initial[t]) for t in topic_list], brokers, rack_assignment,
            desired_replication_factor,
        )
    for issue in issues:
        print(
            f"feasibility {issue.severity}: topic {issue.topic}: {issue.message}",
            file=sys.stderr,
        )

    assigner = TopicAssigner(solver, device=device, failure_policy=failure_policy)
    if context_file is not None and os.path.exists(context_file):
        try:
            assigner.context = Context.load(context_file)
        except (ValueError, KeyError, TypeError, AttributeError, OSError) as e:
            raise ValueError(
                f"invalid leadership context file {context_file!r}: {e}"
            ) from e
    with span("plan/solve"):
        try:
            final_pairs = assigner.generate_assignments(
                [(topic, initial[topic]) for topic in topic_list],
                brokers, rack_assignment, desired_replication_factor,
                preencoded=preencoded,
            )
        except (ValueError, SolveError):
            # ValueError: validation (RF bounds, infeasibility), its plain
            # type kept for library callers and the validation exit code.
            raise
        except Exception as e:
            raise SolveError(
                f"solver backend crashed ({type(e).__name__}): {e}"
            ) from e
    last_ingest["solve_encode"] = getattr(assigner.solver, "last_codec", {}).get("encode")
    if degradation is not None:
        degradation.topics_skipped = list(skipped)
        degradation.solve_fallbacks = assigner.fallbacks
    if obs_active():
        record_plan_stats(initial, final_pairs)
    with span("plan/emit"):
        payload = format_reassignment_pairs(final_pairs)
    print("NEW ASSIGNMENT:\n" + payload, file=out)
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
    with span("plan/fresh"):
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
    if obs_active():
        record_plan_stats({}, pairs)
    print("FRESH ASSIGNMENT:\n" + format_reassignment_pairs(pairs), file=out)
