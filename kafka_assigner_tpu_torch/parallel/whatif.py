"""Batched what-if sweeps: many candidate broker removals evaluated at once
— the port of ``kafka_assigner_tpu/parallel/whatif.py``, with the same names
and semantics: ``evaluate_removal_scenarios`` (:431),
``rank_decommission_candidates`` (:778), the incremental sweep
``_evaluate_incremental`` (:273), the shared rescue ``_rescue_flagged``
(:207), ``ScenarioResult``, ``_topic_rfs`` and ``_topic_stats``.

A scenario is a liveness mask. The sweep places every topic under every
scenario's mask in batched placement calls (``ops/assignment.py:
whatif_sweep``: (scenario, topic) pairs are the batch rows), placement only,
on the ``fast`` leg; scenarios it flags re-run through the full ``auto``
chain. By default (``KA_WHATIF_INCREMENTAL``) only the topics a scenario can
change are placed, and the rest is composed from host baseline loads; the
dense sweep chunks scenarios under ``KA_WHATIF_MEMBUDGET``. Padding
scenarios are never placed: the port has no compiled shapes to fill.

The consumer-group family's device half is here too, as in the reference:
``pack_group_on_device`` (:664) and ``evaluate_group_candidates`` (:698),
each on a ``device`` argument (``cuda`` by default).

The reference's counters and spans are recorded while an obs capture is
active (``whatif.*``: scenarios, fan-out, incremental sweeps, rescued
scenarios, the ``whatif/incremental``, ``whatif/dispatch`` and
``whatif/rescue`` spans and the ``whatif.dispatch_ms`` histogram;
``groups.*``: candidates, dispatches, fan-out and the ``groups/dispatch``
span), and the group calls consult ``fault_point("solve")`` before any
device work. The fan-out gauges keep the reference's definition, the
power-of-two bucket of the scenario or candidate count, though the port
places no padding rows.

On a daemon request thread under the dispatch plane
(``daemon/dispatch.py``), each device call here becomes a row job through
``submit_routed`` there, as in the reference (:98): the dense sweep (its
budgeted blocks one job each, packing with nothing), the incremental subset
sweep, the rescue and the group sweep. Concurrent requests whose shared
operands agree (the same cluster, or clusters whose encodings agree) then
share one call. The call runs on the dispatcher thread, so its spans and
counters go to the cumulative registry, not to the request's capture, as in
the reference.

``mesh`` (``parallel/mesh.py:build_mesh``) shards the scenario axis of
``evaluate_removal_scenarios``, ``_evaluate_incremental`` and
``rank_decommission_candidates``, as the reference's does (:482-537): each
position sweeps its contiguous block of scenarios on its own device (a
thread each), chunked under ``KA_WHATIF_MEMBUDGET`` within the position,
and the blocks are gathered in every process (``fetch_global``). Results
are the unsharded sweep's. No padding rows are placed; ``whatif.fanout``
is the reference's tiled width, the power-of-two bucket rounded up to a
multiple of the scenario axis. The rescue of flagged scenarios runs
unsharded after the gather, on ``device``. A call under the dispatch plane
drops the mesh, as the reference's does (:452-461): a mesh never reaches
``submit_routed``.

:data:`last_sweep` and :data:`last_groups` record what the most recent
call of the process did; under the dispatch plane concurrent requests
overwrite them, and a packed call's ``rows``, ``chunks``, ``waves``,
``syncs`` and ``wait`` are the packed call's; under a mesh they sum every
position's. Under ``torch.profiler`` each timed phase of a sweep is a label
on the profiler's clock around exactly its timer: ``ka/whatif/prep``,
``ka/whatif/chunk`` (each placement call of the sweep, the rescue's too),
``ka/whatif/compose`` (the incremental path; the dense one composes
nothing) and ``ka/whatif/rescue_phase``, which holds the reference's
``whatif/rescue`` span (``ka/whatif/rescue``) when a scenario is rescued;
under a mesh ``ka/whatif/mesh_upload`` and ``ka/whatif/mesh_gather`` on the
calling thread, around each mesh call's upload and gather.
"""
from __future__ import annotations

import itertools
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..assigner import infer_topic_rf
from ..carry import to_tensor
from ..daemon.dispatch import active_broker, submit_routed
from ..faults.inject import fault_point
from ..models.problem import _pad8, batch_bucket, encode_cluster, encode_topic_group
from ..obs.metrics import counter_add, gauge_set
from ..obs.trace import span
from ..ops.assignment import (
    group_pack_sweep,
    host_read,
    host_reads,
    pack_group,
    sharing_device,
    whatif_subset_sweep,
    whatif_sweep,
)
from ..solvers.torch_solver import solve_device
from ..utils.env import env_bool, env_int
from .mesh import Sharded, block_bounds, fetch_global, gather_blocks, owned_blocks, run_positions

#: What the most recent sweep of this process did (read like
#: ``TorchSolver.last_timers``): ``path`` ("incremental" or "dense"),
#: ``scenarios``, ``rescued`` (scenarios re-run on the ``auto`` chain) and
#: ``rescue_waves``, the main sweep's ``rows``, ``chunks`` (placement calls),
#: ``per_call`` (the scenarios its largest placement call held, sized from
#: the device: ``ops/assignment.py:sweep_scenarios_per_call``) and ``waves``
#: per leg, ``t_pad`` on the incremental path, and phase times
#: in ms: ``prep`` (host encode, masks and topic facts, upload), ``sweep``
#: (the device sweep, ending in a synchronize), ``rescue`` (the device
#: re-run of flagged scenarios) and ``compose`` (host). Where the sweep
#: and its rescue ran on a thread a ``torch.profiler`` session records,
#: ``syncs`` counts their device-to-host reads
#: (``ops/assignment.py:host_read``, and three reads of each call's
#: outputs) and ``wait`` the host's ms blocked in them. Under a mesh, summed
#: over the sweep's mesh calls (``mesh_blocks``, each over ``mesh_positions``
#: positions of the scenario axis): ``mesh_upload``, the ms copying the
#: cluster's arrays to each device and waiting for the copies;
#: ``mesh_slowest``, each call's slowest wall among this process's positions
#: (each timed in its own thread, from its sweep's start to its outputs on
#: the host); ``mesh_skew``, that minus the fastest one's; and
#: ``mesh_gather``, the ms gathering the blocks' outputs and records.
last_sweep: Dict[str, object] = {}

#: The mesh's records that add up over a sweep's mesh calls.
_MESH_SUMS = ("mesh_upload", "mesh_slowest", "mesh_skew", "mesh_gather", "mesh_blocks")

#: What the most recent group packing call of this process did: ``kind``
#: ("plan" or "sweep"), ``s`` (candidates), ``p_pad``, ``c_pad``, the scan's
#: ``steps_max`` and ``steps_sum`` (orphan rows per candidate), and phase
#: times in ms: ``upload``, ``sticky`` and ``scan`` (each ending in a device
#: sync), ``download``; ``groups/solve.py`` adds the host ``encode`` and
#: ``decode``.
last_groups: Dict[str, object] = {}


#: Per-request token of the budgeted blocks of a large dense sweep: each
#: block is a job of its own and packs with no other block, since two
#: blocks together are the slab the budget exists to avoid.
_chunk_token = itertools.count(1)


class _OnDevice(NamedTuple):
    """One evaluation's encoded topics on the sweep's device."""

    currents: torch.Tensor  # (B_pad, P_pad, L)
    rack_idx: torch.Tensor  # (N_pad,)
    jhashes: torch.Tensor   # (B_pad,)
    p_reals: torch.Tensor   # (B_pad,)
    rfs: torch.Tensor       # (B_pad,)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _topic_rfs(items, replication_factor):
    """Per-topic RF: the desired override, else inferred from each topic's
    own replica lists with the assigner's uniformity assertion (a topic
    with non-uniform replica lists raises). Callers skip topics with no
    partitions (rf <= 0 contributes nothing)."""
    return [
        infer_topic_rf(topic, cur, replication_factor) for topic, cur in items
    ]


@dataclass
class ScenarioResult:
    """Outcome metrics for one candidate change."""

    removed: Tuple[int, ...]
    moved_replicas: int
    feasible: bool
    max_node_load: int


def _topic_stats(currents: np.ndarray, p_reals, rfs, rack_idx, n):
    """Host-side per-topic facts the incremental sweep composes from.

    Returns (clean (B,), loads (B, n), max_load (B,)) where ``clean[t]``
    certifies that topic t's input assignment reproduces itself under ANY
    scenario whose brokers it doesn't host and whose capacity bound covers
    ``max_load[t]``: every real row has exactly rf live entries, no
    duplicate broker in a row, and no rack repeated in a row. For such a
    topic sticky re-accepts everything, no orphans exist, no waves run —
    placement IS the input, zero movement.
    """
    b, p_pad, w = currents.shape
    rows = np.arange(p_pad)[None, :] < np.asarray(p_reals)[:, None]  # (B,P)
    ent = currents  # (B, P, W) broker index or -1
    pos = ent >= 0
    count = pos.sum(axis=2)  # (B, P)
    full = np.where(rows, count == np.asarray(rfs)[:, None], True).all(axis=1)
    dup = np.zeros((b, p_pad), dtype=bool)
    rackdup = np.zeros((b, p_pad), dtype=bool)
    rk = np.where(pos, np.asarray(rack_idx)[np.maximum(ent, 0)], -1)
    for i in range(w):
        for j in range(i + 1, w):
            both = pos[:, :, i] & pos[:, :, j]
            dup |= both & (ent[:, :, i] == ent[:, :, j])
            rackdup |= both & (rk[:, :, i] == rk[:, :, j])
    clean = (
        full
        & ~np.where(rows, dup, False).any(axis=1)
        & ~np.where(rows, rackdup, False).any(axis=1)
    )
    loads = np.zeros((b, n), dtype=np.int64)
    flat = ent[pos & rows[:, :, None]]
    topic_of = np.broadcast_to(
        np.arange(b)[:, None, None], ent.shape
    )[pos & rows[:, :, None]]
    np.add.at(loads, (topic_of, flat), 1)
    return clean, loads, loads.max(axis=1)


def _rescue_flagged(flagged, alive, on, host, n, rf, r_cap, moved, infeasible,
                    max_load):
    """Re-run flagged scenarios through the FULL auto-chain sweep and write
    the results back in place. The fast-only sweep (dense or incremental)
    raises its infeasible flag for both true infeasibility and fast-leg
    strandings; this shared rescue tells them apart identically for both
    paths, as the actual solver would for that scenario. ``alive`` is the
    host (S, N_pad) mask matrix; ``on`` holds the topic tensors on the
    device and ``host`` the same arrays on the host (the dispatch key).
    Returns the rescue's record (:func:`_download`)."""
    counter_add("whatif.rescued", len(flagged))
    dev = on.currents.device

    def _rescue_call(rows):
        with span("whatif/rescue", hist="whatif.dispatch_ms"), host_reads() as reads:
            res = whatif_sweep(
                on.currents, on.rack_idx, on.jhashes, on.p_reals,
                torch.as_tensor(rows["alive"]).to(dev), n, rf, wave_mode="auto",
                rfs=on.rfs, r_cap=r_cap,
            )
            return _download(res, reads)

    # The "rescue" tag keeps these rows apart from the fast-leg sweeps'.
    rows = {"alive": np.asarray(alive)[flagged]}
    routed = submit_routed("whatif_sweep", host, ("rescue", n, rf, r_cap), rows,
                           len(flagged), _rescue_call)
    moved2, infeasible2, max_load2, rec = (
        routed if routed is not None else _rescue_call(rows))
    for i, s in enumerate(flagged):
        moved[s] = moved2[i]
        infeasible[s] = infeasible2[i]
        max_load[s] = max_load2[i]
    return rec


def _results(scenarios, alive, on, host, n, rf, r_cap, moved, infeasible,
             max_load):
    """Rescue the flagged scenarios, then one :class:`ScenarioResult` per
    scenario (both paths end here)."""
    with span("whatif/rescue_phase", sink=last_sweep, key="rescue", report=False):
        flagged = [s for s in range(len(scenarios)) if infeasible[s]]
        waves = {}
        if flagged:
            rec = _rescue_flagged(flagged, alive, on, host, n, rf, r_cap, moved,
                                  infeasible, max_load)
            waves = rec["waves"]
            if "syncs" in rec and "syncs" in last_sweep:
                # .get: under the dispatch plane a concurrent request may
                # have cleared the record since the test.
                last_sweep["syncs"] = last_sweep.get("syncs", 0) + rec["syncs"]
                last_sweep["wait"] = last_sweep.get("wait", 0.0) + rec["wait"]
    last_sweep.update(rescued=len(flagged), rescue_waves=waves)
    return [
        ScenarioResult(
            removed=tuple(sorted(int(b) for b in scenarios[s])),
            moved_replicas=int(moved[s]),
            feasible=not bool(infeasible[s]),
            max_node_load=int(max_load[s]),
        )
        for s in range(len(scenarios))
    ]


def _evaluate_incremental(
    currents, jhashes, p_reals, rfs, cluster, alive, scenarios, s_real,
    rf, r_cap, b_real, on, host, prep, mesh=None,
):
    """Incremental sweep: solve only the (scenario, topic) pairs whose
    outcome can differ from the input.

    Placement has no cross-topic dependency, so a scenario's metrics
    decompose per topic; a topic that hosts none of the removed brokers and
    is *clean* under the scenario's capacity bound (``_topic_stats``)
    provably reproduces its input — zero movement, unchanged loads. The
    dense sweep remains the oracle, and this path declines (returns None)
    when the affected fraction makes it unprofitable. ``on`` holds the
    topics on the device and ``host`` on the host; ``prep`` is the
    evaluation's open ``whatif/prep`` span, ended here once the index table
    is built. ``mesh`` shards the subset sweep's scenarios; the composition
    is unchanged.

    Scenarios whose fast-leg pair solve strands re-run through the FULL
    auto-chain sweep, exactly like the dense path's rescue.
    """
    n = cluster.n
    clean, loads_t, maxload_t = _topic_stats(
        currents[:b_real], p_reals[:b_real], rfs[:b_real], cluster.rack_idx, n
    )
    base_load = loads_t.sum(axis=0)  # (n,)
    pr = np.asarray(p_reals[:b_real], dtype=np.int64)
    rft = np.asarray(rfs[:b_real], dtype=np.int64)
    affected = []  # per scenario: array of affected topic rows
    for s in range(s_real):
        ridx = np.where(~alive[s, :n])[0]
        n_alive = n - len(ridx)
        if n_alive <= 0:
            return None  # degenerate; let the full sweep report it
        caps = -(-(pr * rft) // n_alive)  # per-topic ceil(P*RF/N_alive)
        hosts = (
            loads_t[:, ridx].sum(axis=1) > 0
            if len(ridx)
            else np.zeros(b_real, dtype=bool)
        )
        affected.append(np.where(hosts | ~clean | (maxload_t > caps))[0])
    # 8-granular pad (not power-of-2): the pad feeds the profitability gate,
    # and a pow2 jump (34 -> 64) would decline sweeps that are profitably
    # ~1/3 affected.
    t_pad = _pad8(max((len(a) for a in affected), default=1), floor=8)
    if 3 * t_pad > b_real:
        return None  # mostly-affected scenarios: the dense sweep wins

    topics = np.full((s_real, t_pad), -1, dtype=np.int32)
    for s, tops in enumerate(affected):
        topics[s, : len(tops)] = tops
    prep.end()
    last_sweep.update(t_pad=t_pad)

    def _subset_rows(rows, on=on):
        dev = on.currents.device
        with host_reads() as reads:
            res = whatif_subset_sweep(
                on.currents, on.rack_idx, on.jhashes, on.p_reals,
                to_tensor(rows["topics"], dev), torch.as_tensor(rows["alive"]).to(dev),
                n, rf, rfs=on.rfs, r_cap=r_cap,
            )
            return _download(res, reads)

    # Every operand but the index table and the masks is the cluster's, so
    # requests over the same encoding pack, across clusters too.
    t0 = time.perf_counter()
    rows = {"topics": topics, "alive": alive}
    if mesh is not None:
        empty = (np.zeros(0, np.int64), np.zeros(0, bool), np.zeros((0, n), np.int64))
        (moved_s, infeas_s, loads_s), rec = _mesh_sweep(
            mesh, host, rows, empty, lambda on_b, r: _subset_rows(r, on_b))
    else:
        routed = submit_routed(
            "whatif_subset_sweep", host, ("subset", n, rf, r_cap, t_pad, alive.shape[1]),
            rows, s_real, _subset_rows)
        moved_s, infeas_s, loads_s, rec = (
            routed if routed is not None else _subset_rows(rows))
    last_sweep.update(sweep=_ms(t0), **rec)

    with span("whatif/compose", sink=last_sweep, key="compose", report=False):
        moved = moved_s.astype(np.int64)
        infeasible = infeas_s.astype(bool)
        load_vec = np.repeat(base_load[None, :], s_real, axis=0)
        for s, tops in enumerate(affected):
            load_vec[s] += loads_s[s] - loads_t[tops].sum(axis=0)
        max_load = load_vec.max(axis=1) if n else np.zeros(s_real, dtype=np.int64)
    return _results(scenarios, alive, on, host, n, rf, r_cap, moved, infeasible,
                    max_load)


def _download(res, reads) -> tuple:
    """A sweep call's three outputs on the host, and its record for
    :data:`last_sweep` (it passes whole through a packed call): rows,
    placement calls, the scenarios a call held, waves, and where the call
    counted its device reads (``reads``, its open ``host_reads`` block)
    their count and the host's ms blocked in them, these three reads
    included."""
    out = tuple(host_read(torch.Tensor.cpu, t).numpy() for t in res[:3])
    rec = {"rows": res.rows, "chunks": res.chunks, "per_call": res.per_call,
           "waves": res.waves}
    if reads is not None:
        rec.update(syncs=reads.syncs, wait=reads.wait)
    return out + (rec,)


def _add_records(recs) -> Dict[str, object]:
    """Records of several sweep calls, summed; ``per_call`` is the
    largest."""
    waves: Dict[str, int] = {}
    for rec in recs:
        for leg, w in rec["waves"].items():
            waves[leg] = waves.get(leg, 0) + w
    out = {"rows": sum(r["rows"] for r in recs),
           "chunks": sum(r["chunks"] for r in recs),
           "per_call": max(r["per_call"] for r in recs), "waves": waves}
    if all("syncs" in r for r in recs):
        out.update(syncs=sum(r["syncs"] for r in recs),
                   wait=sum(r["wait"] for r in recs))
    if all("mesh_positions" in r for r in recs):
        out.update({k: sum(r[k] for r in recs) for k in _MESH_SUMS},
                   mesh_positions=max(r["mesh_positions"] for r in recs))
    return out


def _mesh_sweep(mesh, host, rows, empty, call):
    """A sweep's scenario rows over ``mesh``'s scenario axis: each block of
    ``rows`` (host arrays with a leading scenario axis) this process holds
    goes to ``call(on, block_rows)`` on its position's device, a thread a
    block; ``call`` returns host arrays with the block's scenarios first and
    a record. Returns the outputs gathered in every process (``empty``
    gives each one's dtype and trailing shape, for a block with no
    scenario) and the records summed over every block, with the mesh's own
    (:data:`last_sweep`'s ``mesh_*``). The blocks that share a device split
    its sweep budget (``sharing_device``)."""
    s = len(next(iter(rows.values())))
    k = mesh.shape["scenarios"]
    owned = owned_blocks(mesh, "scenarios")
    sharers = Counter(pos.device for pos in owned.values())
    mesh_rec: Dict[str, object] = {"mesh_blocks": 1, "mesh_positions": k}
    ons = {}
    with span("whatif/mesh_upload", sink=mesh_rec, key="mesh_upload", report=False):
        for pos in owned.values():
            if pos.device not in ons:
                ons[pos.device] = _OnDevice(*(to_tensor(a, pos.device) for a in host))
        for d in ons:
            _sync(d)

    walls: Dict[int, float] = {}

    def run(b):
        t0 = time.perf_counter()
        lo, hi = block_bounds(s, k, b)
        if lo == hi:
            out = tuple(empty) + (None,)
        else:
            dev = owned[b].device
            with sharing_device(sharers[dev]):
                got = call(ons[dev], {name: v[lo:hi] for name, v in rows.items()})
            out = tuple(np.asarray(a, dtype=e.dtype) for a, e in zip(got, empty)) + got[-1:]
        walls[b] = _ms(t0)
        return out

    blocks = list(owned)
    outs = dict(zip(blocks, run_positions(blocks, run)))
    with span("whatif/mesh_gather", sink=mesh_rec, key="mesh_gather", report=False):
        gathered = tuple(
            fetch_global(Sharded(mesh, "scenarios", 0, s, {
                b: (owned[b], torch.from_numpy(np.ascontiguousarray(out[i])))
                for b, out in outs.items()}))
            for i in range(len(empty)))
        recs = gather_blocks(mesh, "scenarios",
                             {b: out[-1] for b, out in outs.items() if out[-1] is not None})
    mesh_rec.update(mesh_slowest=max(walls.values()),
                    mesh_skew=max(walls.values()) - min(walls.values()))
    return gathered, {**_add_records(list(recs.values())), **mesh_rec}


def evaluate_removal_scenarios(
    topic_assignments: Mapping[str, Mapping[int, Sequence[int]]],
    brokers: Set[int],
    rack_assignment: Mapping[int, str],
    scenarios: Sequence[Sequence[int]],
    replication_factor: int = -1,
    device: str | torch.device = "cuda",
    mesh=None,
) -> List[ScenarioResult]:
    """For each candidate broker-removal set, solve the full cluster
    reassignment and report movement/feasibility/load metrics. The sweep
    runs on ``device`` (``cuda`` by default; raises without a card).

    ``mesh``: scenario rows are sharded across its ``scenarios`` axis, each
    position sweeping its block on its own device; the rescue runs on
    ``device``. Dropped on a daemon request thread under the dispatch
    plane, where the dispatcher packs requests instead."""
    # The prep phase runs from here until the sweep's index table or masks
    # are ready, inside the reference's ``whatif/incremental`` span on that
    # path: the span is ended there, and ends here only on an early return.
    with span("whatif/prep", sink=last_sweep, key="prep", report=False) as prep:
        return _evaluate(topic_assignments, brokers, rack_assignment, scenarios,
                         replication_factor, device, mesh, prep)


def _evaluate(topic_assignments, brokers, rack_assignment, scenarios,
              replication_factor, device, mesh, prep) -> List[ScenarioResult]:
    dev = solve_device(device, "evaluate_removal_scenarios")
    last_sweep.clear()
    if mesh is not None and active_broker() is not None:
        mesh = None
    all_items = list(topic_assignments.items())
    all_rfs = _topic_rfs(all_items, replication_factor)
    # Topics with no partitions contribute nothing to any scenario.
    items = [it for it, r in zip(all_items, all_rfs) if r > 0 and it[1]]
    topic_rfs = [r for it, r in zip(all_items, all_rfs) if r > 0 and it[1]]
    if not items:
        return []
    rf = max(topic_rfs)
    cluster = encode_cluster(rack_assignment, brokers)
    encs, currents, jhashes, p_reals = encode_topic_group(
        items, rack_assignment, brokers, topic_rfs, cluster=cluster
    )
    rfs = np.zeros(currents.shape[0], dtype=np.int32)
    rfs[: len(topic_rfs)] = topic_rfs

    enc0 = encs[0]
    broker_to_idx = cluster.broker_to_idx
    s_real = len(scenarios)
    alive = np.zeros((s_real, enc0.n_pad), dtype=bool)
    alive[:, : enc0.n] = True
    for s, removed in enumerate(scenarios):
        for b in removed:
            idx = broker_to_idx.get(int(b))
            if idx is None:
                raise ValueError(f"scenario {s}: unknown broker {b}")
            alive[s, idx] = False
    # Fan-out telemetry: the scenario count, and the reference's padded
    # batch width for it (under a mesh, tiled to the scenario axis).
    counter_add("whatif.scenarios", s_real)
    fanout = batch_bucket(s_real)
    if mesh is not None:
        m = mesh.shape["scenarios"]
        fanout = -(-fanout // m) * m
    gauge_set("whatif.fanout", int(fanout))
    if not s_real:
        return []
    host = (currents, enc0.rack_idx, jhashes, p_reals, rfs)
    on = _OnDevice(*(to_tensor(a, dev) for a in host))
    last_sweep.update(scenarios=s_real)

    if env_bool("KA_WHATIF_INCREMENTAL"):
        with span("whatif/incremental"):
            res = _evaluate_incremental(
                currents, jhashes, p_reals, rfs, cluster, alive, scenarios,
                s_real, rf, enc0.r_cap, len(items), on, host, prep, mesh,
            )
        if res is not None:
            counter_add("whatif.incremental_sweeps")
            last_sweep["path"] = "incremental"
            return res

    # Scenario-axis memory chunking: one dispatch's (S, B, P_pad, RF) state
    # stays under ~KA_WHATIF_MEMBUDGET int32 elements.
    per_scenario = max(1, currents.shape[0] * currents.shape[1] * max(rf, 1))
    s_chunk = max(1, env_int("KA_WHATIF_MEMBUDGET") // per_scenario)
    prep.end()
    last_sweep.update(path="dense", t_pad=None)

    def _sweep_rows(rows, on=on):
        with host_reads() as reads:
            res = whatif_sweep(
                on.currents, on.rack_idx, on.jhashes, on.p_reals,
                torch.as_tensor(rows["alive"]).to(on.currents.device), enc0.n, rf,
                rfs=on.rfs, r_cap=enc0.r_cap,
            )
            return _download(res, reads)

    def _dense_rows(rows):
        with span("whatif/dispatch", hist="whatif.dispatch_ms"):
            return _sweep_rows(rows)

    if mesh is not None:
        # Past the budget the sweep goes in blocks of the budget's
        # scenarios rounded down to a multiple of the scenario axis (at
        # least one a position), each split over the positions and timed
        # on this thread, as the reference keeps its chunks tileable
        # (:535-537): a position's share of a block stays under the budget.
        m = mesh.shape["scenarios"]
        s_block = max(m, s_chunk // m * m)
        empty = (np.zeros(0, np.int64), np.zeros(0, bool), np.zeros(0, np.int64))
        t0 = time.perf_counter()
        blocks = []
        for lo in range(0, s_real, s_block):
            with span("whatif/dispatch", hist="whatif.dispatch_ms"):
                blocks.append(_mesh_sweep(mesh, host, {"alive": alive[lo:lo + s_block]},
                                          empty, lambda on_b, r: _sweep_rows(r, on_b)))
        moved, infeasible, max_load = (
            np.concatenate([blk[0][i] for blk in blocks]) for i in range(3))
        last_sweep.update(sweep=_ms(t0), compose=0.0,
                          **_add_records([blk[1] for blk in blocks]))
        return _results(scenarios, alive, on, host, enc0.n, rf, enc0.r_cap,
                        moved, infeasible, max_load)

    # Only the masks are the request's own: requests over the same encoding
    # (one cluster, or clusters whose encodings agree) pack. Past the budget
    # each block is a job of its own, tagged so that it packs with nothing.
    chunked = s_real > s_chunk
    token = next(_chunk_token) if chunked else 0
    t0 = time.perf_counter()
    blocks = []
    for lo in range(0, s_real, s_chunk):
        rows = {"alive": alive[lo:lo + s_chunk]}
        statics = (("chunk", enc0.n, rf, enc0.r_cap, token, lo) if chunked
                   else ("dense", enc0.n, rf, enc0.r_cap))
        routed = submit_routed("whatif_sweep", host, statics, rows,
                               len(rows["alive"]), _dense_rows)
        blocks.append(routed if routed is not None else _dense_rows(rows))
    moved, infeasible, max_load = (
        np.concatenate([blk[i] for blk in blocks]) for i in range(3))
    last_sweep.update(sweep=_ms(t0), compose=0.0,
                      **_add_records([blk[3] for blk in blocks]))
    return _results(scenarios, alive, on, host, enc0.n, rf, enc0.r_cap,
                    moved, infeasible, max_load)


def rank_decommission_candidates(
    topic_assignments: Mapping[str, Mapping[int, Sequence[int]]],
    brokers: Set[int],
    rack_assignment: Mapping[int, str],
    candidates: Optional[Sequence[int]] = None,
    replication_factor: int = -1,
    device: str | torch.device = "cuda",
    mesh=None,
) -> List[ScenarioResult]:
    """Rank single-broker removals by disruption (feasible first, then fewest
    moved replicas) — the fleet-scale question the reference can only answer
    one process run at a time. ``mesh`` shards the scenarios, as in
    :func:`evaluate_removal_scenarios`."""
    cands = sorted(candidates) if candidates is not None else sorted(brokers)
    results = evaluate_removal_scenarios(
        topic_assignments, brokers, rack_assignment,
        [[c] for c in cands], replication_factor, device, mesh=mesh,
    )
    return sorted(
        results, key=lambda r: (not r.feasible, r.moved_replicas, r.removed)
    )


def _group_tensors(dev, weights, capacities, current, proc_order):
    return tuple(to_tensor(a, dev) for a in (weights, capacities, current, proc_order))


def pack_group_on_device(
    weights: np.ndarray,
    capacities: np.ndarray,
    current: np.ndarray,
    proc_order: np.ndarray,
    alive: np.ndarray,
    p_real: int,
    device: str | torch.device = "cuda",
):
    """One group's packing solve (``ops/assignment.py:pack_group`` at S =
    1) on ``device`` (``cuda`` by default; raises without a card). Returns
    host arrays ``(assigned (P_pad,), load (C_pad,), moved, overflowed,
    infeasible)``, the tuple the host oracle (``solvers/greedypack.py``)
    computes. Records its shapes, steps and phase times in
    :data:`last_groups`. The ``solve`` fault point fires first, as at the
    placement solver's dispatch."""
    fault_point("solve")
    counter_add("groups.dispatches")
    with span("groups/dispatch", hist="whatif.dispatch_ms"):
        t0 = time.perf_counter()
        dev = solve_device(device, "pack_group_on_device")
        last_groups.clear()
        w, cap, cur, order = _group_tensors(dev, weights, capacities, current,
                                            proc_order)
        alive_t = torch.as_tensor(np.asarray(alive, dtype=bool)[None, :]).to(dev)
        _sync(dev)
        last_groups.update(kind="plan", s=1, p_pad=int(w.shape[0]),
                           c_pad=int(cap.shape[0]), upload=_ms(t0))
        out = pack_group(w[None, :], cap, cur, order, alive_t, int(p_real),
                         last_groups)
        t0 = time.perf_counter()
        assigned, load, moved, overflowed, infeasible = (
            t[0].cpu().numpy() for t in out)
        last_groups["download"] = _ms(t0)
    return assigned, load, int(moved), int(overflowed), bool(infeasible)


def evaluate_group_candidates(
    weights: np.ndarray,
    capacities: np.ndarray,
    current: np.ndarray,
    proc_order: np.ndarray,
    alive_masks: np.ndarray,   # (S, C_pad) bool
    scale_pcts,                # (S,) int
    p_real: int,
    device: str | torch.device = "cuda",
):
    """The autoscale sweep's device half: every candidate (consumer count x
    weight scale) in one ``group_pack_sweep`` call on ``device``. Returns
    host arrays ``(moved (S,), overflowed (S,), infeasible (S,), load (S,
    C_pad))``. The batch is not padded (the port has no compiled shapes).
    Records its shapes, steps and phase times in :data:`last_groups`. The
    ``solve`` fault point fires before any device work. Under the dispatch
    plane the candidate rows of concurrent requests whose group tensors
    agree share one call: one KG1 launch."""
    s_real = len(alive_masks)
    counter_add("groups.candidates", s_real)
    fault_point("solve")
    dev = solve_device(device, "evaluate_group_candidates")

    def _sweep_rows(rows):
        counter_add("groups.dispatches")
        gauge_set("groups.fanout", int(batch_bucket(len(rows["alive"]))))
        with span("groups/dispatch", hist="whatif.dispatch_ms"):
            t0 = time.perf_counter()
            last_groups.clear()
            w, cap, cur, order = _group_tensors(dev, weights, capacities, current,
                                                proc_order)
            alive_t = torch.as_tensor(rows["alive"]).to(dev)
            scales = to_tensor(rows["scales"], dev)
            _sync(dev)
            last_groups.update(kind="sweep", s=int(alive_t.shape[0]),
                               p_pad=int(w.shape[0]), c_pad=int(cap.shape[0]),
                               upload=_ms(t0))
            out = group_pack_sweep(w, cap, cur, order, alive_t, scales, int(p_real),
                                   last_groups)
            t0 = time.perf_counter()
            moved, overflowed, infeasible, load = (t.cpu().numpy() for t in out)
            last_groups["download"] = _ms(t0)
        return moved, overflowed, infeasible, load

    rows = {"alive": np.asarray(alive_masks, dtype=bool),
            "scales": np.asarray(scale_pcts, dtype=np.int32)}
    routed = submit_routed(
        "group_sweep", (weights, capacities, current, proc_order),
        ("group", int(p_real), int(rows["alive"].shape[1])), rows, s_real,
        _sweep_rows)
    return routed if routed is not None else _sweep_rows(rows)
