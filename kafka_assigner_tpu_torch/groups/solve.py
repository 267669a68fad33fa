"""Consumer-group plan and autoscale-sweep pipelines, the port of the
reference's ``kafka_assigner_tpu/groups/solve.py``.

Ingest (backend hook, or the explicit synthetic opt-in) -> :mod:`.encode`
-> packing through ``parallel/whatif.py`` on ``device`` -> decode to a
sticky rebalance plan or a cost curve. ``solver="greedy"`` runs the host
oracle (``solvers/greedypack.py``) instead.

A device failure raises :class:`SolveError` under ``fallback="raise"`` (the
default here, the reference's strict policy); under ``fallback="greedy"``
(``--failure-policy best-effort``) the crashed solve re-runs on the host
oracle, the same plan, and the envelope says ``"solver":
"greedy-fallback"``. Malformed inputs keep their ``ValueError`` /
``KeyError``. The solves are the ``groups/plan`` and ``groups/sweep``
spans.

Every envelope is byte-stable for identical inputs: no timestamps, no
elapsed times, keys emitted sorted.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import SolveError
from ..obs.trace import span
from .encode import GroupEncoding, decode_plan, encode_group
from .model import GROUPS_SCHEMA_VERSION, synthetic_group_state


def load_group_states(
    backend,
    partitions,
    groups: Optional[Sequence[str]] = None,
    synthetic: bool = False,
) -> Tuple[dict, bool]:
    """The packing inputs: ``(states {group: state}, groups_real)``.

    ``synthetic=True`` is the explicit opt-in for the deterministic
    synthetic family (derived from ``partitions``); otherwise the backend
    serves real state or refuses loudly."""
    if synthetic:
        names = list(groups) if groups else ["synthetic"]
        return (
            {g: synthetic_group_state(g, partitions) for g in names},
            False,
        )
    states = backend.fetch_consumer_groups(groups)
    return dict(states), bool(
        getattr(backend, "supports_groups", lambda: False)()
    )


def parse_int_list(value, default_csv: Optional[str] = None):
    """A counts or scales input as a list of ints: a list, a comma-separated
    string (blank entries, e.g. a trailing comma, forgiven), or the default
    CSV when ``value`` is None (``None`` when there is no default). Raises
    ``ValueError`` on junk."""
    if value is None:
        if default_csv is None:
            return None
        value = default_csv
    if isinstance(value, str):
        value = [v for v in value.split(",") if v.strip()]
    if not isinstance(value, list):
        raise ValueError(
            f"expected a list or CSV of integers, got {value!r}"
        )
    return [int(v) for v in value]


def build_group_bodies(
    states: dict,
    groups_real: bool,
    part_map,
    kind: str,
    weight: str,
    weight_values,
    scales: Sequence[int],
    headroom: float,
    max_candidates: int,
    counts: Optional[Sequence[int]] = None,
    solver: str = "device",
    device: str = "cuda",
    fallback: str = "raise",
) -> Dict[str, dict]:
    """Per group in sorted order: row universe -> candidate counts ->
    fan-out cap -> encode -> envelope. Returns ``{group: body}``; a body
    whose ``solver`` is ``greedy-fallback`` is a degraded one. With the
    device solver, the host encode's and decode's ms go to
    ``parallel/whatif.py:last_groups`` beside the device phases."""
    from ..parallel import whatif

    bodies: Dict[str, dict] = {}
    for g in sorted(states):
        st = states[g]
        universe = group_partition_universe(st, part_map)
        t0 = time.perf_counter()
        if kind == "sweep":
            counts_g = list(counts) if counts else default_counts(
                len(st.members), len(scales), max_candidates
            )
            if len(counts_g) * len(scales) > max_candidates:
                raise ValueError(
                    f"sweep fan-out {len(counts_g) * len(scales)} "
                    f"exceeds KA_GROUPS_MAX_CANDIDATES={max_candidates}; "
                    "narrow counts/scales or raise the knob"
                )
            enc = encode_group(
                st, partitions=universe, weight=weight,
                weight_values=weight_values,
                max_consumers=max(counts_g), max_scale_pct=max(scales),
                capacity_headroom=headroom,
            )
            encode_ms = (time.perf_counter() - t0) * 1e3
            body = group_sweep_envelope(
                enc, counts_g, scales, groups_real, solver=solver, device=device,
                fallback=fallback,
            )
        else:
            enc = encode_group(
                st, partitions=universe, weight=weight,
                weight_values=weight_values, capacity_headroom=headroom,
            )
            encode_ms = (time.perf_counter() - t0) * 1e3
            body = group_plan_envelope(enc, groups_real, solver=solver, device=device,
                                       fallback=fallback)
        if solver == "device":
            whatif.last_groups["encode"] = encode_ms
        bodies[g] = body
    return bodies


def subscribed_partitions(states: dict, part_map) -> dict:
    """The union of every requested group's row universe: what a
    ``weight="throughput"`` traffic fetch should cover."""
    out: Dict[str, list] = {}
    for st in states.values():
        out.update(group_partition_universe(st, part_map))
    return out


def group_partition_universe(state, part_map) -> dict:
    """One group's row universe: the cluster's partition lists restricted
    to the topics the group subscribes to (mentions in its assignment or
    lag maps), so a group whose offsets cover part of a topic still packs
    every partition of it, and unrelated topics stay out."""
    subscribed = set(state.assignment) | set(state.lags)
    return {
        t: part_map[t] for t in sorted(subscribed) if t in part_map
    }


def _member_view(enc: GroupEncoding, load) -> List[dict]:
    """The envelope's member table over the usable columns."""
    out = []
    for col in range(enc.c):
        cap = int(enc.capacities[col])
        out.append({
            "member": enc.members[col],
            "capacity": cap,
            "load": int(load[col]),
            "load_frac": round(int(load[col]) / max(cap, 1), 4),
        })
    return out


def _host_pack(enc: GroupEncoding, alive, scale_pct: int = 100):
    """The oracle run, in the device tuple's shape (the greedy lane)."""
    from ..solvers.greedypack import pack_consumers, scale_weights

    w = scale_weights([int(x) for x in enc.weights], scale_pct, enc.p)
    res = pack_consumers(
        w, [int(x) for x in enc.capacities],
        [int(x) for x in enc.current], [int(x) for x in enc.proc_order],
        [bool(x) for x in alive], enc.p,
    )
    return (
        np.asarray(res.assigned, dtype=np.int32),
        np.asarray(res.load, dtype=np.int32),
        res.moved,
        res.overflowed,
        not res.feasible,
    )


def _device_call(what: str, fallback: str, fn, *args):
    """A device solve. A malformed input (``ValueError``, ``KeyError``)
    raises as it is; any other failure is a :class:`SolveError`, or, under
    ``fallback="greedy"``, returns None for the caller to re-run on the
    host oracle."""
    try:
        return fn(*args)
    except (ValueError, KeyError):
        raise
    except Exception as e:
        if fallback != "greedy":
            raise SolveError(
                f"groups {what} crashed ({type(e).__name__}: {e})"
            ) from e
        return None


def group_plan_envelope(
    enc: GroupEncoding,
    groups_real: bool,
    solver: str = "device",
    device: str = "cuda",
    fallback: str = "raise",
) -> dict:
    """One group's sticky, movement-minimizing rebalance plan body:
    ``solver="device"`` packs on ``device``, ``"greedy"`` runs the host
    oracle; ``fallback`` as in :func:`build_group_bodies`."""
    from ..parallel import whatif

    alive = enc.alive(enc.c if enc.real_members == 0 else enc.real_members)
    used = solver
    with span("groups/plan"):
        got = None
        if solver == "device":
            got = _device_call(
                "packing solve", fallback, whatif.pack_group_on_device,
                enc.weights, enc.capacities, enc.current, enc.proc_order,
                alive, enc.p, device,
            )
            if got is None:
                used = "greedy-fallback"
        if got is None:
            got = _host_pack(enc, alive)
    assigned, load, moved, overflowed, infeasible = got
    t0 = time.perf_counter()
    plan = {
        t: {str(p): m for p, m in sorted(per.items())}
        for t, per in sorted(decode_plan(enc, assigned).items())
    }
    body = {
        "schema_version": GROUPS_SCHEMA_VERSION,
        "kind": "groups-plan",
        "group": enc.group,
        "groups_real": groups_real,
        "weight": enc.weight_kind,
        "solver": used,
        "members": _member_view(enc, load),
        "plan": plan,
        "moves": int(moved),
        "overflowed": int(overflowed),
        "feasible": not bool(infeasible),
        "partitions": enc.p,
        "total_weight": enc.total_weight,
        "weight_shift": enc.shift,
    }
    if solver == "device":
        whatif.last_groups["decode"] = (time.perf_counter() - t0) * 1e3
    return body


def group_sweep_envelope(
    enc: GroupEncoding,
    counts: Sequence[int],
    scale_pcts: Sequence[int],
    groups_real: bool,
    solver: str = "device",
    device: str = "cuda",
    fallback: str = "raise",
) -> dict:
    """The autoscale cost curve for one group: every (consumer count x
    weight scale) candidate in one batched call. Candidates are emitted
    sorted by (scale, consumers); ``recommended_consumers`` is the smallest
    count that packs feasibly at the lowest swept scale (None when none
    does). ``fallback`` as in :func:`build_group_bodies`."""
    from ..parallel import whatif

    counts = sorted({int(k) for k in counts if int(k) >= 1})
    scale_pcts = sorted({max(int(s), 1) for s in scale_pcts})
    if not counts or not scale_pcts:
        raise ValueError("sweep needs at least one count and one scale")
    if max(counts) > enc.c:
        # Columns past enc.c are pad columns (capacity 0, no member id).
        raise ValueError(
            f"candidate count {max(counts)} exceeds the encoding's "
            f"usable consumer columns ({enc.c}); re-encode with "
            f"max_consumers={max(counts)}"
        )
    cand = [(s, k) for s in scale_pcts for k in counts]
    alive_masks = np.zeros((len(cand), enc.c_pad), dtype=bool)
    for i, (_s, k) in enumerate(cand):
        alive_masks[i, :k] = True
    scales = np.array([s for s, _k in cand], dtype=np.int32)

    used = solver
    with span("groups/sweep"):
        got = None
        if solver == "device":
            got = _device_call(
                "autoscale sweep", fallback, whatif.evaluate_group_candidates,
                enc.weights, enc.capacities, enc.current, enc.proc_order,
                alive_masks, scales, enc.p, device,
            )
            if got is None:
                used = "greedy-fallback"
        if got is None:
            got = _host_sweep(enc, alive_masks, scales)
    moved, overflowed, infeasible, load = got
    t0 = time.perf_counter()
    candidates = []
    for i, (s, k) in enumerate(cand):
        caps = enc.capacities[:k].astype(np.int64)
        row_load = np.asarray(load[i][:k], dtype=np.int64)
        frac = float(
            (row_load / np.maximum(caps, 1)).max()
        ) if k else 0.0
        candidates.append({
            "consumers": k,
            "scale_pct": s,
            "feasible": not bool(infeasible[i]),
            "moved": int(moved[i]),
            "overflowed": int(overflowed[i]),
            "max_load_frac": round(frac, 4),
        })
    base_scale = scale_pcts[0]
    feasible_at_base = sorted(
        c["consumers"] for c in candidates
        if c["scale_pct"] == base_scale and c["feasible"]
    )
    body = {
        "schema_version": GROUPS_SCHEMA_VERSION,
        "kind": "groups-sweep",
        "group": enc.group,
        "groups_real": groups_real,
        "weight": enc.weight_kind,
        "solver": used,
        "candidates": candidates,
        "recommended_consumers": (
            feasible_at_base[0] if feasible_at_base else None
        ),
        "counts": counts,
        "scales_pct": scale_pcts,
        "partitions": enc.p,
        "total_weight": enc.total_weight,
        "weight_shift": enc.shift,
    }
    if solver == "device":
        whatif.last_groups["decode"] = (time.perf_counter() - t0) * 1e3
    return body


def _host_sweep(enc: GroupEncoding, alive_masks, scales):
    """The oracle over the whole candidate batch (the greedy lane)."""
    moved, overflowed, infeasible, loads = [], [], [], []
    for i in range(len(alive_masks)):
        _a, load, m, o, inf = _host_pack(
            enc, alive_masks[i], int(scales[i])
        )
        moved.append(m)
        overflowed.append(o)
        infeasible.append(inf)
        loads.append(load)
    return (
        np.asarray(moved, dtype=np.int64),
        np.asarray(overflowed, dtype=np.int64),
        np.asarray(infeasible, dtype=bool),
        np.stack(loads),
    )


def default_counts(
    real_members: int, n_scales: int, max_candidates: int
) -> List[int]:
    """The sweep's default candidate counts: 1..2x the current membership
    (at least 1..4), truncated so counts x scales stays inside the fan-out
    cap (``KA_GROUPS_MAX_CANDIDATES``)."""
    top = max(2 * max(real_members, 1), 4)
    counts = list(range(1, top + 1))
    budget = max(max_candidates // max(n_scales, 1), 1)
    return counts[:budget]


def throughput_weights(backend, partitions) -> Dict[Tuple[str, int], float]:
    """The throughput weight column: per-partition produced-byte rates from
    the backend's traffic hook (recorded where the snapshot has them, the
    synthetic series elsewhere)."""
    stats = backend.fetch_partition_traffic(
        {t: sorted(parts) for t, parts in partitions.items()}
    )
    return {
        (t, int(p)): float(tr.in_bytes)
        for t, per in stats.items()
        for p, tr in per.items()
    }
