"""Consumer-group model layer, a copy of the reference's
``kafka_assigner_tpu/groups/model.py``: the deterministic synthetic family
and the schema-versioned envelope validators of ``ka-groups``.

The synthetic family is an explicit opt-in (``--synthetic``), never a
silent fallback for a backend that cannot see groups. It is derived from
``obs/health.py:synthetic_partition_traffic``, so the synthetic lag and
the synthetic traffic agree on which partitions are hot.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

from ..io.base import ConsumerGroupState, GroupMember

#: Version stamp of the groups plan and sweep envelopes.
GROUPS_SCHEMA_VERSION = 1

#: Members the synthetic family invents.
_SYNTH_MIN_MEMBERS = 2
_SYNTH_MAX_MEMBERS = 8


def synthetic_group_state(
    group: str,
    partitions: Mapping[str, Sequence[int]],
) -> ConsumerGroupState:
    """Deterministic synthetic consumer group over the given partitions:
    member count scales with partition count (2-8), lag per partition
    comes from the synthetic traffic series, and ownership is round-robin
    over sorted (topic, partition). Capacities stay unknown (0), so the
    encoder derives them from whichever weight column the run packs."""
    from ..obs.health import synthetic_partition_traffic

    traffic = synthetic_partition_traffic(partitions)
    rows = sorted(
        (t, int(p)) for t, parts in partitions.items() for p in parts
    )
    n_members = min(
        _SYNTH_MAX_MEMBERS,
        max(_SYNTH_MIN_MEMBERS, math.ceil(len(rows) / 4)),
    )
    lags: Dict[str, Dict[int, int]] = {}
    for t, p in rows:
        lags.setdefault(t, {})[p] = int(traffic[t][p].lag)
    members = tuple(
        GroupMember(f"{group}-synth-{i}", 0.0) for i in range(n_members)
    )
    assignment: Dict[str, Dict[int, str]] = {}
    for i, (t, p) in enumerate(rows):
        assignment.setdefault(t, {})[p] = members[i % n_members].member_id
    return ConsumerGroupState(
        group=group, members=members, assignment=assignment, lags=lags
    )


# --- envelope validators ----------------------------------------------------

_PLAN_KEYS = (
    "schema_version", "kind", "group", "groups_real", "weight", "solver",
    "members", "plan", "moves", "overflowed", "feasible",
)
_SWEEP_KEYS = (
    "schema_version", "kind", "group", "groups_real", "weight",
    "candidates", "recommended_consumers",
)
_CANDIDATE_KEYS = (
    "consumers", "scale_pct", "feasible", "moved", "overflowed",
    "max_load_frac",
)


def _validate_common(obj, kind: str) -> List[str]:
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"{kind} envelope is not a JSON object"]
    if obj.get("schema_version") != GROUPS_SCHEMA_VERSION:
        problems.append(
            f"schema_version {obj.get('schema_version')!r} != emitter's "
            f"{GROUPS_SCHEMA_VERSION}"
        )
    if obj.get("kind") != kind:
        problems.append(f"kind {obj.get('kind')!r} != {kind!r}")
    if not isinstance(obj.get("groups_real"), bool):
        problems.append("groups_real missing or non-boolean (the "
                        "synthetic-vs-real marker is mandatory)")
    return problems


def validate_groups_plan(obj) -> List[str]:
    """Structural schema check for one per-group plan body; empty = valid."""
    problems = _validate_common(obj, "groups-plan")
    if problems and not isinstance(obj, dict):
        return problems
    for key in _PLAN_KEYS:
        if key not in obj:
            problems.append(f"missing required key {key!r}")
    if not isinstance(obj.get("plan"), dict):
        problems.append("plan is not a {topic: {partition: member}} object")
    if not isinstance(obj.get("members"), list):
        problems.append("members is not a list")
    for key in ("moves", "overflowed"):
        if not isinstance(obj.get(key), int):
            problems.append(f"{key} missing or non-integer")
    if not isinstance(obj.get("feasible"), bool):
        problems.append("feasible missing or non-boolean")
    return problems


def validate_groups_sweep(obj) -> List[str]:
    """Structural schema check for one per-group sweep body; empty = valid."""
    problems = _validate_common(obj, "groups-sweep")
    if problems and not isinstance(obj, dict):
        return problems
    for key in _SWEEP_KEYS:
        if key not in obj:
            problems.append(f"missing required key {key!r}")
    cands = obj.get("candidates")
    if not isinstance(cands, list) or not cands:
        problems.append("candidates missing or empty")
        return problems
    for i, cand in enumerate(cands):
        if not isinstance(cand, dict):
            problems.append(f"candidates[{i}] is not an object")
            continue
        for key in _CANDIDATE_KEYS:
            if key not in cand:
                problems.append(f"candidates[{i}] missing {key!r}")
    rec = obj.get("recommended_consumers")
    if rec is not None and not isinstance(rec, int):
        problems.append("recommended_consumers is neither null nor integer")
    return problems
