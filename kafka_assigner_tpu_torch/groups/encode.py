"""Encode one consumer group's packing problem into the bucketed int32
arrays the device program (``ops/assignment.py:pack_group``) consumes, a
copy of the reference's ``kafka_assigner_tpu/groups/encode.py``.

The partition-row axis and the consumer-column axis both pad to multiples
of 8 (``models/problem.py:_pad8``). Ids appear only here; everything
downstream works in index space.

Weight domain: base weight = column value + 1 (an owned partition always
occupies capacity), then weights and capacities together right-shift just
enough that the largest sweep scale cannot overflow int32 (device and host
agree by exact integer equality, so the domain must be shared). The shift
is recorded on the encoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..io.base import ConsumerGroupState
from ..models.problem import _pad8

#: Scaled totals stay under this (int32 headroom for the load accumulator).
_TOTAL_LIMIT = 1 << 30
#: Per-weight scale products stay under this (the int32 multiply itself).
_MULT_LIMIT = (1 << 31) - 1


@dataclass
class GroupEncoding:
    """One group's packing problem, canonicalized to dense index space."""

    group: str
    rows: List[Tuple[str, int]]   # row -> (topic, partition), sorted
    members: List[str]            # column -> member id, sorted; columns
                                  # >= len(real members) are the sweep's
                                  # synthetic extras ("<group>-extra-N")
    real_members: int             # columns backed by actual group members
    weights: np.ndarray           # (P_pad,) int32 base weights (0 on pads)
    capacities: np.ndarray        # (C_pad,) int32 (0 on pad columns)
    current: np.ndarray           # (P_pad,) int32 consumer column or -1
    proc_order: np.ndarray        # (P_pad,) int32 rows by (-weight, row)
    p: int
    c: int                        # usable columns (real + extras)
    p_pad: int
    c_pad: int
    weight_kind: str
    shift: int                    # right-shift applied to weights AND caps
    total_weight: int             # sum of base weights (post-shift)

    def alive(self, consumers: Optional[int] = None) -> np.ndarray:
        """(C_pad,) liveness mask for a candidate count: the first
        ``consumers`` columns (default: every usable column)."""
        k = self.c if consumers is None else min(consumers, self.c_pad)
        mask = np.zeros(self.c_pad, dtype=bool)
        mask[:k] = True
        return mask


def encode_group(
    state: ConsumerGroupState,
    partitions: Optional[Mapping[str, Sequence[int]]] = None,
    weight: str = "lag",
    weight_values: Optional[Mapping[Tuple[str, int], float]] = None,
    max_consumers: Optional[int] = None,
    max_scale_pct: int = 100,
    capacity_headroom: float = 1.25,
) -> GroupEncoding:
    """Canonicalize one group.

    ``partitions`` widens the row universe beyond what the group state
    mentions; ``weight_values`` supplies the column for ``weight !=
    "lag"``; ``max_consumers`` reserves columns past the real membership
    for the sweep's larger candidates (``<group>-extra-N`` ids, default
    capacity); ``max_scale_pct`` is the largest weight scale any sweep over
    this encoding applies, which the overflow guard keeps int32-exact.
    """
    if weight not in ("lag", "throughput"):
        raise ValueError(f"unknown weight column {weight!r}")
    if weight == "throughput" and weight_values is None:
        raise ValueError(
            "weight='throughput' needs weight_values (the traffic "
            "column); only 'lag' is carried by the group state itself"
        )
    universe = {
        (t, int(p))
        for t, per in state.assignment.items()
        for p in per
    } | {
        (t, int(p))
        for t, per in state.lags.items()
        for p in per
    }
    if partitions:
        universe |= {
            (t, int(p)) for t, parts in partitions.items() for p in parts
        }
    rows = sorted(universe)
    p = len(rows)
    p_pad = _pad8(p)

    members = sorted(
        dict.fromkeys(m.member_id for m in state.members)
    )
    real_members = len(members)
    cap_of = {m.member_id: float(m.capacity) for m in state.members}
    c = max(real_members, int(max_consumers or 0), 1)
    c_pad = _pad8(c)
    for i in range(real_members, c):
        members.append(f"{state.group}-extra-{i - real_members}")

    # Base weights: the chosen column + 1, integer.
    base: List[int] = []
    for t, part in rows:
        if weight == "lag":
            v = int(state.lags.get(t, {}).get(part, 0))
        else:
            v = int(round(float(weight_values.get((t, part), 0.0))))
        base.append(max(v, 0) + 1)
    total = sum(base)

    # Declared estimates where present; every undeclared capacity (a real
    # member without an estimate, and the sweep's extra columns) gets the
    # fair share of the total base weight at the real member count times
    # the headroom knob, constant across sweep candidates.
    default_cap = max(
        int(-(-total * max(capacity_headroom, 1.0) // max(real_members, 1))),
        1,
    )
    caps: List[int] = []
    for m in members:
        est = cap_of.get(m, 0.0)
        caps.append(int(round(est)) if est > 0 else default_cap)

    # Overflow guard: shift weights and capacities until the largest sweep
    # scale keeps every int32 intermediate exact.
    max_scale = max(int(max_scale_pct), 100)
    shift = 0
    max_w = max(base, default=1)
    max_cap = max(caps, default=1)
    while (
        ((total >> shift) * max_scale) // 100 >= _TOTAL_LIMIT
        or (max_w >> shift) * max_scale >= _MULT_LIMIT
        or (max_cap >> shift) >= _TOTAL_LIMIT
    ):
        shift += 1

    weights = np.zeros(p_pad, dtype=np.int32)
    for row, w in enumerate(base):
        weights[row] = max(w >> shift, 1)
    capacities = np.zeros(c_pad, dtype=np.int32)
    for col in range(c):
        capacities[col] = max(caps[col] >> shift, 1)

    col_of = {m: i for i, m in enumerate(members)}
    current = np.full(p_pad, -1, dtype=np.int32)
    for row, (t, part) in enumerate(rows):
        owner = state.assignment.get(t, {}).get(part)
        if owner is not None:
            current[row] = col_of.get(owner, -1)

    order = sorted(range(p), key=lambda r: (-int(weights[r]), r))
    proc_order = np.array(
        order + list(range(p, p_pad)), dtype=np.int32
    )
    return GroupEncoding(
        group=state.group,
        rows=rows,
        members=members,
        real_members=real_members,
        weights=weights,
        capacities=capacities,
        current=current,
        proc_order=proc_order,
        p=p,
        c=c,
        p_pad=p_pad,
        c_pad=c_pad,
        weight_kind=weight,
        shift=shift,
        total_weight=int(weights[:p].sum()),
    )


def decode_plan(
    enc: GroupEncoding, assigned: Sequence[int]
) -> Dict[str, Dict[int, Optional[str]]]:
    """(P_pad,) consumer columns -> ``{topic: {partition: member_id}}``
    over the real rows (column -1 decodes to ``None``: an unplaceable row,
    possible only when no consumer is alive)."""
    out: Dict[str, Dict[int, Optional[str]]] = {}
    for row, (t, part) in enumerate(enc.rows):
        col = int(assigned[row])
        out.setdefault(t, {})[part] = (
            enc.members[col] if 0 <= col < len(enc.members) else None
        )
    return out
