"""The greedy packing oracle, a copy of the reference's
``kafka_assigner_tpu/solvers/greedypack.py``: the host side of the
consumer-group family, the ``--solver greedy`` lane, and the tests' third
witness beside the JAX package and the port's device path.

Exactly the algorithm ``ops/assignment.py:pack_group`` runs on the device,
in plain Python integers:

1. **sticky admission**: per current owner, candidate rows in ascending
   row order; row p stays iff its owner is alive and the inclusive prefix
   weight of candidate rows on that owner through p fits the owner's
   capacity;
2. **orphan spread, first-fit-decreasing**: unkept real rows in
   ``proc_order`` (descending base weight, ties ascending row) each take
   the alive consumer with the most remaining headroom that fits (ties:
   lowest index); when nothing fits the row lands on the max-headroom
   consumer anyway and counts as *overflow*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

#: Matches ops/assignment.py:BIG, the dead-consumer headroom sentinel.
_BIG = 0x3FFFFFFF


@dataclass(frozen=True)
class PackResult:
    """One packing outcome in the device tuple's currency, over the padded
    index space so the comparison is positional."""

    assigned: List[int]   # per row: consumer index or -1
    load: List[int]       # per consumer column: packed weight
    moved: int            # real rows whose owner changed (cur >= 0 only)
    overflowed: int       # rows placed over capacity
    feasible: bool


def scale_weights(
    weights: Sequence[int], scale_pct: int, p_real: int
) -> List[int]:
    """The sweep's weight scaling, as the device does it: ``(w * scale) //
    100`` with a floor of 1 on real rows (an owned partition always
    occupies capacity), 0 on padding rows."""
    out = []
    for row, w in enumerate(weights):
        s = (int(w) * int(scale_pct)) // 100
        out.append(max(s, 1) if row < p_real else 0)
    return out


def pack_consumers(
    weights: Sequence[int],     # (P_pad,) scaled weights
    capacities: Sequence[int],  # (C_pad,)
    current: Sequence[int],     # (P_pad,) consumer index or -1
    proc_order: Sequence[int],  # (P_pad,) rows by (-base weight, row)
    alive: Sequence[bool],      # (C_pad,)
    p_real: int,
) -> PackResult:
    """The full packing solve on the host."""
    p_pad = len(weights)
    c_pad = len(capacities)
    kept = [False] * p_pad
    prefix_per_owner = [0] * c_pad
    # 1. sticky admission: ascending row order is the prefix order.
    for row in range(min(p_real, p_pad)):
        c = current[row]
        if c < 0 or c >= c_pad or not alive[c]:
            continue
        prefix_per_owner[c] += int(weights[row])
        if prefix_per_owner[c] <= int(capacities[c]):
            kept[row] = True
    assigned = [current[row] if kept[row] else -1 for row in range(p_pad)]
    load = [0] * c_pad
    for row in range(p_pad):
        if kept[row]:
            load[current[row]] += int(weights[row])
    # 2. orphan spread, first-fit-decreasing in proc_order.
    overflowed = 0
    for row in proc_order:
        row = int(row)
        if row >= p_real or kept[row]:
            continue
        w = int(weights[row])
        headroom = [
            (int(capacities[c]) - load[c]) if alive[c] else -_BIG
            for c in range(c_pad)
        ]
        best_fit, best_any = -1, 0
        for c in range(c_pad):
            if headroom[c] > headroom[best_any]:
                best_any = c
            if alive[c] and headroom[c] >= w and (
                best_fit < 0 or headroom[c] > headroom[best_fit]
            ):
                best_fit = c
        if best_fit >= 0:
            pick = best_fit
        else:
            pick = best_any
            overflowed += 1
        assigned[row] = pick
        load[pick] += w
    moved = sum(
        1
        for row in range(min(p_real, p_pad))
        if current[row] >= 0 and assigned[row] != current[row]
    )
    return PackResult(
        assigned=assigned,
        load=load,
        moved=moved,
        overflowed=overflowed,
        feasible=overflowed == 0,
    )
