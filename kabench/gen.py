"""Deployments and traffic drawn from a seed: the benchmark's own generator.

The steady-state cluster is a frozen copy of the rack-striped generator the
port ships (``rack_striped_cluster``): every partition's replicas sit on
consecutive entries of a rack-interleaved broker list, so the replicas are
rack-distinct and the load per broker is even. It is copied here so that no
change to the program can move the yardstick.

Each request's draw is a pure function of ``(seed, request index)``, so a
run can regenerate the inputs of any request it checks after the window.
Every seed gets the same sizes: the same number of brokers replaced or
added per rack, the same multiset of removal counts per sweep request.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Set, Tuple

import numpy as np

Topics = Dict[str, Dict[int, List[int]]]


def rack_striped_cluster(
    n_brokers: int,
    n_topics: int,
    p_per_topic: int,
    rf: int,
    n_racks: int,
    name_fmt: str = "topic-{:03d}",
    rack_fmt: str = "rack{}",
) -> Tuple[Topics, Set[int], Dict[int, str]]:
    """``(topics, live brokers, rack map)`` of the steady state: broker ``b``
    in rack ``b % n_racks``, topic ``t``'s partition ``p`` on entries
    ``t * 131 + p * rf + i`` of the rack-interleaved broker list."""
    racks = {b: rack_fmt.format(b % n_racks) for b in range(n_brokers)}
    by_rack: Dict[int, List[int]] = {}
    for b in range(n_brokers):
        by_rack.setdefault(b % n_racks, []).append(b)
    inter = [
        by_rack[r][d]
        for d in range((n_brokers + n_racks - 1) // n_racks)
        for r in range(n_racks)
        if d < len(by_rack[r])
    ]
    topics: Topics = {}
    for t in range(n_topics):
        base = t * 131
        topics[name_fmt.format(t)] = {
            p: [inter[(base + p * rf + i) % n_brokers] for i in range(rf)]
            for p in range(p_per_topic)
        }
    return topics, set(range(n_brokers)), racks


def build_deployment(config: Mapping) -> Tuple[Topics, Set[int], Dict[int, str]]:
    """The steady state a configuration file describes (``deployment``)."""
    d = config["deployment"]
    if d.get("layout") != "rack_striped":
        raise ValueError(f"unknown layout {d.get('layout')!r}")
    return rack_striped_cluster(
        d["brokers"], d["topics"], d["partitions_per_topic"],
        d["replication_factor"], d["racks"], d["topic_name"], d["rack_name"],
    )


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a seed; any whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def request_rng(seed: int, i: int) -> np.random.Generator:
    """The stream of request ``i``'s inputs."""
    return _rng(seed, 0, i)


def sample_rng(seed: int) -> np.random.Generator:
    """The stream that picks which answers the run checks."""
    return _rng(seed, 1, 0)


def _new_ids(rng, params, n_racks: int, rack_fmt: str) -> Dict[int, str]:
    """``per_rack`` new broker ids per rack, drawn without replacement from
    ``[new_id_base, new_id_base + new_id_span)``; the j-th drawn id goes to
    rack ``j % n_racks``."""
    count = params["per_rack"] * n_racks
    ids = params["new_id_base"] + rng.choice(params["new_id_span"], count, replace=False)
    return {int(b): rack_fmt.format(j % n_racks) for j, b in enumerate(ids)}


def plan_request(config: Mapping, params: Mapping, brokers: Set[int],
                 racks: Mapping[int, str], seed: int, i: int
                 ) -> Tuple[Set[int], Dict[int, str]]:
    """Request ``i``'s live broker set and rack map.

    ``op`` ``replace``: ``per_rack`` brokers of every rack leave and as many
    new ids join it. ``expand``: every broker stays and ``per_rack`` new ids
    join every rack. ``decommission``: ``per_rack`` brokers of every rack
    leave."""
    d = config["deployment"]
    n_racks, rack_fmt = d["racks"], d["rack_name"]
    op = params["op"]
    if op not in ("replace", "expand", "decommission"):
        raise ValueError(f"unknown plan op {op!r}")
    rng = request_rng(seed, i)
    live = dict(racks)
    if op in ("replace", "decommission"):
        by_rack: Dict[str, List[int]] = {}
        for b in sorted(brokers):
            by_rack.setdefault(racks[b], []).append(b)
        for r in range(n_racks):
            members = by_rack[rack_fmt.format(r)]
            for b in rng.choice(members, params["per_rack"], replace=False):
                del live[int(b)]
    if op in ("replace", "expand"):
        added = _new_ids(rng, params, n_racks, rack_fmt)
        if set(added) & set(live):
            raise ValueError("new broker ids overlap the live brokers")
        live.update(added)
    return set(live), live


def removal_request(params: Mapping, brokers: Set[int], seed: int, i: int
                    ) -> List[List[int]]:
    """Request ``i``'s removal scenarios: ``scenarios`` of them, removal
    counts cycling over ``k_min..k_max`` in an order drawn from the seed,
    each a set of distinct brokers drawn from the seed."""
    rng = request_rng(seed, i)
    lo, hi = params["k_min"], params["k_max"]
    ks = lo + np.arange(params["scenarios"]) % (hi - lo + 1)
    rng.shuffle(ks)
    ids = np.array(sorted(brokers))
    return [sorted(int(b) for b in rng.choice(ids, int(k), replace=False)) for k in ks]


def moved(before: Mapping[str, Mapping[int, Sequence[int]]],
          pairs: Sequence[Tuple[str, Mapping[int, Sequence[int]]]]) -> int:
    """Replicas placed on a broker that did not hold them."""
    total = 0
    for t, assignment in pairs:
        cur = before[t]
        for p, reps in assignment.items():
            old = set(cur[p])
            total += sum(1 for b in reps if b not in old)
    return total
