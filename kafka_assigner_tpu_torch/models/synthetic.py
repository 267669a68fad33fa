"""Synthetic benchmark clusters (the reference's BASELINE.md configs), a copy
of ``kafka_assigner_tpu/models/synthetic.py:rack_striped_cluster``.

Rack-striped steady state: every partition's RF replicas sit on consecutive
entries of a rack-interleaved broker list, so replicas are rack-diverse and
per-node load is balanced — replacement runs then measure the change only.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple


def rack_striped_cluster(
    n_brokers: int,
    n_topics: int,
    p_per_topic: int,
    rf: int,
    n_racks: int,
    name_fmt: str = "topic-{:03d}",
    extra_brokers: int = 0,
) -> Tuple[Dict[str, Dict[int, List[int]]], Set[int], Dict[int, str]]:
    """Return (topics, live_brokers, rack_map) in steady state.

    ``extra_brokers``: further broker ids (``n_brokers..n_brokers+extra-1``)
    in the rack map (same striping) but not in the live set or any replica
    list — the replacement brokers of a swap scenario."""
    racks = {b: f"rack{b % n_racks}" for b in range(n_brokers + extra_brokers)}
    by_rack: Dict[int, List[int]] = {}
    for b in range(n_brokers):
        by_rack.setdefault(b % n_racks, []).append(b)
    inter = [
        by_rack[r][d]
        for d in range((n_brokers + n_racks - 1) // n_racks)
        for r in range(n_racks)
        if d < len(by_rack[r])
    ]
    topics: Dict[str, Dict[int, List[int]]] = {}
    for t in range(n_topics):
        base = t * 131
        topics[name_fmt.format(t)] = {
            p: [inter[(base + p * rf + i) % n_brokers] for i in range(rf)]
            for p in range(p_per_topic)
        }
    return topics, set(range(n_brokers)), racks


def build_config5():
    """BASELINE config 5: 1k brokers / 100 topics x 50 partitions / RF=3 /
    10 racks — the 256-scenario what-if fleet shape."""
    return rack_striped_cluster(1000, 100, 50, 3, 10)


def build_config4(n_brokers=5000, n_topics=2000, p_per_topic=100, rf=3,
                  n_racks=10, replaced=100):
    """BASELINE config 4, as ``bench.py:build_headline`` builds it: 5k
    brokers in 10 racks, 2,000 topics x 100 partitions at RF 3, brokers
    0-99 replaced by 5000-5099. Returns ``(topic_map, live, rack_map)``."""
    topic_map, _, racks = rack_striped_cluster(
        n_brokers, n_topics, p_per_topic, rf, n_racks,
        name_fmt="topic-{:04d}", extra_brokers=replaced,
    )
    live = set(range(replaced, n_brokers)) | set(
        range(n_brokers, n_brokers + replaced)
    )
    return topic_map, live, {b: racks[b] for b in live}
