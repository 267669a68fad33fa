#!/usr/bin/env python3
"""The port's headline bench on one NVIDIA GPU: BASELINE config 4 (5,000
brokers in 10 racks, 2,000 topics x 100 partitions at RF 3, brokers 0-99
replaced by 5000-5099), solved by the C++ greedy (``--solver native``) and
by the PyTorch/CUDA solver, the twin of ``bench.py``'s headline::

    python3 scripts/torch_bench.py [--warm 5]

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline",
"extra"}``: ``value`` is the device solve's warm median in ms,
``vs_baseline`` the C++ greedy's time over it. ``extra`` holds the greedy's
time, the device solve's cold time (the first solve of the process, the
kernels already built) and each warm time, the phase split of the last warm
solve, the moved replicas (asserted equal on both solvers), the leadership
lane (``KA_LEADERSHIP``) and the codec that ran, and the card's name and
power limit. It imports only the port. Without a card it exits non-zero:
there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def moved(topics, pairs) -> int:
    """Replicas on a broker that did not hold them."""
    by_name = dict(topics)
    total = 0
    for t, assignment in pairs:
        cur = by_name[t]
        for p, reps in assignment.items():
            old = set(cur[p])
            total += sum(1 for b in reps if b not in old)
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warm", type=int, default=5,
                        help="warm device solves; value is their median")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device: this bench measures the GPU solve",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.models.synthetic import build_config4
    from kafka_assigner_tpu_torch.native.build import build_hostcodec, build_native_library
    from kafka_assigner_tpu_torch.ops import build
    from kafka_assigner_tpu_torch.solvers.base import Context

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    build_native_library()
    build_hostcodec()
    build.build_all()
    # The stock configuration only: compat flips the chain's default.
    os.environ.pop("KA_RF_DECREASE_COMPAT", None)
    topic_map, live, rack_map = build_config4()
    topics = list(topic_map.items())

    t0 = time.perf_counter()
    base_pairs = TopicAssigner("native").generate_assignments(topics, live, rack_map)
    greedy_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    TopicAssigner("device", device="cuda").generate_assignments(topics, live, rack_map)
    cold_ms = (time.perf_counter() - t0) * 1e3
    assigner = TopicAssigner("device", device="cuda")
    warm, pairs = [], None
    for _ in range(args.warm):
        assigner.context = Context()
        t0 = time.perf_counter()
        pairs = assigner.generate_assignments(topics, live, rack_map)
        warm.append((time.perf_counter() - t0) * 1e3)
    solver = assigner.solver
    m_base, m_dev = moved(topics, base_pairs), moved(topics, pairs)
    if m_dev != m_base:
        raise AssertionError(f"movement parity broken: device {m_dev}, greedy {m_base}")
    value = statistics.median(warm)
    print(json.dumps({
        "metric": "headline_5kbrokers_200kpartitions_rf3_replace100_solve_torch",
        "value": value,
        "unit": "ms",
        "vs_baseline": greedy_ms / value,
        "extra": {
            "native_greedy_baseline_ms": greedy_ms,
            "device_cold_ms": cold_ms,
            "device_warm_ms": warm,
            "phase_ms": dict(solver.last_timers),
            "moved_replicas": m_dev,
            "total_replicas": sum(len(r) for t in topic_map.values() for r in t.values()),
            "leadership": solver.last_leadership,
            "codec": solver.last_codec,
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
