#!/usr/bin/env python3
"""Config 4's placement phase on the card, for this checkout and another.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_place_ab.py [--reps 30] [--baseline DIR]

The phase is what ``TorchSolver`` times as ``place``: ``place_batched`` over
config 4's encoded topics (5,000 brokers in 10 racks, 2,000 topics x 100
partitions at RF 3, brokers 0-99 replaced by 5000-5099, the ``auto`` chain)
and the copy of the infeasible flags to the host, with the host clock and a
``torch.cuda.synchronize()`` on both sides; median of ``--reps`` after three
warm-up calls. Each checkout runs in its own process, importing its own
``kafka_assigner_tpu_torch``. With ``--baseline DIR`` (another checkout of
the repo, e.g. the parent commit unpacked with ``git archive`` into a
git-ignored directory) the runs go in turns: baseline, this, this,
baseline. The last line is one JSON object.
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


def time_checkout(root: str, reps: int) -> dict:
    """The placement phase of the checkout at ``root`` (run in a fresh
    process: the package is imported from there)."""
    sys.path.insert(0, root)
    import torch

    import kafka_assigner_tpu_torch
    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models.problem import encode_topic_group
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.ops.assignment import place_batched

    topic_map, _, racks = rack_striped_cluster(5000, 2000, 100, 3, 10,
                                               name_fmt="topic-{:04d}",
                                               extra_brokers=100)
    live = set(range(100, 5100))
    encs, cur, jh, pr = encode_topic_group(list(topic_map.items()),
                                           {b: racks[b] for b in live}, live, 3)
    args = [to_tensor(a, "cuda") for a in (cur, encs[0].rack_idx, jh, pr)]
    b = len(encs)

    def place():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = place_batched(*args, encs[0].n, 3, "auto", None, r_cap=encs[0].r_cap)
        infeasible = placed.infeasible[:b].cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, placed.waves, bool(infeasible.any())

    for _ in range(3):
        place()
    runs = [place() for _ in range(reps)]
    ms = [r[0] for r in runs]
    return {"root": os.path.dirname(os.path.dirname(kafka_assigner_tpu_torch.__file__)),
            "median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "waves": runs[-1][1], "infeasible": runs[-1][2]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--baseline", default=None, metavar="DIR")
    p.add_argument("--time-checkout", default=None, metavar="DIR",
                   help=argparse.SUPPRESS)  # one process per checkout
    args = p.parse_args()
    if args.time_checkout is not None:
        print(json.dumps(time_checkout(os.path.abspath(args.time_checkout), args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_place_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    order = [ROOT] if args.baseline is None else [args.baseline, ROOT, ROOT, args.baseline]
    runs = []
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-checkout", root,
             "--reps", str(args.reps)],
            capture_output=True, text=True, check=True, timeout=600,
        ).stdout.strip().splitlines()[-1]
        run = json.loads(out)
        runs.append(run)
        print(f"placement at config 4, {run['root']}: median {run['median_ms']:.2f} ms "
              f"of {args.reps} (min {run['min_ms']:.2f}, max {run['max_ms']:.2f}), "
              f"waves {run['waves']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
