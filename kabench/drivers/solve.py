"""Traffic driver ``solve``: reassignment plans back to back, one client, a
closed loop, through the program's in-process plan entry
(``TopicAssigner("device").generate_assignments``, a fresh leadership
context every plan, as a fresh CLI run has).

Parameters: ``op`` (``replace`` or ``expand``), ``per_rack``,
``new_id_base``, ``new_id_span`` (``gen.plan_request``). Check: ``sample``
plans of the whole window, drawn from the seed, each row equal to the plain
reference's (``placement.check_plan``: the brokers, the orphans' included,
and their order); the limits are 0. A run that completes none is not
correct.
"""
from __future__ import annotations

import pickle
import sys

from kabench import gen
from kabench.harness import Reservoir
from kabench.reference import placement


def build_libraries(device: str) -> None:
    """The program's native codec and, on the card, its kernels: built into
    the checkout's store on a first run, found there after."""
    from kafka_assigner_tpu_torch.native.build import build_hostcodec

    build_hostcodec()
    if device == "cuda":
        from kafka_assigner_tpu_torch.ops import build

        build.build_all()


class Driver:
    kind = "plan"

    def __init__(self, cell, seed: int, device: str) -> None:
        from kafka_assigner_tpu_torch.assigner import TopicAssigner

        build_libraries(device)
        self.cell, self.seed, self.device = cell, seed, device
        self.assigner = TopicAssigner
        topics, self.brokers, self.racks = gen.build_deployment(cell.config)
        self.topics = list(topics.items())
        self.sample = Reservoir(cell.check["sample"], seed)
        d = cell.config["deployment"]
        live, _ = self.prepare(0)
        self.shapes = {"topics": d["topics"], "partitions": d["partitions_per_topic"],
                       "rf": d["replication_factor"], "brokers": len(live)}
        self.solver = None

    def prepare(self, i: int):
        return gen.plan_request(self.cell.config, self.cell.params, self.brokers,
                                self.racks, self.seed, i)

    def request(self, args):
        live, racks = args
        assigner = self.assigner("device", device=self.device)
        out = assigner.generate_assignments(self.topics, live, racks)
        self.solver = assigner.solver
        return out

    def warm(self) -> None:
        self.request(self.prepare(0))

    def observe(self, i: int, args, out, rec: dict) -> None:
        rec["timers"] = dict(self.solver.last_timers)
        j = self.sample.draw()
        if j is not None:
            # Kept as bytes: a plan held as objects is some 600,000
            # containers at config 4, which the collector would scan on
            # every full collection of the program's later plans.
            self.sample.put(j, i, pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL))

    def phases(self, rec: dict):
        t = rec["timers"]
        return "end", [(k, t.get(k, 0.0)) for k in ("encode", "place", "leadership", "decode")]

    def release(self) -> None:
        self.solver = None

    def check(self):
        return check_plans(self.topics, [(i, pickle.loads(b)) for i, b in self.sample.items],
                           self.prepare)


def check_plans(topics, sample, prepare):
    """The numbers compared for a sample ``[(request, plan)]`` of plans."""
    flat = placement.flatten(topics)
    rows = 0
    before = dict(topics)
    for i, pairs in sorted(sample, key=lambda x: x[0]):
        live, racks = prepare(i)
        rows += placement.check_plan(flat, live, racks, pairs)
        print(f"kabench: plan {i} moved {gen.moved(before, pairs)} replicas",
              file=sys.stderr)
    return [("plans_checked_missing", max(0, 1 - len(sample)), 0),
            ("plan_rows_differing", rows, 0)]
