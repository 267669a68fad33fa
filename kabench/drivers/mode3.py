"""Traffic driver ``mode3``: the whole PRINT_REASSIGNMENT of the port's CLI
(``cli.run``: parsing, the snapshot read, feasibility, the solve through
``generator.py:print_least_disruptive_reassignment`` and the emitted JSON)
back to back, one client, a closed loop, from a snapshot file of the
deployment written in set-up under ``TMPDIR``.

Parameters: ``op`` ``decommission`` and ``per_rack`` (``gen.plan_request``):
each request removes brokers with ``--broker_hosts_to_remove``. Check:
``sample`` requests of the window, drawn from the seed, their NEW
ASSIGNMENT held row by row to the plain reference, as the ``solve``
driver's plans are; the limits are 0.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import tempfile

from kabench import gen
from kabench.drivers.solve import build_libraries, check_plans
from kabench.harness import Reservoir

MARK = "NEW ASSIGNMENT:\n"


def write_snapshot(path: str, topics, racks) -> None:
    """The deployment as the program's ``file://`` snapshot."""
    body = {
        "brokers": [{"id": b, "host": f"b{b}", "port": 9092, "rack": racks[b]}
                    for b in sorted(racks)],
        "topics": {t: {str(p): reps for p, reps in a.items()} for t, a in topics.items()},
    }
    with open(path, "w") as f:
        json.dump(body, f)


def parse_plan(text: str):
    """``[(topic, {partition: replicas})]`` of a NEW ASSIGNMENT payload."""
    payload = json.loads(text[text.index(MARK) + len(MARK):].strip().splitlines()[0])
    pairs = {}
    for e in payload["partitions"]:
        pairs.setdefault(e["topic"], {})[int(e["partition"])] = list(e["replicas"])
    return list(pairs.items())


class Driver:
    kind = "cli_plan"

    def __init__(self, cell, seed: int, device: str) -> None:
        from kafka_assigner_tpu_torch import cli

        build_libraries(device)
        self.cli, self.cell, self.seed, self.device = cli, cell, seed, device
        topics, self.brokers, self.racks = gen.build_deployment(cell.config)
        self.topics = sorted(topics.items())
        self.dir = tempfile.mkdtemp(prefix="kabench-")
        self.snapshot = os.path.join(self.dir, "cluster.json")
        write_snapshot(self.snapshot, topics, self.racks)
        self.sample = Reservoir(cell.check["sample"], seed)
        d = cell.config["deployment"]
        self.shapes = {"topics": d["topics"], "partitions": d["partitions_per_topic"],
                       "rf": d["replication_factor"], "brokers": len(self.brokers)}

    def prepare(self, i: int):
        live, _ = gen.plan_request(self.cell.config, self.cell.params, self.brokers,
                                   self.racks, self.seed, i)
        gone = ",".join(f"b{b}" for b in sorted(self.brokers - live))
        return live, ["--zk_string", f"file://{self.snapshot}", "--mode",
                      "PRINT_REASSIGNMENT", "--broker_hosts_to_remove", gone,
                      "--device", self.device]

    def request(self, args):
        from kafka_assigner_tpu_torch.generator import join_warmup_threads

        buf = io.StringIO()
        rc = self.cli.run(args[1], out=buf)
        join_warmup_threads()
        if rc != 0:
            raise RuntimeError(f"PRINT_REASSIGNMENT exited {rc}")
        return buf.getvalue()

    def warm(self) -> None:
        self.request(self.prepare(0))

    def observe(self, i: int, args, out, rec: dict) -> None:
        self.sample.offer(i, out)

    def phases(self, rec: dict):
        return "start", []

    def release(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    def check(self):
        def inputs(i):
            live, _ = self.prepare(i)
            return live, {b: self.racks[b] for b in live}

        sample, unreadable = [], 0
        for i, text in self.sample.items:
            try:
                sample.append((i, parse_plan(text)))
            except (ValueError, KeyError):
                unreadable += 1
        return check_plans(self.topics, sample, inputs) + [
            ("plans_unreadable", unreadable, 0)]
