"""Traffic driver ``sweep``: what-if requests back to back, one client, a
closed loop, through ``parallel/whatif.py:evaluate_removal_scenarios`` with
the program's default knobs. A request is ``scenarios`` broker-removal
scenarios over the whole cluster.

Parameters: ``scenarios``, ``k_min``, ``k_max`` (``gen.removal_request``).
Check: every scenario answered, for its own removal; and ``sample``
scenarios of the window, drawn from the seed, each held to the plain
reference (``placement.removal_answer``): the feasibility and, where the
scenario is feasible, the moved replicas and the largest broker load,
exactly. The limits are 0.
"""
from __future__ import annotations


from kabench import gen
from kabench.harness import Reservoir
from kabench.reference import placement


class Driver:
    kind = "whatif"

    def __init__(self, cell, seed: int, device: str) -> None:
        from kafka_assigner_tpu_torch.native.build import build_hostcodec
        from kafka_assigner_tpu_torch.parallel import whatif

        build_hostcodec()
        self.cell, self.seed, self.device = cell, seed, device
        self.whatif = whatif
        self.topics, self.brokers, self.racks = gen.build_deployment(cell.config)
        self.sample = Reservoir(cell.check["sample"], seed)
        d = cell.config["deployment"]
        self.missing = 0
        self.shapes = {"topics": d["topics"], "partitions": d["partitions_per_topic"],
                       "rf": d["replication_factor"], "brokers": len(self.brokers),
                       "scenarios": cell.params["scenarios"]}

    def prepare(self, i: int):
        return gen.removal_request(self.cell.params, self.brokers, self.seed, i)

    def request(self, scenarios):
        return self.whatif.evaluate_removal_scenarios(
            self.topics, self.brokers, self.racks, scenarios, device=self.device)

    def warm(self) -> None:
        self.request(self.prepare(0))

    def observe(self, i: int, scenarios, out, rec: dict) -> None:
        rec["units"] = len(scenarios)
        rec["sweep"] = {k: v for k, v in self.whatif.last_sweep.items()
                        if isinstance(v, (int, float, str))}
        # Every answer has to come, for its own scenario: counted over the
        # whole window; the values are checked on the sample.
        self.missing += abs(len(scenarios) - len(out)) + sum(
            res.removed != tuple(sc) for sc, res in zip(scenarios, out))
        for s, res in enumerate(out):
            self.sample.offer((i, s), (res.moved_replicas, res.feasible, res.max_node_load))

    def phases(self, rec: dict):
        t = rec["sweep"]
        return "start", [(k, t.get(k, 0.0)) for k in ("prep", "sweep", "compose", "rescue")]

    def release(self) -> None:
        pass

    def check(self):
        flat = placement.flatten(list(self.topics.items()))
        differing = 0
        requests = {}
        for (i, s), got in self.sample.items:
            if i not in requests:
                requests[i] = self.prepare(i)
            want = placement.removal_answer(flat, self.brokers, self.racks,
                                            requests[i][s])
            differing += not placement.removal_agrees(want, got)
        return [("scenarios_checked_missing", max(0, 1 - len(self.sample.items)), 0),
                ("answers_missing_or_misplaced", self.missing, 0),
                ("scenarios_differing", differing, 0)]
