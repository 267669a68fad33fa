"""The port's mesh across real processes (``torch.distributed`` over
``gloo`` on the CPU), as ``tests/test_distributed.py`` runs the JAX package's
over ``jax.distributed``: each worker starts the process group with
``initialize_distributed`` on a free local port, builds one mesh over every
rank's positions, and must reproduce the single-process port's results and
the JAX package's, bit for bit:

- 2 processes x 1 position and 2 processes x 4 positions on the scenario
  axis (``evaluate_removal_scenarios(mesh=)``, both sweep paths);
- 4 processes x 1 position on the part axis (``TorchSolver(mesh=)``).

The workers import neither ``jax`` nor the JAX package: the parent writes
each instance to a JSON file. Every worker runs under its own
``communicate(timeout=)`` and is killed in ``finally``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.parallel.whatif import evaluate_removal_scenarios as jax_evaluate
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.parallel.whatif import evaluate_removal_scenarios
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from .test_invariants import make_cluster

ROOT = Path(__file__).resolve().parent.parent

_WORKER = textwrap.dedent(
    """
    import json, os, sys, time
    import torch
    torch.set_num_threads(1)
    port, pid, n_procs, positions, path = sys.argv[1:6]
    pid, n_procs, positions = int(pid), int(n_procs), int(positions)
    from kafka_assigner_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed, process_count)
    initialize_distributed(f"localhost:{port}", n_procs, pid)
    assert process_count() == n_procs
    with open(path) as f:
        case = json.load(f)
    topics = {t: {int(p): r for p, r in cur.items()} for t, cur in case["topics"].items()}
    live = set(case["live"])
    racks = {int(b): r for b, r in case["racks"].items()}
    devices = ["cpu"] * positions
    t0 = time.perf_counter()
    if case["kind"] == "scenarios":
        from kafka_assigner_tpu_torch.parallel.whatif import evaluate_removal_scenarios
        mesh = build_mesh(devices=devices)
        out = {}
        for inc in ("1", "0"):
            os.environ["KA_WHATIF_INCREMENTAL"] = inc
            res = evaluate_removal_scenarios(topics, live, racks, case["scenarios"], 3,
                                             device="cpu", mesh=mesh)
            out[inc] = [[list(r.removed), r.moved_replicas, r.feasible, r.max_node_load]
                        for r in res]
        shape = mesh.shape
    else:
        from kafka_assigner_tpu_torch.assigner import TopicAssigner
        from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver
        mesh = build_mesh(1, n_procs * positions, devices=devices)
        solver = TorchSolver("cpu", mesh=mesh)
        assigner = TopicAssigner(solver)
        pairs = assigner.generate_assignments(sorted(topics.items()), live, racks, -1)
        out = {"pairs": [[t, sorted(a.items())] for t, a in pairs],
               "counter": sorted(assigner.context.counter.items()),
               "collectives": solver.last_collectives}
        shape = mesh.shape
    print("RESULT:" + json.dumps({"pid": pid, "shape": shape, "out": out,
                                  "elapsed_s": time.perf_counter() - t0}), flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(tmp_path, case, n_procs, positions, timeout_s=40):
    """``n_procs`` workers on ``case``; their parsed RESULT payloads."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    path = tmp_path / "case.json"
    path.write_text(json.dumps(case))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(i), str(n_procs),
             str(positions), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=str(ROOT),
        )
        for i in range(n_procs)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout_s)
            assert proc.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        # Never leave a worker blocked in a collective.
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT:")][-1]
        got.append(json.loads(line[len("RESULT:"):]))
    assert [g["pid"] for g in got] == list(range(n_procs))
    return got


def _case(kind, current, live, rack_map, n_topics, scenarios=None):
    return {"kind": kind,
            "topics": {f"t{i}": {str(p): r for p, r in current.items()}
                       for i in range(n_topics)},
            "live": sorted(live), "racks": {str(b): r for b, r in rack_map.items()},
            "scenarios": scenarios}


def _scenario_run(tmp_path, n_brokers, n_topics, n_scenarios, n_procs, positions):
    current, live, rack_map = make_cluster(0, n_brokers, 32, 3, 4)
    topics = {f"t{i}": current for i in range(n_topics)}
    scenarios = [[100 + i] for i in range(n_scenarios)]
    expected = [[list(r.removed), r.moved_replicas, r.feasible, r.max_node_load]
                for r in jax_evaluate(topics, live, rack_map, scenarios, 3)]
    single = [[list(r.removed), r.moved_replicas, r.feasible, r.max_node_load]
              for r in evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                                  device="cpu")]
    assert single == expected
    got = _run(tmp_path, _case("scenarios", current, live, rack_map, n_topics, scenarios),
               n_procs, positions)
    for g in got:
        assert g["shape"] == {"scenarios": n_procs * positions, "part": 1}
        assert g["out"]["1"] == g["out"]["0"] == expected, g["pid"]
    return expected


def test_two_processes_one_position_each_on_the_scenario_axis(tmp_path):
    """``test_two_process_mesh_matches_single_process``."""
    _scenario_run(tmp_path, 16, 2, 4, 2, 1)


def test_two_processes_four_positions_each_on_the_scenario_axis(tmp_path):
    """``test_two_process_fleet_scale``: 2 processes x 4 positions (8
    global), 32 scenarios over a 128-broker cluster, 8 topics, all
    feasible."""
    expected = _scenario_run(tmp_path, 128, 8, 32, 2, 4)
    assert all(row[2] for row in expected)


def test_four_processes_on_the_part_axis(tmp_path):
    """``TorchSolver(mesh=build_mesh(1, 4))`` over 4 processes of one
    position each: every rank returns the single-process port's
    assignments and context, which are the JAX package's."""
    current, live, rack_map = make_cluster(3, 12, 64, 3, 4)
    topics = sorted({f"t{i}": current for i in range(3)}.items())
    ja, ta = JaxAssigner(TpuSolver()), TopicAssigner(TorchSolver("cpu"))
    ref = ja.generate_assignments(topics, live, rack_map, -1)
    single = ta.generate_assignments(topics, live, rack_map, -1)
    assert single == ref and ta.context.counter == ja.context.counter
    want = [[t, sorted(a.items())] for t, a in single]
    got = _run(tmp_path, _case("part", current, live, rack_map, 3), 4, 1)
    counter = json.loads(json.dumps(sorted(ta.context.counter.items())))
    for g in got:
        assert g["shape"] == {"scenarios": 1, "part": 4}
        assert g["out"]["pairs"] == json.loads(json.dumps(want)), g["pid"]
        assert g["out"]["counter"] == counter
        assert g["out"]["collectives"] > 0
    assert len({g["out"]["collectives"] for g in got}) == 1
