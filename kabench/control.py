"""The control of a cell: the plain reference put in the program's place with
one guarantee of the configuration broken, held to the same check as a run,
at the cell's own size::

    python3 kabench/control.py --workload <cell> --seeds <n> [<n> ...]

Plans (drivers ``solve`` and ``mode3``): the reference's plan with the
leaders unbalanced (``placement.plan(..., "leaders_unbalanced")``).
Removal sweeps (``sweep``): the reference's answers with movement no longer
minimal (``"unsticky"``). Each seed's requests and sample size are the
cell's own; one JSON line a seed gives the numbers the check compares, for
the control and for the sound reference beside it. A benchmark run never
runs this; it reads no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kabench import gen  # noqa: E402
from kabench.harness import load_cell  # noqa: E402
from kabench.reference import placement  # noqa: E402


def plan_readings(cell, seed: int) -> dict:
    topics, brokers, racks = gen.build_deployment(cell.config)
    flat = placement.flatten(sorted(topics.items()) if cell.driver == "mode3"
                             else list(topics.items()))
    out = {}
    for name, control in (("control", "leaders_unbalanced"), ("reference", None)):
        rows = 0
        for i in range(1, cell.check["sample"] + 1):
            live, rmap = gen.plan_request(cell.config, cell.params, brokers, racks, seed, i)
            pairs = placement.as_pairs(flat, placement.plan(flat, live, rmap, control))
            rows += placement.check_plan(flat, live, rmap, pairs)
        out[name] = {"plan_rows_differing": rows}
    return out


def sweep_readings(cell, seed: int) -> dict:
    topics, brokers, racks = gen.build_deployment(cell.config)
    flat = placement.flatten(list(topics.items()))
    scenarios = gen.removal_request(cell.params, brokers, seed, 1)[:cell.check["sample"]]
    out = {}
    for name, control in (("control", "unsticky"), ("reference", None)):
        differing = 0
        for removed in scenarios:
            want = placement.removal_answer(flat, brokers, racks, removed)
            answer = (want if control is None else
                      placement.removal_answer(flat, brokers, racks, removed, control))
            differing += not placement.removal_agrees(want, answer)
        out[name] = {"scenarios_differing": differing}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    read = sweep_readings if cell.driver == "sweep" else plan_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, **read(cell, seed)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
