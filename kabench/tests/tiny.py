"""Tiny deployments and cells for the harness's CPU tests, and a copy of
the benchmark in a temporary directory with them added as files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from kabench.harness import ROOT, Cell

TINY = {
    "name": "tiny_60b",
    "source": "a tiny rack-striped cluster for the CPU tests",
    "deployment": {"layout": "rack_striped", "brokers": 60, "racks": 5, "topics": 30,
                   "partitions_per_topic": 12, "replication_factor": 3,
                   "topic_name": "topic-{:03d}", "rack_name": "rack{}"},
    "reduced": [],
}

#: driver -> (traffic, params, check)
CELLS = {
    "solve": ("replace10", {"op": "replace", "per_rack": 2, "new_id_base": 60,
                            "new_id_span": 100}, {"sample": 3}),
    "sweep": ("sweep16", {"scenarios": 16, "k_min": 1, "k_max": 10}, {"sample": 8}),
    "mode3": ("decommission10", {"op": "decommission", "per_rack": 2}, {"sample": 2}),
}


def cell(driver: str) -> Cell:
    traffic, params, check = CELLS[driver]
    return Cell(f"tiny_60b.{traffic}", "tiny_60b", TINY, traffic, driver, params, check, 1)


def bench_copy(tmp: Path) -> Path:
    """``BENCHMARK.json`` and ``kabench/`` copied under ``tmp``, with the tiny
    configuration and one tiny cell a driver added as files and entries."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "kabench", root / "kabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "kabench" / "configs" / "tiny_60b.json").write_text(json.dumps(TINY))
    spec["configs"].append({"name": "tiny_60b", "source": TINY["source"],
                            "file": "kabench/configs/tiny_60b.json", "reduced": [],
                            "why": "CPU tests"})
    for driver, (traffic, params, check) in CELLS.items():
        name = f"tiny_60b.{traffic}"
        (root / "kabench" / "workloads" / f"{name}.json").write_text(json.dumps({
            "config": "tiny_60b", "traffic": traffic, "chips": 1, "driver": driver,
            "params": params, "check": check}))
        spec["workloads"].append({"name": name, "config": "tiny_60b", "traffic": traffic,
                                  "chips": 1, "why": "CPU tests"})
        kind = {"solve": "plan_ms", "sweep": "scenarios_per_s"}.get(driver)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if kind is not None and kind in (m["name"], m.get("moves")):
                m.setdefault("workloads", []).append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
