"""The harness: one cell, one seed, one window.

Everything particular to a cell is data found by name: ``BENCHMARK.json``
lists the cells and metrics; ``kabench/workloads/<cell>.json`` gives the
cell's configuration, its traffic driver and the driver's parameters;
``kabench/configs/<config>.json`` the deployment; ``kabench/drivers/
<driver>.py`` the code that drives the program; ``kabench/metrics/
<metric>.py`` the reader of each metric. Adding a cell, a configuration or
a metric adds files and edits none.

A run: set-up (the driver builds the deployment from the seed and the
program's libraries, then warms the cell's shapes with one request), the
window (requests back to back for ``seconds``, each timed on the host's
clock; under ``trace`` inside ``torch.profiler``), the device's peak memory,
the program's state freed, then the check of a sample of the window's
answers against the plain reference (``kabench/reference/``), and the result
line.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from . import gen
from .trace import Tracer

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names no run may load: the JAX package this port was
#: made from, and JAX itself. Compared whole: the port's own name begins
#: with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "kafka_assigner_tpu")


def forbidden_modules(names) -> List[str]:
    """The names among ``names`` whose top-level package is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Cell:
    """One entry of ``workloads``, with its files read."""

    name: str
    config_name: str
    config: dict
    traffic: str
    driver: str
    params: dict
    check: dict
    chips: int


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files; the cell file
    has to agree with the entry on configuration, traffic and chips."""
    spec = load_spec(root) if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(root / "kabench" / "workloads" / f"{name}.json") as f:
        cell = json.load(f)
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {cell[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    return Cell(name, entry["config"], config, entry["traffic"], cell["driver"],
                cell["params"], cell["check"], entry["chips"])


def load_file(path: Path, name: str):
    """A module from a file (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    ``trace``, the per-layer ones with it; each where it lists the cell or
    lists none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _sampler(seed: int) -> random.Random:
    return random.Random(int(gen.sample_rng(seed).integers(1 << 62)))


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.seen = k, _sampler(seed), 0
        self.items: List[tuple] = []

    def draw(self) -> Optional[int]:
        """The place in the sample of the stream's next item, or None when
        the sample passes it by."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    def put(self, j: int, key, item) -> None:
        """``item`` into the place ``j`` that :meth:`draw` gave."""
        if j == len(self.items):
            self.items.append((key, item))
        else:
            self.items[j] = (key, item)

    def offer(self, key, item) -> None:
        """The stream's next item."""
        j = self.draw()
        if j is not None:
            self.put(j, key, item)


@dataclass
class RunData:
    """What a metric reader reads."""

    cell: Cell
    kind: str                       # the driver's kind of request
    shapes: dict                    # the driver's shapes of the work
    setup_s: float
    window_s: float
    records: List[dict] = field(default_factory=list)
    trace: Optional[dict] = None


def read_metrics(run: RunData, entries: Sequence[dict], root: Path = ROOT) -> dict:
    """Each entry's reader over ``run``; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        mod = load_file(root / "kabench" / "metrics" / f"{m['name']}.py",
                        f"kabench_metric_{m['name'].replace('.', '_')}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def cache_env(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout, and the
    program's stock settings: no ``KA_*`` knob from the caller's
    environment."""
    for k in [k for k in os.environ if k.startswith("KA_")]:
        del os.environ[k]
    build = root / "build"
    os.environ["KA_PROGRAM_STORE_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "kabench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "kabench" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "kabench" / "cuda")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, t_start: Optional[float] = None,
             check_modules: bool = True, patch=None) -> Tuple[dict, List[tuple]]:
    """One run; returns the result line's object and the numbers compared,
    ``[(name, value, limit)]``. ``patch(driver)`` lets a test break the
    timed path underneath the driver."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    spec = load_spec(root)
    cell = load_cell(workload, root, spec)
    drv_mod = load_file(root / "kabench" / "drivers" / f"{cell.driver}.py",
                        f"kabench_driver_{cell.driver}")
    driver = drv_mod.Driver(cell, seed, device)
    if patch is not None:
        patch(driver)
    driver.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    tracer = Tracer(trace)
    records: List[dict] = []
    failed = 0
    setup_s = time.perf_counter() - t_start
    with tracer.window():
        t_w0 = time.perf_counter()
        i = 1
        while True:
            args = driver.prepare(i)
            with tracer.request():
                t0 = time.perf_counter()
                try:
                    out = driver.request(args)
                except Exception as e:  # a failed request is counted, not fatal
                    print(f"kabench: request {i} failed: {type(e).__name__}: {e}",
                          file=sys.stderr)
                    out = None
                t1 = time.perf_counter()
            rec = {"i": i, "t0": t0 - t_w0, "t1": t1 - t_w0, "ok": out is not None}
            if out is None:
                failed += 1
            else:
                driver.observe(i, args, out, rec)
            records.append(rec)
            i += 1
            if t1 - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
    if check_modules:
        found = forbidden_modules(sys.modules)
        if found:
            raise SystemExit(f"kabench: forbidden modules loaded: {', '.join(found)}")
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                "count": cell.chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(d) for d in range(cell.chips))
                if device == "cuda" else 0}
    summary = None
    if trace:
        phases = [(driver.kind, *driver.phases(r)) if r["ok"] else (driver.kind, "start", [])
                  for r in records]
        t0 = time.perf_counter()
        summary = tracer.reduce(phases)
        print(f"kabench: trace reduced in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
    run = RunData(cell, driver.kind, driver.shapes, setup_s, window_s, records, summary)
    metrics = read_metrics(run, metrics_for(spec, cell.name, trace), root)
    driver.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = [("requests_failed", failed, 0)] + list(driver.check())
    print(f"kabench: {len(records)} requests in {window_s:.3f} s; checked in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks


def main(argv: Optional[Sequence[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache_env(ROOT)
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kabench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}: this benchmark measures the card", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"kabench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"kabench check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
