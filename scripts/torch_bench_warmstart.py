#!/usr/bin/env python3
"""Warm start of the port in fresh processes on one NVIDIA GPU: BASELINE
config 4's mode-3 solve (5,000 brokers in 10 racks, 2,000 topics x 100
partitions at RF 3, brokers 0-99 replaced) through the port's CLI on
``cuda`` with ``--report-json``, each run a fresh process on one temporary
library store::

    python3 scripts/torch_bench_warmstart.py [--snapshot PATH]

The children, in this order:

- ``cold``: an empty store, so the run builds every library;
- ``warm``: the same store, ``KA_WARMUP=0``;
- ``warm_overlap``: the same store, the warm-up on;
- ``off``: ``KA_PROGRAM_STORE=0 KA_WARMUP=0`` (built into the process's
  temporary directory).

Before them, one fresh process times ``import torch`` and then the first
CUDA context (``torch.zeros(1, device="cuda")`` and a synchronize), beside
its own wall.
Prints ONE JSON line with, per child: the CLI wall (the parent's clock
around the process), the child's own wall, the startup library builds or
loads (``prebuild_ms``, before the CLI's report capture), the report's
``compile.store.*``, ``warmup.*``, ``plan/solve`` and ``warmup`` span, the
windows of the streamed ingest, the warm-up and each of its steps (the
host libraries, the CUDA context, the leadership kernel's library, the
inert pass) and of each toolchain's fingerprint (``fingerprint:cuda``
holds the ``nvcc`` version probe and the card's facts), in ms since the
child started, the leadership kernel's launches and the plan's sha256; and the
card's name and power limit. It asserts that every plan is the same bytes
and that each child launched the kernel once; it asserts no speed ratio.
Without a card it exits 1: there is no CPU fallback. ``--snapshot`` reads
the cluster from a ``file://`` snapshot instead of building config 4.

Child mode (also used by ``chip_smoke.py`` phase 21)::

    python3 scripts/torch_bench_warmstart.py --child {cli,warm} ARGV...

runs the port's ``cli.run`` (or ``cli.run_warm``) on ARGV in this process,
under an outer obs capture, after timing the startup build of the native
libraries, and prints ``KA_CHILD <json>`` as the last line of stderr: the
exit code, the leadership kernel's launches, the outer capture's counters
and histogram sums (``compile.store.*`` outside a ``--report-json``
capture), the windows, and the import of torch as this process paid it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODE = "mode/PRINT_REASSIGNMENT"
#: Where the children solve (a CPU rehearsal of the bench's logic sets it).
DEVICE = "cuda"
CHILD_TAG = "KA_CHILD "
#: The warm-up's steps (``solvers/warmup.py:_make_resident``), each timed
#: as a window of its own.
WARMUP_STEPS = ("load_libraries", "create_context", "load_kernel", "inert_pass")
CHILDREN = (
    ("cold", {}),
    ("warm", {"KA_WARMUP": "0"}),
    ("warm_overlap", {}),
    ("off", {"KA_PROGRAM_STORE": "0", "KA_WARMUP": "0"}),
)


def child(kind: str, argv) -> int:
    """One fresh-process run of the CLI or ``ka-warm`` (see the module
    docstring); returns its exit code."""
    t_start = time.perf_counter()
    import torch  # noqa: F401  (its import, timed as this process pays it)

    torch_ms = (time.perf_counter() - t_start) * 1e3
    sys.path.insert(0, ROOT)
    from kafka_assigner_tpu_torch import cli, generator, obs
    from kafka_assigner_tpu_torch.native import build as nbuild
    from kafka_assigner_tpu_torch.ops import leadership
    from kafka_assigner_tpu_torch.solvers import warmup
    from kafka_assigner_tpu_torch.utils import programstore

    windows = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                windows.setdefault(name, []).append(
                    [(t0 - t_start) * 1e3, (time.perf_counter() - t_start) * 1e3])
        return wrapper

    generator.stream_initial_assignment = timed(
        "ingest", generator.stream_initial_assignment)
    warmup.warm_solver_programs = timed("warmup", warmup.warm_solver_programs)
    for step in WARMUP_STEPS:
        setattr(warmup, f"_{step}", timed(f"warmup:{step}", getattr(warmup, f"_{step}")))
    facts = programstore._fingerprint_facts
    programstore._fingerprint_facts = lambda kind="host": timed(
        f"fingerprint:{kind}", facts)(kind)
    with obs.run_capture() as outer:
        t0 = time.perf_counter()
        nbuild.prebuild_native_libraries()
        prebuild_ms = (time.perf_counter() - t0) * 1e3
        rc = cli.run(argv) if kind == "cli" else cli.run_warm(argv)
    sys.stdout.flush()
    print(CHILD_TAG + json.dumps({
        "rc": rc,
        "torch_import_ms": torch_ms,
        "prebuild_ms": prebuild_ms,
        "child_ms": (time.perf_counter() - t_start) * 1e3,
        "launches": leadership.launches["leadership"],
        "counters": dict(outer.counters),
        "hist_sums": {k: {"count": h["count"], "sum": h["sum"]}
                      for k, h in outer.hists.items()},
        "windows": windows,
    }), file=sys.stderr)
    return rc


def run_child(kind: str, argv, env=None, timeout: float = 600.0) -> dict:
    """Run :func:`child` in a fresh process; returns what it printed, with
    ``wall_ms`` (this process's clock around it), ``stdout`` and the tail
    of its stderr."""
    full_env = dict(os.environ, **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", kind, *argv],
        cwd=ROOT, env=full_env, capture_output=True, text=True, timeout=timeout,
    )
    wall_ms = (time.perf_counter() - t0) * 1e3
    tagged = [ln for ln in proc.stderr.splitlines() if ln.startswith(CHILD_TAG)]
    if not tagged:
        raise RuntimeError(f"child {kind} {argv} exited {proc.returncode} without a "
                           f"result: {proc.stderr[-2000:]}")
    out = json.loads(tagged[-1][len(CHILD_TAG):])
    out.update(wall_ms=wall_ms, exit=proc.returncode, stdout=proc.stdout,
               stderr_tail=proc.stderr[-1500:])
    return out


def report_numbers(path: str) -> dict:
    """What the bench reads from one run report."""
    with open(path, encoding="utf-8") as f:
        report = json.load(f)
    m = report["metrics"]
    spans = {s["path"]: s["ms"] for s in report["spans"]}
    return {
        "status": report["status"],
        "store": {k: v for k, v in m["counters"].items() if k.startswith("compile.store.")},
        "store_ms": {k: h["sum"] for k, h in m["histograms"].items()
                     if k.startswith("compile.store.")},
        "warmup_counters": {k: v for k, v in m["counters"].items()
                            if k.startswith("warmup.")},
        "warmup_span_ms": spans.get("warmup"),
        "metadata_ms": spans.get(f"{MODE}/metadata/assignment"),
        "plan_solve_ms": spans.get(f"{MODE}/plan/solve"),
        "mode_ms": spans.get(MODE),
    }


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def fresh_process_ms(code: str) -> tuple:
    """``(wall ms, its stdout)`` of ``python -c code`` in a fresh process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, check=True)
    return (time.perf_counter() - t0) * 1e3, proc.stdout.strip()


#: Prints the import's and the first context's ms, in this order.
STARTUP_CODE = (
    "import time\n"
    "t = time.perf_counter()\n"
    "import torch\n"
    "u = time.perf_counter()\n"
    "torch.zeros(1, device='cuda')\n"
    "torch.cuda.synchronize()\n"
    "print((u - t) * 1e3, (time.perf_counter() - u) * 1e3)\n"
)


def main(argv=None) -> int:
    if argv is None and len(sys.argv) > 2 and sys.argv[1] == "--child":
        return child(sys.argv[2], sys.argv[3:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--snapshot", default=None,
                        help="a file://-readable cluster snapshot (default: build "
                             "config 4)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_bench_warmstart: no CUDA device: this bench measures the GPU "
              "port's warm start", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    with tempfile.TemporaryDirectory(prefix="ka-warmstart-") as work:
        line = bench(work, args.snapshot, smi)
    if line is None:
        return 1
    print(json.dumps(line))
    return 0


def bench(work: str, snap, smi: str):
    """The bench's runs in the scratch directory ``work``; its JSON line,
    or None after a failure (said on stderr)."""
    if snap is None:
        sys.path.insert(0, ROOT)
        from kafka_assigner_tpu_torch.models.synthetic import build_config4

        topic_map, live, rack_map = build_config4()
        snap = os.path.join(work, "config4.json")
        with open(snap, "w", encoding="utf-8") as f:
            json.dump({
                "brokers": [{"id": b, "host": f"b{b}", "port": 9092, "rack": rack_map[b]}
                            for b in sorted(live)],
                "topics": {t: {str(p): r for p, r in parts.items()}
                           for t, parts in topic_map.items()},
            }, f)

    startup_wall, startup_out = fresh_process_ms(STARTUP_CODE)
    import_ms, context_ms = map(float, startup_out.split())
    store = os.path.join(work, "store")
    base_env = {"KA_PROGRAM_STORE_DIR": store}
    results, plans = {}, set()
    for name, env in CHILDREN:
        report = os.path.join(work, f"{name}.json")
        argv_c = ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT",
                  "--device", DEVICE, "--report-json", report]
        r = run_child("cli", argv_c, {**base_env, **env})
        if r["rc"] != 0 or r["exit"] != 0:
            print(f"torch_bench_warmstart: {name} exited {r['exit']}: {r['stderr_tail']}",
                  file=sys.stderr)
            return None
        if r["launches"] != 1:
            print(f"torch_bench_warmstart: {name} launched the leadership kernel "
                  f"{r['launches']} times, not once", file=sys.stderr)
            return None
        plans.add(r["stdout"])
        results[name] = {
            "cli_wall_ms": r["wall_ms"],
            "child_ms": r["child_ms"],
            "torch_import_ms": r["torch_import_ms"],
            "prebuild_ms": r["prebuild_ms"],
            "prebuild_store": r["counters"],
            "prebuild_store_ms": {k: v["sum"] for k, v in r["hist_sums"].items()},
            "windows": r["windows"],
            "launches": r["launches"],
            "plan_sha256": hashlib.sha256(r["stdout"].encode()).hexdigest(),
            **report_numbers(report),
        }
    if len(plans) != 1:
        print("torch_bench_warmstart: the children's plans differ", file=sys.stderr)
        return None
    return {
        "metric": "warmstart_config4",
        "device": smi,
        "torch_import_ms": import_ms,
        "cuda_context_ms": context_ms,
        "startup_wall_ms": startup_wall,
        "plans_identical": True,
        "children": results,
    }


if __name__ == "__main__":
    sys.exit(main())
