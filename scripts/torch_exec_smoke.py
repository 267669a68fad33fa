#!/usr/bin/env python
"""Plan-execution smoke for the port: the crash and resume contract of
``ka-execute`` (``kafka_assigner_tpu_torch/exec/``) on the snapshot
backend's simulated cluster, end to end in a few seconds. The twin of
``scripts/exec_smoke.py``, with the port's entries only (no ``jax``, nothing
of ``kafka_assigner_tpu``, no ``torch`` needed to execute).

    python scripts/torch_exec_smoke.py

Steps, on a fresh temporary cluster, so the outcome is deterministic:

1. plan: mode 3 on the greedy lane over a 9-broker, 3-rack snapshot
   (``tests/jute_server.py:exec_snapshot_cluster``), one broker drained: a
   real multi-wave reassignment;
2. baseline: ``ka-execute`` drives a copy of the cluster to convergence
   uninterrupted: exit 0, final snapshot bytes A, journal complete;
3. kill: a second copy executes under the fault schedule ``wave:1=crash``
   (installed as ``KA_FAULTS_SPEC=wave:1=crash`` would install it) and
   dies at the wave boundary after the first committed wave
   (``InjectedExecCrash``); the journal is ``in-progress`` with one
   committed wave;
4. resume: ``ka-execute --resume`` finishes the run: exit 0, final bytes
   equal to A, the journal complete, and the run report shows the verify
   pass (``exec.verify``) and no skipped move.

Prints ``torch_exec_smoke: PASS ...`` on stderr and exits 0, else 1.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _fixture_cluster() -> dict:
    """The write-path fixture shared with the reference's harnesses, loaded
    from ``tests/jute_server.py`` by path (it imports only the stdlib)."""
    spec = importlib.util.spec_from_file_location(
        "jute_server", os.path.join(REPO, "tests", "jute_server.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.exec_snapshot_cluster()


def _capture(fn, *args):
    out, err = io.StringIO(), io.StringIO()
    box = {}

    def _target():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                box["rc"] = fn(*args)
            except BaseException as e:
                box["exc"] = e

    t = threading.Thread(target=_target, daemon=True)
    t.start()
    t.join(120)
    if t.is_alive():
        print(f"FAIL: hung\n{err.getvalue()}", file=sys.stderr)
        raise SystemExit(1)
    return box, out.getvalue(), err.getvalue()


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    from kafka_assigner_tpu_torch import faults
    from kafka_assigner_tpu_torch.cli import execute, run
    from kafka_assigner_tpu_torch.faults.inject import InjectedExecCrash

    saved_env = dict(os.environ)
    try:
        with tempfile.TemporaryDirectory(prefix="ka_torch_execsmoke_") as d:
            src = os.path.join(d, "cluster.json")
            with open(src, "w", encoding="utf-8") as f:
                json.dump(_fixture_cluster(), f)
            plan = os.path.join(d, "plan.json")
            box, out, err = _capture(run, [
                "--zk_string", src, "--mode", "PRINT_REASSIGNMENT",
                "--solver", "greedy", "--broker_hosts_to_remove", "h9",
                "--device", "cpu",
            ])
            if box.get("rc") != 0 or "NEW ASSIGNMENT:" not in out:
                return _fail(f"plan generation rc={box.get('rc')}\n{err}")
            with open(plan, "w", encoding="utf-8") as f:
                f.write(out)

            os.environ.update({
                "KA_EXEC_WAVE_SIZE": "3",
                "KA_EXEC_POLL_INTERVAL": "0.01",
                "KA_EXEC_POLL_TIMEOUT": "10",
                "KA_EXEC_SIM_POLLS": "1",
            })
            faults.reset()

            # 1. uninterrupted baseline: final bytes A
            base = os.path.join(d, "base.json")
            shutil.copy(src, base)
            box, _, err = _capture(execute, [
                "--zk_string", base, "--plan", plan,
                "--journal", base + ".journal",
            ])
            if box.get("rc") != 0:
                return _fail(f"baseline execution rc={box.get('rc')}\n{err}")
            with open(base, "r", encoding="utf-8") as f:
                final_a = f.read()

            # 2. killed at the wave boundary after wave 1
            intr = os.path.join(d, "intr.json")
            journal = intr + ".journal"
            shutil.copy(src, intr)
            faults.install(faults.FaultInjector(faults.parse_spec("wave:1=crash")))
            box, _, err = _capture(execute, [
                "--zk_string", intr, "--plan", plan, "--journal", journal,
            ])
            if not isinstance(box.get("exc"), InjectedExecCrash):
                return _fail(f"expected the injected wave-boundary kill, got "
                             f"rc={box.get('rc')} exc={box.get('exc')!r}\n{err}")
            with open(journal, "r", encoding="utf-8") as f:
                j = json.load(f)
            if j["status"] != "in-progress" or j["waves_committed"] != 1:
                return _fail(f"journal after the kill should be in-progress at "
                             f"wave 1, got {j['status']}/{j['waves_committed']}")

            # 3. resume: byte-identical final state, verified
            faults.reset()
            report = os.path.join(d, "resume_report.json")
            box, _, err = _capture(execute, [
                "--zk_string", intr, "--plan", plan, "--journal", journal,
                "--resume", "--report-json", report,
            ])
            if box.get("rc") != 0:
                return _fail(f"resume rc={box.get('rc')}\n{err}")
            with open(intr, "r", encoding="utf-8") as f:
                if f.read() != final_a:
                    return _fail("resumed final state is not byte-identical to "
                                 "the uninterrupted run")
            with open(journal, "r", encoding="utf-8") as f:
                if json.load(f)["status"] != "complete":
                    return _fail("resumed journal not complete")
            with open(report, "r", encoding="utf-8") as f:
                rep = json.load(f)
            counters = rep["metrics"]["counters"]
            if not counters.get("exec.verify") or not counters.get("exec.waves"):
                return _fail(f"exec counters missing from the resume report ({counters})")
            if rep["plan"].get("skipped_moves"):
                return _fail("clean resume reported skipped moves")
            print(
                f"torch_exec_smoke: PASS (waves={counters['exec.waves']} "
                f"moves={counters.get('exec.moves', 0)} resumed byte-identical)",
                file=sys.stderr,
            )
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        faults.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
