"""The port stands alone: every module of ``kafka_assigner_tpu_torch``,
``chip_smoke.py`` and the port's bench scripts import with ``jax`` and
``kafka_assigner_tpu`` blocked (checked in a fresh subprocess, since this
test process has both loaded), the native libraries it loads are its own
builds under ``build/``, and the entry points default to ``cuda``."""
from __future__ import annotations

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kafka_assigner_tpu_torch
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = r"""
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "kafka_assigner_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(sys.modules)
print("ok", len(sys.argv) - 1)
"""


def _port_modules():
    mods = ["kafka_assigner_tpu_torch"]
    for info in pkgutil.walk_packages(
        kafka_assigner_tpu_torch.__path__, "kafka_assigner_tpu_torch."
    ):
        mods.append(info.name)
    return mods


def test_every_port_module_and_chip_smoke_import_without_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert "kafka_assigner_tpu_torch.ops.leadership" in mods
    assert "kafka_assigner_tpu_torch.parallel.whatif" in mods
    for new in ("io.base", "obs.health", "solvers.greedypack", "groups", "groups.model",
                "groups.encode", "groups.solve", "groups.__main__", "ops.group_pack",
                "ops.group_pack_cases", "errors", "native", "native.build",
                "native.leadership", "solvers.greedy", "solvers.native", "obs",
                "obs.trace", "obs.metrics", "obs.report", "obs.flight", "obs.names",
                "obs.profile", "obs.promtext", "faults", "faults.inject", "utils.logging",
                "io.zk", "io.zkwire", "io.kafka_admin",
                "utils.backoff", "utils.programstore", "solvers.warmup", "warm",
                "warm.__main__", "exec", "exec.engine", "exec.journal",
                "exec.__main__", "utils.atomicwrite", "daemon", "daemon.state",
                "daemon.supervisor", "daemon.service", "daemon.__main__",
                "daemon.dispatch", "daemon.controller", "daemon.fleet"):
        assert f"kafka_assigner_tpu_torch.{new}" in mods, new
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *mods], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == f"ok {len(mods)}"


_PATHS = r"""
import os
from pathlib import Path
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

tm, _, racks = rack_striped_cluster(20, 2, 40, 3, 5, extra_brokers=2)
live = set(range(2, 22))
rack_map = {b: racks[b] for b in live}
solver = TorchSolver("cpu")
os.environ["KA_DENSE_MASK_BUDGET"] = "64"          # the giant-shape chain
solver.assign_many(list(tm.items()), rack_map, live, 3)
assert "fast" in solver.last_waves, solver.last_waves
solver.fresh_assignment("fresh", 30, live, rack_map, 2)
assert "balance_slots" in solver.last_waves, solver.last_waves
del os.environ["KA_DENSE_MASK_BUDGET"]
os.environ["KA_RF_DECREASE_COMPAT"] = "1"          # compat width on a decrease
cur = {0: [1, 2, 3], 1: [4, 5, 6], 2: [1, 5, 6], 3: [2, 3, 4]}
(_, out), = TopicAssigner(device="cpu").generate_assignments(
    [("t", cur)], set(range(1, 7)), {b: f"r{b % 3}" for b in range(1, 7)}, 2)
assert all(len(r) == 3 for r in out.values()), out
del os.environ["KA_RF_DECREASE_COMPAT"]
from kafka_assigner_tpu_torch.parallel import whatif  # the what-if sweeps
tm, live, racks = rack_striped_cluster(200, 64, 4, 3, 5)
for flag in ("1", "0"):
    os.environ["KA_WHATIF_INCREMENTAL"] = flag
    res = whatif.rank_decommission_candidates(tm, live, racks, [0, 1, 2], device="cpu")
    assert [r.removed for r in res] and all(r.feasible for r in res), res
    assert whatif.last_sweep["path"] == ("incremental" if flag == "1" else "dense")
import contextlib, io, json, tempfile                # consumer-group packing
from kafka_assigner_tpu_torch.cli import run_groups
snap = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
json.dump({"brokers": [], "topics": {"t": {str(p): [0] for p in range(9)}}}, snap)
snap.close()
for mode in ("plan", "sweep"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_groups(["--zk_string", snap.name, "--mode", mode, "--synthetic",
                           "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue())["kind"] == f"groups-{mode}"
os.unlink(snap.name)
from kafka_assigner_tpu_torch import cli             # the native host layer
from kafka_assigner_tpu_torch.native import build
from kafka_assigner_tpu_torch.solvers.base import get_solver
tm, _, racks = rack_striped_cluster(20, 3, 12, 3, 5, extra_brokers=2)
snap = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
json.dump({"brokers": [{"id": b, "host": f"h{b}", "port": 1, "rack": racks[b]}
                       for b in range(2, 22)],
           "topics": {t: {str(p): r for p, r in c.items()} for t, c in tm.items()}}, snap)
snap.close()
plans = {}
for solver in ("native", "greedy", "device"):
    os.environ["KA_LEADERSHIP"] = "native" if solver == "device" else "auto"
    buf = io.StringIO()
    assert cli.run_tool(["--zk_string", snap.name, "--mode", "PRINT_REASSIGNMENT",
                         "--solver", solver, "--device", "cpu"], out=buf) == 0
    plans[solver] = buf.getvalue()
os.unlink(snap.name)
assert plans["native"] == plans["greedy"] and "NEW ASSIGNMENT" in plans["device"]
assert get_solver("native").name == "native"
from kafka_assigner_tpu_torch.models import problem
assert problem.last_codec == {"encode": "c", "decode": "c"}, problem.last_codec
build_dir = os.path.join(os.getcwd(), "build", "torch-")
libs = [build.load_native_library()._name, build.load_hostcodec().__file__]
assert all(p.startswith(build_dir) for p in libs), libs
with open("/proc/self/maps") as f:
    maps = f.read()
assert "kafka_assigner_tpu/native" not in maps, "a JAX package library is loaded"
assert all(p in maps for p in libs), libs
from kafka_assigner_tpu_torch import faults          # the report, the profiler
from kafka_assigner_tpu_torch.obs.profile import capture_window  # and the policy
tm, _, racks = rack_striped_cluster(20, 2, 12, 3, 5)
snap = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
json.dump({"brokers": [{"id": b, "host": f"h{b}", "port": 1, "rack": racks[b]}
                       for b in range(20)],
           "topics": {t: {str(p): r for p, r in c.items()} for t, c in tm.items()}}, snap)
snap.close()
tmp = tempfile.mkdtemp()
os.environ["KA_FAULTS_SPEC"] = "solve:0=crash"
with contextlib.redirect_stderr(io.StringIO()):
    rc = cli.run(["--zk_string", snap.name, "--mode", "PRINT_REASSIGNMENT", "--device",
                  "cpu", "--failure-policy", "best-effort", "--report-json",
                  os.path.join(tmp, "r.json")], out=io.StringIO())
assert rc == cli.EXIT_DEGRADED, rc
report = json.load(open(os.path.join(tmp, "r.json")))
assert report["status"] == "degraded" and report["metrics"]["counters"]["solve.fallbacks"] == 1
del os.environ["KA_FAULTS_SPEC"]
assert capture_window(0.05, os.path.join(tmp, "trace")) and os.listdir(os.path.join(tmp, "trace"))
os.unlink(snap.name)
import importlib.util                                # live ZooKeeper, streamed
spec = importlib.util.spec_from_file_location("jute_server", "tests/jute_server.py")
jute = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jute)
from kafka_assigner_tpu_torch import generator
server = jute.JuteZkServer(jute.cluster_tree())
server.start()
os.environ["KA_ZK_CLIENT"] = "wire"
try:
    buf = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.run(["--zk_string", f"127.0.0.1:{server.port}", "--mode",
                        "PRINT_REASSIGNMENT", "--device", "cpu"], out=buf) == 0
finally:
    server.shutdown()
assert "NEW ASSIGNMENT" in buf.getvalue()
assert generator.last_ingest["solve_encode"] == "preencoded", generator.last_ingest
from kafka_assigner_tpu_torch.utils import programstore  # warm start: ka-warm
os.environ["KA_PROGRAM_STORE_DIR"] = tempfile.mkdtemp()  # on an empty store
os.environ["KA_LEADERSHIP"] = "device"
snap = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
json.dump({"brokers": [{"id": b, "host": f"h{b}", "port": 1, "rack": f"r{b % 3}"}
                       for b in range(9)],
           "topics": {"t": {str(p): [p % 9, (p + 1) % 9] for p in range(12)}}}, snap)
snap.close()
for argv in (["--zk_string", snap.name], ["--buckets", "4,16,2,9,3"]):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.run_warm(argv + ["--device", "cpu"]) == 0, err.getvalue()
    assert "ka-warm: solve_batched: warmed" in err.getvalue(), err.getvalue()
    programstore.clear_memory()
os.unlink(snap.name)
assert sorted(p.name.split("-")[0] for p in Path(os.environ["KA_PROGRAM_STORE_DIR"])
              .rglob("*.so")) == ["greedy", "hostcodec"]
print("paths ok")
"""


def test_new_paths_run_without_jax():
    # The giant-shape chain, fresh placement, the compat width, both
    # what-if paths, ka-groups and the three --solver lanes (the device one
    # on the host leadership lane, through the C codec), run with jax and
    # the JAX package blocked; the native libraries loaded are the port's,
    # from build/. Then a best-effort run with a crash injected and its
    # report, a profiler window, and mode 3 over the jute server through
    # the wire client, the solve taking the streamed preencode.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    script = _BLOCKER.replace("for mod in sys.argv[1:]:", _PATHS + "\nfor mod in []:")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "paths ok" in proc.stdout


def test_torch_bench_imports_without_jax():
    # The script's module body imports with jax and the JAX package blocked
    # (its main needs a card).
    _script_imports_without_jax("torch_bench")


def test_warmstart_bench_imports_without_jax():
    _script_imports_without_jax("torch_bench_warmstart")


def test_exec_smoke_runs_without_jax():
    # The port's ka-execute smoke imports and runs to its PASS line with
    # jax and the JAX package blocked.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    loader = (
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('torch_exec_smoke', "
        "'scripts/torch_exec_smoke.py')\n"
        "m = u.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "assert m.main() == 0\n"
    )
    script = _BLOCKER.replace("for mod in sys.argv[1:]:", loader + "for mod in []:")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch_exec_smoke: PASS" in proc.stderr


def _script_imports_without_jax(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    loader = (
        "import importlib.util as u\n"
        f"spec = u.spec_from_file_location('{script}', 'scripts/{script}.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
    )
    script = _BLOCKER.replace("for mod in sys.argv[1:]:", loader + "for mod in []:")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_name_the_jax_package():
    paths = list((ROOT / "kafka_assigner_tpu_torch").rglob("*.py"))
    for path in paths + [ROOT / "scripts" / "torch_bench.py",
                         ROOT / "scripts" / "torch_bench_warmstart.py",
                         ROOT / "scripts" / "torch_exec_smoke.py", ROOT / "chip_smoke.py"]:
        for line in path.read_text(encoding="utf-8").splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "kafka_assigner_tpu " not in stripped \
                    and "kafka_assigner_tpu." not in stripped, f"{path}: {line}"


def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TorchSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSolver()
    assert TorchSolver(device="cpu").device.type == "cpu"


def test_every_entry_point_defaults_to_cuda():
    from kafka_assigner_tpu_torch import cli

    for build, argv in ((cli.build_parser, []), (cli.build_warm_parser, []),
                        (cli.build_groups_parser, []),
                        (cli.build_daemon_parser, ["--zk_string", "h:2181"])):
        assert build().parse_args(argv).device == "cuda", build.__name__
        assert build().parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_daemon_on_cuda_without_a_card_refuses_at_startup(tmp_path, monkeypatch):
    # With no card visible, `--device cuda` (the default) fails before the
    # daemon reads its cluster or serves anything: no fallback to the CPU.
    snap = tmp_path / "c.json"
    snap.write_text('{"brokers": [{"id": 1, "host": "h1", "port": 1, "rack": "a"}], '
                    '"topics": {"t": {"0": [1]}}}')
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.daemon", "--zk_string",
         str(snap), "--solver", "greedy"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device is available" in proc.stderr
    assert "listening on" not in proc.stderr
    # The library entry refuses the same way, before it opens a backend.
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AssignerDaemon("127.0.0.1:1")


def test_chip_smoke_refuses_without_the_repo_or_a_card(tmp_path):
    # Alone in a directory, chip_smoke.py must fail and print no result.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
