"""BENCHMARK.json against the format's limits, the files it names, the
import rule (no JAX, no JAX package, nothing of the port in the reference),
a cell added as files only, and the command without a card."""
import ast
import json
import re
import subprocess
import sys
import textwrap

import pytest

from kabench import harness
from kabench.tests import tiny

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in SPEC["command"][1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("kabench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    assert len(set(c["file"] for c in SPEC["configs"])) == len(SPEC["configs"])
    cells = []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.append(w["name"])
        harness.load_cell(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(cells)
    assert set(names) == {w["config"] for w in SPEC["workloads"]}
    metrics = []
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m)
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
        metrics.append(m)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for cell in cells:
        e2e_here = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(e2e_here) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in SPEC["per_layer"])


def test_configs_state_source_assumed_and_nothing_reduced():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
        assert conf["assumed"] and conf["guarantees"]


def test_run_length_fits_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["kafka_assigner_tpu_torch", "kafka_assigner_tpu_torch.ops", "jaxtyping",
         "kabench", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "kafka_assigner_tpu",
         "kafka_assigner_tpu.ops"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "kafka_assigner_tpu",
         "kafka_assigner_tpu.ops"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "kabench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not harness.forbidden_modules(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "kabench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "struct", "dataclasses", "typing", "numpy"}, path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole tiny run in a fresh interpreter, each driver in turn: no
    module it loads has a forbidden top-level name."""
    root = tiny.bench_copy(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from kabench import harness
        from kabench.tests import tiny
        from pathlib import Path
        for driver, (traffic, _, _) in tiny.CELLS.items():
            result, _ = harness.run_cell("tiny_60b." + traffic, 5, 0.2, False,
                                         device="cpu", root=Path({str(root)!r}))
            assert result["correct"], result
        print("FORBIDDEN", harness.forbidden_modules(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_a_cell_added_as_files_is_found_and_run(tmp_path):
    """A configuration, a cell and a per-layer metric added to a copy of
    the benchmark as new files and entries only."""
    root = tiny.bench_copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "kabench" / "metrics" / "plans_seen.py").write_text(textwrap.dedent("""
        SOURCE = "host_clock"
        MOVES = "plan_ms"

        def read(run):
            return float(len(run.records)) if run.kind == "plan" else None
    """))
    spec["per_layer"].append({"name": "plans_seen", "unit": "plans", "better": "higher",
                              "source": "host_clock", "layer": "harness",
                              "moves": "plan_ms", "workloads": ["tiny_60b.replace10"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = harness.run_cell("tiny_60b.replace10", 11, 0.3, False, device="cpu",
                                 root=root, check_modules=False)
    assert result["correct"] and {"plan_ms", "setup_s"} <= set(
        result["metrics"])
    result, _ = harness.run_cell("tiny_60b.replace10", 11, 0.3, True, device="cpu",
                                 root=root, check_modules=False)
    assert result["metrics"]["plans_seen"]["value"] >= 1
    assert "plan_tail_ms" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")


def test_command_without_a_card_exits_nonzero_with_no_result(no_card, tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "kabench" / "run.py"), "--workload",
         "config4_5000b.replace100", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
