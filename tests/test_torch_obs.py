"""The port's observability layer (``kafka_assigner_tpu_torch/obs``) against
the JAX package's, on the CPU:

- the cases of ``tests/test_obs.py`` and the non-daemon cases of
  ``tests/test_telemetry.py`` (the report schema and its fixture, spans,
  the registry and its histogram edges, the cumulative registry, the
  flight ring, the access log and its rollover, annotations, the profiler
  hooks, the timers shim), each written once and run on both packages;
- run-report parity: the same snapshot and argv through both CLIs
  (``--solver device --device cpu`` against ``--solver tpu``) give reports
  equal in status, mode, plan, counters, gauges, histogram names and span
  paths with their statuses, apart from :data:`NOT_PORTED` and
  :data:`OWN_ARTIFACT`; the ingest-overlapped warm-up's span and counters
  with the warm-up on, off and crashed, each run on empty stores;
- stdout byte-identical with the report on and off, and no file written
  with nothing enabled;
- ``dispatch_trace`` writes one Chrome trace holding its label under
  ``KA_OBS_PROFILE_DIR``, and none when it is unset; on the card (a
  ``cuda``-marked test) the trace of a small solve holds the leadership
  kernel;
- every metric and span name the port writes is declared in
  ``obs/names.py`` and is one of the reference's names.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import logging
import os
import re
import types
from pathlib import Path

import pytest
import torch

import kafka_assigner_tpu_torch
from kafka_assigner_tpu.cli import run_groups as jax_run_groups
from kafka_assigner_tpu.cli import run_tool as jax_run_tool
from kafka_assigner_tpu.obs import names as jax_names
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.obs import names as torch_names

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "golden" / "run_report_v1.json"

OBS_KNOBS = ("KA_OBS_ENABLE", "KA_OBS_REPORT", "KA_OBS_HIST_EDGES",
             "KA_OBS_PROFILE_DIR", "KA_PROFILE", "KA_FAILURE_POLICY",
             "KA_FAULTS_SPEC")

#: What the reference's reports carry and the port's do not, because it
#: belongs to a module the port has not ported yet; each name with the
#: ROADMAP queue-1 item that brings it. Measured milliseconds are compared
#: by name only (their values are clocks).
NOT_PORTED: dict = {}

#: Names both packages write about different artifacts, so their values
#: cannot agree: ``compile.store.*`` counts serialized XLA executables in the
#: reference and built libraries in the port, and the port's CPU path loads
#: no kernel library (ROADMAP section 3, "Not a fault").
OWN_ARTIFACT = {
    "compile.store.*": "the reference stores XLA executables, the port libraries",
}


def _excluded(name: str) -> bool:
    return any(
        name == key or (key.endswith(".*") and name.startswith(key[:-1]))
        for key in (*NOT_PORTED, *OWN_ARTIFACT)
    )


@pytest.fixture()
def empty_stores(tmp_path, monkeypatch):
    """Both packages on one empty temporary store (each counts only its own
    entries in it), with their in-memory residency cleared and no warm-up
    thread left running, so a warm-up's outcome cannot hang on test
    order."""
    from kafka_assigner_tpu.generator import join_warmup_threads as jax_join
    from kafka_assigner_tpu.utils import programstore as jax_store
    from kafka_assigner_tpu_torch.generator import join_warmup_threads
    from kafka_assigner_tpu_torch.utils import programstore

    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "store"))
    for join, store in ((jax_join, jax_store), (join_warmup_threads, programstore)):
        join()
        store.clear_memory()
    yield
    for join, store in ((jax_join, jax_store), (join_warmup_threads, programstore)):
        join()
        store.clear_memory()


def _package(name: str) -> types.SimpleNamespace:
    root = "kafka_assigner_tpu" if name == "jax" else "kafka_assigner_tpu_torch"
    mod = lambda sub: importlib.import_module(f"{root}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, obs=mod("obs"), trace=mod("obs.trace"), metrics=mod("obs.metrics"),
        report=mod("obs.report"), flight=mod("obs.flight"), profile=mod("obs.profile"),
        timers=mod("utils.timers"), faults=mod("faults"),
    )


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    """Every test starts from the shipped defaults: obs off, no report
    path, no profiler, strict, no faults; no cumulative registry or flight
    recorder in either package."""
    for knob in OBS_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for name in ("jax", "torch"):
        p = _package(name)
        p.faults.reset()
        p.metrics.disable_cumulative()
        p.flight.disable()
    yield
    for name in ("jax", "torch"):
        p = _package(name)
        p.faults.reset()
        p.metrics.disable_cumulative()
        p.flight.disable()


@pytest.fixture()
def snapshot(tmp_path):
    """6 brokers across 3 racks, one RF-3 topic (``tests/test_obs.py``)."""
    cluster = {
        "brokers": [
            {"id": 100 + i, "host": f"h{i}", "port": 9092, "rack": f"r{i % 3}"}
            for i in range(6)
        ],
        "topics": {
            "events": {
                str(p): [100 + (p + i) % 5 for i in range(3)] for p in range(4)
            },
        },
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return str(path)


@pytest.fixture()
def cluster8(tmp_path):
    """8 brokers in 3 racks, two topics of RF 3 and 2, a consumer-group
    section: small enough for every mode on the CPU."""
    cluster = {
        "brokers": [
            {"id": 100 + i, "host": f"h{i}", "port": 9092, "rack": f"r{i % 3}"}
            for i in range(8)
        ],
        "topics": {
            "events": {str(p): [100 + (p + i) % 5 for i in range(3)] for p in range(6)},
            "logs": {str(p): [100 + (p + i) % 5 for i in range(2)] for p in range(4)},
        },
        "groups": {
            "g": {"members": {"c-0": 90.0, "c-1": None, "c-2": 25.0},
                  "assignment": {"events": {"0": "c-0", "1": "c-1", "4": "c-9"}},
                  "lag": {"events": {str(p): 10 * (p + 1) for p in range(6)}}},
        },
    }
    path = tmp_path / "cluster8.json"
    path.write_text(json.dumps(cluster))
    # 8 scenarios, as the ranking's 8 candidates: the reference CLI shards
    # the scenario axis over the test process's 8 CPU devices and tiles its
    # fan-out to them; the port's CLI meshes alike where it sees 8
    # positions (the report test below), and the library-level test below
    # holds the unsharded bucket.
    scen = tmp_path / "scenarios.json"
    scen.write_text(json.dumps([[100, 103], [101], ["h7"], [], [102, 105], [104],
                                ["h6", "h1"], [107]]))
    return str(path), str(scen)


def _run(fn, argv, out_kw=False):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv, out=out) if out_kw else fn(argv)
    return rc, out.getvalue(), err.getvalue()


# --- run-report schema: golden fixture + version bump -------------------------

def test_golden_fixture_is_schema_valid(pkg):
    fixture = json.loads(FIXTURE.read_text(encoding="utf-8"))
    assert pkg.report.validate_report(fixture) == []
    assert fixture["schema_version"] == pkg.report.REPORT_SCHEMA_VERSION
    assert pkg.report.TOOL_NAME == fixture["tool"]


def test_version_drift_fails_validation(pkg):
    fixture = json.loads(FIXTURE.read_text(encoding="utf-8"))
    fixture["schema_version"] = pkg.report.REPORT_SCHEMA_VERSION + 1
    problems = pkg.report.validate_report(fixture)
    assert any("schema_version" in p for p in problems)


def test_validator_catches_structural_drift(pkg):
    fixture = json.loads(FIXTURE.read_text(encoding="utf-8"))
    del fixture["plan"]
    fixture["status"] = "partial"
    fixture["spans"][0].pop("ms")
    del fixture["metrics"]["histograms"]
    problems = pkg.report.validate_report(fixture)
    assert any("missing required key 'plan'" in p for p in problems)
    assert any("status" in p for p in problems)
    assert any("span[0]" in p for p in problems)
    assert any("metrics.histograms" in p for p in problems)
    assert pkg.report.validate_report([]) == ["report is not a JSON object"]


def test_fixture_check_cli_entrypoint(pkg, tmp_path, capsys):
    assert pkg.report.main(["--check-fixture", str(FIXTURE)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert pkg.report.main(["--check-fixture", str(bad)]) == 1
    capsys.readouterr()


# --- the port's CLI with --report-json ----------------------------------------

def test_mode3_report_smoke(snapshot, tmp_path, capsys):
    """``tests/test_obs.py::test_mode3_report_smoke`` on the port: a
    PRINT_REASSIGNMENT solve on the device solver (on the CPU) with
    ``--report-json`` reports encode/solve/decode spans under the mode span,
    the metadata counters and the plan stats."""
    report_path = tmp_path / "report.json"
    rc = cli.run_tool([
        "--zk_string", f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT",
        "--report-json", str(report_path), "--device", "cpu",
    ])
    capsys.readouterr()
    assert rc == 0
    report = json.loads(report_path.read_text())
    assert _package("torch").report.validate_report(report) == []
    assert report["status"] == "ok" and report["mode"] == "PRINT_REASSIGNMENT"
    names = {s["name"] for s in report["spans"]}
    assert {"encode", "solve", "decode"} <= names
    assert report["spans"][0]["path"] == "mode/PRINT_REASSIGNMENT"
    assert all(s["status"] == "ok" for s in report["spans"])
    paths = {s["path"] for s in report["spans"]}
    for leaf in ("metadata/assignment", "feasibility", "plan/solve/encode",
                 "plan/solve/solve", "plan/solve/decode", "plan/emit"):
        assert f"mode/PRINT_REASSIGNMENT/{leaf}" in paths, leaf
    assert report["metrics"]["counters"]["zk.reads"] >= 1
    assert report["metrics"]["counters"]["zk.bytes"] > 0
    assert "encode.pad_waste_frac" in report["metrics"]["gauges"]
    assert report["metrics"]["gauges"]["ingest.topics"] == 1
    for key in ("moves", "leader_churn", "topics", "partitions"):
        assert key in report["plan"]
    assert report["plan"]["partitions"] == 4


def test_error_path_still_emits_report(snapshot, tmp_path, capsys):
    """A run that raises mid-phase still flushes its spans (marked error)
    and emits the report with ``"status": "error"``. A missing topic under
    ``strict`` is an ingest failure, as in the reference: an
    ``IngestError`` with the snapshot's ``KeyError`` as its cause."""
    from kafka_assigner_tpu_torch.errors import IngestError

    report_path = tmp_path / "report.json"
    with pytest.raises(IngestError, match="no_such_topic") as exc_info:
        cli.run_tool([
            "--zk_string", f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT",
            "--topics", "no_such_topic", "--report-json", str(report_path),
            "--device", "cpu",
        ])
    assert isinstance(exc_info.value.__cause__, KeyError)
    capsys.readouterr()
    report = json.loads(report_path.read_text())
    assert _package("torch").report.validate_report(report) == []
    assert report["status"] == "error"
    assert report["error"]["type"] == "IngestError"
    assert "no_such_topic" in report["error"]["message"]
    assert report["spans"], "spans lost on the failure path"
    assert {s["path"]: s["status"] for s in report["spans"]} == {
        "mode/PRINT_REASSIGNMENT": "error",
        "mode/PRINT_REASSIGNMENT/metadata/assignment": "error",
        "mode/PRINT_REASSIGNMENT/metadata/assignment/ingest/stream": "error",
    }


def test_disabled_mode_uses_shared_noop_singleton(pkg):
    obs = pkg.obs
    assert obs.active_run() is None
    assert obs.span("anything") is pkg.trace.NULL_SPAN
    assert obs.span("other") is pkg.trace.NULL_SPAN
    assert pkg.metrics.hist_ms("whatif.dispatch_ms") is pkg.trace.NULL_SPAN
    obs.counter_add("zk.reads")
    obs.gauge_set("plan.moves", 1)
    obs.hist_observe("whatif.dispatch_ms", 1.0)
    assert not obs.obs_active()


def test_disabled_run_is_byte_identical_and_fileless(snapshot, tmp_path, monkeypatch):
    argv = ["--zk_string", f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT"]
    ref = _run(jax_run_tool, argv + ["--solver", "tpu"])
    base = _run(cli.run_tool, argv + ["--device", "cpu"])
    assert ref[0] == base[0] == 0 and base[1] == ref[1]

    monkeypatch.setenv("KA_OBS_ENABLE", "0")
    disabled = _run(cli.run_tool, argv + ["--device", "cpu"])
    assert disabled[1:] == base[1:]
    assert "obs:" not in disabled[2]
    assert list(tmp_path.iterdir()) == [tmp_path / "cluster.json"]

    monkeypatch.setenv("KA_OBS_ENABLE", "1")
    enabled = _run(cli.run_tool, argv + ["--device", "cpu"])
    assert enabled[0] == 0 and enabled[1] == base[1]
    assert "obs: run ok mode=PRINT_REASSIGNMENT" in enabled[2]
    assert list(tmp_path.iterdir()) == [tmp_path / "cluster.json"]


def test_ka_obs_report_env_default_path(snapshot, tmp_path, monkeypatch, capsys):
    report_path = tmp_path / "envreport.json"
    monkeypatch.setenv("KA_OBS_REPORT", str(report_path))
    assert cli.run_tool([
        "--zk_string", f"file://{snapshot}", "--mode", "PRINT_CURRENT_BROKERS",
    ]) == 0
    capsys.readouterr()
    report = json.loads(report_path.read_text())
    assert _package("torch").report.validate_report(report) == []
    assert report["mode"] == "PRINT_CURRENT_BROKERS"


def test_cli_report_has_no_annotation_keys(snapshot, tmp_path, capsys):
    report_path = tmp_path / "report.json"
    assert cli.run_tool([
        "--zk_string", f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT",
        "--solver", "greedy", "--report-json", str(report_path), "--device", "cpu",
    ]) == 0
    capsys.readouterr()
    report = json.loads(report_path.read_text())
    assert all(set(s) == {"name", "path", "parent", "depth", "ms", "status"}
               for s in report["spans"])
    assert report["metrics"]["counters"]["greedy.assigns"] == 1


def test_report_write_failure_never_masks_the_run(snapshot, tmp_path, capsys):
    rc = cli.run_tool([
        "--zk_string", f"file://{snapshot}", "--mode", "PRINT_CURRENT_BROKERS",
        "--report-json", str(tmp_path / "no" / "dir" / "report.json"),
    ])
    assert rc == 0
    assert "obs: could not write report" in capsys.readouterr().err


# --- report parity with the JAX package -----------------------------------------

def _comparable(report: dict) -> dict:
    """What the parity contract compares: everything but measured
    milliseconds, :data:`NOT_PORTED` and :data:`OWN_ARTIFACT`."""
    metrics = report["metrics"]
    return {
        "schema_version": report["schema_version"],
        "tool": report["tool"],
        "status": report["status"],
        "mode": report["mode"],
        "plan": report["plan"],
        "counters": {k: v for k, v in metrics["counters"].items() if not _excluded(k)},
        "gauges": {k: (v if not k.endswith("_ms") else "ms")
                   for k, v in metrics["gauges"].items() if not _excluded(k)},
        "histograms": sorted(k for k in metrics["histograms"] if not _excluded(k)),
        "spans": sorted({
            (s["path"], s["status"]) for s in report["spans"]
            if not any(_excluded(part) for part in _span_parts(s["path"]))
        }),
    }


def _span_parts(path: str):
    """The span names a path is built of (``ingest/stream`` is one name)."""
    parts, names = path.split("/"), []
    while parts:
        two = "/".join(parts[:2])
        if two in torch_names.SPAN_NAMES or two in jax_names.SPAN_NAMES \
                or parts[0] == "mode":
            names.append(two)
            parts = parts[2:]
        else:
            names.append(parts[0])
            parts = parts[1:]
    return names


def _both_reports(tmp_path, jax_fn, torch_fn, argv, jax_extra, torch_extra):
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_fn, argv + jax_extra + ["--report-json", str(a)])
    got = _run(torch_fn, argv + torch_extra + ["--report-json", str(b)])
    return ref, got, json.loads(a.read_text()), json.loads(b.read_text())


REPORT_CASES = {
    "mode3": ["--mode", "PRINT_REASSIGNMENT", "--integer_broker_ids",
              "101,102,103,104,105,106"],
    "mode3-topics": ["--mode", "PRINT_REASSIGNMENT", "--topics", "logs,events,logs"],
    "mode3-rf-increase": ["--mode", "PRINT_REASSIGNMENT", "--desired_replication_factor",
                          "3", "--topics", "logs"],
    "fresh": ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "x,y",
              "--partition_count", "12", "--desired_replication_factor", "2"],
    # 8 live brokers, 8 candidates (see the scenario file in cluster8).
    "rank": ["--mode", "RANK_DECOMMISSION"],
    "rank-dense": ["--mode", "RANK_DECOMMISSION", "KA_WHATIF_INCREMENTAL=0"],
    "current": ["--mode", "PRINT_CURRENT_ASSIGNMENT"],
}


@pytest.mark.parametrize("name", sorted(REPORT_CASES))
def test_report_matches_the_reference(cluster8, tmp_path, monkeypatch, empty_stores,
                                      name):
    snap, _ = cluster8
    argv = [a for a in REPORT_CASES[name] if "=" not in a]
    for knob in (a for a in REPORT_CASES[name] if "=" in a):
        monkeypatch.setenv(*knob.split("=", 1))
    ref, got, ra, rb = _both_reports(
        tmp_path, jax_run_tool, cli.run_tool, ["--zk_string", f"file://{snap}"] + argv,
        ["--solver", "tpu"], ["--device", "cpu"],
    )
    assert ref[0] == got[0] == 0
    assert got[1] == ref[1]
    assert _package("torch").report.validate_report(rb) == []
    assert _comparable(rb) == _comparable(ra)


@pytest.mark.parametrize("solver", [["--solver", "device"], ["--solver", "greedy"]])
def test_report_over_zookeeper_matches_the_reference(tmp_path, monkeypatch, empty_stores,
                                                     solver):
    """Mode 3 over the jute server (``tests/jute_server.py``) with the wire
    client: the same span tree (``ingest/stream``, ``zk/brokers`` under the
    mode) and the same ``zk.*``, ``zk.pipeline.*`` and ``ingest.*`` names
    and counts as the reference's report, apart from :data:`NOT_PORTED`."""
    from .jute_server import JuteZkServer, cluster_tree

    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    server = JuteZkServer(cluster_tree())
    server.start()
    try:
        argv = ["--zk_string", f"127.0.0.1:{server.port}", "--mode",
                "PRINT_REASSIGNMENT", "--broker_hosts_to_remove", "h4"]
        jax_solver = ["--solver", "tpu"] if solver[1] == "device" else solver
        ref, got, ra, rb = _both_reports(tmp_path, jax_run_tool, cli.run_tool, argv,
                                         jax_solver, solver + ["--device", "cpu"])
    finally:
        server.shutdown()
    assert ref[0] == got[0] == 0 and got[1] == ref[1]
    assert _package("torch").report.validate_report(rb) == []
    assert _comparable(rb) == _comparable(ra)
    paths = {s["path"] for s in rb["spans"]}
    assert "mode/PRINT_REASSIGNMENT/metadata/assignment/ingest/stream" in paths
    counters, gauges = rb["metrics"]["counters"], rb["metrics"]["gauges"]
    assert counters["zk.pipeline.batches"] >= 2 and counters["zk.wire_frames_in"] > 0
    assert gauges["ingest.topics"] == 2
    assert ("ingest.overlap_ms" in gauges) == (solver[1] == "device")


def test_scenario_file_report_matches_the_reference(cluster8, tmp_path, empty_stores,
                                                   monkeypatch):
    # Eight visible positions, as the reference CLI sees eight devices: both
    # shard the sweep, and the spans and gauges compare.
    from kafka_assigner_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    snap, scen = cluster8
    argv = ["--zk_string", f"file://{snap}", "--mode", "RANK_DECOMMISSION",
            "--scenario_file", scen]
    ref, got, ra, rb = _both_reports(tmp_path, jax_run_tool, cli.run_tool, argv,
                                     [], ["--device", "cpu"])
    assert ref[0] == got[0] == 0 and got[1] == ref[1]
    assert _comparable(rb) == _comparable(ra)


#: ``ka-execute`` runs whose reports are compared: extra argv, knobs, and
#: whether a forward run goes first (the rollback's).
EXEC_CASES = {
    "forward": ([], {}, False),
    "rollback": (["--rollback"], {}, True),
    "best-effort-lost": (["--failure-policy", "best-effort"],
                         {"KA_FAULTS_SPEC": "write:0=lost", "KA_EXEC_POLL_TIMEOUT": "0.3"},
                         False),
}


@pytest.mark.parametrize("name", sorted(EXEC_CASES))
def test_execute_report_matches_the_reference(tmp_path, monkeypatch, name):
    """``ka-execute``'s report: the ``mode/EXECUTE_REASSIGNMENT`` or
    ``ROLLBACK_REASSIGNMENT`` span with ``exec/wave``, ``exec/submit``,
    ``exec/poll`` and ``exec/verify`` under it, the ``exec.*`` and
    ``zk.writes`` counters, the ``plan`` section and the status equal the
    reference's apart from milliseconds (and, where a poll budget runs
    out, the clock's count of polls, ``exec.retries``)."""
    from kafka_assigner_tpu.cli import execute as jax_execute
    from kafka_assigner_tpu.cli import run as jax_run

    from .jute_server import exec_snapshot_cluster

    extra, env, forward_first = EXEC_CASES[name]
    for knob, value in (("KA_EXEC_WAVE_SIZE", "3"), ("KA_EXEC_POLL_INTERVAL", "0.01"),
                        ("KA_EXEC_SIM_POLLS", "1")):
        monkeypatch.setenv(knob, value)
    snap, plan = tmp_path / "cluster.json", tmp_path / "plan.txt"
    snap.write_text(json.dumps(exec_snapshot_cluster()))
    rc, text, _ = _run(jax_run, ["--zk_string", str(snap), "--mode", "PRINT_REASSIGNMENT",
                                 "--solver", "greedy", "--broker_hosts_to_remove", "h9"])
    assert rc == 0
    plan.write_text(text)
    argv = ["--zk_string", str(snap), "--plan", str(plan)]
    reports, rcs = {}, {}
    for name_, fn in (("jax", jax_execute), ("torch", cli.execute)):
        snap.write_text(json.dumps(exec_snapshot_cluster()))
        for leftover in tmp_path.glob("plan.txt*journal"):
            leftover.unlink()
        if forward_first:
            assert _run(fn, argv)[0] == 0
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for p in ("jax", "torch"):
            _package(p).faults.reset()
        path = tmp_path / f"{name_}.json"
        rcs[name_] = _run(fn, argv + extra + ["--report-json", str(path)])[0]
        for key in env:
            monkeypatch.delenv(key)
        reports[name_] = json.loads(path.read_text())
    assert rcs["torch"] == rcs["jax"] == (6 if "lost" in name else 0)
    assert _package("torch").report.validate_report(reports["torch"]) == []
    ra, rb = (_comparable(reports[p]) for p in ("jax", "torch"))
    if "lost" in name:
        for r in (ra, rb):
            r["counters"].pop("exec.retries", None)
    assert rb == ra
    mode = "ROLLBACK_REASSIGNMENT" if forward_first else "EXECUTE_REASSIGNMENT"
    assert rb["mode"] == mode
    paths = {path for path, _ in rb["spans"]}
    for child in ("exec/wave", "exec/wave/exec/submit", "exec/wave/exec/poll",
                  "exec/verify"):
        assert f"mode/{mode}/{child}" in paths, child
    counters = rb["counters"]
    assert counters["exec.waves"] == counters["zk.writes"] >= 2
    assert counters["exec.verify"] == 1
    assert rb["plan"]["waves"] == counters["exec.waves"]


@pytest.mark.parametrize("lane", ["greedy", "native"])
def test_greedy_lane_reports_match_the_reference(cluster8, tmp_path, empty_stores, lane):
    snap, _ = cluster8
    argv = ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT",
            "--solver", lane]
    ref, got, ra, rb = _both_reports(tmp_path, jax_run_tool, cli.run_tool, argv,
                                     [], ["--device", "cpu"])
    assert ref[0] == got[0] == 0 and got[1] == ref[1]
    assert _comparable(rb) == _comparable(ra)


WARMUP_CASES = {
    "on": {},
    "off": {"KA_WARMUP": "0"},
    "crash": {"KA_FAULTS_SPEC": "warmup:0=crash"},
    "one-topic-chunks": {"KA_ZK_INGEST_CHUNK": "1"},
}


@pytest.mark.parametrize("case", sorted(WARMUP_CASES))
def test_warmup_report_matches_the_reference(cluster8, tmp_path, monkeypatch,
                                             empty_stores, case):
    """Mode 3 on the device lane, both packages on empty stores: the
    ``warmup`` span (its path and status) and the ``warmup.*`` counters
    agree with the warm-up on (``warmup.warmed`` 1), off (neither), crashed
    by the injected fault (``warmup.failures`` 1, no span) and started at
    the first of several chunks; stdout is the same bytes in each case."""
    snap, _ = cluster8
    for knob, value in WARMUP_CASES[case].items():
        monkeypatch.setenv(knob, value)
    for name in ("jax", "torch"):
        _package(name).faults.reset()
    argv = ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT"]
    ref, got, ra, rb = _both_reports(tmp_path, jax_run_tool, cli.run_tool, argv,
                                     ["--solver", "tpu"], ["--device", "cpu"])
    assert ref[0] == got[0] == 0 and got[1] == ref[1]
    assert _comparable(rb) == _comparable(ra)
    counters = rb["metrics"]["counters"]
    warm = {k: v for k, v in counters.items() if k.startswith("warmup.")}
    spans = [(s["path"], s["status"]) for s in rb["spans"] if s["name"] == "warmup"]
    want = {"on": ({"warmup.warmed": 1}, [("warmup", "ok")]),
            "one-topic-chunks": ({"warmup.warmed": 1}, [("warmup", "ok")]),
            "off": ({}, []),
            "crash": ({"warmup.failures": 1}, [])}[case]
    assert (warm, spans) == want
    if case == "crash":
        assert "kafka-assigner: warm-up failed (InjectedWarmupCrash" in got[2]


GROUP_CASES = {
    "plan": ["--mode", "plan"],
    "plan-greedy": ["--mode", "plan", "--solver", "greedy"],
    "sweep": ["--mode", "sweep", "--counts", "1,2,3", "--scales", "100,200"],
    "synthetic-sweep": ["--mode", "sweep", "--synthetic", "--weight", "throughput",
                        "--scales", "100,"],
}


@pytest.mark.parametrize("name", sorted(GROUP_CASES))
def test_groups_report_matches_the_reference(cluster8, tmp_path, name):
    snap, _ = cluster8
    argv = ["--zk_string", snap] + GROUP_CASES[name]
    ref, got, ra, rb = _both_reports(tmp_path, jax_run_groups, cli.run_groups, argv,
                                     [], ["--device", "cpu"])
    assert ref[0] == got[0] == 0 and got[1] == ref[1]
    assert rb["mode"] in ("GROUPS_PLAN", "GROUPS_SWEEP")
    assert _comparable(rb) == _comparable(ra)


def test_groups_refusal_report_matches_the_reference(snapshot, tmp_path):
    argv = ["--zk_string", snapshot, "--mode", "plan"]
    ref, got, ra, rb = _both_reports(tmp_path, jax_run_groups, cli.run_groups, argv,
                                     [], ["--device", "cpu"])
    assert ref[0] == got[0] == cli.EXIT_USAGE
    assert rb["status"] == "error"
    assert _comparable(rb) == _comparable(ra)


def test_whatif_fanout_metrics_match_the_reference():
    """``tests/test_obs.py::test_whatif_fanout_metrics`` through both
    libraries (no mesh): the same counters and gauges."""
    from kafka_assigner_tpu.parallel.whatif import evaluate_removal_scenarios as jax_eval
    from kafka_assigner_tpu_torch.parallel.whatif import evaluate_removal_scenarios

    from .test_invariants import make_cluster

    current, live, rack_map = make_cluster(3, 8, 16, 3, 4)
    topics = {"t0": current}
    scenarios = [[], [100], [101]]
    runs = {}
    for name, fn, kw in (("jax", jax_eval, {}), ("torch", evaluate_removal_scenarios,
                                                 {"device": "cpu"})):
        p = _package(name)
        with p.obs.run_capture() as run:
            results = fn(topics, live, rack_map, scenarios, 3, **kw)
        assert len(results) == 3
        assert p.obs.active_run() is None
        runs[name] = run
    ref, got = runs["jax"], runs["torch"]
    assert got.counters["whatif.scenarios"] == 3
    assert got.gauges["whatif.fanout"] == ref.gauges["whatif.fanout"] == 4
    assert {k: v for k, v in got.counters.items() if not _excluded(k)} \
        == {k: v for k, v in ref.counters.items() if not _excluded(k)}
    assert {s["path"] for s in got.spans} == {s["path"] for s in ref.spans}


# --- span mechanics -----------------------------------------------------------

def test_spans_nest_and_mark_failure(pkg):
    with pkg.obs.run_capture() as run:
        with pytest.raises(RuntimeError):
            with pkg.obs.span("outer"):
                with pkg.obs.span("inner"):
                    pass
                with pkg.obs.span("boom"):
                    raise RuntimeError("x")
    by_name = {s["name"]: s for s in run.spans}
    assert by_name["inner"]["parent"] == 0
    assert by_name["inner"]["path"] == "outer/inner"
    assert by_name["inner"]["depth"] == 1
    assert by_name["inner"]["status"] == "ok"
    assert by_name["boom"]["status"] == "error"
    assert by_name["outer"]["status"] == "error"


def test_span_cap_overflow_is_counted_not_silent(pkg, monkeypatch):
    monkeypatch.setattr(pkg.trace, "MAX_SPANS", 2)
    with pkg.obs.run_capture() as run:
        for i in range(5):
            with pkg.obs.span(f"s{i}"):
                pass
    assert len(run.spans) == 2
    assert run.spans_dropped == 3
    assert pkg.report.build_report(run)["spans_dropped"] == 3


def test_run_capture_nests_by_save_restore(pkg):
    with pkg.obs.run_capture() as outer:
        pkg.obs.counter_add("zk.reads")
        with pkg.obs.run_capture() as inner:
            pkg.obs.counter_add("zk.reads", 5)
        assert pkg.obs.active_run() is outer
        pkg.obs.counter_add("zk.reads")
    assert outer.counters["zk.reads"] == 2
    assert inner.counters["zk.reads"] == 5


def test_histogram_bucketing_and_edges_knob(pkg, monkeypatch, capsys):
    monkeypatch.setenv("KA_OBS_HIST_EDGES", "10,1")  # unsorted on purpose
    with pkg.obs.run_capture() as run:
        for v in (0.5, 5.0, 50.0):
            pkg.obs.hist_observe("whatif.dispatch_ms", v)
    h = run.hists["whatif.dispatch_ms"]
    assert h["edges"] == [1.0, 10.0]
    assert h["counts"] == [1, 1, 1]
    assert h["count"] == 3 and h["min"] == 0.5 and h["max"] == 50.0

    monkeypatch.setenv("KA_OBS_HIST_EDGES", "not,numbers")
    assert pkg.metrics.resolve_hist_edges() == pkg.metrics.DEFAULT_HIST_EDGES
    assert "KA_OBS_HIST_EDGES" in capsys.readouterr().err
    for bad in ("nan,5", "5,5,100", "-5,100", "0,10"):
        monkeypatch.setenv("KA_OBS_HIST_EDGES", bad)
        assert pkg.metrics.resolve_hist_edges() == pkg.metrics.DEFAULT_HIST_EDGES, bad
        assert "KA_OBS_HIST_EDGES" in capsys.readouterr().err


def test_default_hist_edges_are_the_reference_edges():
    assert _package("torch").metrics.DEFAULT_HIST_EDGES \
        == _package("jax").metrics.DEFAULT_HIST_EDGES


def test_span_fail_forces_error_status(pkg):
    with pkg.obs.run_capture() as run:
        with pkg.obs.span("mode/X") as sp:
            sp.fail()
    assert run.spans[0]["status"] == "error"
    with pkg.obs.span("noop") as sp:
        sp.fail()


def test_span_log_contract_survives_failure(pkg):
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(f"test_torch_obs.phase_log.{pkg.name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = _Capture()
    logger.addHandler(handler)
    try:
        with pkg.obs.span("encode", log=logger):
            pass
        with pytest.raises(RuntimeError):
            with pkg.obs.span("solve", log=logger):
                raise RuntimeError("mid-phase")
    finally:
        logger.removeHandler(handler)
    assert any(m.startswith("phase encode:") for m in records)
    assert any(m.startswith("phase solve:") for m in records)


def test_solver_phases_log_to_the_timers_logger(snapshot, capsys, monkeypatch):
    """``KA_LOG=INFO`` prints the solver's phase lines, as the reference's."""
    from kafka_assigner_tpu_torch.utils import logging as port_logging

    root = logging.getLogger("kafka_assigner_tpu_torch")
    saved = (list(root.handlers), root.level, root.propagate)
    root.handlers = []
    monkeypatch.setenv("KA_LOG", "info")
    try:
        log = port_logging.get_logger("timers")
        assert log.getEffectiveLevel() == logging.INFO
        assert cli.run_tool(["--zk_string", snapshot, "--mode", "PRINT_REASSIGNMENT",
                             "--device", "cpu"]) == 0
    finally:
        root.handlers, root.level, root.propagate = saved
    err = capsys.readouterr().err
    for name in ("encode", "solve", "decode"):
        assert f"kafka_assigner_tpu_torch.timers phase {name}:" in err


# --- utils/timers.py compat shim ----------------------------------------------

def test_timers_shim_accumulates_without_capture(pkg):
    timers = pkg.timers.Timers()
    with timers.phase("encode"):
        pass
    with timers.phase("encode"):
        pass
    assert set(timers.ms) == {"encode"}
    assert timers.ms["encode"] >= 0.0
    assert timers.report() == timers.ms


def test_timers_shim_records_spans_under_capture(pkg):
    timers = pkg.timers.Timers()
    with pkg.obs.run_capture() as run:
        with timers.phase("solve"):
            pass
    assert [s["name"] for s in run.spans] == ["solve"]
    assert "solve" in timers.ms


def test_solver_last_timers_keep_their_four_keys(snapshot, tmp_path, capsys):
    """The report's spans and ``TorchSolver.last_timers`` come from the same
    clocks: the encode and decode spans equal the timers' entries."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner

    topics = {"events": {p: [100 + (p + i) % 5 for i in range(3)] for p in range(4)}}
    assigner = TopicAssigner(device="cpu")
    obs = _package("torch").obs
    with obs.run_capture() as run:
        assigner.generate_assignments(topics, set(range(100, 106)),
                                      {100 + i: f"r{i % 3}" for i in range(6)})
    timers = assigner.solver.last_timers
    assert set(timers) == {"encode", "place", "leadership", "decode"}
    spans = {s["name"]: s for s in run.spans}
    assert [s["name"] for s in run.spans] == ["encode", "solve", "decode"]
    for name in ("encode", "decode"):
        assert spans[name]["ms"] == round(timers[name], 3)
    assert spans["solve"]["ms"] >= round(timers["place"] + timers["leadership"], 3) - 0.01


# --- cumulative registry --------------------------------------------------------

def test_cumulative_splits_cluster_label_and_sums(pkg):
    cum = pkg.metrics.CumulativeMetrics(hist_edges=(1.0, 10.0))
    cum.counter_add("daemon.requests@west", 2)
    cum.counter_add("daemon.requests@west")
    cum.counter_add("daemon.requests@east")
    cum.counter_add("daemon.requests")
    by_label = cum.snapshot()["counters"]["daemon.requests"]
    assert by_label[(("cluster", "west"),)] == 3
    assert by_label[(("cluster", "east"),)] == 1
    assert by_label[()] == 1
    assert cum.counter_value("daemon.requests@west") == 3
    assert cum.counter_value("daemon.requests", labels={"cluster": "east"}) == 1


def test_cumulative_labeled_hist_bucketing(pkg):
    cum = pkg.metrics.CumulativeMetrics(hist_edges=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        cum.hist_observe("daemon.http.request_ms", v,
                         labels={"endpoint": "plan", "cluster": "a"})
    h = cum.snapshot()["hists"]["daemon.http.request_ms"][
        (("cluster", "a"), ("endpoint", "plan"))]
    assert h["counts"] == [1, 1, 1]
    assert h["count"] == 3 and h["sum"] == 55.5


def test_module_writes_feed_both_run_and_cumulative(pkg):
    obs = pkg.obs
    cum = pkg.metrics.enable_cumulative(hist_edges=(1.0,))
    with obs.run_capture() as run:
        obs.counter_add("zk.reads", 3)
        obs.gauge_set("plan.moves", 7)
        obs.hist_observe("whatif.dispatch_ms", 0.5)
        with obs.hist_ms("whatif.dispatch_ms"):
            pass
    assert run.counters["zk.reads"] == 3
    assert run.gauges["plan.moves"] == 7
    assert run.hists["whatif.dispatch_ms"]["count"] == 2
    snap = cum.snapshot()
    assert snap["counters"]["zk.reads"][()] == 3
    assert snap["gauges"]["plan.moves"][()] == 7
    assert snap["hists"]["whatif.dispatch_ms"][()]["count"] == 2
    obs.counter_add("zk.reads", 2)
    assert cum.counter_value("zk.reads") == 5
    assert run.counters["zk.reads"] == 3


def test_disabled_state_keeps_noop_singleton(pkg):
    assert pkg.metrics.cumulative() is None
    assert pkg.obs.hist_ms("whatif.dispatch_ms") is pkg.trace.NULL_SPAN
    cum = pkg.metrics.enable_cumulative(hist_edges=(1.0,))
    with pkg.obs.hist_ms("whatif.dispatch_ms"):
        pass
    assert cum.snapshot()["hists"]["whatif.dispatch_ms"][()]["count"] == 1


# --- flight recorder ------------------------------------------------------------

def test_flight_ring_bounds_and_filters(pkg, tmp_path):
    rec = pkg.flight.FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("watch", "a" if i % 2 else "b", event=f"e{i}")
    assert rec.dropped == 2
    events = rec.snapshot()
    assert [e["event"] for e in events] == ["e2", "e3", "e4"]
    assert all(e["seq"] > 2 for e in events)
    rec.record("daemon", event="draining")
    a_events = rec.snapshot(cluster="a")
    assert {e.get("cluster", "a") for e in a_events} == {"a"}
    assert any(e["kind"] == "daemon" for e in a_events)
    path = tmp_path / "flight.ndjson"
    assert rec.flush(str(path)) == str(path)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["seq"] for e in lines] == [e["seq"] for e in rec.snapshot()]
    err = io.StringIO()
    assert rec.flush(str(tmp_path / "no" / "dir.ndjson"), err=err) is None
    assert "flight dump" in err.getvalue()


def test_flight_snapshot_order_pinned_to_seq(pkg, tmp_path):
    rec = pkg.flight.FlightRecorder(capacity=4)
    for i in range(4):
        rec.record("watch", event=f"e{i}")
    rec._events.rotate(2)
    assert [e["seq"] for e in rec.snapshot()] == [1, 2, 3, 4]
    assert [e["seq"] for e in rec.view()["events"]] == [1, 2, 3, 4]
    path = tmp_path / "flight.ndjson"
    rec.flush(str(path))
    assert [json.loads(ln)["seq"] for ln in path.read_text().splitlines()] == [1, 2, 3, 4]


def test_flight_module_activation(pkg, monkeypatch):
    flight = pkg.flight
    assert flight.recorder() is None
    flight.record("daemon", event="ignored")
    monkeypatch.setenv("KA_OBS_FLIGHT_EVENTS", "2")
    rec = flight.enable()
    assert rec is flight.recorder() and rec.capacity == 2
    monkeypatch.setenv("KA_OBS_FLIGHT_EVENTS", "0")
    assert flight.enable() is None
    monkeypatch.setenv("KA_OBS_FLIGHT_DUMP", "")
    flight.enable(capacity=4)
    flight.record("daemon", event="x")
    assert flight.flush_to_dump() is None


def test_fired_fault_lands_in_the_flight_ring(pkg, capsys):
    rec = pkg.flight.enable(capacity=8)
    inj = pkg.faults.FaultInjector(pkg.faults.parse_spec("solve:0=crash"))
    with pytest.raises(pkg.faults.InjectedSolverCrash):
        inj.solve_attempt()
    (ev,) = rec.snapshot()
    assert (ev["kind"], ev["spec"], ev["scope"], ev["fault_kind"]) == \
        ("fault", "solve:0=crash", "solve", "crash")
    assert "fault injected: solve:0=crash" in capsys.readouterr().err


# --- access log -----------------------------------------------------------------

def test_access_log_file_and_stderr(pkg, tmp_path):
    AccessLog = pkg.report.AccessLog
    path = tmp_path / "access.ndjson"
    log = AccessLog(str(path))
    log.log(request_id="r1", method="POST", path="/plan", code=200)
    log.log(request_id="r2", method="GET", path="/healthz", code=200)
    log.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["request_id"] for ln in lines] == ["r1", "r2"]
    assert all("ts" in ln for ln in lines)
    log2 = AccessLog(str(path))
    log2.log(request_id="r3", method="POST", path="/plan", code=200)
    log2.close()
    assert len(path.read_text().splitlines()) == 3
    err = io.StringIO()
    AccessLog(None, err=err).log(request_id="r4", code=503)
    assert json.loads(err.getvalue())["request_id"] == "r4"
    err = io.StringIO()
    bad = AccessLog(str(tmp_path / "no" / "log.ndjson"), err=err)
    assert "access log" in err.getvalue()
    bad.log(request_id="r5", code=200)
    assert '"request_id": "r5"' in err.getvalue()


def test_access_log_rollover_caps_size(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("KA_OBS_ACCESS_LOG_MAX_MB", "1")
    path = tmp_path / "access.ndjson"
    log = pkg.report.AccessLog(str(path))
    filler = "x" * 4096
    lines_to_fill = (1024 * 1024) // 4096 + 2
    for i in range(lines_to_fill):
        log.log(request_id=f"r{i}", pad=filler)
    rolled = tmp_path / "access.ndjson.1"
    assert rolled.exists()
    assert rolled.stat().st_size >= 1024 * 1024
    assert path.stat().st_size < 1024 * 1024
    all_lines = (rolled.read_text() + path.read_text()).splitlines()
    assert [json.loads(ln)["request_id"] for ln in all_lines] \
        == [f"r{i}" for i in range(lines_to_fill)]
    first_rolled_head = rolled.read_text().splitlines()[0]
    for i in range(lines_to_fill):
        log.log(request_id=f"s{i}", pad=filler)
    log.close()
    assert rolled.read_text().splitlines()[0] != first_rolled_head
    assert not (tmp_path / "access.ndjson.2").exists()


def test_access_log_unbounded_by_default(pkg, tmp_path, monkeypatch):
    monkeypatch.delenv("KA_OBS_ACCESS_LOG_MAX_MB", raising=False)
    path = tmp_path / "access.ndjson"
    log = pkg.report.AccessLog(str(path))
    for i in range(50):
        log.log(request_id=f"r{i}", pad="y" * 1000)
    log.close()
    assert not (tmp_path / "access.ndjson.1").exists()
    assert len(path.read_text().splitlines()) == 50


def test_access_log_rollover_resumes_count_across_restart(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("KA_OBS_ACCESS_LOG_MAX_MB", "1")
    path = tmp_path / "access.ndjson"
    filler = "z" * 4096
    log = pkg.report.AccessLog(str(path))
    for i in range(100):
        log.log(request_id=f"a{i}", pad=filler)
    log.close()
    log2 = pkg.report.AccessLog(str(path))
    n = 0
    while not (tmp_path / "access.ndjson.1").exists():
        log2.log(request_id=f"b{n}", pad=filler)
        n += 1
        assert n < 400, "rollover never tripped after restart"
    log2.close()
    assert n < 200


def test_access_log_rollover_failure_reported_once(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("KA_OBS_ACCESS_LOG_MAX_MB", "1")
    path = tmp_path / "access.ndjson"
    (tmp_path / "access.ndjson.1").mkdir()
    err = io.StringIO()
    log = pkg.report.AccessLog(str(path), err=err)
    filler = "x" * 4096
    n = (1024 * 1024) // 4096 + 10
    for i in range(n):
        log.log(request_id=f"r{i}", pad=filler)
    log.close()
    assert err.getvalue().count("rollover failed") == 1
    assert err.getvalue().count("rollover disabled") == 1
    assert len(path.read_text().splitlines()) == n


# --- span annotations -------------------------------------------------------------

def test_annotations_stamp_spans_recorded_after(pkg):
    with pkg.obs.run_capture() as run:
        with pkg.obs.span("before"):
            pass
        run.annotate("request_id", "rid-1")
        with pkg.obs.span("encode"):
            pass
        pkg.trace.record_span("warmup", 1.0)
    by_name = {s["name"]: s for s in run.spans}
    assert "request_id" not in by_name["before"]
    assert by_name["encode"]["request_id"] == "rid-1"
    assert by_name["warmup"]["request_id"] == "rid-1"


# --- profile hooks ----------------------------------------------------------------

def test_profile_disabled_is_refusal_not_crash(pkg):
    profile = pkg.profile
    assert profile.profile_dir() is None
    with pytest.raises(RuntimeError, match="KA_OBS_PROFILE_DIR"):
        profile.capture_window(0.1)
    with profile.dispatch_trace():
        pass


def test_profile_window_capture_and_busy(pkg, monkeypatch, tmp_path):
    profile = pkg.profile
    monkeypatch.setenv("KA_OBS_PROFILE_DIR", str(tmp_path))
    with pytest.raises(ValueError):
        profile.capture_window(float("nan"))
    assert profile.capture_window(0.05) == str(tmp_path)
    assert list(tmp_path.iterdir()), "no trace artifact written"
    assert profile._PROFILER_LOCK.acquire(blocking=False)
    try:
        with pytest.raises(profile.ProfilerBusy):
            profile.capture_window(0.05)
        with profile.dispatch_trace():
            pass
    finally:
        profile._PROFILER_LOCK.release()


def _trace_events(path):
    return json.loads(Path(path).read_text())["traceEvents"]


def test_dispatch_trace_writes_one_labelled_chrome_trace(monkeypatch, tmp_path):
    """Each batched solve under ``KA_OBS_PROFILE_DIR`` is one Chrome trace
    holding the dispatch label; unset, nothing is written; ``KA_PROFILE``
    is the older name of the same knob."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.obs.profile import DISPATCH_LABEL

    topics = {"events": {p: [100 + (p + i) % 5 for i in range(3)] for p in range(4)}}
    brokers, racks = set(range(100, 106)), {100 + i: f"r{i % 3}" for i in range(6)}
    assigner = TopicAssigner(device="cpu")
    baseline = assigner.generate_assignments(topics, brokers, racks)

    traced = tmp_path / "traces"
    for knob in ("KA_OBS_PROFILE_DIR", "KA_PROFILE"):
        monkeypatch.setenv(knob, str(traced / knob))
        assigner = TopicAssigner(device="cpu")
        assert assigner.generate_assignments(topics, brokers, racks) == baseline
        monkeypatch.delenv(knob)
        (path,) = (traced / knob).iterdir()
        assert path.name.startswith(f"ka_dispatch_{os.getpid()}_")
        names = [e.get("name") for e in _trace_events(path)]
        assert names.count(DISPATCH_LABEL) == 1
        assert any("leadership" in str(n) or "aten::" in str(n) for n in names)
    assigner = TopicAssigner(device="cpu")
    assigner.generate_assignments(topics, brokers, racks)
    assert sorted(p.name for p in traced.iterdir()) == ["KA_OBS_PROFILE_DIR", "KA_PROFILE"]


def test_device_trace_writes_when_the_block_raises(tmp_path):
    from kafka_assigner_tpu_torch.obs.profile import device_trace

    with pytest.raises(RuntimeError, match="inside"):
        with device_trace(str(tmp_path), "failing") as path:
            torch.ones(4).sum()
            raise RuntimeError("inside")
    assert Path(path).exists() and _trace_events(path)


@pytest.mark.cuda
def test_dispatch_trace_on_the_card_holds_the_leadership_kernel(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.ops import leadership as lead

    tm, live, racks = rack_striped_cluster(60, 8, 40, 3, 5)
    assigner = TopicAssigner(device="cuda")
    assigner.generate_assignments(tm, live, racks)  # builds the kernel
    monkeypatch.setenv("KA_OBS_PROFILE_DIR", str(tmp_path))
    lead.launches["leadership"] = 0
    assigner.generate_assignments(tm, live, racks)
    assert lead.launches["leadership"] == 1
    (path,) = tmp_path.iterdir()
    kernels = [e["name"] for e in _trace_events(path) if e.get("cat") == "kernel"]
    assert sum("chain_kernel" in k for k in kernels) == 1, kernels
    assert sum("prologue_kernel" in k for k in kernels) == 1, kernels


# --- declared names -----------------------------------------------------------------

_WRITE = re.compile(
    r"""\b(?:counter_add|gauge_set|hist_observe|hist_ms|span|record_span)\("""
    r"""\s*["']([a-z_./]+)["']"""
    r"""|hist=["']([a-z_./]+)["']""")


def test_every_literal_name_the_port_writes_is_declared():
    """The port's stand-in for the reference's lint rule KA013: every literal
    first argument of a metric write or a span in the port's sources is
    declared in ``obs/names.py``; and every declared name is the
    reference's."""
    pkg_root = Path(kafka_assigner_tpu_torch.__file__).parent
    written = set()
    for path in pkg_root.rglob("*.py"):
        for m in _WRITE.finditer(path.read_text(encoding="utf-8")):
            written.add(m.group(1) or m.group(2))
    undeclared = sorted(written - torch_names.ALL_NAMES)
    assert not undeclared, undeclared
    assert torch_names.METRIC_NAMES <= jax_names.METRIC_NAMES
    assert torch_names.SPAN_NAMES <= jax_names.SPAN_NAMES
    assert {"zk.reads", "plan.moves", "solve.fallbacks", "encode", "warmup",
            "warmup.failures", "compile.store.hits", "compile.store.misses",
            "compile.store.exec_fallbacks", "compile.store.loads_ms",
            "compile.store.compiles_ms"} <= written


def test_every_name_in_the_ports_reports_is_declared(cluster8, tmp_path, monkeypatch,
                                                    empty_stores):
    """The names the port's reports carry over mode 3 (both policies, a
    fallback, a skip), fresh, the ranking and ``ka-groups``: each is
    declared, or composes on a declared base (``mode/<MODE>``,
    ``faults.injected.<kind>``, ``warmup.<outcome>``)."""
    snap, scen = cluster8
    base = ["--zk_string", snap, "--device", "cpu"]
    seen = set()
    runs = [
        (cli.run_tool, ["--mode", "PRINT_REASSIGNMENT"], {}),
        (cli.run_tool, ["--mode", "PRINT_REASSIGNMENT", "--solver", "native"], {}),
        (cli.run_tool, ["--mode", "PRINT_REASSIGNMENT", "--failure-policy",
                        "best-effort", "--topics", "events,ghost"],
         {"KA_FAULTS_SPEC": "solve:0=crash"}),
        (cli.run_tool, ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "x",
                        "--partition_count", "6", "--desired_replication_factor", "2"], {}),
        (cli.run_tool, ["--mode", "RANK_DECOMMISSION", "--scenario_file", scen], {}),
        (cli.run_tool, ["--mode", "RANK_DECOMMISSION"], {"KA_WHATIF_INCREMENTAL": "0"}),
        (cli.run_groups, ["--mode", "plan"], {}),
        (cli.run_groups, ["--mode", "sweep", "--failure-policy", "best-effort"],
         {"KA_FAULTS_SPEC": "solve:0=crash"}),
    ]
    for i, (fn, argv, env) in enumerate(runs):
        torch_faults.reset()
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            path = tmp_path / f"r{i}.json"
            rc, _, _ = _run(fn, base + argv + ["--report-json", str(path)])
        assert rc in (0, cli.EXIT_DEGRADED), argv
        report = json.loads(path.read_text())
        metrics = report["metrics"]
        seen |= set(metrics["counters"]) | set(metrics["gauges"]) \
            | set(metrics["histograms"])
        seen |= {s["name"] for s in report["spans"]}
    composed = {n for n in seen
                if n.startswith(("mode/", "faults.injected.", "warmup."))
                and n != "warmup.failures"}
    assert {"mode/PRINT_REASSIGNMENT", "faults.injected.crash",
            "warmup.warmed"} <= composed
    assert not sorted(seen - composed - torch_names.ALL_NAMES)
    assert {"solve.fallbacks", "ingest.topics_skipped", "plan.unplanned_topics",
            "native/assign_many", "whatif/dispatch", "groups.solve_fallbacks"} <= seen

