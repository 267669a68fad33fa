"""``ka-execute`` in the port (``kafka_assigner_tpu_torch/exec/``, the
snapshot backend's write side, ``cli.execute``) against the JAX package's,
on the CPU:

- the contracts of ``tests/test_exec.py`` on the port's entries: the
  journal's life and crash safety, waves and throttled convergence on the
  snapshot backend's simulated cluster, the write read-back rule, the exit
  codes (ok, resume, degraded, verify mismatch), the rollback and the
  journal's (cluster, plan) identity;
- parity with the reference's ``execute`` on copies of one snapshot at one
  path, byte for byte: the final snapshot, stderr (milliseconds masked),
  the journal, the exit code and the run report (apart from milliseconds),
  for a forward run, ``--rollback``, a kill at a wave boundary then
  ``--resume`` (also across the packages), and each ``write`` and
  ``converge`` fault under both policies; a snapshot with ``traffic`` and
  ``groups`` sections persists to the reference's bytes;
- ``scripts/torch_exec_smoke.py``, and an execution that imports no
  ``torch``.

The plan is a real multi-wave one: mode 3 on the greedy lane over the
9-broker fixture of ``tests/jute_server.py`` with one broker drained.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import execute as jax_execute
from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.faults.inject import InjectedExecCrash as JaxExecCrash
from kafka_assigner_tpu_torch import faults
from kafka_assigner_tpu_torch.cli import (
    EXIT_DEGRADED,
    EXIT_EXECUTE,
    EXIT_OK,
    EXIT_VALIDATION,
    EXIT_VERIFY,
    execute,
    run,
)
from kafka_assigner_tpu_torch.exec.engine import (
    PlanExecutor,
    load_plan_file,
)
from kafka_assigner_tpu_torch.exec.journal import (
    ExecutionJournal,
    JournalError,
    plan_fingerprint,
)
from kafka_assigner_tpu_torch.faults.inject import InjectedExecCrash

from .test_torch_obs import _comparable


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(autouse=True)
def _fast_exec_env(monkeypatch):
    """Tight wave/poll knobs so every test runs in milliseconds; the sim
    convergence needs one extra poll per move (KA_EXEC_SIM_POLLS=1), which
    keeps the retry path honest."""
    monkeypatch.setenv("KA_EXEC_WAVE_SIZE", "3")
    monkeypatch.setenv("KA_EXEC_POLL_INTERVAL", "0.01")
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "10")
    monkeypatch.setenv("KA_EXEC_SIM_POLLS", "1")


def _cluster():
    from .jute_server import exec_snapshot_cluster

    return exec_snapshot_cluster()


@pytest.fixture(scope="module")
def plan_text(tmp_path_factory):
    """One real multi-wave plan (greedy mode 3, broker h9 drained), built
    once for the module: the full mode-3 stdout, banners included — what an
    operator actually saves."""
    d = tmp_path_factory.mktemp("exec_plan")
    src = d / "cluster.json"
    src.write_text(json.dumps(_cluster()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run([
            "--zk_string", str(src), "--mode", "PRINT_REASSIGNMENT",
            "--solver", "greedy", "--broker_hosts_to_remove", "h9",
            "--device", "cpu",
        ])
    assert rc == 0 and "NEW ASSIGNMENT:" in out.getvalue()
    return out.getvalue()


@pytest.fixture()
def workdir(tmp_path, plan_text):
    """A fresh cluster copy + plan file + journal path per test."""
    cluster = tmp_path / "cluster.json"
    cluster.write_text(json.dumps(_cluster()))
    plan = tmp_path / "plan.json"
    plan.write_text(plan_text)
    return {
        "cluster": str(cluster),
        "plan": str(plan),
        "journal": str(tmp_path / "run.journal"),
        "report": str(tmp_path / "report.json"),
    }


def _execute(w, *extra):
    argv = ["--zk_string", w["cluster"], "--plan", w["plan"],
            "--journal", w["journal"], *extra]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(argv)
    return rc, err.getvalue()


def _final_topics(w):
    with open(w["cluster"], "r", encoding="utf-8") as f:
        return {
            t: {int(p): list(r) for p, r in parts.items()}
            for t, parts in json.load(f)["topics"].items()
        }


# --- journal -----------------------------------------------------------------

def test_journal_round_trip_and_wave_split(tmp_path):
    path = str(tmp_path / "j")
    moves = [("t", p, [1, 2, 3]) for p in range(7)]
    j = ExecutionJournal.fresh(path, "hash", 3, moves)
    assert j.waves_total == 3
    assert [m[1] for m in j.wave(0)] == [0, 1, 2]
    assert [m[1] for m in j.wave(2)] == [6]
    j.commit_wave(2, skipped=[("t", 4)])
    loaded = ExecutionJournal.load(path)
    assert loaded.waves_committed == 2
    assert loaded.skipped == [("t", 4)]
    assert loaded.moves == moves
    assert loaded.status == "in-progress"
    loaded.complete()
    assert ExecutionJournal.load(path).status == "complete"


def test_fresh_journal_move_order_is_canonical(tmp_path):
    """The wave partition is a function of plan CONTENT: scrambled upstream
    ordering freezes into (topic, partition) order — but ``load`` replays a
    journal file's order verbatim, committed wave boundaries included."""
    path = str(tmp_path / "j")
    scrambled = [("tb", 1, [2]), ("ta", 5, [3]), ("tb", 0, [1]),
                 ("ta", 2, [4])]
    j = ExecutionJournal.fresh(path, "hash", 2, scrambled)
    canonical = [("ta", 2, [4]), ("ta", 5, [3]), ("tb", 0, [1]),
                 ("tb", 1, [2])]
    assert j.moves == canonical
    assert ExecutionJournal.fresh(
        str(tmp_path / "j2"), "hash", 2, list(reversed(scrambled))
    ).moves == canonical
    # load() is verbatim: hand the file a NON-canonical order and the
    # in-flight run must resume against exactly those waves.
    data = json.loads((tmp_path / "j").read_text())
    data["moves"] = [list(m) for m in reversed(canonical)]
    (tmp_path / "j").write_text(json.dumps(data))
    loaded = ExecutionJournal.load(path)
    assert loaded.moves == list(reversed(canonical))


def test_journal_rejects_corruption_and_bad_schema(tmp_path):
    p = tmp_path / "j"
    p.write_text("{not json")
    with pytest.raises(JournalError, match="corrupt"):
        ExecutionJournal.load(str(p))
    p.write_text(json.dumps({"version": 99}))
    with pytest.raises(JournalError, match="version"):
        ExecutionJournal.load(str(p))
    p.write_text(json.dumps({
        "version": 1, "plan": "h", "wave_size": 2, "status": "in-progress",
        "waves_committed": 9, "moves": [["t", 0, [1]]], "skipped": [],
    }))
    with pytest.raises(JournalError, match="committed"):
        ExecutionJournal.load(str(p))


def test_plan_fingerprint_is_whitespace_insensitive(workdir):
    plan_a, order_a = load_plan_file(workdir["plan"])
    bare = json.dumps({
        "partitions": [
            {"partition": p, "replicas": plan_a[t][p], "topic": t}
            for t in order_a for p in sorted(plan_a[t])
        ],
        "version": 1,
    }, indent=3)
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    parsed = parse_reassignment_json(bare)
    assert plan_fingerprint(parsed, list(parsed)) == \
        plan_fingerprint(plan_a, order_a)


def test_load_plan_file_accepts_bare_json_and_saved_stdout(
    workdir, tmp_path
):
    full, order = load_plan_file(workdir["plan"])
    bare_path = tmp_path / "bare.json"
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

    bare_path.write_text(
        format_reassignment_pairs([(t, full[t]) for t in order])
    )
    bare, bare_order = load_plan_file(str(bare_path))
    assert bare == full and bare_order == order
    # The rollback section must NOT be what gets executed: a saved stdout
    # contains the CURRENT ASSIGNMENT first, and it differs from the plan.
    with open(workdir["plan"], "r", encoding="utf-8") as f:
        rollback = f.read().split("NEW ASSIGNMENT:")[0]
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    current = parse_reassignment_json(rollback.split("\n", 1)[1].strip())
    assert current != full


# --- happy path --------------------------------------------------------------

def test_execute_ok_and_verify(workdir):
    rc, err = _execute(workdir, "--report-json", workdir["report"])
    assert rc == EXIT_OK, err
    assert "verify-after-move OK" in err
    plan, _ = load_plan_file(workdir["plan"])
    final = _final_topics(workdir)
    for t, parts in plan.items():
        for p, reps in parts.items():
            assert final[t][p] == reps
    with open(workdir["report"], "r", encoding="utf-8") as f:
        rep = json.load(f)
    counters = rep["metrics"]["counters"]
    assert counters["exec.waves"] >= 2          # a real multi-wave run
    assert counters["exec.moves"] >= counters["exec.waves"]
    assert counters["exec.verify"] == 1
    assert counters["zk.writes"] == counters["exec.waves"]
    assert "exec.wave_ms" in rep["metrics"]["histograms"]
    assert rep["plan"]["skipped_moves"] == []
    assert rep["plan"]["verify_mismatches"] == []
    assert [s for s in rep["spans"] if s["name"] == "exec/verify"]
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        assert json.load(f)["status"] == "complete"


def test_execute_is_idempotent_when_converged(workdir):
    rc, _ = _execute(workdir)
    assert rc == EXIT_OK
    os.unlink(workdir["journal"])
    rc, err = _execute(workdir)
    assert rc == EXIT_OK
    assert "0 move(s) submitted" in err  # everything was a noop


def test_wave_size_flag_overrides_knob(workdir):
    rc, err = _execute(workdir, "--wave-size", "1")
    assert rc == EXIT_OK
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        j = json.load(f)
    assert j["wave_size"] == 1
    assert len(j["moves"]) == -(-len(j["moves"]) // 1)  # one move per wave


# --- crash / resume ----------------------------------------------------------

def _baseline_final(workdir, tmp_path):
    base = str(tmp_path / "baseline.json")
    shutil.copy(workdir["cluster"], base)
    w = dict(workdir, cluster=base, journal=str(tmp_path / "b.journal"))
    rc, err = _execute(w)
    assert rc == EXIT_OK, err
    with open(base, "r", encoding="utf-8") as f:
        return f.read()


def test_kill_at_wave_boundary_resumes_byte_identical(
    workdir, tmp_path, monkeypatch
):
    base_final = _baseline_final(workdir, tmp_path)
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    with pytest.raises(InjectedExecCrash):
        _execute(workdir)
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        j = json.load(f)
    assert j["status"] == "in-progress" and j["waves_committed"] == 1
    # Without --resume the interrupted journal is refused loudly.
    rc, err = _execute(workdir)
    assert rc == EXIT_VALIDATION
    assert "--resume" in err
    rc, err = _execute(workdir, "--resume")
    assert rc == EXIT_OK, err
    assert "resuming from journal" in err
    with open(workdir["cluster"], "r", encoding="utf-8") as f:
        assert f.read() == base_final


def test_resume_refuses_a_different_plan(workdir, tmp_path, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    with pytest.raises(InjectedExecCrash):
        _execute(workdir)
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    plan, order = load_plan_file(workdir["plan"])
    t0 = order[0]
    p0 = sorted(plan[t0])[0]
    plan[t0][p0] = list(reversed(plan[t0][p0]))
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

    with open(workdir["plan"], "w", encoding="utf-8") as f:
        f.write(format_reassignment_pairs([(t, plan[t]) for t in order]))
    rc, err = _execute(workdir, "--resume")
    assert rc == EXIT_VALIDATION
    assert "different plan" in err


def test_resume_without_journal_is_a_validation_error(workdir):
    rc, err = _execute(workdir, "--resume")
    assert rc == EXIT_VALIDATION
    assert "journal" in err


def test_interrupted_journal_of_another_plan_is_never_clobbered(
    workdir, tmp_path, monkeypatch
):
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    with pytest.raises(InjectedExecCrash):
        _execute(workdir)
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        before = f.read()
    # A DIFFERENT plan pointed at the same journal path: refused, and the
    # interrupted run's committed-wave record survives untouched.
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

    other = tmp_path / "other_plan.json"
    other.write_text(format_reassignment_pairs([("events", {0: [2, 1, 3]})]))
    rc, err = _execute(dict(workdir, plan=str(other)))
    assert rc == EXIT_VALIDATION
    assert "DIFFERENT plan" in err
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        assert f.read() == before


def test_plan_time_skips_survive_a_crash_and_resume_degraded(
    workdir, tmp_path, monkeypatch
):
    """A best-effort run whose plan names an unresolvable topic, killed
    mid-execution: the plan-time skip is journaled, so the resumed run
    still exits DEGRADED with the skip named — never reclassified as a
    verify mismatch."""
    plan, order = load_plan_file(workdir["plan"])
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

    mixed = tmp_path / "mixed_plan.json"
    mixed.write_text(format_reassignment_pairs(
        [("ghost", {0: [1, 2, 3]})] + [(t, plan[t]) for t in order]
    ))
    w = dict(workdir, plan=str(mixed), journal=str(tmp_path / "m.journal"))
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    with pytest.raises(InjectedExecCrash):
        _execute(w, "--failure-policy", "best-effort")
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    with open(w["journal"], "r", encoding="utf-8") as f:
        assert ["ghost", 0] in json.load(f)["skipped"]
    rc, err = _execute(w, "--failure-policy", "best-effort", "--resume",
                       "--report-json", w["report"])
    assert rc == EXIT_DEGRADED, err
    with open(w["report"], "r", encoding="utf-8") as f:
        rep = json.load(f)
    assert ["ghost", 0] in rep["plan"]["skipped_moves"]
    assert rep["plan"]["verify_mismatches"] == []


# --- write seams -------------------------------------------------------------

def test_write_drop_reads_back_and_resubmits(workdir, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "write:0=drop")
    faults.reset()
    rc, err = _execute(workdir, "--report-json", workdir["report"])
    assert rc == EXIT_OK, err
    assert "never a blind replay" in err
    with open(workdir["report"], "r", encoding="utf-8") as f:
        counters = json.load(f)["metrics"]["counters"]
    assert counters["exec.write_retries"] >= 1
    assert counters["faults.injected.drop"] == 1


def test_write_lost_strict_halts_resumably(workdir, monkeypatch, tmp_path):
    base_final = _baseline_final(workdir, tmp_path)
    monkeypatch.setenv("KA_FAULTS_SPEC", "write:0=lost")
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "0.3")
    faults.reset()
    rc, err = _execute(workdir)
    assert rc == EXIT_EXECUTE
    assert "--resume" in err
    # The acked-but-lost write left the OLD assignment complete: nothing
    # stranded, and the journal resumes to the byte-identical final state.
    monkeypatch.delenv("KA_FAULTS_SPEC")
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "10")
    faults.reset()
    rc, err = _execute(workdir, "--resume")
    assert rc == EXIT_OK, err
    with open(workdir["cluster"], "r", encoding="utf-8") as f:
        assert f.read() == base_final


def test_write_lost_best_effort_degrades_with_accounting(
    workdir, monkeypatch
):
    initial = _final_topics(workdir)
    monkeypatch.setenv("KA_FAULTS_SPEC", "write:0=lost")
    monkeypatch.setenv("KA_EXEC_POLL_TIMEOUT", "0.3")
    faults.reset()
    rc, err = _execute(workdir, "--failure-policy", "best-effort",
                       "--report-json", workdir["report"])
    assert rc == EXIT_DEGRADED, err
    with open(workdir["report"], "r", encoding="utf-8") as f:
        rep = json.load(f)
    assert rep["status"] == "degraded"
    skipped = rep["plan"]["skipped_moves"]
    assert skipped  # the lost wave's moves, named partition by partition
    final = _final_topics(workdir)
    for t, p in skipped:
        # A skipped move leaves its COMPLETE initial replica list — never
        # a partial state.
        assert final[t][int(p)] == initial[t][int(p)]


def test_converge_stall_retries_through(workdir, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "converge:0=stall")
    faults.reset()
    rc, _ = _execute(workdir, "--report-json", workdir["report"])
    assert rc == EXIT_OK
    with open(workdir["report"], "r", encoding="utf-8") as f:
        counters = json.load(f)["metrics"]["counters"]
    assert counters["exec.retries"] >= 1
    assert counters["faults.injected.stall"] == 1


# --- verify-after-move -------------------------------------------------------

def test_external_drift_fails_verify(workdir, monkeypatch):
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    with pytest.raises(InjectedExecCrash):
        _execute(workdir)
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    # Somebody else rewrites a partition the interrupted run had already
    # committed; the resumed run's verify pass must catch it.
    with open(workdir["journal"], "r", encoding="utf-8") as f:
        t0, p0, _ = json.load(f)["moves"][0]
    with open(workdir["cluster"], "r", encoding="utf-8") as f:
        snap = json.load(f)
    snap["topics"][t0][str(p0)] = [9] + snap["topics"][t0][str(p0)][1:]
    with open(workdir["cluster"], "w", encoding="utf-8") as f:
        json.dump(snap, f)
    rc, err = _execute(workdir, "--resume", "--report-json",
                       workdir["report"])
    assert rc == EXIT_VERIFY
    assert "VERIFY MISMATCH" in err
    with open(workdir["report"], "r", encoding="utf-8") as f:
        rep = json.load(f)
    assert rep["plan"]["verify_mismatches"]
    assert rep["plan"]["verify_mismatches"][0]["topic"] == t0


def test_read_only_backend_is_refused():
    class ReadOnly:
        pass

    # ValueError (validation exit): refused before any journal exists.
    with pytest.raises(ValueError, match="cannot execute"):
        PlanExecutor(
            ReadOnly(), {"t": {0: [1]}}, ["t"], "/nonexistent/journal"
        ).execute()


def test_missing_plan_topic_strict_vs_best_effort(workdir, tmp_path):
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

    ghost_plan = tmp_path / "ghost.json"
    ghost_plan.write_text(
        format_reassignment_pairs([("ghost", {0: [1, 2, 3]})])
    )
    w = dict(workdir, plan=str(ghost_plan),
             journal=str(tmp_path / "g.journal"))
    # Validation, not the resumable-halt code: no journal exists yet, so
    # exit 8's "--resume" promise would be a lie here.
    rc, err = _execute(w)
    assert rc == EXIT_VALIDATION
    assert "does not exist" in err
    assert not os.path.exists(w["journal"])
    rc, err = _execute(w, "--failure-policy", "best-effort")
    assert rc == EXIT_DEGRADED
    assert "skipping" in err


# --- usage / CLI surface -----------------------------------------------------

def test_usage_requires_plan_and_zk_string(capsys):
    assert execute([]) == 1
    assert "required" in capsys.readouterr().err


def test_journal_default_path_is_plan_derived(workdir):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", workdir["cluster"],
                      "--plan", workdir["plan"]])
    assert rc == EXIT_OK
    assert os.path.exists(workdir["plan"] + ".journal")


# --- degraded-run diff in the plan section -------------------------------------

def test_mode3_reports_unplanned_topics(workdir, tmp_path):
    report = str(tmp_path / "m3_report.json")
    err = io.StringIO()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run([
            "--zk_string", workdir["cluster"],
            "--mode", "PRINT_REASSIGNMENT", "--solver", "greedy",
            "--topics", "events,ghost", "--failure-policy", "best-effort",
            "--report-json", report, "--device", "cpu",
        ])
    assert rc == EXIT_DEGRADED
    with open(report, "r", encoding="utf-8") as f:
        rep = json.load(f)
    assert rep["plan"]["unplanned_topics"] == ["ghost"]
    assert rep["metrics"]["gauges"]["ingest.topics_skipped"] == 1


# --- ka-execute --rollback ---------------------------------------------------

def _canonical_snapshot_bytes(tmp_path, data):
    """The original cluster serialized through the snapshot writer — the
    byte-identity oracle for 'rollback restored the initial state' (the
    execution engine re-persists through the same writer)."""
    from kafka_assigner_tpu_torch.io.base import BrokerInfo
    from kafka_assigner_tpu_torch.io.snapshot import write_snapshot

    path = str(tmp_path / "canonical_initial.json")
    write_snapshot(
        path,
        [BrokerInfo(id=b["id"], host=b["host"], port=b["port"],
                    rack=b.get("rack")) for b in data["brokers"]],
        {t: {int(p): list(r) for p, r in parts.items()}
         for t, parts in data["topics"].items()},
    )
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def test_rollback_restores_byte_identical_state(workdir, tmp_path):
    canonical = _canonical_snapshot_bytes(tmp_path, _cluster())
    initial = _final_topics(workdir)

    rc, _ = _execute(workdir)
    assert rc == EXIT_OK
    moved = _final_topics(workdir)
    assert moved != initial  # the forward run really moved replicas

    # Rollback through the same wave engine, default rollback journal.
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", workdir["cluster"],
                      "--plan", workdir["plan"], "--rollback"])
    assert rc == EXIT_OK, err.getvalue()
    assert "verify-after-move OK" in err.getvalue()
    with open(workdir["cluster"], "r", encoding="utf-8") as f:
        assert f.read() == canonical  # byte-identical restore
    # Its own journal identity: the forward journal is untouched, the
    # rollback journal is complete.
    assert os.path.exists(workdir["plan"] + ".rollback.journal")
    with open(workdir["plan"] + ".rollback.journal", encoding="utf-8") as f:
        assert json.load(f)["status"] == "complete"


def test_rollback_refuses_bare_plan_json(tmp_path, capsys):
    bare = tmp_path / "bare_plan.json"
    bare.write_text(
        '{"partitions": [{"topic": "events", "partition": 0, '
        '"replicas": [1, 2, 3]}], "version": 1}'
    )
    cluster = tmp_path / "cluster.json"
    cluster.write_text(json.dumps(_cluster()))
    rc = execute(["--zk_string", str(cluster), "--plan", str(bare),
                  "--rollback"])
    assert rc == EXIT_VALIDATION
    assert "no 'CURRENT ASSIGNMENT:'" in capsys.readouterr().err


def test_load_plan_file_current_section(workdir):
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    fwd, _ = load_plan_file(workdir["plan"])
    cur, _ = load_plan_file(workdir["plan"], section="current")
    with open(workdir["plan"], "r", encoding="utf-8") as f:
        text = f.read()
    snapshot_line = text.split("CURRENT ASSIGNMENT:", 1)[1].strip()
    snapshot_line = snapshot_line.splitlines()[0]
    assert cur == parse_reassignment_json(snapshot_line)
    assert cur != fwd  # the plan really changes something


def test_rollback_env_journal_gets_own_identity(workdir, tmp_path,
                                                monkeypatch):
    """KA_EXEC_JOURNAL must not make forward and rollback runs share one
    journal: the env default gets the rollback suffix too."""
    shared = str(tmp_path / "env.journal")
    monkeypatch.setenv("KA_EXEC_JOURNAL", shared)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", workdir["cluster"],
                      "--plan", workdir["plan"]])
    assert rc == EXIT_OK, err.getvalue()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", workdir["cluster"],
                      "--plan", workdir["plan"], "--rollback"])
    assert rc == EXIT_OK, err.getvalue()
    assert os.path.exists(shared)
    assert os.path.exists(shared + ".rollback")
    with open(shared, encoding="utf-8") as f:
        fwd = json.load(f)
    with open(shared + ".rollback", encoding="utf-8") as f:
        rb = json.load(f)
    assert fwd["plan"] != rb["plan"]  # two journal identities, both complete
    assert fwd["status"] == rb["status"] == "complete"


# --- journal identity = (cluster, plan sha) ----------------------------------

def test_journal_persists_cluster_identity(tmp_path):
    path = str(tmp_path / "j")
    j = ExecutionJournal.fresh(path, "hash", 3, [("t", 0, [1])],
                               cluster="zk-a:2181")
    loaded = ExecutionJournal.load(path)
    assert loaded.cluster == "zk-a:2181"
    # legacy journals (no cluster field) load as cluster=None
    raw = json.loads((tmp_path / "j").read_text())
    del raw["cluster"]
    (tmp_path / "legacy").write_text(json.dumps(raw))
    assert ExecutionJournal.load(str(tmp_path / "legacy")).cluster is None


def test_resume_refuses_same_plan_on_a_different_cluster(
    workdir, tmp_path, monkeypatch
):
    """Two clusters executing BYTE-IDENTICAL plans must never cross-resume
    through one journal file: the journal is keyed by (cluster, plan sha),
    not the plan sha alone."""
    # interrupt a run on cluster A after one committed wave
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(InjectedExecCrash):
        execute(["--zk_string", workdir["cluster"], "--plan",
                 workdir["plan"], "--journal", workdir["journal"]])
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    # cluster B: same initial metadata, so the SAME plan bytes apply — but
    # resuming through A's journal must be refused loudly
    other = tmp_path / "other_cluster.json"
    other.write_text(json.dumps(_cluster()))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", str(other), "--plan", workdir["plan"],
                      "--journal", workdir["journal"], "--resume"])
    assert rc == EXIT_VALIDATION
    assert "DIFFERENT cluster" in err.getvalue()
    # a FRESH run on cluster B through the same journal path is refused
    # too: the interrupted run's record must never be clobbered
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", str(other), "--plan", workdir["plan"],
                      "--journal", workdir["journal"]])
    assert rc == EXIT_VALIDATION
    assert "DIFFERENT cluster" in err.getvalue()
    # the rightful owner still resumes to completion
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = execute(["--zk_string", workdir["cluster"], "--plan",
                      workdir["plan"], "--journal", workdir["journal"],
                      "--resume"])
    assert rc == EXIT_OK, err.getvalue()


def test_legacy_clusterless_journal_still_resumes(workdir, monkeypatch):
    """Back-compat: a journal written before the cluster field existed
    (cluster=None) resumes under any cluster."""
    monkeypatch.setenv("KA_FAULTS_SPEC", "wave:1=crash")
    faults.reset()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(InjectedExecCrash):
        execute(["--zk_string", workdir["cluster"], "--plan",
                 workdir["plan"], "--journal", workdir["journal"]])
    monkeypatch.delenv("KA_FAULTS_SPEC")
    faults.reset()
    raw = json.loads(open(workdir["journal"]).read())
    raw["cluster"] = None
    with open(workdir["journal"], "w", encoding="utf-8") as f:
        json.dump(raw, f)
    rc, err = _execute(workdir, "--resume")
    assert rc == EXIT_OK, err


# --- parity with the reference's ka-execute ----------------------------------

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {
    "jax": (jax_execute, jax_faults, JaxExecCrash),
    "torch": (execute, faults, InjectedExecCrash),
}
#: Measured milliseconds in the obs summary on stderr.
_MS = re.compile(r"\d+(?:\.\d+)?ms")
#: What a clock decides: the number of polls inside a poll budget, and so
#: the spans the summary counts.
_CLOCK = re.compile(r"spans=\d+")


def _drive(monkeypatch, w, steps, clock=False):
    """Run ``steps`` in ``w`` (every step on the same paths, so journals and
    messages name the same files): each step is ``(package, extra argv,
    env)`` or a callable taking ``w``. Returns each step's exit code (or
    ``"crash"`` for the injected kill), masked stderr and comparable
    report, then the final snapshot and journal bytes."""
    out = {"steps": []}
    for step in steps:
        if callable(step):
            step(w)
            continue
        pkg, extra, env = step
        fn, flt, crash = PACKAGES[pkg]
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for f in (faults, jax_faults):
            f.reset()
        if os.path.exists(w["report"]):
            os.unlink(w["report"])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                rc = fn(["--zk_string", w["cluster"], "--plan", w["plan"],
                         "--journal", w["journal"], *extra])
            except crash:
                rc = "crash"
        for key in env:
            monkeypatch.delenv(key)
        text = _MS.sub("<ms>", err.getvalue())
        report = None
        if os.path.exists(w["report"]):
            with open(w["report"], "r", encoding="utf-8") as f:
                report = _comparable(json.load(f))
        if clock:
            text = _CLOCK.sub("spans=<n>", text)
            if report is not None:
                report["counters"].pop("exec.retries", None)
                report["spans"] = sorted({s for s in report["spans"]})
        out["steps"].append((rc, text, report))
    for key in ("cluster", "journal"):
        if os.path.exists(w[key]):
            with open(w[key], "r", encoding="utf-8") as f:
                out[key] = f.read()
    rollback = w["plan"] + ".rollback.journal"
    if os.path.exists(rollback):
        with open(rollback, "r", encoding="utf-8") as f:
            out["rollback_journal"] = f.read()
    return out


def _reset(w, cluster):
    with open(w["cluster"], "w", encoding="utf-8") as f:
        json.dump(cluster, f)
    for path in (w["journal"], w["report"], w["plan"] + ".rollback.journal"):
        if os.path.exists(path):
            os.unlink(path)


def _both(monkeypatch, w, steps, cluster=None, clock=False):
    """The same steps on the reference, then on the port, each from the
    same initial cluster at the same path."""
    cluster = cluster if cluster is not None else _cluster()
    runs = {}
    for pkg in ("jax", "torch"):
        _reset(w, cluster)
        runs[pkg] = _drive(monkeypatch, w, [
            s if callable(s) else (pkg, *s) for s in steps], clock=clock)
    return runs["jax"], runs["torch"]


def _doctor(w):
    # Another writer changes a partition the interrupted run committed.
    with open(w["journal"], "r", encoding="utf-8") as f:
        t0, p0, _ = json.load(f)["moves"][0]
    with open(w["cluster"], "r", encoding="utf-8") as f:
        snap = json.load(f)
    snap["topics"][t0][str(p0)] = [9] + snap["topics"][t0][str(p0)][1:]
    with open(w["cluster"], "w", encoding="utf-8") as f:
        json.dump(snap, f)


def _rep(w):
    return ("--report-json", w["report"])


PARITY = {
    "forward": lambda w: [(_rep(w), {})],
    "forward-wave-1": lambda w: [(("--wave-size", "1", *_rep(w)), {})],
    "rollback": lambda w: [((), {}), (("--rollback", *_rep(w)), {})],
    "kill-resume": lambda w: [((), {"KA_FAULTS_SPEC": "wave:1=crash"}),
                              ((), {}),
                              (("--resume", *_rep(w)), {})],
    "verify-mismatch": lambda w: [((), {"KA_FAULTS_SPEC": "wave:1=crash"}), _doctor,
                                  (("--resume", *_rep(w)), {})],
    "ghost-best-effort": lambda w: [(("--failure-policy", "best-effort", *_rep(w)),
                                     {})],
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_execute_matches_the_reference(workdir, monkeypatch, name):
    if name == "ghost-best-effort":
        # A plan topic the cluster lacks, skipped at plan time.
        plan, order = load_plan_file(workdir["plan"])
        from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs

        with open(workdir["plan"], "w", encoding="utf-8") as f:
            f.write(format_reassignment_pairs(
                [("ghost", {0: [1, 2, 3]})] + [(t, plan[t]) for t in order]))
    ref, got = _both(monkeypatch, workdir, PARITY[name](workdir))
    assert got == ref
    rcs = [rc for rc, _, _ in got["steps"]]
    want = {"forward": [0], "forward-wave-1": [0], "rollback": [0, 0],
            "kill-resume": ["crash", EXIT_VALIDATION, EXIT_OK],
            "verify-mismatch": ["crash", EXIT_VERIFY],
            "ghost-best-effort": [EXIT_DEGRADED]}[name]
    assert rcs == want
    assert got["steps"][-1][2] is not None  # the report was compared too


@pytest.mark.parametrize("policy", ["strict", "best-effort"])
@pytest.mark.parametrize("spec", ["write:0=drop", "write:1=lost", "converge:0=stall"])
def test_write_seams_match_the_reference(workdir, monkeypatch, spec, policy):
    env = {"KA_FAULTS_SPEC": spec}
    clock = "lost" in spec
    if clock:
        env["KA_EXEC_POLL_TIMEOUT"] = "0.3"
    steps = [(("--failure-policy", policy, "--report-json", workdir["report"]), env)]
    ref, got = _both(monkeypatch, workdir, steps, clock=clock)
    assert got == ref
    rc, err, report = got["steps"][0]
    if "lost" in spec:
        assert rc == (EXIT_EXECUTE if policy == "strict" else EXIT_DEGRADED), err
        assert report["status"] == ("error" if policy == "strict" else "degraded")
        skipped = report["plan"].get("skipped_moves")
        assert bool(skipped) == (policy == "best-effort")
    else:
        assert rc == EXIT_OK, err
        assert report["plan"]["skipped_moves"] == []


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_resume_across_the_packages(workdir, monkeypatch, first, second):
    # One package is killed at a wave boundary, the other resumes its
    # journal: the same final bytes, journal and stderr as the first
    # package resuming its own.
    kill = (first, (), {"KA_FAULTS_SPEC": "wave:1=crash"})
    _reset(workdir, _cluster())
    mixed = _drive(monkeypatch, workdir, [kill, (second, ("--resume",), {})])
    _reset(workdir, _cluster())
    own = _drive(monkeypatch, workdir, [kill, (first, ("--resume",), {})])
    assert mixed == own
    assert [rc for rc, _, _ in mixed["steps"]] == ["crash", EXIT_OK]
    assert "resuming from journal" in mixed["steps"][1][1]
    assert json.loads(mixed["journal"])["status"] == "complete"


def _with_sections(cluster):
    parts = {t: sorted(int(p) for p in per) for t, per in cluster["topics"].items()}
    cluster["traffic"] = {
        t: {str(p): {"in_bytes": 1000.0 * (p + 1), "out_bytes": 2e3, "lag": p}
            for p in ps} for t, ps in parts.items()}
    cluster["groups"] = {"analytics": {
        "members": {"c-0": 120.0, "c-1": None},
        "assignment": {"events": {"0": "c-0", "1": "c-1"}},
        "lag": {"events": {"0": 500, "1": 7}}}}
    return cluster


def test_a_snapshot_with_traffic_and_groups_persists_the_references_bytes(
        workdir, monkeypatch):
    cluster = _with_sections(_cluster())
    ref, got = _both(monkeypatch, workdir, [((), {})], cluster=cluster)
    assert got == ref and got["steps"][0][0] == EXIT_OK
    final = json.loads(got["cluster"])
    assert final["traffic"] == cluster["traffic"]
    assert final["groups"] == cluster["groups"]
    assert final["topics"] != cluster["topics"]  # the waves were persisted


def test_write_snapshot_matches_the_reference(tmp_path):
    from kafka_assigner_tpu.io.base import BrokerInfo as JaxBroker
    from kafka_assigner_tpu.io.snapshot import write_snapshot as jax_write
    from kafka_assigner_tpu_torch.io.base import BrokerInfo
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend, write_snapshot

    cluster = _with_sections(_cluster())
    cluster["brokers"].append({"id": 99, "host": "norack", "port": 1})
    topics = {t: {int(p): r for p, r in per.items()} for t, per in cluster["topics"].items()}
    for name, broker, write in (("ref", JaxBroker, jax_write),
                                ("port", BrokerInfo, write_snapshot)):
        write(str(tmp_path / f"{name}.json"),
              [broker(b["id"], b["host"], b["port"], b.get("rack"))
               for b in cluster["brokers"]],
              topics, traffic=cluster["traffic"], groups=cluster["groups"])
    port = (tmp_path / "port.json").read_text()
    assert port == (tmp_path / "ref.json").read_text()
    back = SnapshotBackend(str(tmp_path / "port.json"))
    assert back._traffic_raw == cluster["traffic"] and back._groups_raw == cluster["groups"]
    assert back.supports_traffic() and back.supports_groups()


def test_plan_text_matches_the_reference(plan_text, tmp_path):
    # The plan every test here executes is the reference's greedy plan.
    src = tmp_path / "cluster.json"
    src.write_text(json.dumps(_cluster()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_run(["--zk_string", str(src), "--mode", "PRINT_REASSIGNMENT",
                        "--solver", "greedy", "--broker_hosts_to_remove", "h9"]) == 0
    assert out.getvalue() == plan_text


_NO_TORCH = r"""
import sys
from kafka_assigner_tpu_torch.cli import execute
rc = execute(sys.argv[1:])
assert rc == 0, rc
assert "torch" not in sys.modules, "ka-execute imported torch"
print("no torch")
"""


def test_execution_imports_no_torch(workdir):
    # ka-execute does no device work: it never imports torch, so it never
    # creates a CUDA context.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, "--zk_string", workdir["cluster"],
         "--plan", workdir["plan"], "--report-json", workdir["report"]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no torch" in proc.stdout
    assert "verify-after-move OK" in proc.stderr


def test_module_entry_runs_ka_execute(workdir):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.exec", "--zk_string",
         workdir["cluster"], "--plan", workdir["plan"], "--journal", workdir["journal"]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == EXIT_OK, proc.stderr
    assert "verify-after-move OK" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.exec"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1 and "required" in proc.stderr


def test_torch_exec_smoke_script():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_exec_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch_exec_smoke: PASS" in proc.stderr


def test_executor_hooks_and_journal_helpers_match_the_reference(workdir, tmp_path):
    # The executor's outcome and stderr, the journal's resume payload and
    # the journal-directory scan, equal to the reference's on the same plan.
    from kafka_assigner_tpu.exec import engine as jax_engine
    from kafka_assigner_tpu.exec import journal as jax_journal
    from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JaxSnapshot
    from kafka_assigner_tpu_torch.exec import engine as torch_engine
    from kafka_assigner_tpu_torch.exec import journal as torch_journal
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend

    seen = {}
    for name, eng, jmod, backend_cls in (
            ("jax", jax_engine, jax_journal, JaxSnapshot),
            ("torch", torch_engine, torch_journal, SnapshotBackend)):
        _reset(workdir, _cluster())
        plan, order = eng.load_plan_file(workdir["plan"])
        err = io.StringIO()
        ex = eng.PlanExecutor(
            backend_cls(workdir["cluster"]), plan, order, workdir["journal"],
            cluster="c", err=err)
        out = ex.execute()
        j = jmod.ExecutionJournal.load(workdir["journal"])
        payload = jmod.journal_resume_payload(j)
        for fname in ("ka-execute-east-2-0123456789ab.journal",
                      "ka-controller-east-2-0123456789ab.rollback.journal",
                      "ka-controller-west-fedcba987654.journal", "other.journal"):
            (tmp_path / fname).write_text("{}")
        scan = jmod.scan_journal_dir(str(tmp_path), ["east-2", "west", "north"])
        seen[name] = (err.getvalue(), ex.plan_hash, dataclasses.asdict(out), payload, scan)
    assert seen["torch"] == seen["jax"]
    stderr, plan_hash, out, payload, scan = seen["torch"]
    assert out["waves_run"] >= 2 and "committed" in stderr
    assert plan_hash == j.plan_hash and payload[0]
    assert [e["kind"] for e in scan["east-2"]] == ["rollback", "execute"]
    assert scan["north"] == [] and [e["kind"] for e in scan["west"]] == ["forward"]
