"""The port's CLI (``python -m kafka_assigner_tpu_torch.cli``) on the CPU:
stdout against the golden files and against the JAX package's CLI, byte for
byte, on every ``--solver`` lane (``device`` against the JAX ``tpu``, under
each ``KA_LEADERSHIP`` lane and ``KA_HOSTCODEC`` codec; ``native`` and
``greedy`` against the same lanes there); the ``--leadership_context`` file
and the documented exit codes."""
from __future__ import annotations

import contextlib
import io
import json
import os

import pytest

from kafka_assigner_tpu.cli import run_tool as jax_run_tool
from kafka_assigner_tpu_torch import cli

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def golden(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name), "r", encoding="utf-8") as f:
        return f.read()


def _snapshot(tmp_path, name, cluster) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(cluster))
    return str(path)


def _port(*argv) -> str:
    buf = io.StringIO()
    assert cli.run_tool(list(argv) + ["--device", "cpu"], out=buf) == 0
    return buf.getvalue()


def _jax(*argv, solver="tpu") -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_run_tool(list(argv) + ["--solver", solver]) == 0
    return buf.getvalue()


def _steady(tmp_path) -> str:
    return _snapshot(tmp_path, "steady.json", {
        "brokers": [{"id": 1, "host": "h1", "port": 9092},
                    {"id": 2, "host": "h2", "port": 9092}],
        "topics": {"x": {"0": [1, 2]}},
    })


def _multitopic(tmp_path) -> list:
    """Same fixture and CLI topic order as tests/test_golden_output.py."""
    topics = {f"t{i:02d}": {str(p): [1 + (i + p) % 4, 1 + (i + p + 1) % 4]
                            for p in range(2)} for i in range(18)}
    snap = _snapshot(tmp_path, "multi.json", {
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092} for b in range(1, 5)],
        "topics": topics,
    })
    order = ",".join(f"t{i:02d}" for i in (
        17, 3, 0, 11, 5, 16, 8, 2, 14, 9, 1, 13, 7, 4, 15, 10, 6, 12))
    return ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT",
            "--topics", order]


def test_golden_mode3_steady_state(tmp_path):
    out = _port("--zk_string", _steady(tmp_path), "--mode", "PRINT_REASSIGNMENT")
    assert out == golden("mode3_steady_state.txt")


def test_golden_mode3_multitopic(tmp_path):
    out = _port(*_multitopic(tmp_path))
    assert out == golden("mode3_multitopic.txt")


@pytest.mark.parametrize("solver", ["greedy", "native"])
def test_golden_mode3_on_the_greedy_lanes(tmp_path, solver):
    # The steady-state and multi-topic goldens through --solver greedy and
    # native, equal to the JAX CLI's same lane.
    for argv, name in (
        (["--zk_string", _steady(tmp_path), "--mode", "PRINT_REASSIGNMENT"],
         "mode3_steady_state.txt"),
        (_multitopic(tmp_path), "mode3_multitopic.txt"),
    ):
        out = _port(*argv, "--solver", solver)
        assert out == golden(name)
        assert out == _jax(*argv, solver=solver)


@pytest.mark.parametrize("solver", ["greedy", "native"])
def test_golden_mode3_replacement(tmp_path, solver):
    # Broker 3 replaced by 4 (racks a/b/c), as tests/test_golden_output.py.
    snap = _snapshot(tmp_path, "replacement3.json", {
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092, "rack": r}
                    for b, r in ((1, "a"), (2, "b"), (4, "c"))],
        "topics": {t: {str(p): [1 + (p + i) % 3 for i in range(2)] for p in range(n)}
                   for t, n in (("events", 4), ("logs", 2))},
    })
    argv = ["--zk_string", snap, "--mode", "PRINT_REASSIGNMENT"]
    out = _port(*argv, "--solver", solver)
    assert out == golden("mode3_replacement.txt")
    assert out == _jax(*argv, solver=solver)


@pytest.fixture()
def replacement_snapshot(tmp_path):
    """Brokers 0-3 replaced by 40-43 on a 40-broker, 4-rack cluster."""
    racks = {b: f"r{b % 4}" for b in range(44)}
    live = [b for b in range(4, 44)]
    inter = sorted(range(40), key=lambda b: (b // 4, b % 4))
    topics = {
        f"topic-{t}": {str(p): [inter[(t * 7 + p * 3 + i) % 40] for i in range(3)]
                       for p in range(12)}
        for t in range(6)
    }
    return _snapshot(tmp_path, "replacement.json", {
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092, "rack": racks[b]}
                    for b in live],
        "topics": topics,
    })


@pytest.mark.parametrize("extra", [
    [],
    ["--topics", "topic-4,topic-1,topic-4"],
    ["--broker_hosts_to_remove", "h5,h6", "--desired_replication_factor", "2"],
    ["--integer_broker_ids", ",".join(str(b) for b in range(4, 40))],
    ["--disable_rack_awareness"],
])
def test_stdout_matches_jax_tpu_solver(replacement_snapshot, extra):
    argv = ["--zk_string", replacement_snapshot, "--mode", "PRINT_REASSIGNMENT", *extra]
    assert _port(*argv) == _jax(*argv)


@pytest.mark.parametrize("solver", ["greedy", "native"])
@pytest.mark.parametrize("extra", [
    [],
    ["--topics", "topic-4,topic-1,topic-4"],
    ["--broker_hosts_to_remove", "h5,h6", "--desired_replication_factor", "2"],
])
def test_greedy_lanes_match_jax_cli(replacement_snapshot, solver, extra):
    argv = ["--zk_string", replacement_snapshot, "--mode", "PRINT_REASSIGNMENT", *extra]
    assert _port(*argv, "--solver", solver) == _jax(*argv, solver=solver)


@pytest.mark.parametrize("codec", ["1", "0"])
@pytest.mark.parametrize("lane", ["native", "device"])
@pytest.mark.parametrize("extra", [
    [],
    ["--broker_hosts_to_remove", "h5,h6", "--desired_replication_factor", "2"],
])
def test_device_solver_lanes_and_codecs_match_jax(replacement_snapshot, monkeypatch,
                                                  lane, codec, extra):
    # KA_LEADERSHIP picks where leaders are ordered, KA_HOSTCODEC the
    # boundary codec: every combination prints the JAX CLI's bytes.
    argv = ["--zk_string", replacement_snapshot, "--mode", "PRINT_REASSIGNMENT", *extra]
    ref = _jax(*argv)
    monkeypatch.setenv("KA_LEADERSHIP", lane)
    monkeypatch.setenv("KA_HOSTCODEC", codec)
    assert _port(*argv, "--solver", "device") == ref


@pytest.mark.parametrize("mode,extra", [
    ("PRINT_FRESH_ASSIGNMENT", ["--topics", "new", "--partition_count", "8",
                                "--desired_replication_factor", "3"]),
    ("RANK_DECOMMISSION", ["--integer_broker_ids", "4,5"]),
])
@pytest.mark.parametrize("solver", ["greedy", "native"])
def test_modes_without_solver_note_it(replacement_snapshot, capsys, mode, extra, solver):
    argv = ["--zk_string", replacement_snapshot, "--mode", mode, *extra]
    want = _jax(*argv)
    capsys.readouterr()
    assert _port(*argv, "--solver", solver) == want
    err = capsys.readouterr().err
    why = "always the batched device sweep" if mode == "RANK_DECOMMISSION" \
        else "always the device solver"
    assert f"note: --solver {solver} is ignored by {mode} ({why})" in err


def test_leadership_context_file_matches(replacement_snapshot, tmp_path):
    ctx_port, ctx_jax = str(tmp_path / "port.ctx"), str(tmp_path / "jax.ctx")
    argv = ["--zk_string", replacement_snapshot, "--mode", "PRINT_REASSIGNMENT"]
    for _ in range(2):  # the second run loads what the first saved
        out_p = _port(*argv, "--leadership_context", ctx_port)
        out_j = _jax(*argv, "--leadership_context", ctx_jax)
        assert out_p == out_j
    with open(ctx_port, "rb") as a, open(ctx_jax, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture()
def scenario_file(tmp_path):
    """Broker ids, hostnames, a same-rack pair, a cross-rack pair and the
    empty scenario."""
    return _snapshot(tmp_path, "scenarios.json",
                     [[4, 8], [5, 6], ["h7"], ["h9", 10], [], [11]])


@pytest.mark.parametrize("mode,extra", [
    ("PRINT_CURRENT_ASSIGNMENT", []),
    ("PRINT_CURRENT_ASSIGNMENT", ["--topics", "topic-4,topic-1"]),
    ("PRINT_CURRENT_BROKERS", []),
    ("RANK_DECOMMISSION", []),
    ("RANK_DECOMMISSION", ["--integer_broker_ids", "4,5,6,17,39"]),
    ("RANK_DECOMMISSION", ["--broker_hosts", "h8,h9,h30"]),
    ("RANK_DECOMMISSION", ["--broker_hosts_to_remove", "h5,h6"]),
    ("RANK_DECOMMISSION", ["--topics", "topic-2,topic-0",
                           "--desired_replication_factor", "2"]),
    ("RANK_DECOMMISSION", ["--scenario_file"]),
    ("RANK_DECOMMISSION", ["--scenario_file", "--broker_hosts_to_remove", "h30"]),
])
def test_more_modes_match_jax_cli(replacement_snapshot, scenario_file, monkeypatch,
                                  mode, extra):
    if extra[:1] == ["--scenario_file"]:
        extra = [extra[0], scenario_file, *extra[1:]]
    argv = ["--zk_string", replacement_snapshot, "--mode", mode, *extra]
    for incremental in ("1", "0"):
        monkeypatch.setenv("KA_WHATIF_INCREMENTAL", incremental)
        assert _port(*argv) == _jax(*argv)


def test_rank_decommission_on_the_incremental_path_matches(tmp_path, monkeypatch):
    # 64 topics x 4 partitions over 200 brokers: each broker sits in at most
    # 4 topics, so the incremental sweep's gate admits it (3 x 8 <= 64).
    from kafka_assigner_tpu.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.parallel import whatif

    tm, live, racks = rack_striped_cluster(200, 64, 4, 3, 5)
    snap = _snapshot(tmp_path, "wide.json", {
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092, "rack": racks[b]}
                    for b in sorted(live)],
        "topics": {t: {str(p): r for p, r in cur.items()} for t, cur in tm.items()},
    })
    monkeypatch.delenv("KA_WHATIF_INCREMENTAL", raising=False)
    argv = ["--zk_string", snap, "--mode", "RANK_DECOMMISSION"]
    assert _port(*argv) == _jax(*argv)
    assert whatif.last_sweep["path"] == "incremental"
    assert whatif.last_sweep["scenarios"] == 200


def test_current_brokers_without_racks_match(tmp_path):
    snap = _snapshot(tmp_path, "rackless.json", {
        "brokers": [{"id": 3, "host": "c", "port": 9093},
                    {"id": 1, "host": "a", "port": 9092, "rack": "r1"},
                    {"id": 2}],
        "topics": {},
    })
    argv = ["--zk_string", f"file://{snap}", "--mode", "PRINT_CURRENT_BROKERS"]
    assert _port(*argv) == _jax(*argv)


@pytest.mark.parametrize("scenarios", [
    [[4], [999]], [["h4", "nohost"]], [[True]], [[4.5]], {"a": [4]}, [4],
])
def test_scenario_file_errors_match(replacement_snapshot, tmp_path, scenarios):
    path = _snapshot(tmp_path, "bad.json", scenarios)
    argv = ["--zk_string", replacement_snapshot, "--mode", "RANK_DECOMMISSION",
            "--scenario_file", path]
    with pytest.raises(ValueError) as ref:
        jax_run_tool(argv)
    with pytest.raises(ValueError) as got:
        cli.run_tool(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value)
    assert cli.run(argv + ["--device", "cpu"]) == cli.EXIT_VALIDATION


def test_rank_unknown_candidate_errors_match(replacement_snapshot):
    argv = ["--zk_string", replacement_snapshot, "--mode", "RANK_DECOMMISSION",
            "--integer_broker_ids", "4,77"]
    with pytest.raises(ValueError) as ref:
        jax_run_tool(argv)
    with pytest.raises(ValueError) as got:
        cli.run_tool(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value)


def test_exit_codes(replacement_snapshot, capsys):
    assert cli.run(["--mode", "PRINT_REASSIGNMENT", "--device", "cpu"]) == cli.EXIT_USAGE
    assert cli.run(["--zk_string", replacement_snapshot, "--mode",
                    "PRINT_REASSIGNMENT", "--topics", "nope", "--device", "cpu"]
                   ) == cli.EXIT_VALIDATION
    assert cli.run(["--zk_string", replacement_snapshot, "--mode",
                    "PRINT_REASSIGNMENT", "--desired_replication_factor", "99",
                    "--device", "cpu"]) == cli.EXIT_VALIDATION
    assert cli.run(["--zk_string", "file:///no/such/snapshot.json", "--mode",
                    "PRINT_REASSIGNMENT", "--device", "cpu"]) == cli.EXIT_INGEST
    assert "error:" in capsys.readouterr().err
