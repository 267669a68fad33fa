"""Fresh placement in the port (``TorchSolver.fresh_assignment`` and the CLI's
``PRINT_FRESH_ASSIGNMENT``) against the JAX package's ``TpuSolver`` and
CLI: the cases of ``tests/test_fresh_and_rescue.py`` as parity cases, a
fresh topic past a lowered ``KA_DENSE_MASK_BUDGET`` (where ``balance_slots``
leads the chain), several topics through one ``Context``, and the CLI's
stdout, usage errors and exit codes. Exact equality throughout.
"""
from __future__ import annotations

import contextlib
import io
import json

import jax
import pytest

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.solvers.base import Context as JaxContext
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from .helpers import moved_replicas, verify_full_invariants


def _both_fresh(topic, partitions, brokers, racks, rf, jctx=None, tctx=None):
    jctx = JaxContext() if jctx is None else jctx
    tctx = Context() if tctx is None else tctx
    ref = TpuSolver().fresh_assignment(topic, partitions, brokers, racks, rf, jctx)
    solver = TorchSolver("cpu")
    got = solver.fresh_assignment(topic, partitions, brokers, racks, rf, tctx)
    assert got == ref
    assert tctx.counter == jctx.counter
    return got, solver.last_waves


def test_fresh_assignment_where_greedy_dead_ends():
    # 50 partitions x RF 3 over 10 brokers in 5 racks: the reference's
    # first-fit cannot place it from scratch; the balance waves do.
    brokers = set(range(100, 110))
    racks = {b: f"rack{b % 5}" for b in brokers}
    out, _ = _both_fresh("fresh", 50, brokers, racks, 3)
    assert set(out) == set(range(50))
    verify_full_invariants(out, racks, sorted(brokers), 3)


def test_fresh_assignment_balances_load():
    brokers = set(range(20))
    racks = {b: f"r{b % 4}" for b in brokers}
    out, _ = _both_fresh("t", 40, brokers, racks, 2)
    loads = {}
    for r in out.values():
        for b in r:
            loads[b] = loads.get(b, 0) + 1
    assert max(loads.values()) <= 4 and min(loads.values()) >= 2


def test_reassignment_succeeds_where_reference_strands():
    # Rack-unaware 10 -> 8 broker decommission: the reference's first-fit
    # strands; the balance leg completes it with minimal movement.
    n, p, rf = 10, 50, 3
    cur = {q: [(q + i) % n for i in range(rf)] for q in range(p)}
    live = set(range(2, n))
    ref = JaxAssigner("tpu").generate_assignment("t", cur, live, {}, -1)
    got = TopicAssigner(device="cpu").generate_assignment("t", cur, live, {}, -1)
    assert got == ref
    verify_full_invariants(got, {}, sorted(live), rf)
    assert moved_replicas(cur, got) == sum(
        1 for r in cur.values() for b in r if b not in live)


@pytest.fixture
def budget_flip(monkeypatch):
    def set_budget(value):
        monkeypatch.setenv("KA_DENSE_MASK_BUDGET", str(value))
        jax.clear_caches()

    yield set_budget
    monkeypatch.delenv("KA_DENSE_MASK_BUDGET", raising=False)
    jax.clear_caches()


@pytest.mark.parametrize("partitions,rf", [(600, 3), (333, 2)])
def test_fresh_past_the_budget_leads_with_balance_slots(budget_flip, partitions, rf):
    brokers = set(range(30))
    racks = {b: f"r{b % 5}" for b in brokers}
    budget_flip(1_000)
    out, waves = _both_fresh("giant-fresh", partitions, brokers, racks, rf)
    assert next(iter(waves)) == "balance_slots" and waves["balance_slots"] > 0
    assert "dense" not in waves and "seq" not in waves
    verify_full_invariants(out, racks, sorted(brokers), rf)


@pytest.mark.parametrize("rf", [1, 2])
def test_fresh_under_compat_keeps_rf_wide_rows(monkeypatch, rf):
    # Fresh rows encode two slots wide; compat must not widen an RF-1 plan.
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    brokers = set(range(1, 10))
    racks = {b: f"r{b % 3}" for b in brokers}
    out, _ = _both_fresh("c", 18, brokers, racks, rf)
    assert {len(r) for r in out.values()} == {rf}


def test_several_fresh_topics_share_one_context():
    brokers = set(range(1, 13))
    racks = {b: f"r{b % 4}" for b in brokers}
    jctx, tctx = JaxContext(), Context()
    for topic, partitions, rf in (("a", 24, 3), ("b", [5, 1, 9, 20], 2),
                                  ("a", 7, 1), ("c", 30, 3)):
        _both_fresh(topic, partitions, brokers, racks, rf, jctx, tctx)


def test_infeasible_fresh_raises_the_reference_message_and_keeps_context():
    brokers = {1, 2, 3}
    racks = {1: "a", 2: "a", 3: "b"}
    with pytest.raises(ValueError) as ref:
        TpuSolver().fresh_assignment("t", 6, brokers, racks, 3)
    ctx = Context()
    with pytest.raises(ValueError) as got:
        TorchSolver("cpu").fresh_assignment("t", 6, brokers, racks, 3, ctx)
    assert str(got.value) == str(ref.value)
    assert "could not be fully assigned" in str(got.value)
    assert ctx.counter == {}


# --- the CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """24 brokers in 4 racks with one existing topic."""
    path = tmp_path_factory.mktemp("fresh") / "cluster.json"
    path.write_text(json.dumps({
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092, "rack": f"r{b % 4}"}
                    for b in range(1, 25)],
        "topics": {"old": {"0": [1, 2, 3]}},
    }))
    return f"file://{path}"


def _run(run, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra", [
    ["--topics", "new", "--partition_count", "48", "--desired_replication_factor", "3"],
    ["--topics", "b,a,b", "--partition_count", "10", "--desired_replication_factor", "2"],
    ["--topics", "x", "--partition_count", "20", "--desired_replication_factor", "3",
     "--broker_hosts_to_remove", "h1,h2,h99"],
    ["--topics", "x", "--partition_count", "12", "--desired_replication_factor", "2",
     "--integer_broker_ids", "1,2,3,4,5,6,77"],
    ["--topics", "x", "--partition_count", "9", "--desired_replication_factor", "3",
     "--broker_hosts", "h1,h2,h3,h4,h5,h6", "--disable_rack_awareness"],
    # Infeasible (RF above the rack count): exit 5, nothing on stdout.
    ["--topics", "x", "--partition_count", "9", "--desired_replication_factor", "5"],
])
def test_stdout_and_exit_code_match_jax_cli(snapshot, extra):
    argv = ["--zk_string", snapshot, "--mode", "PRINT_FRESH_ASSIGNMENT", *extra]
    rc_p, out_p = _run(cli.run, argv + ["--device", "cpu"])
    rc_j, out_j = _run(jax_run, argv + ["--solver", "tpu"])
    assert (rc_p, out_p) == (rc_j, out_j)
    if rc_p == cli.EXIT_OK:
        assert out_p.startswith("FRESH ASSIGNMENT:\n")


@pytest.mark.parametrize("extra", [
    [],
    ["--topics", "x", "--desired_replication_factor", "3"],
    ["--topics", "x", "--partition_count", "0", "--desired_replication_factor", "3"],
    ["--topics", "x", "--partition_count", "5"],
    ["--topics", "x", "--partition_count", "5", "--desired_replication_factor", "0"],
])
def test_usage_errors_match_jax_cli(snapshot, extra, capsys):
    argv = ["--zk_string", snapshot, "--mode", "PRINT_FRESH_ASSIGNMENT", *extra]
    assert cli.run(argv + ["--device", "cpu"]) == cli.EXIT_USAGE
    err_p = capsys.readouterr().err
    assert jax_run(argv + ["--solver", "tpu"]) == cli.EXIT_USAGE
    assert "requires --topics, a positive --partition_count" in err_p
    assert capsys.readouterr().out == ""


def test_leadership_context_file_is_not_read(snapshot, tmp_path):
    ctx = Context()
    ctx.counter = {b: {0: 50 + b, 1: 7} for b in range(1, 25)}
    ctx.save(str(tmp_path / "ctx.json"))
    argv = ["--zk_string", snapshot, "--mode", "PRINT_FRESH_ASSIGNMENT", "--topics",
            "x", "--partition_count", "16", "--desired_replication_factor", "2",
            "--device", "cpu"]
    plain = _run(cli.run, argv)
    with_ctx = _run(cli.run, argv + ["--leadership_context", str(tmp_path / "ctx.json")])
    assert plain == with_ctx and plain[0] == cli.EXIT_OK
