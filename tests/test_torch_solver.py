"""``TorchSolver(device="cpu")`` against the JAX package's ``TpuSolver`` on
decommission, expansion and replacement clusters: identical plans, an
identical ``Context`` afterwards, the same infeasibility error and the same
wave-mode knob handling. Exact equality throughout. The giant-shape chain,
fresh placement and the compat width have their own files
(``test_torch_giant.py``, ``test_torch_fresh.py``, ``test_torch_compat.py``).
"""
from __future__ import annotations

import random

import pytest

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu.solvers.base import Context as JaxContext
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver


def _cluster(kind):
    if kind == "decommission":
        tm, _, racks = rack_striped_cluster(40, 8, 20, 3, 4, name_fmt="sd-{:02d}")
        live = set(range(40)) - {0, 1, 2, 3}
    elif kind == "expansion":
        tm, _, racks = rack_striped_cluster(
            30, 8, 20, 3, 5, name_fmt="se-{:02d}", extra_brokers=5
        )
        live = set(range(35))
    else:  # replacement: 5 brokers swapped for 5 new ones
        tm, _, racks = rack_striped_cluster(
            30, 8, 20, 3, 5, name_fmt="sr-{:02d}", extra_brokers=5
        )
        live = set(range(5, 35))
    return list(tm.items()), live, {b: racks[b] for b in live}


def _both(topics, live, rack_map, rfs, jctx=None, tctx=None):
    jctx = JaxContext() if jctx is None else jctx
    tctx = Context() if tctx is None else tctx
    ref = TpuSolver().assign_many(topics, rack_map, live, rfs, jctx)
    got = TorchSolver("cpu").assign_many(topics, rack_map, live, rfs, tctx)
    return ref, got, jctx, tctx


@pytest.mark.parametrize("kind", ["decommission", "expansion", "replacement"])
def test_assign_many_matches_tpu_solver(kind):
    topics, live, rack_map = _cluster(kind)
    ref, got, jctx, tctx = _both(topics, live, rack_map, 3)
    assert got == ref
    assert tctx.counter == jctx.counter


def test_context_carries_across_calls_like_the_reference():
    topics, live, rack_map = _cluster("replacement")
    jctx, tctx = JaxContext(), Context()
    for chunk in (topics[:3], topics[3:5], topics[:2]):
        ref, got, _, _ = _both(chunk, live, rack_map, 3, jctx, tctx)
        assert got == ref
        assert tctx.counter == jctx.counter


def test_duplicate_topics_and_mixed_rf():
    topics, live, rack_map = _cluster("expansion")
    rf_of = {t: r for (t, _), r in zip(topics, [3, 2, 1, 3, 2, 3, 1, 2])}
    items = []
    for t, cur in topics[:4] + topics[:2]:
        items.append((t, {p: r[: rf_of[t]] for p, r in cur.items()}))
    rfs = [rf_of[t] for t, _ in items]
    ref, got, jctx, tctx = _both(items, live, rack_map, rfs)
    assert got == ref and tctx.counter == jctx.counter


def test_single_topic_assign_matches():
    topics, live, rack_map = _cluster("decommission")
    topic, cur = topics[0]
    parts = set(cur) | {97, 98}  # two partitions with no current replicas
    jctx, tctx = JaxContext(), Context()
    ref = TpuSolver().assign(topic, cur, rack_map, live, parts, 3, jctx)
    got = TorchSolver("cpu").assign(topic, cur, rack_map, live, parts, 3, tctx)
    assert got == ref and tctx.counter == jctx.counter


def test_topic_assigner_matches_reference_assigner():
    rng = random.Random(4)
    topics, live, rack_map = _cluster("replacement")
    rng.shuffle(topics)
    ja, ta = JaxAssigner("tpu"), TopicAssigner(device="cpu")
    assert ta.generate_assignments(topics, live, rack_map, -1) == \
        ja.generate_assignments(topics, live, rack_map, -1)
    assert ta.context.counter == ja.context.counter
    name, cur = topics[0]
    assert ta.generate_assignment(name, cur, live, rack_map) == \
        ja.generate_assignment(name, cur, live, rack_map)


def test_infeasible_raises_the_reference_message_and_keeps_context():
    current = {0: [10, 11], 1: [11, 10]}
    racks = {10: "a", 11: "a", 12: "a"}
    with pytest.raises(ValueError) as ref:
        TpuSolver().assign_many([("t", current)], racks, {10, 11, 12}, 2)
    ctx = Context()
    with pytest.raises(ValueError) as got:
        TorchSolver("cpu").assign_many([("t", current)], racks, {10, 11, 12}, 2, ctx)
    assert str(got.value) == str(ref.value)
    assert "could not be fully assigned" in str(got.value)
    assert ctx.counter == {}


def test_context_files_load_across_packages(tmp_path):
    topics, live, rack_map = _cluster("expansion")
    _, _, jctx, tctx = _both(topics[:3], live, rack_map, 3)
    jctx.save(str(tmp_path / "jax.json"))
    tctx.save(str(tmp_path / "port.json"))
    assert Context.load(str(tmp_path / "jax.json")).counter == jctx.counter
    assert JaxContext.load(str(tmp_path / "port.json")).counter == tctx.counter
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()


def _outcome(solver, topics, live, rack_map, rfs, ctx):
    try:
        return solver.assign_many(topics, rack_map, live, rfs, ctx), ctx.counter
    except ValueError as e:
        return str(e), ctx.counter


@pytest.mark.parametrize("kind", ["decommission", "replacement"])
def test_compat_without_rf_decrease_uses_seq_like_the_reference(monkeypatch, kind):
    # Under compat the default chain is the reference-verbatim seq leg,
    # which may solve an instance (decommission) or strand it (this
    # replacement): either way both packages agree.
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    topics, live, rack_map = _cluster(kind)
    ref = _outcome(TpuSolver(), topics[:3], live, rack_map, 3, JaxContext())
    got = _outcome(TorchSolver("cpu"), topics[:3], live, rack_map, 3, Context())
    assert got == ref


@pytest.mark.parametrize("mode", ["fast_balance", "dense", "seq"])
def test_wave_mode_knob_matches(monkeypatch, mode):
    monkeypatch.setenv("KA_WAVE_MODE", mode)
    topics, live, rack_map = _cluster("decommission")
    ref, got, jctx, tctx = _both(topics[:4], live, rack_map, 3)
    assert got == ref and tctx.counter == jctx.counter


def test_unknown_wave_mode_falls_back_loudly(monkeypatch, capsys):
    monkeypatch.setenv("KA_WAVE_MODE", "no-such-chain")
    topics, live, rack_map = _cluster("decommission")
    got = TorchSolver("cpu").assign_many(topics[:2], rack_map, live, 3)
    assert "ignoring unknown KA_WAVE_MODE" in capsys.readouterr().err
    monkeypatch.delenv("KA_WAVE_MODE")
    assert got == TorchSolver("cpu").assign_many(topics[:2], rack_map, live, 3)
