"""The port's giant-shape leg chain against the JAX package, on small
instances with ``KA_DENSE_MASK_BUDGET`` lowered so the chain engages (the
treatment of ``tests/test_wave_boundaries.py``): ``place_batched`` against
``place_scan`` on every wave mode, the resolved chains, a batch whose topics
sit on both sides of the quota leg's endgame switch, and ``TorchSolver``
against ``TpuSolver``. Integers everywhere: exact equality.

The JAX side reads the budget when it traces, so every flip is bracketed by
``jax.clear_caches()``; the port reads it per call.
"""
from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu.solvers.base import Context as JaxContext
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.carry import encoded_to_torch, to_numpy, to_tensor
from kafka_assigner_tpu_torch.ops import assignment as tops
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from .helpers import moved_replicas
from .test_torch_placement import _assert_same, _encode, _jax_place, _port_place


@pytest.fixture
def budget_flip(monkeypatch):
    """Set a knob for the test; no flipped-knob JAX program outlives it."""

    def set_knob(value, name="KA_DENSE_MASK_BUDGET"):
        monkeypatch.setenv(name, str(value))
        jax.clear_caches()

    yield set_knob
    for name in ("KA_DENSE_MASK_BUDGET", "KA_QUOTA_WAVE_TARGET", "KA_QUOTA_ENDGAME"):
        monkeypatch.delenv(name, raising=False)
    jax.clear_caches()


def _saturated():
    """tests/test_wave_boundaries.py's exactly-saturated instance: 50
    brokers in 5 racks, one 1,000-partition RF-3 topic, brokers 0-9
    replaced by 50-59 (600 orphans, 600 free slots)."""
    tm, _, racks = rack_striped_cluster(
        50, 1, 1000, 3, 5, name_fmt="sat-{:02d}", extra_brokers=10
    )
    live = set(range(10, 60))
    return list(tm.items()), live, {b: racks[b] for b in live}


def _expansion():
    """tests/test_wave_boundaries.py's expansion: 2,000 partitions on 50
    brokers, 5 brokers join (cap 120 -> 110, 500 replicas move)."""
    tm, _, racks = rack_striped_cluster(
        50, 1, 2000, 3, 5, name_fmt="exp-{:02d}", extra_brokers=5
    )
    live = set(range(55))
    return list(tm.items()), live, {b: racks[b] for b in live}


def _mixed_rf(seed=7):
    """Six topics of RF 1-3 (drawn from the seed) on 40 brokers in 5 racks,
    brokers 0-3 replaced by 40-43."""
    rng = random.Random(seed)
    tm, _, racks = rack_striped_cluster(
        40, 6, 64, 3, 5, name_fmt="mix-{:02d}", extra_brokers=4
    )
    rfs = [rng.randint(1, 3) for _ in tm]
    topics = [(t, {p: r[:rf] for p, r in cur.items()})
              for (t, cur), rf in zip(tm.items(), rfs)]
    live = set(range(4, 44))
    return topics, live, {b: racks[b] for b in live}, rfs


# Budgets just under each instance's P_pad x N_pad.
BUDGETS = {"saturated": 50_000, "expansion": 100_000, "mixed_rf": 2_000}


@pytest.fixture(scope="module")
def encoded():
    out = {}
    for kind, make in (("saturated", _saturated), ("expansion", _expansion)):
        topics, live, rack_map = make()
        out[kind] = (_encode(topics, live, rack_map, 3), 3, None)
    topics, live, rack_map, rfs = _mixed_rf()
    enc = _encode(topics, live, rack_map, rfs)
    rfs_arr = np.full(enc[1].shape[0], 3, np.int32)
    rfs_arr[: len(rfs)] = rfs
    out["mixed_rf"] = (enc, 3, rfs_arr)
    return out


MODES = ["auto", "fresh", "fast", "balance", "balance_quota", "fast_balance"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["saturated", "expansion", "mixed_rf"])
def test_giant_chain_matches_place_scan(encoded, budget_flip, kind, mode):
    enc, rf, rfs = encoded[kind]
    budget_flip(BUDGETS[kind])
    legs, _, giant = tops.resolve_chain(mode, enc[1].shape[1], enc[0][0].n_pad)
    assert giant
    ref = _jax_place(*enc, rf, mode, rfs)
    got, waves = _port_place(*enc, rf, mode, rfs)
    _assert_same(got, ref)
    assert list(waves) == list(legs[: len(waves)])


GIANT_CHAINS = {
    "auto": ("fast", "balance_quota", "balance", "seq", "dense"),
    "fresh": ("balance_slots", "balance_quota", "balance", "fast", "seq", "dense"),
    "fast": ("fast",),
    "dense": ("dense",),
    "seq": ("seq",),
    "balance": ("balance_slots", "balance_quota", "balance"),
    "fast_balance": ("fast", "balance_quota", "balance"),
    "fast_dense": ("fast", "dense"),
    "balance_quota": ("balance_quota",),
}


@pytest.mark.parametrize("mode", sorted(GIANT_CHAINS))
def test_resolved_chain_on_both_sides_of_the_budget(monkeypatch, mode):
    monkeypatch.setenv("KA_DENSE_MASK_BUDGET", str(200_000 * 5_104 - 1))
    assert tops.resolve_chain(mode, 200_000, 5_104, 16) == (
        GIANT_CHAINS[mode], 16, True)
    assert tops.resolve_chain(mode, 104, 5_000, 16) == (
        tops.WAVE_MODES[mode], 16, False)


@pytest.mark.parametrize("mode", ["seq", "dense"])
def test_single_leg_seq_and_dense_past_the_budget(encoded, budget_flip, mode):
    enc, rf, _ = encoded["expansion"]
    budget_flip(64)
    _assert_same(_port_place(*enc, rf, mode)[0], _jax_place(*enc, rf, mode))


@pytest.mark.parametrize("target,endgame", [(1, 1), (2, 8), (4, 32), (8, 200)])
def test_quota_knobs_match(encoded, budget_flip, target, endgame):
    # Divisor 1 hands out all headroom per wave (the corner the endgame
    # exists for); a high endgame hands over at once.
    enc, rf, _ = encoded["saturated"]
    budget_flip(BUDGETS["saturated"])
    budget_flip(target, "KA_QUOTA_WAVE_TARGET")
    budget_flip(endgame, "KA_QUOTA_ENDGAME")
    ref = _jax_place(*enc, rf, "auto")
    got, waves = _port_place(*enc, rf, "auto")
    _assert_same(got, ref)
    assert "balance_quota" in waves


def test_topics_in_quota_bulk_and_endgame_share_a_batch(budget_flip):
    # One topic's fullest rack starts far above KA_QUOTA_ENDGAME (bulk),
    # the other's at or below it (endgame). Batched, each must take its own
    # branch and equal the JAX package placing it alone.
    tm, _, racks = rack_striped_cluster(
        50, 2, 1000, 3, 5, name_fmt="mq-{:02d}", extra_brokers=10
    )
    topics = list(tm.items())
    topics[1] = (topics[1][0], {p: r for p, r in topics[1][1].items() if p < 40})
    live = set(range(10, 60))
    rack_map = {b: racks[b] for b in live}
    encs, currents, jhashes, p_reals = _encode(topics, live, rack_map, 3)
    budget_flip(50_000)
    endgame = tops.quota_endgame_headroom()
    cur, rack, jh, pr = encoded_to_torch(currents, encs[0].rack_idx, jhashes, p_reals)
    n = encs[0].n
    cap = (pr * 3 + n - 1) // n
    sticky = tops.sticky_fill(cur, rack, 3, cap, n, pr, tops.default_alive(rack, n),
                              torch.full_like(pr, 3))
    room = tops._rack_room(
        tops._headroom(sticky, cap, n, tops.default_alive(rack, n)),
        rack[:n].long(), encs[0].r_cap,
    ).amax(1)
    assert room[0] > endgame >= room[1] > 0
    got, waves = _port_place(encs, currents, jhashes, p_reals, 3, "balance_quota")
    assert waves["balance_quota"] > 0
    for t in range(2):
        one = (encs[t:t + 1], currents[t:t + 1], jhashes[t:t + 1], p_reals[t:t + 1])
        ref = _jax_place(*one, 3, "balance_quota")
        _assert_same([g[t:t + 1] for g in got], ref)


@pytest.mark.parametrize("kind,moved", [("saturated", 600), ("expansion", 500)])
def test_assign_many_matches_tpu_solver_past_the_budget(budget_flip, kind, moved):
    topics, live, rack_map = _saturated() if kind == "saturated" else _expansion()
    budget_flip(BUDGETS[kind])
    jctx, tctx = JaxContext(), Context()
    ref = TpuSolver().assign_many(topics, rack_map, live, 3, jctx)
    solver = TorchSolver("cpu")
    got = solver.assign_many(topics, rack_map, live, 3, tctx)
    assert got == ref
    assert tctx.counter == jctx.counter
    cur = dict(topics)
    assert sum(moved_replicas(cur[t], a) for t, a in got) == moved
    assert "dense" not in solver.last_waves and "seq" not in solver.last_waves


def test_topic_assigner_single_topic_path_past_the_budget(budget_flip):
    topics, live, rack_map = _saturated()
    budget_flip(BUDGETS["saturated"])
    (name, cur), = topics
    ja, ta = JaxAssigner("tpu"), TopicAssigner(device="cpu")
    assert ta.generate_assignment(name, cur, live, rack_map) == \
        ja.generate_assignment(name, cur, live, rack_map)
    assert ta.context.counter == ja.context.counter


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_giant_chain_plan_on_card_equals_cpu(monkeypatch):
    dev = cuda_device()
    topics, live, rack_map = _saturated()
    monkeypatch.setenv("KA_DENSE_MASK_BUDGET", str(BUDGETS["saturated"]))
    on_card = TorchSolver(dev).assign_many(topics, rack_map, live, 3, Context())
    on_cpu = TorchSolver("cpu").assign_many(topics, rack_map, live, 3, Context())
    assert on_card == on_cpu
    encs, currents, jhashes, p_reals = enc = _encode(topics, live, rack_map, 3)
    res = tops.place_batched(
        *(to_tensor(a, dev) for a in (currents, encs[0].rack_idx, jhashes, p_reals)),
        encs[0].n, 3, "auto", r_cap=encs[0].r_cap,
    )
    ref, _ = _port_place(*enc, 3, "auto")
    _assert_same([to_numpy(t) for t in (res.acc_nodes, res.acc_count,
                                        res.infeasible, res.deficit)], ref)
