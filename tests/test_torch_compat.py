"""``KA_RF_DECREASE_COMPAT=1`` in the port against the JAX package's tpu
solver: the cases of ``tests/test_rf_decrease_compat.py`` as port == JAX
(plans, errors and the ``Context``), the compat slot width under the
giant-shape chain, and, on the card, the leadership kernel at ``rf =
width`` against its plain version. The reference orders compat-wide rows off
its Pallas kernel (``solvers/tpu.py:_resolve_pallas``); the port runs its
CUDA kernel there, and this file is the parity pin that lifts the refusal.
"""
from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.solvers.base import Context as JaxContext
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.carry import to_tensor
from kafka_assigner_tpu_torch.ops import leadership as lead
from kafka_assigner_tpu_torch.ops.leadership_cases import random_rows
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from .helpers import moved_replicas


def _solve(assigner, topics, brokers, racks, rf):
    try:
        out = assigner.generate_assignments(topics, brokers, racks, rf)
        return out, None, assigner.context.counter
    except ValueError as e:
        return None, str(e), assigner.context.counter


def _both(topics, brokers, racks, rf):
    ref = _solve(JaxAssigner("tpu"), topics, brokers, racks, rf)
    got = _solve(TopicAssigner(device="cpu"), topics, brokers, racks, rf)
    assert got == ref
    return got


def _random_decrease_case(rng):
    n = rng.choice([8, 12, 16])
    brokers = set(range(1, n + 1))
    racks = {b: f"r{b % 4}" for b in brokers}
    old_rf = rng.randint(3, 4)
    new_rf = rng.randint(1, old_rf - 1)
    p = rng.randint(3, 9)
    topics = [
        (f"t{t}", {q: rng.sample(sorted(brokers), old_rf) for q in range(p)})
        for t in range(rng.randint(1, 3))
    ]
    return topics, brokers, racks, new_rf


@pytest.fixture
def compat(monkeypatch):
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    return monkeypatch


@pytest.mark.parametrize("wave_mode", [None, "auto"])
@pytest.mark.parametrize("seed", range(6))
def test_differential_matches_jax(compat, seed, wave_mode):
    # Unset, compat's chain is seq (the reference's assignOrphans); an
    # explicit auto runs the auction legs on the wide slots.
    if wave_mode is not None:
        compat.setenv("KA_WAVE_MODE", wave_mode)
    _both(*_random_decrease_case(random.Random(100 + seed)))


def test_nonuniform_lists_match_jax(compat):
    brokers = set(range(1, 7))
    racks = {b: f"r{b % 3}" for b in brokers}
    cur = {0: [1, 2, 3], 1: [4, 5, 6], 2: [1, 5, 6], 3: [2, 3, 4]}
    out, err, _ = _both([("t0", cur)], brokers, racks, 2)
    assert err is None
    assert all(len(r) == 3 for r in out[0][1].values())  # all retained


def test_orphaned_decrease_matches_jax(compat):
    brokers = set(range(1, 9))
    racks = {b: f"r{b % 4}" for b in brokers}
    rng = random.Random(42)
    cur = {q: rng.sample(sorted(brokers), 4) for q in range(6)}
    out, err, _ = _both([("t0", cur)], brokers, racks, 2)
    if out is not None:
        assert moved_replicas(cur, out[0][1]) > 0
        assert len({len(r) for r in out[0][1].values()}) > 1  # non-uniform


def test_noop_without_decrease(monkeypatch):
    brokers = set(range(1, 13))
    racks = {b: f"r{b % 4}" for b in brokers}
    rng = random.Random(5)
    topics = [("t0", {q: rng.sample(sorted(brokers), 3) for q in range(8)})]
    monkeypatch.delenv("KA_RF_DECREASE_COMPAT", raising=False)
    base = _both(topics, brokers, racks, -1)
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    assert _both(topics, brokers, racks, -1) == base


def test_single_topic_assign_path(compat):
    brokers = set(range(1, 13))
    racks = {b: f"r{b % 4}" for b in brokers}
    rng = random.Random(9)
    cur = {q: rng.sample(sorted(brokers), 4) for q in range(5)}
    jctx, tctx = JaxContext(), Context()
    ref = TpuSolver().assign("t", cur, racks, brokers, set(cur), 2, jctx)
    got = TorchSolver("cpu").assign("t", cur, racks, brokers, set(cur), 2, tctx)
    assert got == ref and tctx.counter == jctx.counter
    assert max(len(r) for r in got.values()) > 2  # retained past the RF


def test_mixed_rf_decrease_carries_the_wide_slab(compat):
    # Topics at RF 1 and 2 from width-4 lists: the slab and the decode span
    # the width; each topic's leading slots alone move its counters.
    brokers = set(range(1, 17))
    racks = {b: f"r{b % 4}" for b in brokers}
    rng = random.Random(3)
    topics = [(f"m{t}", {q: rng.sample(sorted(brokers), 4) for q in range(6)})
              for t in range(3)]
    jctx, tctx = JaxContext(), Context()
    ref = TpuSolver().assign_many(topics, racks, brokers, [2, 1, 2], jctx)
    got = TorchSolver("cpu").assign_many(topics, racks, brokers, [2, 1, 2], tctx)
    assert got == ref and tctx.counter == jctx.counter
    assert any(slot >= 2 for per in tctx.counter.values() for slot in per)


@pytest.mark.parametrize("n,p,old_rf,new_rf,replaced,legs", [
    # Solved by the quota leg after the slot-packed fast leg strands.
    (25, 50, 4, 2, 5, ("fast", "balance_quota")),
    # Infeasible: every leg of the giant chain runs, dense last.
    (20, 40, 4, 3, 2, ("fast", "balance_quota", "balance", "seq", "dense")),
])
def test_compat_width_under_the_giant_chain(compat, n, p, old_rf, new_rf, replaced, legs):
    from kafka_assigner_tpu.models.synthetic import rack_striped_cluster

    tm, _, racks = rack_striped_cluster(
        n, 1, p, old_rf, 5, name_fmt="g{:02d}", extra_brokers=replaced
    )
    live = set(range(replaced, n + replaced))
    rack_map = {b: racks[b] for b in live}
    compat.setenv("KA_WAVE_MODE", "auto")
    compat.setenv("KA_DENSE_MASK_BUDGET", "64")
    jax.clear_caches()
    try:
        jctx, tctx = JaxContext(), Context()
        solver = TorchSolver("cpu")
        outcomes = []
        for s, ctx in ((TpuSolver(), jctx), (solver, tctx)):
            try:
                outcomes.append(s.assign_many(list(tm.items()), rack_map, live, new_rf, ctx))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1] and tctx.counter == jctx.counter
        assert tuple(solver.last_waves) == legs
    finally:
        compat.delenv("KA_DENSE_MASK_BUDGET")
        jax.clear_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("width,rf", [(4, 2), (5, 3), (6, 1)])
def test_kernel_at_compat_width_matches_plain_on_card(width, rf):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    # Compat rows: `width` slots, counts from rf up to width, -1 past them,
    # a slab `width` wide with counters already in it.
    rng = np.random.default_rng(width)
    counts = rng.integers(rf, width + 1, (3, 400))
    acc, cnt = random_rows(rng, 3, 400, 60, width, counts)
    counters = rng.integers(0, 9, (64, width)).astype(np.int32)
    jhs = rng.integers(0, 2**30, 3).astype(np.int32)
    args = [to_tensor(x) for x in (acc, cnt, counters, jhs)]
    before = lead.launches["leadership"]
    o_k, c_k = lead.leadership_order(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert lead.launches["leadership"] == before + 1
    o_p, c_p = lead.leadership_order_plain(*args)
    assert torch.equal(o_k.cpu(), o_p) and torch.equal(c_k.cpu(), c_p)
