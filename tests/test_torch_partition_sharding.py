"""The port's partition-sharded solve against the unsharded port and the JAX
package, on the CPU: eight in-process ``cpu`` positions on the part axis
(``build_mesh(1, 8)``), the counterparts of ``tests/test_partition_sharding.py``
(the placement and ordering directly, and ``TorchSolver(mesh=)``),
``tests/test_wave_boundaries.py:108`` (the saturated quota chain past a
lowered ``KA_DENSE_MASK_BUDGET``) and a reduced
``tests/test_giant_topic.py:78`` (one topic of 2,000 partitions on the
``auto`` and ``fresh`` chains, mixed RF, ``KA_RF_DECREASE_COMPAT=1``), plus
rows that reach the ``dense`` and ``seq`` legs and part axes that do not
divide ``P_pad``.

The JAX side runs unsharded (its own tests pin sharded == unsharded on the
conftest's eight virtual devices). Outputs are integers: exact equality,
the leadership counters included.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu.ops.assignment import solve_batched_jit
from kafka_assigner_tpu.solvers.tpu import TpuSolver
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.carry import encoded_to_torch, to_numpy, to_tensor
from kafka_assigner_tpu_torch.models.problem import encode_cluster
from kafka_assigner_tpu_torch.ops import assignment as tops
from kafka_assigner_tpu_torch.ops.leadership import leadership_order
from kafka_assigner_tpu_torch.parallel import mesh as tm
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from __graft_entry__ import _example_problem

from .helpers import moved_replicas
from .test_invariants import make_cluster
from .test_torch_giant import _mixed_rf, _saturated, budget_flip  # noqa: F401  (fixture)


def _mesh(k=8):
    return tm.build_mesh(1, k, devices=["cpu"] * k)


def _port_part_solve(mesh, enc0, currents, jhashes, p_reals, counters):
    """Placement and ordering over ``mesh``'s part axis, the way
    ``TorchSolver(mesh=)`` runs them: P_pad padded to tile the axis, each
    position placing its block, gathering, and ordering the whole. Returns
    every position's ``(ordered, counters, infeasible, deficit, acc_count,
    collectives)``."""
    positions = tm.part_axis(mesh)
    k = positions[0].size
    b, p_pad, w = currents.shape
    blk = -(-p_pad // k)
    tiled = np.full((b, blk * k, w), -1, np.int32)
    tiled[:, :p_pad] = currents
    order_lock = threading.Lock()  # as the solver orders: one position at a time

    def run(pos):
        lo = pos.index * blk
        cur, rack, jh, pr = encoded_to_torch(tiled[:, lo:lo + blk], enc0.rack_idx,
                                             jhashes, p_reals)
        placed = tops.place_batched(cur, rack, jh, pr, enc0.n, enc0.rf, "auto",
                                    r_cap=enc0.r_cap, part=pos, p_pad=p_pad)
        acc = pos.gather(placed.acc_nodes, 1)[:, :p_pad]
        cnt = pos.gather(placed.acc_count, 1)[:, :p_pad]
        deficit = pos.gather(placed.deficit, 1)[:, :p_pad]
        with order_lock:
            ordered, after = leadership_order(acc, cnt, to_tensor(counters), jh)
        return tuple(to_numpy(t) for t in (ordered, after, placed.infeasible, deficit,
                                           cnt)) + (pos.collectives,)

    return tm.run_positions(positions, run)


def _jax_solve(enc0, currents, jhashes, p_reals, counters):
    return [np.asarray(a) for a in jax.device_get(solve_batched_jit(
        jnp.asarray(currents), jnp.asarray(enc0.rack_idx), jnp.asarray(counters),
        jnp.asarray(jhashes), jnp.asarray(p_reals), n=enc0.n, rf=enc0.rf,
    ))]


@pytest.mark.parametrize("shape", [dict(n_topics=4, p=256, n=64, rf=3),
                                   dict(n_topics=1, p=1024, n=64, rf=3)])
def test_part_sharded_placement_and_order_match_unsharded_and_jax(shape):
    """``test_partition_sharded_exact_solve_matches_unsharded`` and
    ``test_partition_sharded_giant_single_topic``: every position's
    ordering, counters and flags equal the unsharded port's and JAX's."""
    enc0, currents, jhashes, p_reals, counters = _example_problem(**shape)
    ref = _jax_solve(enc0, currents, jhashes, p_reals, counters)
    plain = _port_part_solve(_mesh(1), enc0, currents, jhashes, p_reals, counters)
    outs = _port_part_solve(_mesh(8), enc0, currents, jhashes, p_reals, counters)
    assert len(outs) == 8 and plain[0][-1] == 3  # one position: the gathers only
    for got in plain + outs:
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_array_equal(a, b)
    assert not ref[2].any()
    # Every position ran the same collectives.
    assert len({o[-1] for o in outs}) == 1 and outs[0][-1] > 0


def _three_ways(topics, live, rack_map, rf=-1, k=8):
    """The JAX package's solve, the unsharded port's and the port's over a
    part axis of ``k`` positions, each with a fresh context; all equal.
    Returns the sharded solver and its assignments."""
    ja = JaxAssigner(TpuSolver())
    ref = ja.generate_assignments(topics, live, rack_map, rf)
    ta = TopicAssigner(TorchSolver("cpu"))
    plain = ta.generate_assignments(topics, live, rack_map, rf)
    solver = TorchSolver("cpu", mesh=_mesh(k))
    sa = TopicAssigner(solver)
    sharded = sa.generate_assignments(topics, live, rack_map, rf)
    assert sharded == plain == ref
    assert sa.context.counter == ta.context.counter == ja.context.counter
    assert solver.last_collectives > 0
    return solver, sharded


def test_torch_solver_mesh_option_is_identical():
    """``test_tpu_solver_mesh_option_is_identical``."""
    current, live, rack_map = make_cluster(3, 12, 64, 3, 4)
    topics = [(f"t{i}", current) for i in range(3)]
    _three_ways(topics, live, rack_map)


def test_saturated_part_sharded_equals_unsharded_on_quota_chain(budget_flip):
    """``tests/test_wave_boundaries.py:108``: the saturated instance through
    the giant-shape chain (slot-packed fast, then the quota hybrid) past a
    lowered ``KA_DENSE_MASK_BUDGET``, 8 ways, moving exactly 600."""
    topics, live, rack_map = _saturated()
    budget_flip(50_000)
    solver, sharded = _three_ways(topics, live, rack_map)
    assert sum(moved_replicas(dict(topics)[t], a) for t, a in sharded) == 600
    assert "balance_quota" in solver.last_waves


def _giant(partitions=2000, n_brokers=40, added=4, cell="expansion"):
    """A reduced ``test_giant_topic.py`` instance: one topic on
    ``n_brokers`` in 10 racks plus ``added`` brokers, expansion (all live)
    or saturated (the first ``added`` replaced)."""
    tm_, _, racks = rack_striped_cluster(n_brokers, 1, partitions, 3, 10,
                                         name_fmt="giant-{:04d}", extra_brokers=added)
    live = set(range(n_brokers + added)) if cell == "expansion" else \
        set(range(added, n_brokers + added))
    return list(tm_.items()), live, {b: racks[b] for b in live}


@pytest.mark.parametrize("cell,mode,moved", [
    ("expansion", "auto", 520),
    ("saturated", "auto", 600),
    ("expansion", "fresh", None),
])
def test_reduced_giant_topic_part_sharded(budget_flip, monkeypatch, cell, mode, moved):
    """``test_giant_topic_part_sharded_equality_and_oracle_parity`` at 2,000
    partitions on 44 brokers in 10 racks, past a lowered budget so the
    giant-shape chain runs, on the ``auto`` and ``fresh`` chains."""
    topics, live, rack_map = _giant(cell=cell)
    budget_flip(50_000)
    monkeypatch.setenv("KA_WAVE_MODE", mode)
    solver, sharded = _three_ways(topics, live, rack_map)
    got = sum(moved_replicas(dict(topics)[t], a) for t, a in sharded)
    if moved is not None:
        assert got == moved
    assert "dense" not in solver.last_waves and "seq" not in solver.last_waves


def test_mixed_rf_part_sharded(budget_flip):
    """Six topics of RF 1-3 in one batch (the per-topic ``rfs`` lane) past a
    lowered budget."""
    topics, live, rack_map, rfs = _mixed_rf()
    budget_flip(2_000)
    _three_ways(topics, live, rack_map)


@pytest.mark.parametrize("wave_mode", [None, "auto"])
def test_rf_decrease_compat_part_sharded(monkeypatch, wave_mode):
    """``KA_RF_DECREASE_COMPAT=1`` on an RF decrease 4 -> 2 with brokers
    replaced: the wide slot width through the part axis, on compat's
    ``seq`` chain and on the auction legs."""
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    if wave_mode:
        monkeypatch.setenv("KA_WAVE_MODE", wave_mode)
    tm_, _, racks = rack_striped_cluster(25, 1, 50, 4, 5, name_fmt="compat-{:02d}",
                                         extra_brokers=5)
    live = set(range(5, 30))
    _three_ways(list(tm_.items()), live, {b: racks[b] for b in live}, rf=2)


@pytest.mark.parametrize("wave_mode,k,legs", [
    ("dense", 8, {"dense"}), ("seq", 3, {"seq"}), ("auto", 5, {"fast", "dense"}),
])
def test_dense_and_seq_legs_part_sharded(monkeypatch, wave_mode, k, legs):
    """Rows that reach the ``dense`` and ``seq`` legs (on ``auto``, dense
    after the fast leg strands): the dense auction's requests ranked across
    positions, and the sequential leg run on the gathered rows in every
    position; ``k`` 3 and 5 do not divide P_pad."""
    current, live, rack_map = make_cluster(2, 24, 48, 3, 4, remove=3)
    monkeypatch.setenv("KA_WAVE_MODE", wave_mode)
    solver, _ = _three_ways([(f"t{i}", current) for i in range(2)], live, rack_map, k=k)
    assert set(solver.last_waves) == legs


def test_strand_through_every_leg_raises_the_same_error(budget_flip, monkeypatch):
    """An infeasible compat decrease under the giant-shape chain: every leg
    runs (dense last), on the gathered ``seq`` rows too, and the sharded
    solve raises the unsharded solve's error."""
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    monkeypatch.setenv("KA_WAVE_MODE", "auto")
    budget_flip(64)
    tm_, _, racks = rack_striped_cluster(20, 1, 40, 4, 5, name_fmt="g{:02d}",
                                         extra_brokers=2)
    live = set(range(2, 22))
    rack_map = {b: racks[b] for b in live}
    errors = []
    for solver in (TpuSolver(), TorchSolver("cpu"), TorchSolver("cpu", mesh=_mesh(8))):
        with pytest.raises(ValueError, match="could not be fully assigned") as e:
            solver.assign_many(list(tm_.items()), rack_map, live, 3)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == errors[2]
    assert tuple(solver.last_waves) == ("fast", "balance_quota", "balance", "seq", "dense")


@pytest.mark.parametrize("k", [3])
def test_part_axis_that_does_not_divide_p_pad(budget_flip, k):
    """P_pad 1,000 over 3 positions: the batch is padded with
    empty rows to tile the axis, and the chain is resolved for P_pad itself
    (the giant-shape gate sits between 1,000 and the padded tile)."""
    topics, live, rack_map = _saturated()
    cells = 1_000 * encode_cluster(rack_map, live).n_pad  # P_pad x N_pad
    budget_flip(cells - 1)  # giant; so is every padded tile
    solver, _ = _three_ways(topics, live, rack_map, k=k)
    assert "balance_quota" in solver.last_waves
    budget_flip(cells)  # P_pad's own product is not giant; the tile's would be
    solver, _ = _three_ways(topics, live, rack_map, k=k)
    assert "balance_quota" not in solver.last_waves


def test_fresh_assignment_stays_unsharded():
    """``fresh_assignment`` ignores the mesh, as the reference's does."""
    brokers = set(range(12))
    racks = {b: f"r{b % 4}" for b in brokers}
    solver = TorchSolver("cpu", mesh=_mesh(8))
    got = solver.fresh_assignment("t", 40, brokers, racks, 3)
    assert got == TorchSolver("cpu").fresh_assignment("t", 40, brokers, racks, 3)
    assert solver.last_collectives is None


def test_native_leadership_lane_part_sharded(monkeypatch):
    """``KA_LEADERSHIP=native``: every position orders on the host pass."""
    from kafka_assigner_tpu_torch.native.build import NativeBuildError, build_native_library

    try:
        build_native_library()
    except NativeBuildError as e:
        pytest.fail(f"the host library does not build here: {e}")
    monkeypatch.setenv("KA_LEADERSHIP", "native")
    current, live, rack_map = make_cluster(3, 12, 64, 3, 4)
    solver, _ = _three_ways([(f"t{i}", current) for i in range(3)], live, rack_map)
    assert solver.last_leadership == "native"
