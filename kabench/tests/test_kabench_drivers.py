"""Each traffic driver at a tiny deployment on the CPU, called directly, and
the plain reference against the port on the CPU and against its controls."""
import random

import numpy as np
import pytest

from kabench import gen
from kabench.drivers import mode3, solve, sweep
from kabench.reference import placement
from kabench.tests import tiny

DRIVERS = {"solve": solve, "sweep": sweep, "mode3": mode3}
SEED = 2**31 + 12345


def drive(name, requests=3, seed=SEED):
    d = DRIVERS[name].Driver(tiny.cell(name), seed, "cpu")
    d.warm()
    recs = []
    for i in range(1, requests + 1):
        args = d.prepare(i)
        rec = {"ok": True}
        d.observe(i, args, d.request(args), rec)
        recs.append(rec)
    checks = d.check()
    d.release()
    return d, recs, checks


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_runs_and_checks_clean(name):
    d, recs, checks = drive(name)
    assert checks and all(v == 0 for _, v, _ in checks), checks
    assert all(lim == 0 for _, _, lim in checks)
    kind, layout = d.phases(recs[-1])
    assert kind in ("start", "end")
    assert all(ms >= 0 for _, ms in layout)


def test_same_seed_same_requests():
    d = solve.Driver(tiny.cell("solve"), SEED, "cpu")
    assert d.prepare(5) == d.prepare(5)
    assert d.prepare(5) != d.prepare(6)
    s = sweep.Driver(tiny.cell("sweep"), SEED, "cpu")
    first = s.prepare(2)
    assert first == s.prepare(2)
    # Every request gets the same multiset of removal counts.
    assert sorted(map(len, first)) == sorted(map(len, s.prepare(3)))


def _plan_inputs(op, seed=3, i=1):
    topics, brokers, racks = gen.build_deployment(tiny.TINY)
    params = dict(tiny.CELLS["solve"][1], op=op)
    live, rmap = gen.plan_request(tiny.TINY, params, brokers, racks, seed, i)
    return list(topics.items()), live, rmap


def _random_cluster(seed):
    """A small cluster with uneven racks, loads and topic sizes, and a
    request that removes some brokers and adds some: shapes at which every
    leg of the orphan spread runs."""
    rng = random.Random(seed)
    n, n_racks, rf = rng.randint(6, 40), rng.randint(2, 6), rng.randint(2, 3)
    skew = rng.random() < 0.5
    racks = {b: f"r{rng.randrange(n_racks) if skew else b % n_racks}" for b in range(n)}
    topics = {}
    for t in range(rng.randint(1, 8)):
        assignment = {}
        for p in range(rng.randint(1, 30)):
            order = rng.sample(range(n), n)
            reps, used = [], set()
            for b in order:
                if racks[b] not in used and len(reps) < rf:
                    reps.append(b)
                    used.add(racks[b])
            reps += [b for b in order if b not in reps][:rf - len(reps)]
            assignment[p] = reps
        topics[f"t{t}-{rng.randrange(10**6)}"] = assignment
    live = {b: racks[b] for b in range(n) if rng.random() > 0.3}
    for j in range(rng.randint(0, 5)):
        live[1000 + j] = f"r{rng.randrange(n_racks + 1)}"
    removals = [sorted(rng.sample(range(n), rng.randint(1, max(1, n // 3))))
                for _ in range(6)]
    return topics, set(range(n)), racks, live, removals


def _port_plan(topics, live):
    from kafka_assigner_tpu_torch.assigner import TopicAssigner

    try:
        return TopicAssigner("device", device="cpu").generate_assignments(
            list(topics.items()), set(live), live)
    except Exception:
        return None


@pytest.mark.parametrize("seed", range(12))
def test_reference_is_the_ports_plan(seed):
    """The reference's whole plan and its removal answers equal the port's
    on the CPU, where the port is held to its JAX package: every broker,
    the orphans' included, every order, every largest load."""
    from kafka_assigner_tpu_torch.parallel import whatif

    topics, brokers, racks, live, removals = _random_cluster(seed)
    flat = placement.flatten(list(topics.items()))
    ref = placement.plan(flat, set(live), live)
    got = _port_plan(topics, live)
    assert (ref is None) == (got is None)
    if ref is not None:
        assert placement.check_plan(flat, set(live), live, got) == 0
    answers = whatif.evaluate_removal_scenarios(topics, brokers, racks, removals,
                                                device="cpu")
    for removed, res in zip(removals, answers):
        want = placement.removal_answer(flat, brokers, racks, removed)
        assert placement.removal_agrees(
            want, (res.moved_replicas, res.feasible, res.max_node_load)), removed


@pytest.mark.parametrize("leg", placement.LEGS)
def test_each_leg_is_the_ports(monkeypatch, leg):
    """Each leg of the orphan spread alone equals the port's chain of that
    one leg, strands included."""
    monkeypatch.setenv("KA_WAVE_MODE", leg)
    monkeypatch.setattr(placement, "LEGS", (leg,))
    for seed in range(100, 110):
        topics, _, _, live, _ = _random_cluster(seed)
        flat = placement.flatten(list(topics.items()))
        ref = placement.plan(flat, set(live), live)
        got = _port_plan(topics, live)
        assert (ref is None) == (got is None), seed
        if ref is not None:
            assert placement.check_plan(flat, set(live), live, got) == 0, seed


@pytest.mark.parametrize("op", ["replace", "expand", "decommission"])
def test_reference_keeps_the_tools_guarantees(op):
    """The reference's plan keeps RF distinct live brokers in distinct racks
    a row, the sticky fill's replicas, and the per-topic capacity."""
    topics, live, rmap = _plan_inputs(op)
    flat = placement.flatten(topics)
    rows = placement.plan(flat, live, rmap)
    sticky = placement.sticky(flat, live, rmap).brokers()
    for r, row in enumerate(rows.tolist()):
        reps = [b for b in row if b >= 0]
        assert len(reps) == flat.rf[flat.topic_of[r]]
        assert set(reps) <= live and len({rmap[b] for b in reps}) == len(reps)
        assert {b for b in sticky[r] if b >= 0} <= set(reps)
    for t, name in enumerate(flat.names):
        lo, hi = flat.starts[t], flat.starts[t + 1]
        per = np.unique(rows[lo:hi][rows[lo:hi] >= 0], return_counts=True)[1]
        assert per.max() <= -(-(flat.p_count[t] * flat.rf[t]) // len(live))


@pytest.mark.parametrize("control", placement.CONTROLS)
def test_plan_control_is_not_correct(control):
    """The reference passes its own check; each control, one broken
    guarantee, does not."""
    topics, live, rmap = _plan_inputs("replace")
    flat = placement.flatten(topics)
    sound = placement.as_pairs(flat, placement.plan(flat, live, rmap))
    assert placement.check_plan(flat, live, rmap, sound) == 0
    broken = placement.as_pairs(flat, placement.plan(flat, live, rmap, control))
    assert placement.check_plan(flat, live, rmap, broken) > 0


def test_plan_check_catches_an_orphan_elsewhere():
    """An orphan placed on another broker that keeps every guarantee (live,
    its own rack free, under capacity) reads as a differing row."""
    topics, live, rmap = _plan_inputs("replace")
    flat = placement.flatten(topics)
    rows = placement.plan(flat, live, rmap)
    sticky = placement.sticky(flat, live, rmap).brokers()
    r = next(r for r in range(len(rows)) if (sticky[r] >= 0).sum() < flat.rf[flat.topic_of[r]])
    orphan = next(b for b in rows[r] if b >= 0 and b not in sticky[r])
    t = flat.topic_of[r]
    lo, hi = flat.starts[t], flat.starts[t + 1]
    used = set(rows[lo:hi].ravel().tolist())
    other = next(b for b in sorted(live) if rmap[b] == rmap[orphan] and b not in used)
    bad = rows.copy()
    bad[r][bad[r] == orphan] = other
    assert placement.check_plan(flat, live, rmap, placement.as_pairs(flat, bad)) == 1


def test_removal_reference_and_control():
    topics, brokers, racks = gen.build_deployment(tiny.TINY)
    flat = placement.flatten(list(topics.items()))
    for removed in gen.removal_request(tiny.CELLS["sweep"][1], brokers, 9, 1)[:6]:
        want = placement.removal_answer(flat, brokers, racks, removed)
        moved, feasible, load = want
        assert feasible and moved > 0
        assert placement.removal_agrees(want, want)
        assert not placement.removal_agrees(want, (moved, feasible, load + 1))
        control = placement.removal_answer(flat, brokers, racks, removed, "unsticky")
        assert not placement.removal_agrees(want, control)


@pytest.mark.parametrize("name", ["solve", "mode3", "sweep"])
def test_control_readings_separate(name):
    """``control.py``'s readings at a tiny size: the control fails the check
    the runs pass, the sound reference beside it passes."""
    from kabench import control

    cell = tiny.cell(name)
    read = control.sweep_readings if name == "sweep" else control.plan_readings
    out = read(cell, SEED)
    assert all(v == 0 for v in out["reference"].values())
    assert any(v > 0 for v in out["control"].values())
