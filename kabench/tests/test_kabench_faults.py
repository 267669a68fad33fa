"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped), with the timed path broken underneath the driver: every fault the
cells can have must make ``correct`` come out false, and the sound path
true. The cells run on one chip, so no exchange between chips exists to
leave out."""
import dataclasses

import pytest

from kabench import harness
from kabench.tests import tiny


def _wrap_plan(driver, broken):
    """The program's plan entry, with ``broken(topics, plan)`` applied to
    what it returns (``broken(topics, plan, live, racks)`` where it takes
    four arguments)."""
    class Broken(driver.assigner):
        def generate_assignments(self, topic_assignments, *a, **k):
            out = super().generate_assignments(topic_assignments, *a, **k)
            if broken.__code__.co_argcount == 4:
                return broken(topic_assignments, out, *a)
            return broken(topic_assignments, out)
    driver.assigner = Broken


def unchanged_plan(driver):
    """The plan step returns its state unchanged: the current assignment."""
    _wrap_plan(driver, lambda topics, out: [(t, {p: list(r) for p, r in a.items()})
                                            for t, a in topics])


def half_plan(driver):
    """Half of the batch left out: the plan of the first half of the topics."""
    _wrap_plan(driver, lambda topics, out: out[:len(out) // 2])


def altered_plan(driver):
    """An answer altered where it is produced: one row's first two replicas
    swapped in every plan."""
    def broken(topics, out):
        _, assignment = out[0]
        reps = assignment[min(assignment)]
        reps[0], reps[1] = reps[1], reps[0]
        return out
    _wrap_plan(driver, broken)


def orphan_elsewhere_plan(driver):
    """The orphan spread altered where it is produced: in every plan, one
    replica placed on a broker that did not hold it moves to another broker
    of its rack that holds none of the topic, so every guarantee still
    holds."""
    def broken(topics, out, live, racks):
        before = dict(topics)
        for name, assignment in out:
            used = {b for reps in assignment.values() for b in reps}
            for p, reps in assignment.items():
                for s, b in enumerate(reps):
                    if b in before[name][p]:
                        continue
                    other = [x for x in sorted(live) if racks[x] == racks[b] and x not in used]
                    if other:
                        reps[s] = other[0]
                        return out
        raise AssertionError("no orphan to move")
    _wrap_plan(driver, broken)


def _wrap_sweep(driver, broken):
    """The program's what-if entry, with ``broken(results)`` applied."""
    real = driver.whatif

    class Broken:
        last_sweep = real.last_sweep

        @staticmethod
        def evaluate_removal_scenarios(*a, **k):
            return broken(real.evaluate_removal_scenarios(*a, **k))
    driver.whatif = Broken


def unchanged_sweep(driver):
    """The sweep returns every scenario's state unchanged: nothing moves."""
    _wrap_sweep(driver, lambda out: [dataclasses.replace(r, moved_replicas=0)
                                     for r in out])


def half_sweep(driver):
    """Half of the scenarios' answers left out."""
    _wrap_sweep(driver, lambda out: out[:len(out) // 2])


def altered_sweep(driver):
    """Every scenario's answer altered where it is produced."""
    _wrap_sweep(driver, lambda out: [
        dataclasses.replace(r, moved_replicas=r.moved_replicas + 1) for r in out])


def load_altered_sweep(driver):
    """Every scenario's largest broker load altered where it is produced,
    its moved replicas and feasibility left right."""
    _wrap_sweep(driver, lambda out: [
        dataclasses.replace(r, max_node_load=r.max_node_load + 1) for r in out])


FAULTS = {
    "solve": [unchanged_plan, half_plan, altered_plan, orphan_elsewhere_plan],
    "sweep": [unchanged_sweep, half_sweep, altered_sweep, load_altered_sweep],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.bench_copy(tmp_path_factory.mktemp("bench"))


def _run(root, driver, patch=None):
    traffic = tiny.CELLS[driver][0]
    return harness.run_cell(f"tiny_60b.{traffic}", 77, 0.3, False, device="cpu",
                            root=root, check_modules=False, patch=patch)


@pytest.mark.parametrize("driver", sorted(FAULTS))
def test_sound_run_is_correct(root, driver):
    result, _ = _run(root, driver)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("driver,fault", [(d, f) for d, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, driver, fault):
    result, checks = _run(root, driver, fault)
    assert result["correct"] is False, checks
