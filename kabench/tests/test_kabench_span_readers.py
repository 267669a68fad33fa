"""The readers of the program's own records of host time (RF inference,
the collector's pauses, placement's and the sweep's waits in device reads)
on canned records: each reads its key's mean in its own kind of cell, and
nothing in the other kind or where the program recorded nothing (a parent
without the records)."""
import pytest

from kabench import harness
from kabench.harness import RunData

PLAN = ("infer_ms.plan", "gc_ms.plan", "place_wait_ms.plan")
SWEEP = ("whatif_syncs", "whatif_wait_ms")


def read(name, run):
    return harness.load_file(harness.ROOT / "kabench" / "metrics" / f"{name}.py",
                             f"t_{name.replace('.', '_')}").read(run)


def plan_run(extra=True):
    recs = [{"ok": True, "t0": 0.1 * i, "t1": 0.1 * i + 0.08,
             "timers": dict({"encode": 10.0, "place": 5.0, "leadership": 16.0,
                             "decode": 40.0},
                            **({"infer": 30.0 + i, "gc": 0.0 if i % 4 else 8.0,
                                "place_wait": 2.0} if extra else {}))}
            for i in range(20)]
    recs.append({"ok": False, "t0": 2.0, "t1": 2.1})
    return RunData(None, "plan", {}, 12.5, 2.1, recs, None)


def sweep_run(extra=True):
    recs = [{"ok": True, "t0": i, "t1": i + 0.9, "units": 256,
             "sweep": dict({"prep": 100.0, "compose": 0.0, "sweep": 800.0, "rescue": 4.0},
                           **({"syncs": 300 + 2 * i, "wait": 250.0 + i} if extra else {}))}
            for i in range(4)]
    return RunData(None, "whatif", {}, 20.0, 4.0, recs, None)


def test_plan_span_readers():
    run = plan_run()
    assert read("infer_ms.plan", run) == pytest.approx(30.0 + 9.5)
    assert read("gc_ms.plan", run) == pytest.approx(8.0 * 5 / 20)
    assert read("place_wait_ms.plan", run) == 2.0
    assert read("place_wait_ms.plan", run) <= read("place_ms.plan", run)
    for name in SWEEP:
        assert read(name, run) is None


def test_sweep_span_readers():
    run = sweep_run()
    assert read("whatif_syncs", run) == pytest.approx(303.0)
    assert read("whatif_wait_ms", run) == pytest.approx(251.5)
    for name in PLAN:
        assert read(name, run) is None


@pytest.mark.parametrize("name", PLAN + SWEEP)
def test_nothing_recorded_reads_nothing(name):
    run = plan_run(False) if name in PLAN else sweep_run(False)
    assert read(name, run) is None


def test_the_five_metrics_are_declared_for_their_cells():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    plan_cells = ["config4_5000b.replace100", "guideline_30b.expand6"]
    for name in PLAN:
        assert spec[name]["workloads"] == plan_cells and spec[name]["moves"] == "plan_ms"
    for name in SWEEP:
        assert spec[name]["workloads"] == ["config4_5000b.decommission_sweep"]
        assert spec[name]["moves"] == "scenarios_per_s"
