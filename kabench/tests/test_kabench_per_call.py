"""The reader of the scenarios a sweep's placement call held, on canned
records: their mean in a sweep cell, nothing in a plan cell or where the
program recorded nothing (a parent without the record)."""
import pytest

from kabench import harness
from kabench.harness import RunData


def read(run):
    return harness.load_file(harness.ROOT / "kabench" / "metrics" / "whatif_per_call.py",
                             "t_whatif_per_call").read(run)


def sweep_run(kind="whatif", extra=True):
    recs = [{"ok": True, "t0": i, "t1": i + 0.9, "units": 256,
             "sweep": dict({"prep": 100.0, "sweep": 800.0, "chunks": 8},
                           **({"per_call": 32 + i} if extra else {}))}
            for i in range(4)]
    recs.append({"ok": False, "t0": 4.0, "t1": 4.5})
    return RunData(None, kind, {}, 20.0, 4.5, recs, None)


def test_per_call_reads_the_mean_of_the_record():
    assert read(sweep_run()) == pytest.approx(33.5)


@pytest.mark.parametrize("kind,extra", [("plan", True), ("whatif", False)])
def test_per_call_reads_nothing_elsewhere(kind, extra):
    assert read(sweep_run(kind, extra)) is None


def test_per_call_is_declared_for_the_sweep_cell():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    m = spec["whatif_per_call"]
    assert m["workloads"] == ["config4_5000b.decommission_sweep"]
    assert (m["moves"], m["source"], m["layer"]) == (
        "scenarios_per_s", "program_counter", "what-if device sweep")
