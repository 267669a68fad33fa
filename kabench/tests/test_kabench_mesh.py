"""The four-card what-if cell's driver, ``sweep_mesh``, at a tiny size on
the CPU, with the program's visible devices patched to four ``cpu``
positions: a whole run checks clean against the plain reference, a run
whose gather swaps two positions' blocks does not, and each reader of the
mesh's record reads its mean, or nothing where the program recorded
nothing (a parent without the record)."""
import json

import pytest
import torch

from kabench import harness
from kabench.harness import RunData
from kabench.tests import tiny

CELL = "tiny_60b.sweep_mesh32"
READERS = {"whatif_mesh_upload_ms": "mesh_upload", "whatif_mesh_slowest_ms": "mesh_slowest",
           "whatif_mesh_skew_ms": "mesh_skew", "whatif_mesh_gather_ms": "mesh_gather",
           "whatif_mesh_blocks": "mesh_blocks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark's copy with the tiny cells and a tiny four-chip mesh
    cell: 32 scenarios a request, every scenario of a short window in the
    sample."""
    root = tiny.bench_copy(tmp_path_factory.mktemp("bench"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "kabench" / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "config": "tiny_60b", "traffic": "sweep_mesh32", "chips": 4, "driver": "sweep_mesh",
        "params": {"scenarios": 32, "k_min": 1, "k_max": 10}, "check": {"sample": 96}}))
    spec["workloads"].append({"name": CELL, "config": "tiny_60b", "traffic": "sweep_mesh32",
                              "chips": 4, "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "scenarios_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def four_positions(monkeypatch):
    from kafka_assigner_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 4)


def _run(root, trace=False):
    return harness.run_cell(CELL, 2**31 + 91, 0.3, trace, device="cpu", root=root,
                            check_modules=False)


def test_mesh_run_checks_clean_and_reads_the_mesh(root, four_positions):
    result, checks = _run(root)
    assert result["correct"] is True, checks
    assert {"scenarios_per_s", "setup_s"} <= set(result["metrics"])
    result, checks = _run(root, trace=True)
    assert result["correct"] is True, checks
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(got)
    assert got["whatif_mesh_blocks"] == 1
    assert 0 <= got["whatif_mesh_skew_ms"] <= got["whatif_mesh_slowest_ms"]
    assert got["whatif_mesh_slowest_ms"] <= got["whatif_sweep_ms"]


def test_swapped_blocks_are_not_correct(root, four_positions, monkeypatch):
    """The gather hands back positions 0 and 1's blocks in each other's
    places: the answers stay in scenario order but are other scenarios'."""
    from kafka_assigner_tpu_torch.parallel import whatif

    real = whatif.fetch_global

    def swapped(x):
        blocks = dict(x.blocks)
        (p0, t0), (p1, t1) = blocks[0], blocks[1]
        assert t0.shape == t1.shape
        x.blocks = {**blocks, 0: (p0, t1), 1: (p1, t0)}
        return real(x)

    monkeypatch.setattr(whatif, "fetch_global", swapped)
    result, checks = _run(root)
    assert result["correct"] is False, checks
    assert dict((n, v) for n, v, _ in checks)["scenarios_differing"] > 0


def test_a_mesh_of_other_width_than_the_cell_raises(root):
    """One visible device gives no mesh: the four-chip cell refuses to run
    unsharded."""
    with pytest.raises(RuntimeError, match="scenario position"):
        _run(root)


def test_a_program_without_auto_mesh_gets_its_cli_layout(four_positions, monkeypatch):
    """Against a program older than ``auto_mesh`` the driver lays the mesh
    out as that program's ``RANK_DECOMMISSION`` did: every visible device
    on the scenario axis."""
    from kabench.drivers import sweep_mesh
    from kafka_assigner_tpu_torch.parallel import mesh

    want = dict(mesh.auto_mesh("cpu").shape)
    monkeypatch.delattr(mesh, "auto_mesh")
    assert dict(sweep_mesh.program_mesh("cpu").shape) == want == {"scenarios": 4, "part": 1}


def _sweep_run(kind="whatif", extra=True):
    recs = [{"ok": True, "t0": i, "t1": i + 0.9, "units": 1024,
             "sweep": dict({"prep": 180.0, "sweep": 900.0},
                           **({"mesh_upload": 4.0 + i, "mesh_slowest": 700.0 + i,
                               "mesh_skew": 40.0 + i, "mesh_gather": 2.0 + i,
                               "mesh_blocks": 3, "mesh_positions": 4} if extra else {}))}
            for i in range(4)]
    recs.append({"ok": False, "t0": 4.0, "t1": 4.5})
    return RunData(None, kind, {}, 20.0, 4.5, recs, None)


def _read(name, run):
    return harness.load_file(harness.ROOT / "kabench" / "metrics" / f"{name}.py",
                             f"t_{name}").read(run)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_mean_of_its_key(name):
    run = _sweep_run()
    want = sum(r["sweep"][READERS[name]] for r in run.records if r["ok"]) / 4
    assert _read(name, run) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("kind,extra", [("plan", True), ("whatif", False)])
def test_reader_reads_nothing_without_its_key(name, kind, extra):
    assert _read(name, _sweep_run(kind, extra)) is None


def test_the_mesh_metrics_are_declared_for_the_four_card_cell():
    spec = harness.load_spec()
    cell = "config4_5000b_4card.decommission_sweep_mesh"
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] == [cell]
        assert (m["moves"], m["layer"]) == ("scenarios_per_s", "what-if mesh")
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    assert entry["chips"] == 4
    loaded = harness.load_cell(cell)
    assert loaded.driver == "sweep_mesh" and loaded.params["scenarios"] == 1024
    assert loaded.config["deployment"] == harness.load_cell(
        "config4_5000b.decommission_sweep").config["deployment"]
