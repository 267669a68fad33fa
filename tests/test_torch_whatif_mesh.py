"""The port's scenario-sharded what-if sweeps (``evaluate_removal_scenarios(
mesh=)``) on eight in-process ``cpu`` positions, against the unsharded port
and the JAX package on the conftest's eight virtual CPU devices:

- ``tests/test_whatif.py:54`` (sharded == unsharded) and ``:93`` (the
  ``KA_WHATIF_MEMBUDGET`` blocks through a mesh), and
  ``tests/test_config5_fleet.py:20`` (256 scenarios of BASELINE config 5 on
  8 positions, full size), each on both sweep paths;
- the ``whatif.fanout`` gauge equal to the reference's under the same mesh
  width;
- a call under an active dispatcher runs unsharded, through the dispatcher;
- the mesh's own record in ``last_sweep`` (upload, slowest position, skew,
  gather, mesh calls, positions) on 4 positions, and none unsharded;
- the port's CLI ``RANK_DECOMMISSION`` with the visible-device lookup
  patched to 8 ``cpu`` positions, byte-identical to the JAX CLI, which
  auto-meshes over its 8 devices.

Results are integers, compared exactly (``dataclasses.astuple``).
"""
from __future__ import annotations

import dataclasses
import io

import jax
import pytest
import torch

import kafka_assigner_tpu.parallel.whatif as jw
import kafka_assigner_tpu_torch.parallel.whatif as tw
from kafka_assigner_tpu import obs as jax_obs
from kafka_assigner_tpu.models.synthetic import build_config5
from kafka_assigner_tpu.parallel.mesh import build_mesh as jax_build_mesh
from kafka_assigner_tpu_torch import obs
from kafka_assigner_tpu_torch.daemon.dispatch import SolveDispatcher, dispatch_scope
from kafka_assigner_tpu_torch.ops import assignment as tops
from kafka_assigner_tpu_torch.parallel import mesh as tm

from .test_invariants import make_cluster
from .test_torch_cli import _jax, _port, replacement_snapshot, scenario_file  # noqa: F401

PATHS = ["1", "0"]  # KA_WHATIF_INCREMENTAL: the incremental and the dense sweep


@pytest.fixture(scope="module")
def cluster():
    """``tests/test_whatif.py``'s cluster."""
    current, live, rack_map = make_cluster(0, 16, 32, 3, 4)
    return {f"t{i}": current for i in range(3)}, live, rack_map


def _mesh8():
    return tm.build_mesh(devices=["cpu"] * 8)


def _tuples(results):
    return [dataclasses.astuple(r) for r in results]


@pytest.fixture
def sweep_path(monkeypatch, request):
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", request.param)
    return request.param


def _three(topics, live, rack_map, scenarios, path):
    """JAX on its 8-device mesh, the unsharded port and the port on 8
    positions; all equal. Returns the port's sharded results."""
    ref = jw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                        mesh=jax_build_mesh())
    plain = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                          device="cpu")
    sharded = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                            device="cpu", mesh=_mesh8())
    assert _tuples(sharded) == _tuples(plain) == _tuples(ref)
    return sharded


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
def test_whatif_sharded_equals_unsharded(cluster, sweep_path):
    _three(*cluster, [[100 + i] for i in range(8)], sweep_path)


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
@pytest.mark.parametrize("scenarios", [
    [[100], [101, 102], [], [115]],                 # 4 on 8 positions: 4 empty
    [[b] for b in range(100, 113)],                 # 13: blocks of 2, the last 1
])
def test_whatif_sharded_uneven_blocks(cluster, sweep_path, scenarios):
    _three(*cluster, scenarios, sweep_path)


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
def test_whatif_scenario_chunking_matches_unchunked_through_a_mesh(cluster, monkeypatch,
                                                                   sweep_path):
    """``tests/test_whatif.py:93``: a budget of one scenario a block, within
    each position's block, equals the single-dispatch sweep."""
    topics, live, rack_map = cluster
    scenarios = [[b] for b in sorted(live)[:12]]
    expected = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                             device="cpu")
    monkeypatch.setenv("KA_WHATIF_MEMBUDGET", "1")
    _three(topics, live, rack_map, scenarios, sweep_path)
    chunked = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                            device="cpu", mesh=_mesh8())
    assert _tuples(chunked) == _tuples(expected)
    if sweep_path == "0":
        # Blocks of 2 scenarios on 6 positions, one scenario a chunk, each
        # scenario's rows the 3 topics' batch bucket of 4.
        assert tw.last_sweep["chunks"] == 12 and tw.last_sweep["rows"] == 12 * 4


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
def test_config5_256_scenarios_on_8_positions(sweep_path):
    """``tests/test_config5_fleet.py:20`` at full size: 256 single-broker
    removals over the 1,000-broker cluster, sharded 8 ways."""
    topics, live, rack_map = build_config5()
    scenarios = [[b] for b in range(256)]
    plain = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                          device="cpu")
    rec_plain = dict(tw.last_sweep)
    sharded = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                            device="cpu", mesh=_mesh8())
    ref = jw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3)
    assert _tuples(sharded) == _tuples(plain) == _tuples(ref)
    assert len(sharded) == 256 and all(r.feasible for r in sharded)
    rec = tw.last_sweep
    assert rec["path"] == rec_plain["path"] == ("incremental" if sweep_path == "1" else "dense")
    # last_sweep sums every position's rows, chunks and waves.
    assert rec["rows"] == rec_plain["rows"] and rec["chunks"] == 8
    assert sum(rec["waves"].values()) >= sum(rec_plain["waves"].values())


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
def test_positions_on_one_device_split_its_sweep_budget(cluster, monkeypatch, sweep_path):
    """Eight in-process positions on one device each size their calls for
    eight sweeps at once on it; an unsharded sweep for one."""
    topics, live, rack_map = cluster
    seen = []

    def budget(dev):
        seen.append(tops._SHARERS.k)
        return None
    monkeypatch.setattr(tops, "sweep_budget", budget)
    scenarios = [[100 + i] for i in range(8)]
    tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3, device="cpu")
    assert seen and set(seen) == {1}
    seen.clear()
    tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3, device="cpu",
                                  mesh=_mesh8())
    assert len(seen) == 8 and set(seen) == {8}


@pytest.mark.parametrize("sweep_path", PATHS, indirect=True)
def test_mesh_sweep_records_upload_positions_and_gather(cluster, monkeypatch, sweep_path):
    """A sweep on 4 positions, in blocks of 4 scenarios (a budget of one a
    block, rounded up to the axis) on the dense path: ``last_sweep`` sums
    its mesh calls' upload, slowest position, skew and gather, counts the
    calls, and names the axis; an unsharded sweep records none of them."""
    topics, live, rack_map = cluster
    scenarios = [[b] for b in sorted(live)[:12]]
    monkeypatch.setenv("KA_WHATIF_MEMBUDGET", "1")
    plain = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                          device="cpu")
    assert not [k for k in tw.last_sweep if k.startswith("mesh_")]
    calls = []
    real = tw.run_positions

    def spy(blocks, fn):
        calls.append(len(blocks))
        return real(blocks, fn)

    monkeypatch.setattr(tw, "run_positions", spy)
    got = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                        device="cpu", mesh=tm.build_mesh(devices=["cpu"] * 4))
    assert _tuples(got) == _tuples(plain)
    rec = tw.last_sweep
    assert calls and set(calls) == {4}
    assert rec["mesh_blocks"] == len(calls) and rec["mesh_positions"] == 4
    if sweep_path == "0":
        assert len(calls) == 3
    assert 0 <= rec["mesh_skew"] <= rec["mesh_slowest"] <= rec["sweep"]
    assert rec["mesh_upload"] >= 0 and rec["mesh_gather"] >= 0
    assert rec["mesh_upload"] + rec["mesh_slowest"] + rec["mesh_gather"] <= rec["sweep"]


@pytest.mark.parametrize("n_scenarios,fanout", [(3, 8), (8, 8), (9, 16), (17, 32)])
def test_fanout_gauge_equals_the_reference_under_the_same_mesh(cluster, n_scenarios,
                                                               fanout):
    topics, live, rack_map = cluster
    scenarios = [[100 + i % 16] for i in range(n_scenarios)]
    runs = {}
    for name, pkg, call in (
        ("jax", jax_obs, lambda: jw.evaluate_removal_scenarios(
            topics, live, rack_map, scenarios, 3, mesh=jax_build_mesh())),
        ("torch", obs, lambda: tw.evaluate_removal_scenarios(
            topics, live, rack_map, scenarios, 3, device="cpu", mesh=_mesh8())),
    ):
        with pkg.run_capture() as run:
            runs[name] = _tuples(call())
        runs[name + "_gauges"] = run.gauges
    assert runs["torch"] == runs["jax"]
    assert runs["torch_gauges"]["whatif.fanout"] == runs["jax_gauges"]["whatif.fanout"] \
        == fanout
    assert len(jax.devices()) == 8


def test_a_call_under_the_dispatcher_runs_unsharded(cluster, monkeypatch):
    """Under an active dispatcher the mesh is dropped, as the reference
    drops it: the rows go through ``submit_routed``, no mesh position runs,
    and the fan-out is the unsharded bucket."""
    topics, live, rack_map = cluster
    scenarios = [[100], [101], [102]]
    plain = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                          device="cpu")

    def no_positions(*_):
        raise AssertionError("a mesh position ran under the dispatcher")

    monkeypatch.setattr(tw, "run_positions", no_positions)
    d = SolveDispatcher(err=io.StringIO())
    routed, submit = [], d.submit_rows

    def counted(entry, *args, **kw):
        routed.append(entry)
        return submit(entry, *args, **kw)

    d.submit_rows = counted
    try:
        with dispatch_scope(d), obs.run_capture() as run:
            got = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                                device="cpu", mesh=_mesh8())
    finally:
        d.close()
    assert _tuples(got) == _tuples(plain)
    assert run.gauges["whatif.fanout"] == 4
    assert routed and set(routed) <= {"whatif_sweep", "whatif_subset_sweep"}


@pytest.mark.parametrize("extra", [[], ["--integer_broker_ids", "4,5,6,17,39"],
                                   ["--scenario_file"]])
def test_cli_rank_decommission_on_8_positions_matches_the_jax_cli(
        replacement_snapshot, scenario_file, monkeypatch, extra):
    """The CLI's auto-mesh: with 8 visible positions the port sweeps on
    them (one block a position) and prints the JAX CLI's bytes, which
    auto-meshes over its 8 devices."""
    if extra == ["--scenario_file"]:
        extra = [extra[0], scenario_file]
    argv = ["--zk_string", replacement_snapshot, "--mode", "RANK_DECOMMISSION", *extra]
    monkeypatch.setattr(tm, "visible_devices", lambda device="cuda": [torch.device("cpu")] * 8)
    seen = []
    real = tw.run_positions

    def spy(blocks, fn):
        seen.append(len(blocks))
        return real(blocks, fn)

    monkeypatch.setattr(tw, "run_positions", spy)
    for incremental in PATHS:
        monkeypatch.setenv("KA_WHATIF_INCREMENTAL", incremental)
        assert _port(*argv) == _jax(*argv)
    assert seen and all(n == 8 for n in seen)
