"""The port's ``(scenarios, part)`` mesh (``parallel/mesh.py``) on the CPU:

- ``build_mesh`` shapes, defaults and errors against the JAX package's on
  the conftest's eight virtual CPU devices (the port's positions: eight
  ``cpu`` entries in one process);
- ``auto_mesh``, the CLI's layout, over 1, 2 and 4 visible devices;
- ``put_sharded`` -> ``fetch_global`` round trips, uneven blocks included;
- each part-axis collective against its plain single-position result, in
  process at 1, 2, 3 and 8 positions;
- a part axis that mixes ranks owning several positions raises, and a
  collective that fails or times out raises in every position.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from kafka_assigner_tpu.parallel.mesh import build_mesh as jax_build_mesh
from kafka_assigner_tpu_torch.ops.assignment import UNSHARDED
from kafka_assigner_tpu_torch.parallel import mesh as tm

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("args", [(), (None, 1), (8, 1), (1, 8), (2, 4), (4, 2),
                                  (None, 2), (None, 4), (None, 8)])
def test_build_mesh_shapes_match_the_reference(args):
    ref = jax_build_mesh(*args)
    got = tm.build_mesh(*args, devices=CPU8)
    assert dict(got.shape) == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape
    assert got.axis_names == ref.axis_names == ("scenarios", "part")
    assert got.size == 8 and all(p == (0, torch.device("cpu")) for p in got.devices.flat)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_auto_mesh_puts_each_visible_device_on_the_scenario_axis(monkeypatch, n):
    """``auto_mesh`` (``RANK_DECOMMISSION``'s layout): no mesh on one visible
    device, else an n x 1 mesh of one position a device, in order."""
    devices = [torch.device("cpu")] * n
    monkeypatch.setattr(tm, "visible_devices", lambda device="cuda": devices)
    mesh = tm.auto_mesh("cuda")
    if n == 1:
        assert mesh is None
        return
    assert dict(mesh.shape) == {"scenarios": n, "part": 1}
    assert list(mesh.devices.flat) == [(0, d) for d in devices]


@pytest.mark.parametrize("args", [(3, 3), (None, 3), (16, 1), (2, 8), (None, 16)])
def test_build_mesh_errors_match_the_reference(args):
    with pytest.raises(ValueError) as ref:
        jax_build_mesh(*args)
    with pytest.raises(ValueError) as got:
        tm.build_mesh(*args, devices=CPU8)
    assert str(got.value) == str(ref.value)


def test_default_devices_are_the_visible_cards(monkeypatch):
    assert tm.visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tm.visible_devices() == [torch.device("cuda", i) for i in range(3)]
    mesh = tm.build_mesh()
    assert mesh.shape == {"scenarios": 3, "part": 1}
    assert [p.device for p in mesh.devices.flat] == tm.visible_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tm.visible_devices() == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.build_mesh()
    with pytest.raises(ValueError, match="cuda or cpu"):
        tm.visible_devices("meta")


def test_shardings_and_the_single_process_view():
    mesh = tm.build_mesh(2, 4, devices=CPU8)
    assert tm.scenario_sharding(mesh).spec == ("scenarios",)
    assert tm.replicated(mesh).spec == ()
    assert len(mesh.owned()) == 8 and mesh.rank == 0
    assert tm.process_count() == 1 and tm.process_index() == 0


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 13, 256])
def test_block_bounds_tile_the_rows(n, k):
    bounds = [tm.block_bounds(n, k, i) for i in range(k)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    blk = -(-n // k)
    assert all(hi - lo <= blk for lo, hi in bounds)


@pytest.mark.parametrize("shape,spec", [
    ((13, 3), ("scenarios", None)),
    ((5,), ("scenarios",)),
    ((3, 10, 2), (None, "part", None)),
    ((2, 7), (None, "part")),
    ((4, 4), ()),
])
@pytest.mark.parametrize("grid", [(8, 1), (1, 8), (2, 4), (4, 2), (3, 1)])
def test_put_sharded_fetch_global_round_trip(shape, spec, grid):
    rng = np.random.default_rng(sum(shape) + grid[0])
    a = rng.integers(-5, 100, size=shape).astype(np.int32)
    mesh = tm.build_mesh(*grid, devices=["cpu"] * (grid[0] * grid[1]))
    sh = tm.put_sharded(a, mesh, spec)
    axis = next((x for x in spec if x is not None), None)
    k = mesh.shape[axis] if axis else 1
    assert sorted(sh.blocks) == list(range(k))
    for b, (_, block) in sh.blocks.items():
        if axis:
            dim = spec.index(axis)
            lo, hi = tm.block_bounds(shape[dim], k, b)
            np.testing.assert_array_equal(block.numpy(), np.take(a, range(lo, hi), axis=dim))
        else:
            np.testing.assert_array_equal(block.numpy(), a)
    got = tm.fetch_global(sh)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


def test_put_sharded_takes_tensors():
    t = torch.arange(12, dtype=torch.int32).view(6, 2)
    sh = tm.put_sharded(t, tm.build_mesh(devices=["cpu"] * 4), ("scenarios", None))
    assert [tuple(sh.blocks[b][1].shape) for b in range(4)] == [(2, 2), (2, 2), (2, 2), (0, 2)]
    np.testing.assert_array_equal(tm.fetch_global(sh), t.numpy())


def test_fetch_global_passes_host_values_through():
    t = torch.arange(6, dtype=torch.int32).view(2, 3)
    np.testing.assert_array_equal(tm.fetch_global(t), t.numpy())
    np.testing.assert_array_equal(tm.fetch_global([1, 2]), np.array([1, 2]))
    sh = tm.put_sharded(np.array([True, False, True]), tm.build_mesh(devices=["cpu"] * 2),
                        ("scenarios",))
    assert tm.fetch_global(sh).tolist() == [True, False, True]


def _run_ops(k, seed):
    """Each collective at ``k`` in-process positions on per-position inputs
    drawn from ``seed``; returns (inputs, outputs per position)."""
    rng = np.random.default_rng(seed)
    counts = [torch.as_tensor(rng.integers(0, 50, size=(3, 7)), dtype=torch.int32)
              for _ in range(k)]
    flags = [torch.as_tensor(rng.random(5) < 0.15) for _ in range(k)]
    blocks = [torch.as_tensor(rng.integers(-1, 9, size=(2, 4, 3)), dtype=torch.int32)
              for _ in range(k)]
    mesh = tm.build_mesh(1, k, devices=["cpu"] * k)
    positions = tm.part_axis(mesh)
    assert [p.index for p in positions] == list(range(k))
    assert all(p.size == k for p in positions)

    def run(pos):
        i = pos.index
        return (pos.exclusive_prefix(counts[i]), pos.sum(counts[i]), pos.any(flags[i]),
                pos.gather(blocks[i], 1), pos.collectives)

    return (counts, flags, blocks), tm.run_positions(positions, run)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_part_collectives_equal_their_plain_results(k, seed):
    (counts, flags, blocks), outs = _run_ops(k, seed)
    total = torch.stack(counts).sum(0)
    for i, (prefix, summed, anyed, gathered, calls) in enumerate(outs):
        plain_prefix = torch.stack(counts[:i]).sum(0) if i else torch.zeros_like(counts[0])
        assert torch.equal(prefix, plain_prefix)
        assert torch.equal(summed, total)
        assert torch.equal(anyed, torch.stack(flags).any(0))
        assert torch.equal(gathered, torch.cat(blocks, 1))
        assert calls == 4
    # One position's collectives are the unsharded placement's identity.
    if k == 1:
        assert torch.equal(UNSHARDED.sum(counts[0]), counts[0])
        assert torch.equal(UNSHARDED.any(flags[0]), flags[0])
        assert torch.equal(UNSHARDED.gather(blocks[0], 1), blocks[0])
        assert not UNSHARDED.exclusive_prefix(counts[0]).any()


def test_a_mixed_part_axis_raises():
    # Two ranks that each own two positions of one part-axis row.
    cpu = torch.device("cpu")
    positions = [tm.Position(r, cpu) for r in (0, 0, 1, 1)]
    with pytest.raises(ValueError, match="one position per rank"):
        tm.part_axis(tm.Mesh(positions, 1, 4, rank=0))
    # The scenario axis allows the mix: each row is one rank's.
    rows = tm.Mesh(positions, 2, 2, rank=0)
    assert [p.index for p in tm.part_axis(rows)] == [0, 1]
    with pytest.raises(ValueError, match="owns no position"):
        tm.part_axis(tm.Mesh(positions, 2, 2, rank=2))


def test_a_failed_position_fails_every_position():
    mesh = tm.build_mesh(1, 3, devices=["cpu"] * 3)
    positions = tm.part_axis(mesh)

    def run(pos):
        if pos.index == 1:
            raise KeyError("position 1 failed")
        return pos.sum(torch.ones(2, dtype=torch.int32))

    with pytest.raises(KeyError, match="position 1 failed"):
        tm.run_positions(positions, run)


def test_a_collective_that_times_out_raises():
    mesh = tm.build_mesh(1, 2, devices=["cpu"] * 2)
    positions = tm.part_axis(mesh, timeout=0.2)
    done = threading.Event()

    def run(pos):
        if pos.index == 0:
            done.wait(1)  # joins no collective
            return None
        return pos.sum(torch.ones(2, dtype=torch.int32))

    try:
        with pytest.raises(tm.MeshError, match="failed or timed out"):
            tm.run_positions(positions, run)
    finally:
        done.set()
