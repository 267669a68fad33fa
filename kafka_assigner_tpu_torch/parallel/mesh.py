"""The ``(scenarios, part)`` device mesh — the port of
``kafka_assigner_tpu/parallel/mesh.py``, with the same names: ``build_mesh``
(:28), ``scenario_sharding`` (:50), ``put_sharded`` (:56), ``fetch_global``
(:73), ``replicated`` (:82) and ``initialize_distributed`` (:86).

Two axes, as in the reference:

- ``scenarios``, the data-parallel axis: independent what-if scenarios,
  each position sweeping its contiguous block of them
  (``parallel/whatif.py``);
- ``part``, the partition axis of one solve: each position holds a
  contiguous block of every topic's partition rows and places it through
  the part-axis group of its mesh row (:func:`part_axis`), whose
  collectives the placement calls where it crosses partitions
  (``ops/assignment.py``; ``TorchSolver(mesh=)``).

A position is a (rank, ``torch.device``) pair: the rank of the process that
runs it and the device it runs on. One process may own several positions
(a thread each), and several positions may share one device: that is how
the CPU tests get eight positions and one card runs a mesh of two or four.
``torch.distributed.device_mesh.DeviceMesh`` cannot stand in for this
class: it needs a rank per position.

Across processes, :func:`initialize_distributed` starts the process group
(``nccl`` when every rank of the host has a card of its own, else ``gloo``,
which stages CUDA tensors through host memory), and :func:`build_mesh`
builds one mesh over every rank's local devices in rank order, as
``jax.devices()`` lists the global devices of a multi-process JAX run. A
collective that fails or outlasts :data:`COLLECTIVE_TIMEOUT_S` raises;
nothing falls back to an unsharded solve.
"""
from __future__ import annotations

import datetime
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("scenarios", "part")

#: Seconds a collective waits for the other positions before it raises.
COLLECTIVE_TIMEOUT_S = 600.0


class MeshError(RuntimeError):
    """A collective of the mesh failed, timed out or was abandoned."""


class Position(NamedTuple):
    """One mesh position: the process (rank) that runs it and its device."""

    rank: int
    device: torch.device


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks of the process group (1 without one)."""
    return dist.get_world_size() if _distributed() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _distributed() else 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def _staged() -> bool:
    """Whether collectives stage tensors through host memory (``gloo``)."""
    return dist.get_backend() == "gloo"


def _collective_device() -> torch.device:
    """Where a tensor must be for a collective of the default group."""
    if _staged():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def visible_devices(device: str | torch.device = "cuda") -> List[torch.device]:
    """This process's local device list for ``device``'s type: ``[cpu]``
    for the CPU; for ``cuda`` every visible card, or under a process group
    of more than one rank this rank's card (its local rank modulo the cards:
    ranks share a card when there are fewer cards than ranks); none without
    a card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        return []
    n = torch.cuda.device_count()
    if process_count() > 1:
        return [torch.device("cuda", _local_rank() % n)]
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A ``(scenarios, part)`` grid of :class:`Position` s. ``devices`` is
    the grid (an object array), ``shape`` maps each axis name to its size,
    as a ``jax.sharding.Mesh``'s does, and ``rank`` is this process's."""

    axis_names = AXES

    def __init__(self, positions: Sequence[Position], n_scenarios: int, n_part: int,
                 rank: int) -> None:
        grid = np.empty(len(positions), dtype=object)
        grid[:] = list(positions)
        self.devices = grid.reshape(n_scenarios, n_part)
        self.rank = rank
        self._groups: Optional[Dict[int, object]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def owned(self) -> List[Tuple[Tuple[int, int], Position]]:
        """This process's positions with their (row, column)."""
        return [((int(r), int(c)), pos) for (r, c), pos in np.ndenumerate(self.devices)
                if pos.rank == self.rank]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, "
                f"{[(p.rank, str(p.device)) for p in self.devices.flat]})")


def build_mesh(
    n_scenarios_axis: Optional[int] = None,
    n_part_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(scenarios, part)`` mesh over the available devices.

    ``devices`` is this process's local list (default
    :func:`visible_devices`: the visible cards); it may repeat a device,
    which puts several positions on it. Under a process group of more than
    one rank the global list is every rank's local list in rank order,
    exchanged once. Every position goes on the scenario axis by default;
    pass ``n_part_axis > 1`` to shard the partition axis of one solve.
    Raises ``ValueError`` when the grid does not match the device count."""
    local = [torch.device(d) for d in (devices if devices is not None
                                       else visible_devices())]
    if not local:
        raise RuntimeError(
            "build_mesh: no device: no CUDA device is available; pass CPU "
            "devices to run on the CPU"
        )
    rank = process_index()
    if process_count() > 1:
        lists: List = [None] * process_count()
        dist.all_gather_object(lists, [str(d) for d in local])
        positions = [Position(r, torch.device(d)) for r, ds in enumerate(lists)
                     for d in ds]
    else:
        positions = [Position(0, d) for d in local]
    if n_scenarios_axis is None:
        n_scenarios_axis = len(positions) // n_part_axis
    if n_scenarios_axis * n_part_axis != len(positions):
        raise ValueError(
            f"mesh {n_scenarios_axis}x{n_part_axis} != {len(positions)} devices"
        )
    return Mesh(positions, n_scenarios_axis, n_part_axis, rank)


def auto_mesh(device: str | torch.device = "cuda") -> Optional[Mesh]:
    """The mesh a what-if sweep on ``device`` spreads over when the caller
    names none (``RANK_DECOMMISSION``): every position of
    :func:`visible_devices` on the scenario axis, one a card in one process,
    when there is more than one visible device or more than one rank; else
    None, the unsharded sweep."""
    local = visible_devices(device)
    if len(local) > 1 or process_count() > 1:
        return build_mesh(devices=local)
    return None


class Sharding(NamedTuple):
    """A mesh and a spec: per leading dimension the axis it is split over,
    or None (the ``NamedSharding(mesh, PartitionSpec(...))`` of the
    reference); an empty spec replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def scenario_sharding(mesh: Mesh) -> Sharding:
    """Per-scenario arrays: the leading axis split over ``scenarios``,
    everything else replicated."""
    return Sharding(mesh, ("scenarios",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def block_bounds(n: int, k: int, i: int) -> Tuple[int, int]:
    """``[lo, hi)`` of block ``i`` of ``n`` rows split into ``k`` contiguous
    blocks of ceil(n / k) rows (the last ones shorter or empty)."""
    blk = -(-n // k) if k else 0
    return min(i * blk, n), min((i + 1) * blk, n)


class Sharded:
    """An array split along ``dim`` over a mesh axis: ``blocks`` maps each
    block this process holds to ``(position, tensor)``, the tensor on that
    position's device. A block held by several of this process's positions
    (the positions of one row hold the same scenario block) is held once, by
    the first. ``length`` is the global extent of ``dim``."""

    def __init__(self, mesh: Mesh, axis: Optional[str], dim: int, length: int,
                 blocks: Dict[int, Tuple[Position, torch.Tensor]]) -> None:
        self.mesh, self.axis, self.dim, self.length = mesh, axis, dim, length
        self.blocks = blocks

    @property
    def n_blocks(self) -> int:
        return self.mesh.shape[self.axis] if self.axis else 1

    def bounds(self, b: int) -> Tuple[int, int]:
        return block_bounds(self.length, self.n_blocks, b)


def owned_blocks(mesh: Mesh, axis: Optional[str]) -> Dict[int, Position]:
    """Each block along ``axis`` this process holds, with the first of its
    positions that holds it."""
    out: Dict[int, Position] = {}
    for (r, c), pos in mesh.owned():
        b = 0 if axis is None else (r if axis == "scenarios" else c)
        out.setdefault(b, pos)
    return out


def _block_owner(mesh: Mesh, axis: Optional[str], b: int) -> int:
    """The lowest rank holding block ``b``: the one whose copy is fetched."""
    if axis is None:
        return int(min(p.rank for p in mesh.devices.flat))
    line = mesh.devices[b] if axis == "scenarios" else mesh.devices[:, b]
    return int(min(p.rank for p in line))


def put_sharded(array, mesh: Mesh, spec: Sequence[Optional[str]]) -> Sharded:
    """Place host data on the mesh: every process holds the full host array
    and hands each block it holds to its position's device (the
    reference's ``make_array_from_callback`` feeding). ``spec`` names at
    most one split dimension; an empty spec replicates (one block)."""
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(np.asarray(array))
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    if len(named) > 1:
        raise ValueError(f"put_sharded splits one dimension, not {tuple(spec)}")
    dim, axis = named[0] if named else (0, None)
    if axis is not None and axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")
    length = t.shape[dim] if t.dim() else 1
    out = Sharded(mesh, axis, dim, length, {})
    for b, pos in owned_blocks(mesh, axis).items():
        lo, hi = out.bounds(b)
        block = t.narrow(dim, lo, hi - lo) if axis else t
        out.blocks[b] = (pos, block.to(pos.device))
    return out


def fetch_global(x) -> np.ndarray:
    """Materialize a (possibly cross-process) :class:`Sharded` array as a
    host array in every process: the blocks in order, each across ranks by
    one ``all_gather`` (the blocks padded to equal length, trimmed after).
    A tensor or host array comes back as a host array."""
    if not isinstance(x, Sharded):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    n_blocks = x.n_blocks
    if process_count() == 1:
        parts = [x.blocks[b][1].cpu() for b in range(n_blocks)]
        return torch.cat(parts, x.dim).numpy() if x.axis else parts[0].numpy()
    some = next(iter(x.blocks.values()))[1]
    blk = -(-x.length // n_blocks) if x.axis else x.length
    rest = list(some.movedim(x.dim, 0).shape[1:]) if x.axis else list(some.shape)
    dev = _collective_device()
    mine = torch.zeros([n_blocks, blk] + rest if x.axis else [1] + rest,
                       dtype=some.dtype, device=dev)
    for b, (_, t) in x.blocks.items():
        if x.axis:
            t = t.movedim(x.dim, 0)
            mine[b, : t.shape[0]] = t.to(dev)
        else:
            mine[0] = t.to(dev)
    flag = mine.dtype == torch.bool  # gathered as bytes
    got = [torch.empty_like(mine, dtype=torch.uint8 if flag else None)
           for _ in range(process_count())]
    dist.all_gather(got, mine.to(torch.uint8) if flag else mine)
    got = [g.bool() for g in got] if flag else got
    if not x.axis:
        return got[_block_owner(x.mesh, None, 0)][0].cpu().numpy()
    parts = []
    for b in range(n_blocks):
        lo, hi = x.bounds(b)
        parts.append(got[_block_owner(x.mesh, x.axis, b)][b, : hi - lo])
    return torch.cat(parts, 0).movedim(0, x.dim).cpu().numpy()


def gather_blocks(mesh: Mesh, axis: str, values: Dict[int, object]) -> Dict[int, object]:
    """Each block's host object (a record, a dict) in every process:
    ``values`` holds this process's blocks; the copy of the lowest rank
    that holds a block wins, as in :func:`fetch_global`."""
    if process_count() == 1:
        return dict(values)
    lists: List = [None] * process_count()
    dist.all_gather_object(lists, values)
    return {b: lists[_block_owner(mesh, axis, b)][b] for b in range(mesh.shape[axis])
            if b in lists[_block_owner(mesh, axis, b)]}


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start the process group (one process per rank): ``tcp://`` at
    ``coordinator_address`` (``host:port``; default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` ranks (``WORLD_SIZE``), this one
    ``process_id`` (``RANK``), with :data:`COLLECTIVE_TIMEOUT_S` as the
    group's timeout. ``nccl`` when every rank on the host has a card of its
    own (``LOCAL_WORLD_SIZE``, default every rank, at most the visible
    cards), else ``gloo``: on the CPU, and for ranks that share a card,
    which NCCL refuses. A no-op when a group is already up; a failed start
    raises."""
    if _distributed():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    nccl = (torch.cuda.is_available() and dist.is_nccl_available()
            and local_world <= torch.cuda.device_count())
    if nccl:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if nccl else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )


# ---------------------------------------------------------------------------
# The part-axis group: the collectives a partition-sharded placement calls.
# ---------------------------------------------------------------------------


class _ThreadGroup:
    """The part axis of one mesh row whose positions this process owns: a
    thread per position, shared slots and a barrier. Each collective posts
    the caller's tensor, waits for every position's, and copies what it
    reads to the caller's device. A barrier that breaks (a position failed,
    or a wait outlasted ``timeout``) raises :class:`MeshError` in every
    position."""

    def __init__(self, devices: Sequence[torch.device],
                 timeout: float = COLLECTIVE_TIMEOUT_S) -> None:
        self.devices = list(devices)
        self._slots: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        self._barrier = threading.Barrier(len(self.devices), timeout=timeout)

    def abort(self) -> None:
        self._barrier.abort()

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MeshError("part-axis collective failed or timed out") from None

    def exchange(self, index: int, x: torch.Tensor) -> List[torch.Tensor]:
        self._slots[index] = x
        self._wait()
        got = [t.to(self.devices[index]) for t in self._slots]
        self._wait()  # every position has read the slots
        return got


class _DistGroup:
    """The part axis of one mesh row of one position per rank: collectives
    of ``torch.distributed`` on a subgroup of the row's ranks. Under
    ``gloo`` every tensor goes through host memory (a CUDA tensor is copied
    out and back)."""

    def __init__(self, group, device: torch.device) -> None:
        self.group = group
        self.device = device
        self.staged = _staged()

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.staged else x.contiguous()

    def exchange(self, index: int, x: torch.Tensor) -> List[torch.Tensor]:
        x = self._out(x)
        got = [torch.empty_like(x) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(got, x, group=self.group)
        return [t.to(self.device) for t in got]

    def abort(self) -> None:
        """Nothing to release: a failed peer makes the group's next
        collective raise."""


class PartPosition:
    """One position of a part axis: its ``index`` on the axis, the axis's
    ``size``, its ``device``, and the four collectives a partition-sharded
    placement calls. ``collectives`` counts this position's calls."""

    def __init__(self, group, index: int, size: int, device: torch.device) -> None:
        self.group, self.index, self.size, self.device = group, index, size, device
        self.collectives = 0

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        self.collectives += 1
        return self.group.exchange(self.index, x)

    def exclusive_prefix(self, counts: torch.Tensor) -> torch.Tensor:
        """What the positions before this one hold: the sum of their
        ``counts``, zeros on the first."""
        got = self._exchange(counts)
        out = torch.zeros_like(got[0])
        for t in got[: self.index]:
            out += t
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        got = self._exchange(x)
        out = got[0].clone()
        for t in got[1:]:
            out += t
        return out

    def any(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(x)).any(0)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every position's ``x`` concatenated along ``dim``, in axis
        order (the blocks are of equal size)."""
        return torch.cat(self._exchange(x), dim)


def part_axis(mesh: Mesh, timeout: float = COLLECTIVE_TIMEOUT_S) -> List[PartPosition]:
    """This process's positions on the part axis of its first mesh row: every
    position of the row when the process owns the whole row (a thread
    each, a new in-process group each call), or its one position when the
    row has one position per rank (a ``torch.distributed`` subgroup, made
    once per mesh: every rank makes every row's subgroup in the same order,
    as ``new_group`` requires). A part axis of several ranks that each own
    several positions raises ``ValueError``; so does a process that owns no
    position."""
    rows = [list(mesh.devices[r]) for r in range(mesh.devices.shape[0])]
    for row in rows:
        ranks = [p.rank for p in row]
        if len(set(ranks)) > 1 and len(set(ranks)) != len(ranks):
            raise ValueError(
                "a part axis over several ranks needs one position per rank; "
                f"this row has ranks {ranks}"
            )
    if mesh._groups is None:
        mesh._groups = {}
        for r, row in enumerate(rows):
            ranks = [p.rank for p in row]
            if len(set(ranks)) > 1:
                mesh._groups[r] = dist.new_group(
                    ranks=ranks, timeout=datetime.timedelta(seconds=timeout))
    for r, row in enumerate(rows):
        ranks = [p.rank for p in row]
        if mesh.rank not in ranks:
            continue
        if r in mesh._groups:
            i = ranks.index(mesh.rank)
            group = _DistGroup(mesh._groups[r], row[i].device)
            return [PartPosition(group, i, len(row), row[i].device)]
        group = _ThreadGroup([p.device for p in row], timeout)
        return [PartPosition(group, i, len(row), p.device) for i, p in enumerate(row)]
    raise ValueError(f"rank {mesh.rank} owns no position of {mesh!r}")


def run_positions(positions: Sequence, fn: Callable) -> List:
    """``fn(position)`` for each of this process's positions, a thread each
    when there are several; the results in order. A position that raises
    breaks its group's barrier, so the others raise too instead of waiting,
    and the first position's own error is raised here."""
    if len(positions) == 1:
        return [fn(positions[0])]
    results: List = [None] * len(positions)
    errors: List[Optional[BaseException]] = [None] * len(positions)

    def run(i: int) -> None:
        try:
            results[i] = fn(positions[i])
        except BaseException as e:  # re-raised below, in the caller's thread
            errors[i] = e
            group = getattr(positions[i], "group", None)
            if group is not None:
                group.abort()

    threads = [threading.Thread(target=run, args=(i,), name=f"ka-mesh-{i}", daemon=True)
               for i in range(len(positions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and not isinstance(e, MeshError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results

