"""The PyTorch/CUDA solver: host encode → placement on the device → the
leadership kernel → host decode. The counterpart of
``kafka_assigner_tpu/solvers/tpu.py:TpuSolver`` (``assign_many`` :377 and
``assign`` :309) with the same invariants and byte-identical output:

- sticky fill reproduces the reference's decisions (movement parity);
- orphans are placed by the reference package's ``auto`` leg chain
  (``ops/assignment.py``);
- leadership ordering is bit-identical (``ops/leadership.py``), carried
  across topics through one counter slab in topic order;
- an infeasible solve raises "Partition N could not be fully assigned!"
  and leaves the ``Context`` untouched;
- under ``KA_RF_DECREASE_COMPAT=1`` on an RF decrease, placement, the
  counter slab, leadership and decode all run as wide as the current
  replica lists (``solvers/tpu.py:495-507``). The reference orders such
  rows off its Pallas kernel; the CUDA kernel here takes them at
  ``rf = width`` (1..32), pinned against the plain version;
- :meth:`TorchSolver.fresh_assignment` places a topic from scratch with the
  ``fresh`` chain (``solvers/tpu.py:856``), ordered by the same kernel;
- ``KA_LEADERSHIP=native`` orders on the host instead, through the C++ pass
  ``native/leadership.py:order_many`` after a copy of the placement to the
  host, as the reference's ``_order_placed`` (``solvers/tpu.py:826-845``)
  and ``fresh_assignment`` (:893-925) do; the bytes are the same;
- the batched encode and decode take the C boundary codec under
  ``KA_HOSTCODEC`` (``models/problem.py``); ``assign_many`` takes mode 3's
  streamed ``preencoded`` group and skips its own encode
  (``solvers/tpu.py:440-475``);
- on a daemon request thread under the dispatch plane
  (``daemon/dispatch.py``), ``assign_many`` sends its placement rows to the
  dispatcher as one row job (the reference's ``_place_routed``,
  ``solvers/tpu.py:754-822``): distinct plans whose encodings agree in
  shape, statics and rack bytes share one ``place_batched`` call on the
  dispatcher thread, each plan takes its own rows back (placement is
  independent per row) and orders its leaders on its request thread, K1 or
  the host pass, on the device's default stream as the placement;
- ``TorchSolver(mesh=)`` shards the partition axis over the mesh's ``part``
  axis, as ``TpuSolver(mesh=)`` does (``solvers/tpu.py:521-530``): the
  batch is padded to tile the axis, each position places its block of
  rows through its part-axis group (``parallel/mesh.py:part_axis``, a
  thread per position this process owns), gathers the placement, and
  orders leaders on the whole of it (K1, or the host pass under
  ``KA_LEADERSHIP=native``), so every process returns the same
  assignments. No routing through the dispatcher under a mesh, as the
  reference routes none (:549, :669); ``fresh_assignment`` stays
  unsharded, as the reference's does;
- observability as the reference's (``solvers/tpu.py:321-329``, :414-494,
  :552, :612, :878-880): ``fault_point("solve")`` before any work of
  ``assign`` and ``assign_many``, the ``solver.assign_calls`` and
  ``solver.fresh_calls`` counters, and on the batched path the spans
  ``encode`` (the same clock as ``last_timers["encode"]``), ``solve``
  (placement and leadership) and ``decode`` (the same clock as
  ``last_timers["decode"]``), with the ``encode.*`` gauges. On every path
  each phase is a span, and so, under ``torch.profiler``, a label on the
  profiler's clock: ``ka/encode``, ``ka/solve``, within it ``ka/place``
  and ``ka/leadership`` (the port's own, kept out of the report), and
  ``ka/decode``.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, List, Mapping, Sequence, Set

import numpy as np
import torch

from ..carry import to_tensor
from ..faults.inject import fault_point
from ..models import problem
from ..models.problem import (
    apply_counter_updates,
    context_to_array,
    decode_assignments_batched,
    encode_cluster,
    encode_problem,
    encode_topic_group,
)
from ..native.leadership import leadership_backend, order_many
from ..obs.metrics import counter_add, gauge_set, obs_active
from ..obs.trace import span
from ..ops.assignment import WAVE_MODES, PlaceResult, host_read, host_reads, place_batched
from ..ops.leadership import leadership_order
from ..utils.env import env_bool, env_choice, env_int
from ..utils.logging import get_logger
from .base import Context


def rf_compat_enabled() -> bool:
    return env_bool("KA_RF_DECREASE_COMPAT")


def wave_mode() -> str:
    """``KA_WAVE_MODE``; default ``auto``, or ``seq`` under
    ``KA_RF_DECREASE_COMPAT=1`` (the reference's ``solver_tuning``)."""
    default = "seq" if rf_compat_enabled() else "auto"
    return env_choice("KA_WAVE_MODE", choices=tuple(WAVE_MODES), default=default)


def leader_chunk(p_pad: int) -> int:
    """``KA_LEADER_CHUNK``, resolved like the reference's ``leadership_order``
    (8 when it tiles P_pad, else 1; a requested chunk that does not tile
    P_pad is refused loudly). Semantics-invariant: the plain version reads
    its rows in blocks of this many; the kernel, one launch per batch, has
    no chunk."""
    default = 8 if p_pad % 8 == 0 else 1
    chunk = env_int("KA_LEADER_CHUNK")
    if chunk is None:
        return default
    if p_pad % chunk != 0:
        print(
            f"kafka-assigner: leader chunk {chunk} does not divide "
            f"p_pad={p_pad}; using {default}",
            file=sys.stderr,
        )
        return default
    return chunk


def solve_device(device: str | torch.device, who: str = "TorchSolver") -> torch.device:
    """``device`` as a ``torch.device``; raises when it is ``cuda`` and no
    card is present, or neither ``cuda`` nor ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to run "
            "on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on cuda or cpu, not {device}")
    return device


class TorchSolver:
    """Solver-protocol implementation on PyTorch tensors.

    ``device`` defaults to ``cuda`` and the constructor raises when no card
    is present; pass ``device="cpu"`` to run the plain versions on the CPU
    (the tests do). ``mesh`` (``parallel/mesh.py:build_mesh``) with a
    ``part`` axis of more than one position shards the partition axis of
    :meth:`assign` and :meth:`assign_many` over it; each position runs on
    its own device."""

    #: ``assign_many`` takes one batch of topics of different replication
    #: factors (``TopicAssigner.generate_assignments`` reads this).
    supports_mixed_rf = True

    #: The lane's name in the best-effort fallback's stderr line.
    name = "device"

    def __init__(self, device: str | torch.device = "cuda", mesh=None) -> None:
        self.device = solve_device(device)
        self.mesh = mesh
        #: phase wall-clock (ms) of the most recent solve: encode, place,
        #: leadership, decode; each phase ends in a device synchronize. In a
        #: daemon under the dispatch plane ``place`` includes the queue wait,
        #: and a synchronize also waits for other requests' device work.
        #: Under a ``torch.profiler`` session on the solving thread, and
        #: where placement ran on that thread (unsharded, not packed by the
        #: dispatcher), ``place_wait``: the part of ``place`` the host spent
        #: blocked in reads of the device (``ops/assignment.py:host_read``,
        #: the read of the infeasible flags too). ``TopicAssigner`` adds
        #: ``infer`` and, under a profiler, ``gc``.
        self.last_timers: Dict[str, float] = {}
        #: batched waves per leg of the most recent placement.
        self.last_waves: Dict[str, int] = {}
        #: where the most recent solve ordered leaders: ``native`` (the host
        #: C++ pass), ``cuda`` (the kernel) or ``plain`` (its plain version
        #: on the CPU).
        self.last_leadership: str | None = None
        #: which codec the most recent solve's encode and decode took:
        #: ``{"encode": "c" | "numpy", "decode": "c" | "numpy"}``; encode is
        #: ``"preencoded"`` when the solve took a streamed preencode.
        self.last_codec: Dict[str, str] = {}
        #: collectives one position of the most recent part-sharded solve
        #: ran (placement and gather); None after an unsharded solve.
        self.last_collectives: int | None = None

    def _sync(self, device: torch.device | None = None) -> None:
        device = self.device if device is None else device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return to_tensor(a, self.device)

    def assign(
        self,
        topic: str,
        current_assignment: Mapping[int, Sequence[int]],
        rack_assignment: Mapping[int, str],
        nodes: Set[int],
        partitions: Set[int],
        replication_factor: int,
        context: Context | None = None,
    ) -> Dict[int, List[int]]:
        """Solve one topic (``partitions`` missing from the current
        assignment are placed from scratch)."""
        # Crash injection (KA_FAULTS_SPEC solve:i=crash): the device-failure
        # stand-in the fallback chain is tested against.
        fault_point("solve")
        counter_add("solver.assign_calls")
        if context is None:
            context = Context()

        def encode():
            enc = encode_problem(
                topic, current_assignment, rack_assignment, nodes, partitions,
                replication_factor,
            )
            return [enc], _single(enc)

        (_, out), = self._solve(encode, [replication_factor], context)
        return out

    def assign_many(
        self,
        named_currents: Sequence[tuple],  # [(topic, current_assignment), ...]
        rack_assignment: Mapping[int, str],
        nodes: Set[int],
        replication_factor,  # int, or Sequence[int] per topic (mixed RF)
        context: Context | None = None,
        preencoded: tuple | None = None,
    ) -> List[tuple]:
        """Solve a group of topics together, returning ``[(topic,
        assignment), ...]`` in input order; identical to solving them
        serially in that order (the leadership counters carry across
        topics). Topics of different replication factors share the batch
        through the per-topic ``rfs`` lane.

        ``preencoded``: an :func:`encode_topic_group`-shaped ``(encs,
        currents, jhashes, p_reals)`` for exactly these topics in this
        order, built while the metadata streamed in
        (``generator.stream_initial_assignment``), as the reference's
        (``solvers/tpu.py:440-475``). The encode phase then checks it
        against the batch (topic order, and the broker set and rack map it
        was built on: a stale preencode raises, never solves) and stamps
        the real ``rf`` values; ``last_codec["encode"]`` says
        ``"preencoded"``."""
        fault_point("solve")
        if context is None:
            context = Context()
        if not named_currents:
            return []
        if isinstance(replication_factor, int):
            rf_list = [replication_factor] * len(named_currents)
        else:
            rf_list = [int(r) for r in replication_factor]

        def encode():
            if preencoded is not None:
                encs, currents, jhashes, p_reals = _checked_preencode(
                    preencoded, named_currents, rack_assignment, nodes, rf_list
                )
            else:
                encs, currents, jhashes, p_reals = encode_topic_group(
                    named_currents, rack_assignment, nodes, rf_list
                )
            if obs_active():
                # Bucketing cost, per run: the padding share of the (B, P)
                # slab.
                cells = int(currents.shape[0]) * int(currents.shape[1])
                real = int(np.asarray(p_reals, dtype=np.int64).sum())
                gauge_set(
                    "encode.pad_waste_frac",
                    round(1.0 - real / cells, 6) if cells else 0.0,
                )
                gauge_set("encode.topics", len(encs))
                gauge_set("encode.p_pad", int(currents.shape[1]))
            return encs, (currents, jhashes, p_reals)

        out = self._solve(encode, rf_list, context, record=True)
        if preencoded is not None:
            self.last_codec["encode"] = "preencoded"
        return out

    def fresh_assignment(
        self,
        topic: str,
        partitions: Sequence[int] | int,
        nodes: Set[int],
        rack_assignment: Mapping[int, str],
        replication_factor: int,
        context: Context | None = None,
    ) -> Dict[int, List[int]]:
        """Place a topic from scratch (no current assignment): empty
        replica lists through the same encode, the ``fresh`` leg chain
        (capacity-greedy balance first, first-fit legs behind it), then the
        leadership kernel against ``context``. ``partitions`` is a count or
        the partition ids."""
        counter_add("solver.fresh_calls")
        if isinstance(partitions, int):
            partitions = list(range(partitions))
        if context is None:
            context = Context()

        def encode():
            current = {int(p): [] for p in partitions}
            enc = encode_problem(
                topic, current, rack_assignment, nodes, set(current),
                replication_factor,
            )
            return [enc], _single(enc)

        (_, out), = self._solve(encode, [replication_factor], context, fresh=True)
        return out

    def _solve(self, encode, rf_list, context, fresh: bool = False,
               record: bool = False) -> List[tuple]:
        """Encode, place, order and decode. ``encode()`` returns ``(encs,
        (currents, jhashes, p_reals))``. ``fresh`` runs the ``fresh`` chain
        and never the compat width, as the reference's ``fresh_assignment``
        does. ``record`` puts the phases in the run report (the batched
        path, where the reference's ``assign_many`` has its spans)."""
        timers = {}
        self.last_timers = timers
        log = get_logger("timers") if record else None
        # Resolved first: KA_LEADERSHIP=native without its library raises
        # before any placement work.
        native_order = leadership_backend() == "native"
        with span("encode", sink=timers, log=log, report=record):
            encs, (currents, jhashes, p_reals) = encode()
            rf_max = max(rf_list)
            # Compat slot width: on an RF decrease under
            # KA_RF_DECREASE_COMPAT the current lists are wider than rf_max
            # and every slot can survive sticky, so the whole pipeline runs
            # `width` wide.
            width = None
            if not fresh and rf_compat_enabled() and currents.shape[2] > rf_max:
                width = currents.shape[2]
            # The counter slab spans the widest RF of the group (the widest
            # slot under compat); a narrower topic touches only its own
            # leading slots.
            enc_slab = dataclasses.replace(encs[0], rf=width or rf_max)
            counters_before = context_to_array(context, enc_slab)
            b_real = len(encs)
            rfs_np, rfs = None, None
            if any(r != rf_max for r in rf_list):
                rfs_np = np.full(currents.shape[0], rf_max, dtype=np.int32)
                rfs_np[:b_real] = rf_list
                rfs = self._t(rfs_np)
            cur_t, rack_t = self._t(currents), self._t(encs[0].rack_idx)
            jh_t, pr_t = self._t(jhashes), self._t(p_reals)
            counters_t = None if native_order else self._t(counters_before)
            self._sync()

        with span("solve", log=log, report=record):
            mode = "fresh" if fresh else wave_mode()
            self.last_collectives = None
            sharded = self._part_sharded(fresh)
            if sharded:
                placed, order_out = self._solve_part(
                    currents, encs[0], jhashes, p_reals, rf_max, mode, rfs_np, width,
                    b_real, counters_before, native_order,
                )
                infeasible = placed.infeasible[:b_real].cpu().numpy()
            else:
                with span("place", sink=timers, report=False), host_reads() as reads:
                    # The batched path of a daemon request under the
                    # dispatch plane places through the dispatcher (the
                    # reference routes assign_many only); None: no
                    # dispatcher routes.
                    placed = (self._place_routed(currents, encs[0], jhashes, p_reals,
                                                 rf_max, mode, rfs_np, width)
                              if record and not fresh else None)
                    routed = placed is not None
                    if not routed:
                        placed = place_batched(
                            cur_t, rack_t, jh_t, pr_t, encs[0].n, rf_max, mode, rfs,
                            r_cap=encs[0].r_cap, width=width,
                        )
                    infeasible = host_read(torch.Tensor.cpu,
                                           placed.infeasible[:b_real]).numpy()
                if reads is not None and not routed:
                    timers["place_wait"] = reads.wait
            self.last_waves = placed.waves
            if not infeasible.any():
                ordered, counters_after = order_out if sharded else self._order(
                    placed, b_real, jhashes, p_reals, counters_before,
                    counters_t, jh_t, native_order, currents.shape[1],
                )
        if infeasible.any():
            # Raised after the solve phase, as the reference raises it.
            b = int(np.argmax(infeasible))
            bad = int(np.argmax(placed.deficit[b].cpu().numpy() > 0))
            raise ValueError(
                f"Partition {int(encs[b].partition_ids[bad])} could not be "
                "fully assigned!"
            )

        with span("decode", sink=timers, log=log, report=record):
            if isinstance(ordered, torch.Tensor):
                ordered = ordered.cpu().numpy()
                counters_after = counters_after.cpu().numpy()
            apply_counter_updates(context, enc_slab, counters_before, counters_after)
            # Compat decodes every slot, so retained replicas past the RF
            # survive and rows shorter than `width` come out shorter.
            decoded = decode_assignments_batched(
                encs if width is None
                else [dataclasses.replace(e, rf=width) for e in encs],
                ordered,
            )
        self.last_codec = dict(problem.last_codec)
        return [(enc.topic, a) for enc, a in zip(encs, decoded)]

    def _part_sharded(self, fresh: bool) -> bool:
        """Whether this solve shards the partition axis: a mesh with a part
        axis of more than one position, and not a fresh placement."""
        return self.mesh is not None and not fresh and self.mesh.shape["part"] > 1

    def _solve_part(self, currents, enc, jhashes, p_reals, rf, mode, rfs_np, width,
                    b_real, counters_before, native_order):
        """The partition-sharded placement and ordering: ``P_pad`` padded
        with empty rows to tile the part axis, each of this process's
        positions placing its block (a thread each), gathering the whole
        placement and ordering it. Returns the first position's
        :class:`PlaceResult` (rows cut back to ``P_pad``) and ``(ordered,
        counters_after)`` (None when infeasible). The chain is resolved for
        the batch's own ``P_pad``, as the unsharded solve resolves it."""
        from ..parallel.mesh import part_axis, run_positions

        positions = part_axis(self.mesh)
        k = positions[0].size
        b, p_pad, w = currents.shape
        blk = -(-p_pad // k)
        tiled = np.full((b, blk * k, w), -1, dtype=currents.dtype)
        tiled[:, :p_pad] = currents
        timers = self.last_timers
        order_lock = threading.Lock()

        def position(pos):
            took = {}
            dev = pos.device
            lo = pos.index * blk
            with span("place", sink=took, report=False):
                placed = place_batched(
                    to_tensor(tiled[:, lo:lo + blk], dev), to_tensor(enc.rack_idx, dev),
                    to_tensor(jhashes, dev), to_tensor(p_reals, dev), enc.n, rf, mode,
                    None if rfs_np is None else to_tensor(rfs_np, dev),
                    r_cap=enc.r_cap, width=width, part=pos, p_pad=p_pad,
                )
                placed = PlaceResult(
                    pos.gather(placed.acc_nodes, 1)[:, :p_pad],
                    pos.gather(placed.acc_count, 1)[:, :p_pad],
                    placed.infeasible, pos.gather(placed.deficit, 1)[:, :p_pad],
                    placed.waves,
                )
                self._sync(dev)
            if pos.index == positions[0].index:
                timers["place"] = took["place"]
            if bool(placed.infeasible[:b_real].any()):
                return placed, None, pos.collectives
            # The positions order one after the other: the ordering crosses
            # no position, and the plain version's loop over rows would
            # only contend for the interpreter lock.
            with order_lock:
                return placed, self._order(
                    placed, b_real, jhashes, p_reals, counters_before,
                    None if native_order else to_tensor(counters_before, dev),
                    to_tensor(jhashes, dev), native_order, p_pad, dev,
                ), pos.collectives

        placed, order_out, self.last_collectives = run_positions(positions, position)[0]
        return placed, order_out

    def _place_routed(self, currents, enc, jhashes, p_reals, rf, mode, rfs_np,
                      width):
        """The placement's rows as one row job on the calling thread's
        dispatcher: this plan's whole (bucketed) topic batch, its rows the
        topics. The key holds everything the rows share: the shapes and
        statics, whether the batch has per-topic RFs, and the rack bytes, so
        two plans that remove different brokers never pack, two clusters
        read from one snapshot do, and a ``--topics`` subset packs with the
        whole cluster. The key hashes host arrays only. Returns the
        :class:`PlaceResult` of these rows (tensors on this solver's
        device), or None when no dispatcher routes."""
        from ..daemon.dispatch import submit_routed

        rows = {"cur": currents, "jh": jhashes, "pr": p_reals}
        if rfs_np is not None:
            rows["rfs"] = rfs_np
        statics = ("place_batched", enc.n, rf, mode, enc.r_cap, width,
                   currents.shape[1], currents.shape[2], str(currents.dtype),
                   rfs_np is None)

        def _call(r):
            # On the dispatcher thread: every tensor names the device.
            placed = place_batched(
                self._t(r["cur"]), self._t(enc.rack_idx), self._t(r["jh"]),
                self._t(r["pr"]), enc.n, rf, mode,
                None if rfs_np is None else self._t(r["rfs"]),
                r_cap=enc.r_cap, width=width,
            )
            return tuple(placed[:4]) + (placed.waves,)

        out = submit_routed("place_batched", (enc.rack_idx,), statics, rows,
                            int(currents.shape[0]), _call)
        return None if out is None else PlaceResult(*out)

    def _order(self, placed, b_real, jhashes, p_reals, counters_before,
               counters_t, jh_t, native_order, p_pad, device=None):
        """The leadership phase (``last_timers["leadership"]``, the span
        ``leadership``): the host C++ lane or the device lane (the kernel on
        cuda, its plain version on cpu) on ``device`` (default the
        solver's). Returns ``(ordered, counters_after)``."""
        device = self.device if device is None else device
        took = {}
        with span("leadership", sink=took, report=False):
            if native_order:
                # The host lane: the placement comes to the host (inside
                # this phase's time), and the counter slab is the one built
                # above, `width` wide under compat and rf_max wide in a
                # mixed-RF batch.
                self.last_leadership = "native"
                out = order_many(
                    placed.acc_nodes[:b_real].cpu().numpy(),
                    placed.acc_count[:b_real].cpu().numpy(),
                    jhashes[:b_real].astype(np.int64), p_reals[:b_real],
                    counters_before,
                )
            else:
                self.last_leadership = "cuda" if device.type == "cuda" else "plain"
                out = leadership_order(
                    placed.acc_nodes[:b_real].contiguous(),
                    placed.acc_count[:b_real].contiguous(),
                    counters_t, jh_t[:b_real].contiguous(),
                    chunk=leader_chunk(p_pad),
                )
                self._sync(device)
        self.last_timers["leadership"] = took["leadership"]
        return out


def _checked_preencode(preencoded, named_currents, rack_assignment, nodes,
                       rf_list) -> tuple:
    """A streamed preencode, checked against the batch it is to solve and
    with the real ``rf`` values stamped. The encode bakes in the broker set
    and the rack map, so a preencode built against another cluster (reused
    after a broker removal) raises instead of solving the wrong cluster."""
    encs, currents, jhashes, p_reals = preencoded
    if len(encs) != len(named_currents) or any(
        e.topic != t for e, (t, _) in zip(encs, named_currents)
    ):
        raise ValueError(
            "preencoded group does not match the topic batch "
            f"({len(encs)} encodings for {len(named_currents)} topics)"
        )
    cluster = encode_cluster(rack_assignment, nodes)
    if not (
        np.array_equal(encs[0].broker_ids, cluster.broker_ids)
        and np.array_equal(encs[0].rack_idx, cluster.rack_idx)
    ):
        raise ValueError(
            "preencoded group was built against a different broker set or "
            "rack assignment than this solve"
        )
    encs = [dataclasses.replace(e, rf=rf) for e, rf in zip(encs, rf_list)]
    return encs, currents, jhashes, p_reals


def _single(enc) -> tuple:
    """One ``encode_problem`` topic as a batch of one: ``(currents, jhashes,
    p_reals)``."""
    return (enc.current[None], np.array([enc.jhash], np.int32),
            np.array([enc.p], np.int32))
