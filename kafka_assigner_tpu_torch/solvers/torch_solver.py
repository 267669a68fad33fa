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
- observability as the reference's (``solvers/tpu.py:321-329``, :414-494,
  :552, :612, :878-880): ``fault_point("solve")`` before any work of
  ``assign`` and ``assign_many``, the ``solver.assign_calls`` and
  ``solver.fresh_calls`` counters, and on the batched path the spans
  ``encode`` (the same clock as ``last_timers["encode"]``), ``solve``
  (placement and leadership) and ``decode`` (the same clock as
  ``last_timers["decode"]``), with the ``encode.*`` gauges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
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
from ..ops.assignment import WAVE_MODES, place_batched
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


@contextlib.contextmanager
def _phase(name: str, sink, record: bool, log=None):
    """One solve phase: an obs span on the batched path (``record``), where
    the reference's ``assign_many`` has one, else a plain timer; either way
    the phase's wall ms land in ``sink`` (``last_timers``) when given."""
    if record:
        with span(name, sink=sink, log=log):
            yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


class TorchSolver:
    """Solver-protocol implementation on PyTorch tensors.

    ``device`` defaults to ``cuda`` and the constructor raises when no card
    is present; pass ``device="cpu"`` to run the plain versions on the CPU
    (the tests do)."""

    #: ``assign_many`` takes one batch of topics of different replication
    #: factors (``TopicAssigner.generate_assignments`` reads this).
    supports_mixed_rf = True

    #: The lane's name in the best-effort fallback's stderr line.
    name = "device"

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = solve_device(device)
        #: phase wall-clock (ms) of the most recent solve: encode, place,
        #: leadership, decode; each phase ends in a device synchronize.
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        does. ``record`` makes the phases obs spans (the batched path)."""
        timers = {}
        self.last_timers = timers
        log = get_logger("timers") if record else None
        # Resolved first: KA_LEADERSHIP=native without its library raises
        # before any placement work.
        native_order = leadership_backend() == "native"
        with _phase("encode", timers, record, log):
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
            rfs = None
            if any(r != rf_max for r in rf_list):
                rfs_np = np.full(currents.shape[0], rf_max, dtype=np.int32)
                rfs_np[:b_real] = rf_list
                rfs = self._t(rfs_np)
            cur_t, rack_t = self._t(currents), self._t(encs[0].rack_idx)
            jh_t, pr_t = self._t(jhashes), self._t(p_reals)
            counters_t = None if native_order else self._t(counters_before)
            self._sync()

        with _phase("solve", None, record, log):
            t0 = time.perf_counter()
            placed = place_batched(
                cur_t, rack_t, jh_t, pr_t, encs[0].n, rf_max,
                "fresh" if fresh else wave_mode(), rfs, r_cap=encs[0].r_cap,
                width=width,
            )
            self.last_waves = placed.waves
            infeasible = placed.infeasible[:b_real].cpu().numpy()
            timers["place"] = (time.perf_counter() - t0) * 1e3
            if not infeasible.any():
                ordered, counters_after = self._order(
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

        with _phase("decode", timers, record, log):
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

    def _order(self, placed, b_real, jhashes, p_reals, counters_before,
               counters_t, jh_t, native_order, p_pad):
        """The leadership phase (``last_timers["leadership"]``): the host C++
        lane or the device lane (the kernel on cuda, its plain version on
        cpu). Returns ``(ordered, counters_after)``."""
        t0 = time.perf_counter()
        if native_order:
            # The host lane: the placement comes to the host (inside this
            # phase's time), and the counter slab is the one built above,
            # `width` wide under compat and rf_max wide in a mixed-RF batch.
            self.last_leadership = "native"
            out = order_many(
                placed.acc_nodes[:b_real].cpu().numpy(),
                placed.acc_count[:b_real].cpu().numpy(),
                jhashes[:b_real].astype(np.int64), p_reals[:b_real],
                counters_before,
            )
        else:
            self.last_leadership = "cuda" if self.device.type == "cuda" else "plain"
            out = leadership_order(
                placed.acc_nodes[:b_real].contiguous(),
                placed.acc_count[:b_real].contiguous(),
                counters_t, jh_t[:b_real].contiguous(),
                chunk=leader_chunk(p_pad),
            )
            self._sync()
        self.last_timers["leadership"] = (time.perf_counter() - t0) * 1e3
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
