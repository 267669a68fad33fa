"""The C++ greedy solver (``--solver native``): ``native/greedy.cpp`` behind
the solver interface, a copy of ``kafka_assigner_tpu/solvers/native.py``
with its ``native.*`` counters and ``native/assign_many`` span.

Its choices are the Python oracle's (``solvers/greedy.py``: the same five
phases and tie-breaks), but for the RF-decrease clamp it shares with the
device solver; ``KA_RF_DECREASE_COMPAT=1`` lifts the clamp to the
reference's unbounded retention, as it does on the device solver. It is the
single-thread native baseline that ``scripts/torch_bench.py`` times the
device solve against.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Mapping, Sequence, Set, Tuple

import numpy as np

from ..models.problem import (
    apply_counter_updates,
    context_to_array,
    decode_assignment,
    encode_cluster,
    encode_problem,
)
from ..native.build import load_native_library
from ..obs.metrics import counter_add
from ..obs.trace import span
from .base import Context
from .torch_solver import rf_compat_enabled


def _as_i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _out_width(rf: int, hist_width: int) -> int:
    """Slot width of the C solve's rows and counters: ``rf``, widened to the
    historical replica width under ``KA_RF_DECREASE_COMPAT=1``, so the
    reference's unbounded sticky retention survives."""
    if rf_compat_enabled() and hist_width > rf:
        return hist_width
    return rf


class NativeGreedySolver:
    """Solver interface over ``ka_solve_topic`` / ``ka_solve_many``. The
    constructor loads the built library and raises ``NativeBuildError``
    when it is not built."""

    name = "native"

    def __init__(self) -> None:
        self._lib = load_native_library()

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
        counter_add("native.assigns")
        counter_add("native.partitions", len(partitions))
        if context is None:
            context = Context()
        enc = encode_problem(
            topic, current_assignment, rack_assignment, nodes, partitions,
            replication_factor,
        )
        out_w = _out_width(enc.rf, enc.current.shape[1])
        enc_slab = enc if out_w == enc.rf else dataclasses.replace(enc, rf=out_w)
        counters = np.ascontiguousarray(context_to_array(context, enc_slab))
        before = counters.copy()
        rack_of = np.ascontiguousarray(enc.rack_idx[: enc.n])
        current = np.ascontiguousarray(enc.current[: enc.p])
        ordered = np.full((enc.p, out_w), -1, dtype=np.int32)
        counters_live = np.ascontiguousarray(counters[: enc.n])

        rc = self._lib.ka_solve_topic(
            enc.n, _as_i32(rack_of), int(rack_of.max()) + 1,
            enc.p, _as_i32(current), current.shape[1],
            enc.rf, out_w, enc.jhash,
            _as_i32(counters_live), _as_i32(ordered),
        )
        if rc != 0:
            raise ValueError(
                f"Partition {int(enc.partition_ids[rc - 1])} could not be "
                "fully assigned!"
            )
        counters[: enc.n] = counters_live
        apply_counter_updates(context, enc_slab, before, counters)
        full = np.full((enc.p_pad, out_w), -1, dtype=np.int32)
        full[: enc.p] = ordered
        return decode_assignment(enc, full)

    def assign_many(
        self,
        named_currents: Sequence[tuple],  # [(topic, current_assignment), ...]
        rack_assignment: Mapping[int, str],
        nodes: Set[int],
        replication_factor: int,
        context: Context | None = None,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        """The whole serial topic loop in one native call, the counters
        shared in memory across topics. One replication factor per call:
        ``TopicAssigner`` hands this solver runs of equal-RF topics."""
        if context is None:
            context = Context()
        if not named_currents:
            return []
        with span("native/assign_many"):
            return self._assign_many(
                named_currents, rack_assignment, nodes, replication_factor,
                context,
            )

    def _assign_many(
        self, named_currents, rack_assignment, nodes, replication_factor,
        context,
    ) -> List[Tuple[str, Dict[int, List[int]]]]:
        cluster = encode_cluster(rack_assignment, nodes)
        rf = replication_factor
        encs = [
            encode_problem(t, cur, rack_assignment, nodes, set(cur), rf,
                           cluster=cluster)
            for t, cur in named_currents
        ]
        n = cluster.n
        rack_of = np.ascontiguousarray(cluster.rack_idx[:n])
        n_racks = int(rack_of.max()) + 1

        p_counts = np.array([e.p for e in encs], dtype=np.int32)
        widths = np.array([e.current.shape[1] for e in encs], dtype=np.int32)
        out_w = _out_width(rf, int(widths.max()))
        jhashes = np.array([e.jhash for e in encs], dtype=np.int64)
        cur_sizes = p_counts.astype(np.int64) * widths
        cur_offsets = np.zeros(len(encs), dtype=np.int64)
        np.cumsum(cur_sizes[:-1], out=cur_offsets[1:])
        currents = np.concatenate(
            [np.ascontiguousarray(e.current[: e.p]).ravel() for e in encs]
        ).astype(np.int32)
        ord_sizes = p_counts.astype(np.int64) * out_w
        ord_offsets = np.zeros(len(encs), dtype=np.int64)
        np.cumsum(ord_sizes[:-1], out=ord_offsets[1:])
        ordered = np.full(int(ord_sizes.sum()), -1, dtype=np.int32)

        enc_slab = encs[0] if out_w == encs[0].rf else dataclasses.replace(
            encs[0], rf=out_w
        )
        counters = np.ascontiguousarray(context_to_array(context, enc_slab))
        before = counters.copy()
        counters_live = np.ascontiguousarray(counters[:n])
        fail_part = np.zeros(1, dtype=np.int32)

        rc = self._lib.ka_solve_many(
            n, _as_i32(rack_of), n_racks, len(encs),
            _as_i32(p_counts), _as_i32(widths), _as_i64(jhashes),
            _as_i32(currents), _as_i64(cur_offsets),
            rf, out_w,
            _as_i32(counters_live), _as_i32(ordered), _as_i64(ord_offsets),
            _as_i32(fail_part),
        )
        if rc != 0:
            enc = encs[rc - 1]
            raise ValueError(
                f"Partition {int(enc.partition_ids[int(fail_part[0])])} could "
                "not be fully assigned!"
            )
        counters[:n] = counters_live
        apply_counter_updates(context, enc_slab, before, counters)
        out: List[Tuple[str, Dict[int, List[int]]]] = []
        for i, enc in enumerate(encs):
            full = np.full((enc.p_pad, out_w), -1, dtype=np.int32)
            full[: enc.p] = ordered[
                ord_offsets[i]: ord_offsets[i] + ord_sizes[i]
            ].reshape(enc.p, out_w)
            out.append((enc.topic, decode_assignment(enc, full)))
        return out
