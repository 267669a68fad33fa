"""Placement in plain PyTorch, batched over topics — the port of
``kafka_assigner_tpu/ops/assignment.py``'s sticky fill and orphan-spread
leg chain (``sticky_fill`` :197, ``cluster_segments`` :331, ``_wave_body``
:349, ``_hybrid_quota_body`` :529, ``_wave_body_dense`` :257, ``_seq_fill``
:573, ``spread_orphans`` :719), held byte-identical to ``place_scan``
(:1170), giant-shape legs and the compat slot width included.

Placement is independent per topic (only leadership carries state across
topics), so where the reference scans topics and runs one ``while_loop`` per
topic, this port runs each leg as ONE wave loop over a batch of topics:

- one sticky fill over ``(B, P_pad, L)``;
- the chain's first leg (``fast`` under ``auto``) over every topic at once,
  each topic with its own node loads, capacity and rotation start; the loop
  syncs with the host once per wave (to test whether any topic still has a
  deficit), never once per topic;
- topics a leg strands restart from their post-sticky state in the next leg,
  exactly as ``spread_orphans`` restarts each leg (this is the reference's
  ``place_chunked`` + stranded-topic rescue, pinned byte-equal to
  ``place_scan`` by ``tests/test_place_vmap.py``).

A finished or stranded topic is frozen inside a batched wave loop (its
state is selected back), which is what the per-topic ``while_loop`` does.

Parity hazards the reference leaves to JAX semantics, handled explicitly:
``lax.top_k`` breaks ties toward the lower index (a stable sort here);
``jnp.argsort`` is stable (``stable=True`` here); ``argmax`` over a bool
mask takes the first True (cast to int32 first); int32 ``cumsum`` is given
its dtype; and every index JAX would clamp is clamped here.

Past ``KA_DENSE_MASK_BUDGET`` (``P_pad * N_pad`` over the budget, read per
call) the chain is rewritten as the reference's ``spread_orphans`` does
(:770-848): the fast leg hands out headroom slots, dense goes last,
``balance_slots`` leads a chain that starts with ``balance``, and the quota
leg ``balance_quota`` goes before every ``balance`` leg (see
:func:`resolve_chain`). The quota leg picks its quota or endgame wave per
topic, never once for the batch.

Liveness is a per-row input: a batch row may be a (scenario, topic) pair of
a what-if sweep, each scenario with its own mask of live brokers. Every
liveness-derived tensor (mask, live count, segments) has a leading dim of 1,
shared by every row and broadcast, or of the batch, one per row; capacity
and rotation start are per row either way. :func:`whatif_sweep` and
:func:`whatif_subset_sweep` (the reference's :1393 and :1458) flatten
(scenario, topic) into the batch axis and reduce per scenario.

The partition axis may be sharded (``TorchSolver(mesh=)``, the reference's
``TpuSolver(mesh=)`` under GSPMD): each mesh position then holds a
contiguous block of every topic's partition rows, everything per node
(loads, capacity, segments) stays replicated, and every step that crosses
partitions goes through the position's part-axis group (``part``): a
request's rank adds the requests of the positions before it, a wave's node
loads sum every position's accepts, the stranded and active flags are an
``any`` over positions, and the sequential ``seq`` leg runs on the gathered
rows in every position. ``part`` is :data:`UNSHARDED` otherwise, and none
of those steps runs. Every host decision reads replicated values only, so
every position runs the same waves and the same collectives.

The consumer-group family's :func:`pack_group` and :func:`group_pack_sweep`
(the reference's :1552 and :1638) close the module: sticky admission here,
the orphan scan in ``ops/group_pack.py``.
"""
from __future__ import annotations

import contextlib
import operator
import threading
import time
from types import MappingProxyType
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs.trace import profiling, span
from ..utils.env import env_int

BIG = 0x3FFFFFFF
I32 = torch.int32

#: Elements (stranded topics x P_pad x N_pad) of one dense-leg chunk: the
#: dense leg builds (P x N) masks per topic, so it runs over the stranded
#: topics in chunks of at most this many mask elements.
DENSE_CHUNK_ELEMS = 1 << 26

#: Elements (rows x N_pad) of one what-if sweep chunk off a CUDA device: the
#: node-load state and each row's segments are (rows x N_pad), so there a
#: sweep places whole scenarios in chunks of at most this many elements. On
#: a CUDA device the chunk is sized from the card's memory instead
#: (:func:`sweep_scenarios_per_call`). Rows are independent: the chunking
#: changes no value.
SWEEP_CHUNK_ELEMS = 1 << 25

#: One what-if sweep call on a CUDA device may hold its card's total memory
#: over this (:func:`sweep_budget`), which leaves the rest to the plans, the
#: dispatcher's packed calls and a rescue's dense leg on the same card.
SWEEP_MEMORY_SHARE = 4

#: Elements any one tensor of a sweep call may hold: the sorts, scans and
#: gathers it runs stay within 32-bit element counts.
SWEEP_MAX_ELEMS = (1 << 31) - 1


class _Unsharded:
    """The part axis of an unsharded placement: one position, whose
    collectives return their input (the prefix of nothing is zero). The
    placement skips every collective when ``size`` is 1."""

    size = 1
    index = 0

    def exclusive_prefix(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def any(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x


#: The part-axis group of every unsharded placement.
UNSHARDED = _Unsharded()


class AssignState(NamedTuple):
    """Carried placement state for a batch of B topics."""

    acc_nodes: torch.Tensor   # (B, P, RF) accepted broker index per slot, -1 empty
    acc_count: torch.Tensor   # (B, P)     number accepted per partition
    node_load: torch.Tensor   # (B, N+1)   replicas per node (+1 scratch row)
    deficit: torch.Tensor     # (B, P)     replicas still to place
    infeasible: torch.Tensor  # (B,)       bool: some partition cannot be completed

    def take(self, idx: torch.Tensor) -> "AssignState":
        return AssignState(*(t[idx] for t in self))

    def put(self, idx: torch.Tensor, rows: "AssignState") -> "AssignState":
        out = []
        for t, r in zip(self, rows):
            t = t.clone()
            t[idx] = r
            out.append(t)
        return AssignState(*out)


class PlaceResult(NamedTuple):
    acc_nodes: torch.Tensor   # (B, P_pad, RF) int32
    acc_count: torch.Tensor   # (B, P_pad) int32
    infeasible: torch.Tensor  # (B,) bool
    deficit: torch.Tensor     # (B, P_pad) int32
    waves: Dict[str, int]     # leg -> batched waves run (1 for seq)


class HostReads:
    """The device-to-host reads inside one :func:`host_reads` block: how
    many (``syncs``) and the host's wall ms blocked in them (``wait``)."""

    __slots__ = ("syncs", "wait")

    def __init__(self) -> None:
        self.syncs = 0
        self.wait = 0.0


class _OpenReads(threading.local):
    """Each thread's open :class:`HostReads` (``on``), if any."""

    on: Optional[HostReads] = None


_READS = _OpenReads()


class _Sharers(threading.local):
    """How many sweeps this thread's sweep shares its device with, itself
    included (:func:`sharing_device`)."""

    k = 1


_SHARERS = _Sharers()


@contextlib.contextmanager
def host_reads() -> Iterator[Optional[HostReads]]:
    """Count this thread's reads of the device inside the block
    (:func:`host_read`) while a ``torch.profiler`` session records on it
    (``obs/trace.py:profiling``): yields the :class:`HostReads`, else None
    and counts nothing. The innermost open block counts."""
    if not profiling():
        yield None
        return
    outer = _READS.on
    reads = _READS.on = HostReads()
    try:
        yield reads
    finally:
        _READS.on = outer


def host_read(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that reads the device and so waits
    for it: one read, and its wall ms, in this thread's open
    :func:`host_reads` block; else just the call."""
    reads = _READS.on
    if reads is None:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        reads.syncs += 1
        reads.wait += (time.perf_counter() - t0) * 1e3


def dense_mask_budget() -> int:
    """The reference's giant-shape gate (``KA_DENSE_MASK_BUDGET``)."""
    return env_int("KA_DENSE_MASK_BUDGET")


def quota_wave_target() -> int:
    """Per-wave drain divisor of the quota leg (``KA_QUOTA_WAVE_TARGET``):
    a node offers ceil(headroom / target) slots per wave."""
    return env_int("KA_QUOTA_WAVE_TARGET")


def quota_endgame_headroom() -> int:
    """The quota leg hands a topic to the node-per-wave balance wave once its
    fullest rack's headroom is at most this (``KA_QUOTA_ENDGAME``)."""
    return env_int("KA_QUOTA_ENDGAME")


def default_alive(rack_idx: torch.Tensor, n: int) -> torch.Tensor:
    """(N_pad,) liveness: the first n real nodes are alive, padding is not."""
    return torch.arange(rack_idx.shape[0], device=rack_idx.device) < n


def _gather1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]``, where either side may have a leading dim of 1
    (one tensor shared by every row)."""
    if idx.shape[0] == 1 and x.shape[0] != 1:
        return x[:, idx[0]]
    if x.shape[0] == 1 and idx.shape[0] != 1:
        return x[0][idx]
    return x.gather(1, idx)


def _rows(x: torch.Tensor, idx) -> torch.Tensor:
    """The rows ``idx`` of a per-row tensor; a shared one (leading dim 1)
    stays as it is."""
    return x if x.shape[0] == 1 else x[idx]


def _requests_rank(
    pick: torch.Tensor, valid: torch.Tensor, sentinel: int, part=UNSHARDED
) -> torch.Tensor:
    """(B, P) rank of each valid request among the requests of its topic for
    the same key, in ascending partition-row order — the stand-in for
    "TreeMap iteration order decides who hits the capacity gate first".

    One stable sort over (topic, key) composites; rank = sorted position
    minus the first position of that composite. Valid keys lie in
    [0, sentinel); invalid rows get the sentinel and an unused rank. On a
    sharded part axis the rank is global: the local rank plus the requests
    for the same (topic, key) on the positions before this one."""
    b, p = pick.shape
    dev = pick.device
    keys = torch.where(valid, pick, sentinel).long()
    comp = (torch.arange(b, device=dev)[:, None] * (sentinel + 1) + keys).reshape(-1)
    sorted_keys, order = torch.sort(comp, stable=True)
    first = torch.searchsorted(sorted_keys, sorted_keys, side="left")
    rank_sorted = torch.arange(b * p, device=dev) - first
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    if part.size > 1:
        # A (B, sentinel + 1) histogram of valid requests per call: about
        # 40 MB of int32 at config 4's B 2,000 x N 5,001, but the part axis
        # is for giant single topics, where it is (1, 5,101).
        hist = torch.bincount(comp[valid.reshape(-1)], minlength=b * (sentinel + 1))
        rank = rank + part.exclusive_prefix(hist.to(I32))[comp]
    return rank.view(b, p).to(I32)


def _accept_batch(
    state: AssignState, cand: torch.Tensor, accept: torch.Tensor, part=UNSHARDED
) -> AssignState:
    """Record one accepted replica per accepting partition (``Node.accept``
    + ``Rack.accept``, ``KafkaAssignmentStrategy.java:326-331``). On a
    sharded part axis the node loads add every position's accepts."""
    rf = state.acc_nodes.shape[2]
    n_scratch = state.node_load.shape[1] - 1
    slots = torch.arange(rf, dtype=I32, device=cand.device)
    write = (slots == state.acc_count[..., None]) & accept[..., None]
    acc_nodes = torch.where(write, cand.to(I32)[..., None], state.acc_nodes)
    acc_count = state.acc_count + accept.to(I32)
    target = torch.where(accept, cand, n_scratch).long()
    ones = torch.ones_like(target, dtype=I32)
    if part.size > 1:
        delta = torch.zeros_like(state.node_load).scatter_add_(1, target, ones)
        node_load = state.node_load + part.sum(delta)
    else:
        node_load = state.node_load.scatter_add(1, target, ones)
    deficit = state.deficit - accept.to(I32)
    return state._replace(
        acc_nodes=acc_nodes, acc_count=acc_count, node_load=node_load,
        deficit=deficit,
    )


def _acc_racks(state: AssignState, rack_idx: torch.Tensor) -> torch.Tensor:
    """(B, P, RF) rack id of each accepted replica, -1 for empty slots."""
    nodes = state.acc_nodes
    return torch.where(nodes >= 0, rack_idx[nodes.clamp(min=0).long()], -1)


def _candidate_ok(
    state: AssignState,
    cand: torch.Tensor,       # (B, P)
    rack_idx: torch.Tensor,
    rf_actual: torch.Tensor,  # (B,)
    alive: torch.Tensor,      # (N_pad,), or (1|B, N_pad) per row
) -> torch.Tensor:
    """Acceptability of one candidate per partition, sans capacity: node
    exists and is alive in the row's scenario, not already holding the
    partition, rack unused (``Node.canAccept`` and ``Rack.canAccept``,
    ``:320-324, 346-348``)."""
    safe = cand.clamp(min=0).long()
    exists = (cand >= 0) & _gather1(alive.reshape(-1, alive.shape[-1]), safe)
    dup_node = (state.acc_nodes == cand[..., None]).any(-1)
    dup_rack = (_acc_racks(state, rack_idx) == rack_idx[safe][..., None]).any(-1)
    under_rf = state.acc_count < rf_actual[:, None]
    return exists & ~dup_node & ~dup_rack & under_rf


def sticky_fill(
    current: torch.Tensor,    # (B, P, L) broker index or -1
    rack_idx: torch.Tensor,   # (N_pad,)
    rf: int,                  # slot width (batch-max RF)
    cap: torch.Tensor,        # (B,) per-topic capacity
    n: int,
    p_real: torch.Tensor,     # (B,) real partition counts; padded rows get no deficit
    alive: torch.Tensor,      # (N_pad,), or (1|B, N_pad) per row, bool
    rf_actual: torch.Tensor,  # (B,) per-topic RF <= rf
    width: int | None = None,  # compat slot width > rf (RF decrease)
    part=UNSHARDED,
) -> AssignState:
    """Vectorized sticky fill (``fillNodesFromAssignment``, ``:101-131``):
    slot by slot (slot 0 of every partition before any slot 1), ascending
    partition rows win capacity ties; a partition keeps at most its RF.

    ``width`` (``KA_RF_DECREASE_COMPAT=1`` on an RF decrease) makes the
    state ``width`` slots wide and bounds retention by the slot width
    instead of the RF, so every current replica that passes the node, rack
    and capacity gates is kept, as in the reference (``:233-236``).

    On a sharded part axis ``current`` is this position's block of rows,
    the ``part.index``-th of equal blocks."""
    b, p, hist_width = current.shape
    dev = current.device
    rows = torch.arange(p, device=dev)
    if part.size > 1:
        rows = rows + part.index * p
    deficit = torch.where(
        rows[None, :] < p_real[:, None], rf_actual[:, None], 0
    ).to(I32)
    w = rf if width is None else width
    retain = rf_actual if width is None else torch.full_like(rf_actual, w)
    state = AssignState(
        acc_nodes=torch.full((b, p, w), -1, dtype=I32, device=dev),
        acc_count=torch.zeros((b, p), dtype=I32, device=dev),
        node_load=torch.zeros((b, n + 1), dtype=I32, device=dev),
        deficit=deficit,
        infeasible=torch.zeros(b, dtype=torch.bool, device=dev),
    )
    for s in range(hist_width):
        cand = current[:, :, s]
        ok = _candidate_ok(state, cand, rack_idx, retain, alive)
        rank = _requests_rank(cand, ok, n, part)
        load = state.node_load.gather(1, cand.clamp(min=0).long())
        accept = ok & (load + rank < cap[:, None])
        state = _accept_batch(state, cand, accept, part)
    return state


class Segments(NamedTuple):
    """Live nodes sorted by (rack, live-rank), with per-rack [start, end)
    bounds (see the reference's ``Segments``). They depend on the liveness
    mask only, so they are built once per mask; within a batch every field
    has a leading dim of 1 (one mask for every topic) or one row per topic."""

    order: torch.Tensor        # (n,) int64 node indices
    sorted_key: torch.Tensor   # (n,) rack * n_pad + live-rank (BIG for dead)
    sorted_rank: torch.Tensor  # (n,) live-rank in sorted order (BIG for dead)
    seg_start: torch.Tensor    # (r_cap,) int64
    seg_end: torch.Tensor      # (r_cap,) int64


def cluster_segments(
    rack_idx: torch.Tensor, n: int, alive: torch.Tensor, r_cap: int
) -> Segments:
    """:class:`Segments` of one mask ``alive`` (N_pad,), with the shapes
    above, or of M masks (M, N_pad), each field then with a leading dim M:
    one stable sort per mask."""
    if alive.dim() == 1:
        return Segments(*(t[0] for t in cluster_segments(rack_idx, n, alive[None], r_cap)))
    n_pad = rack_idx.shape[0]
    alive_n = alive[:, :n]
    alive_rank = torch.cumsum(alive_n.to(I32), 1, dtype=I32) - 1
    key = torch.where(alive_n, rack_idx[:n] * n_pad + alive_rank, BIG).to(I32)
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = key.gather(1, order)
    alive_s = alive_n.gather(1, order)
    sorted_rack = torch.where(alive_s, rack_idx[:n][order], r_cap).to(I32)
    sorted_rank = torch.where(alive_s, alive_rank.gather(1, order), BIG).to(I32)
    rr = torch.arange(r_cap, dtype=I32, device=rack_idx.device)
    rr = rr.expand(alive.shape[0], r_cap).contiguous()
    seg_start = torch.searchsorted(sorted_rack, rr, side="left")
    seg_end = torch.searchsorted(sorted_rack, rr, side="right")
    return Segments(order, sorted_key, sorted_rank, seg_start, seg_end)


def _topk_stable(x: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Indices of the k largest (smallest) entries per row, ties toward the
    lower index — ``lax.top_k``'s order, which ``torch.topk`` does not
    promise."""
    _, idx = torch.sort(-x if largest else x, dim=1, stable=True)
    return idx[:, :k]


def _headroom(state: AssignState, cap: torch.Tensor, n: int,
              alive: torch.Tensor) -> torch.Tensor:
    """(B, n) free slots per node: cap - load where the node is alive and
    under cap, else 0."""
    load_n = state.node_load[:, :n]
    avail = alive[..., :n] & (load_n < cap[:, None])
    return torch.where(avail, cap[:, None] - load_n, 0).to(I32)


def _rack_room(headroom: torch.Tensor, rack_n: torch.Tensor, r_cap: int) -> torch.Tensor:
    """(B, r_cap) summed headroom per rack."""
    b, n = headroom.shape
    return torch.zeros((b, r_cap), dtype=I32, device=headroom.device).scatter_add_(
        1, rack_n.expand(b, n), headroom
    )


def _wave_body(
    rack_idx: torch.Tensor,
    cap: torch.Tensor,     # (B,)
    n: int,
    alive: torch.Tensor,   # (1|B, N_pad)
    rf: int,               # slot width
    r_cap: int,
    seg: Segments,         # fields (1|B, ...)
    start: torch.Tensor,   # (B,) topic rotation start = jhash % n_alive
    n_alive: torch.Tensor,  # (1|B,) live nodes of the row's scenario
    balance: bool = False,
    slot_pack: bool = False,
    quota: bool = False,
    part=UNSHARDED,
):
    """One rack-factored auction wave over every deficient partition of
    every topic (the reference's ``_wave_body``).

    A partition's first-fit node is the min-rotated-position available node
    of its best unblocked rack; the rotation within a rack's segment is a
    cut at live-rank ``n_alive - start``. ``balance=True`` ranks candidate
    racks by remaining capacity instead (ties to the lowest rack id). Among
    the K = min(RF+1, r_cap) best racks at least one is unblocked.

    A unit handed out is one node per wave by default, one slot of headroom
    under ``slot_pack``, and ceil(headroom / ``KA_QUOTA_WAVE_TARGET``) slots
    under ``quota`` (with ``balance``), where K widens to min(r_cap,
    max(RF+1, 16)) and each valid requester's dense rank among its topic's
    valid requesters picks the candidate rack whose cumulative-allowance
    interval holds it (the reference's :436-446, :485-500)."""
    k = min(r_cap, max(rf + 1, 16)) if quota else min(rf + 1, r_cap)
    t_div = quota_wave_target() if quota else 1
    order, sorted_key, sorted_rank, seg_start, seg_end = seg
    n_pad = rack_idx.shape[0]
    dev = rack_idx.device
    rr = torch.arange(r_cap, dtype=I32, device=dev)
    # Per-topic, per-rack rotation cut: first in-segment index whose
    # live-rank >= n_alive - start.
    cut = torch.searchsorted(
        sorted_key[0] if sorted_key.shape[0] == 1 else sorted_key,
        (rr[None, :] * n_pad + (n_alive - start)[:, None]).to(I32),
    )
    n_alive = n_alive[:, None]
    rack_n = rack_idx[:n].long()

    def body(state: AssignState) -> AssignState:
        headroom = _headroom(state, cap, n, alive)
        if quota:
            units = (headroom + t_div - 1) // t_div
        elif slot_pack:
            units = headroom
        else:
            units = (headroom > 0).to(I32)
        ca = torch.cumsum(_gather1(units, order), dim=1, dtype=I32)
        ca_pad = F.pad(ca, (1, 0))
        base = _gather1(ca_pad, seg_start)           # (B, r_cap)
        end = _gather1(ca_pad, seg_end)
        seg_avail = end - base                       # per-rack available units
        cum_at_cut = ca_pad.gather(1, cut)
        a_after = end - cum_at_cut                   # available at/after the cut
        if balance:
            rack_room = _rack_room(headroom, rack_n, r_cap)
            cand_racks = _topk_stable(rack_room, k, largest=True)
            cand_ok = rack_room.gather(1, cand_racks) > 0
        else:
            # Best rotated position per rack: first available at/after the
            # cut (the wrapped half), else first available before it.
            t_first = torch.where(a_after > 0, cum_at_cut + 1, base + 1)
            i_first = torch.searchsorted(ca, t_first).clamp(0, n - 1)
            rack_best = torch.where(
                seg_avail > 0,
                (_gather1(sorted_rank, i_first) + start[:, None]) % n_alive, BIG,
            ).to(I32)
            cand_racks = _topk_stable(rack_best, k, largest=False)
            cand_ok = rack_best.gather(1, cand_racks) < BIG

        acc_racks = _acc_racks(state, rack_idx)      # (B, P, RF)
        blocked = (cand_racks[:, None, :, None] == acc_racks[:, :, None, :]).any(3)
        wanting = state.deficit > 0
        ok = ~blocked & cand_ok[:, None, :] & wanting[..., None]   # (B, P, K)
        has_choice = ok.any(2)
        valid = wanting & has_choice
        if quota:
            # Demand spread in proportion to allowance: a requester's dense
            # rank among its topic's valid requesters, modulo the summed
            # allowance of its eligible candidates, falls in one
            # candidate's cumulative interval.
            q_cand = torch.where(ok, seg_avail.gather(1, cand_racks)[:, None, :], 0)
            cum_q = torch.cumsum(q_cand, dim=2, dtype=I32)
            total_q = cum_q[:, :, -1]
            rank_valid = torch.cumsum(valid.to(I32), dim=1, dtype=I32) - 1
            if part.size > 1:
                rank_valid = rank_valid + part.exclusive_prefix(
                    valid.sum(1, dtype=I32))[:, None]
            choice = torch.where(valid, rank_valid % total_q.clamp(min=1), 0)
            first_ok = torch.argmax((cum_q > choice[..., None]).to(I32), dim=2)
        else:
            first_ok = torch.argmax(ok.to(I32), dim=2)   # first True
        # Monotone eligibility: no eligible rack now means never again.
        stranded = (wanting & ~has_choice).any(1)
        if part.size > 1:
            stranded = part.any(stranded)
        infeasible = state.infeasible | stranded

        # Rank among same-rack requesters, then hand out that rack's j-th
        # best available node in rotated order.
        rack_choice = cand_racks.gather(1, first_ok)
        pick_rack = torch.where(valid, rack_choice, r_cap)
        j = _requests_rank(pick_rack, valid, r_cap, part)
        accept = valid & (j < seg_avail.gather(1, rack_choice))
        pick = pick_rack.clamp(0, r_cap - 1)
        a_after_p = a_after.gather(1, pick)
        target = torch.where(
            j >= a_after_p,                          # past the wrapped half
            base.gather(1, pick) + (j - a_after_p) + 1,
            cum_at_cut.gather(1, pick) + j + 1,
        )
        slot = torch.searchsorted(ca, target).clamp(0, n - 1)
        node = _gather1(order, slot)
        state = _accept_batch(state, node, accept, part)
        return state._replace(infeasible=infeasible)

    return body


def _hybrid_quota_body(
    rack_idx: torch.Tensor,
    cap: torch.Tensor,
    n: int,
    alive: torch.Tensor,
    rf: int,
    r_cap: int,
    seg: Segments,
    start: torch.Tensor,
    n_alive: torch.Tensor,
    part=UNSHARDED,
):
    """The ``balance_quota`` leg (the reference's ``_hybrid_quota_body``):
    quota waves while a topic's fullest rack has more headroom than
    ``KA_QUOTA_ENDGAME``, then the node-per-wave balance wave. Headroom only
    falls, so the switch is one-way. Each topic takes its own branch: a
    batch with topics on both sides computes both waves and selects."""
    quota_body = _wave_body(
        rack_idx, cap, n, alive, rf, r_cap, seg, start, n_alive,
        balance=True, quota=True, part=part,
    )
    endgame_body = _wave_body(
        rack_idx, cap, n, alive, rf, r_cap, seg, start, n_alive, balance=True,
        part=part,
    )
    endgame = quota_endgame_headroom()
    rack_n = rack_idx[:n].long()

    def body(state: AssignState) -> AssignState:
        room = _rack_room(_headroom(state, cap, n, alive), rack_n, r_cap)
        bulk = room.amax(1) > endgame
        if host_read(bool, bulk.all()):
            return quota_body(state)
        if not host_read(bool, bulk.any()):
            return endgame_body(state)
        return _select(bulk, quota_body(state), endgame_body(state))

    return body


def _select(mask: torch.Tensor, a: AssignState, b: AssignState) -> AssignState:
    """Per topic: ``a``'s state where ``mask`` (B,) is set, else ``b``'s."""
    return AssignState(*(
        torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)
        for x, y in zip(a, b)
    ))


def _wave_body_dense(
    rack_idx: torch.Tensor,
    pos: torch.Tensor,     # (B, N_pad) rotated position per node (BIG for dead)
    cap: torch.Tensor,
    n: int,
    alive: torch.Tensor,   # (1|B, N_pad)
    r_cap: int,
    part=UNSHARDED,
):
    """Dense-eligibility wave: every deficient partition bids for its best
    eligible node over an explicit (P x N) mask (the reference's
    ``_wave_body_dense``)."""
    rack_n = rack_idx[:n].long()

    def body(state: AssignState) -> AssignState:
        b, p, _ = state.acc_nodes.shape
        dev = state.acc_nodes.device
        nodes = torch.where(state.acc_nodes >= 0, state.acc_nodes, n).long()
        assigned = torch.zeros((b, p, n + 1), dtype=torch.bool, device=dev).scatter_(
            2, nodes, torch.ones_like(nodes, dtype=torch.bool)
        )[:, :, :n]
        acc_racks = _acc_racks(state, rack_idx)
        racks = torch.where(acc_racks >= 0, acc_racks, r_cap).long()
        rack_used = torch.zeros((b, p, r_cap + 1), dtype=torch.bool, device=dev).scatter_(
            2, racks, torch.ones_like(racks, dtype=torch.bool)
        )
        rack_blocked = rack_used[:, :, rack_n]
        under_cap = (state.node_load[:, :n] < cap[:, None]) & alive[..., :n]
        wanting = state.deficit > 0
        eligible = ~assigned & ~rack_blocked & under_cap[:, None, :] & wanting[..., None]

        score = torch.where(eligible, pos[:, None, :n], BIG)
        pick = torch.argmin(score, dim=2)
        has_choice = eligible.any(2)
        valid = wanting & has_choice
        stranded = (wanting & ~has_choice).any(1)
        if part.size > 1:
            stranded = part.any(stranded)
        infeasible = state.infeasible | stranded

        rank = _requests_rank(pick, valid, n, part)
        load = state.node_load.gather(1, pick)
        accept = valid & (load + rank < cap[:, None])
        state = _accept_batch(state, pick, accept, part)
        return state._replace(infeasible=infeasible)

    return body


def _seq_fill(
    state: AssignState,
    rack_idx: torch.Tensor,
    pos: torch.Tensor,     # (B, N_pad)
    cap: torch.Tensor,
    n: int,
    alive: torch.Tensor,   # (1|B, N_pad)
) -> AssignState:
    """The reference's ``assignOrphans`` verbatim (``:162-186``, the
    reference package's ``_seq_fill``): partitions in ascending row order,
    each filled completely by rotated first-fit before the next starts.
    Sequential over rows, batched over topics. A row with no deficit in any
    topic of the batch is a no-op, so only rows with a deficit are
    visited (read once, before the scan: a row's deficit changes only
    while that row is processed)."""
    b, _, w = state.acc_nodes.shape
    dev = state.acc_nodes.device
    pos_n = pos[:, :n]
    rows_n = torch.arange(n, dtype=I32, device=dev)
    slots = torch.arange(w, dtype=I32, device=dev)
    rack_n = rack_idx[:n]
    alive_n = alive[..., :n]
    acc_nodes = state.acc_nodes.clone()
    acc_count = state.acc_count.clone()
    deficit = state.deficit.clone()
    node_load = state.node_load
    infeasible = state.infeasible.clone()
    todo_rows = host_read(lambda: torch.nonzero((deficit > 0).any(0)).flatten().tolist())
    for r in todo_rows:
        nodes, count, dfc = acc_nodes[:, r], acc_count[:, r], deficit[:, r]
        for _ in range(w):  # a row's deficit <= its slot width
            racks = torch.where(nodes >= 0, rack_idx[nodes.clamp(min=0).long()], -1)
            rack_blocked = (rack_n[None, :, None] == racks[:, None, :]).any(2)
            dup = (rows_n[None, :, None] == nodes[:, None, :]).any(2)
            eligible = (
                alive_n & (node_load[:, :n] < cap[:, None]) & ~rack_blocked & ~dup
            )
            any_e = eligible.any(1)
            pick = torch.argmin(torch.where(eligible, pos_n, BIG), dim=1)
            ok = (dfc > 0) & any_e
            infeasible |= (dfc > 0) & ~any_e
            write = (slots == count[:, None]) & ok[:, None]
            nodes = torch.where(write, pick.to(I32)[:, None], nodes)
            count = count + ok.to(I32)
            node_load = node_load.scatter_add(
                1, torch.where(ok, pick, n)[:, None],
                torch.ones((b, 1), dtype=I32, device=dev),
            )
            dfc = dfc - ok.to(I32)
        acc_nodes[:, r], acc_count[:, r], deficit[:, r] = nodes, count, dfc
    return AssignState(acc_nodes, acc_count, node_load, deficit, infeasible)


#: Legal wave modes and the leg chain each runs (the reference's
#: ``WAVE_MODES``). Every leg restarts from the post-sticky state; a later
#: leg runs only for the topics the previous one stranded.
WAVE_MODES = MappingProxyType({
    "auto": ("fast", "dense", "balance", "seq"),
    "fresh": ("balance", "fast", "dense", "seq"),
    "fast": ("fast",),
    "dense": ("dense",),
    "balance": ("balance",),
    "seq": ("seq",),
    "fast_balance": ("fast", "balance"),
    "fast_dense": ("fast", "dense"),
    "balance_quota": ("balance_quota",),
})


def _resolve_wave_plan(
    wave_mode: str, n_pad: int, r_cap: int | None
) -> Tuple[Tuple[str, ...], int]:
    """(legs, r_cap), as the reference resolves them: validates the mode,
    defaults r_cap, and degrades first-fit chains to dense/seq where the
    int32 (rack, live-rank) key packing would overflow."""
    if wave_mode not in WAVE_MODES:
        raise ValueError(
            f"unknown wave_mode {wave_mode!r}; expected one of {sorted(WAVE_MODES)}"
        )
    if r_cap is None:
        r_cap = 2 * n_pad
    legs = WAVE_MODES[wave_mode]
    if n_pad * n_pad >= BIG:
        if wave_mode in ("balance", "balance_quota"):
            raise ValueError(
                f"wave_mode {wave_mode!r} packs (rack, live-rank) into int32 "
                f"keys, which overflows at n_pad={n_pad}"
            )
        if wave_mode != "seq":
            legs = ("dense", "seq") if len(legs) > 1 else ("dense",)
    return legs, r_cap


def resolve_chain(
    wave_mode: str, p_pad: int, n_pad: int, r_cap: int | None = None
) -> Tuple[Tuple[str, ...], int, bool]:
    """``(legs, r_cap, giant)``: the leg chain the reference's
    ``spread_orphans`` runs (:759-848). Past ``KA_DENSE_MASK_BUDGET``
    (``giant``): dense goes last in a multi-leg chain, the fast leg
    slot-packs, ``balance_slots`` leads a chain that starts with
    ``balance``, and ``balance_quota`` goes before every ``balance``."""
    legs, r_cap = _resolve_wave_plan(wave_mode, n_pad, r_cap)
    giant = p_pad * n_pad > dense_mask_budget()
    if giant:
        if len(legs) > 1 and "dense" in legs:
            legs = tuple(leg for leg in legs if leg != "dense") + ("dense",)
        if legs[0] == "balance":
            legs = ("balance_slots",) + legs
        legs = tuple(
            x for leg in legs
            for x in (("balance_quota", leg) if leg == "balance" else (leg,))
        )
    return legs, r_cap, giant


def _positions(alive: torch.Tensor, start: torch.Tensor,
               n_alive: torch.Tensor) -> torch.Tensor:
    """(B, N_pad) topic-rotated position of every node (BIG for dead);
    ``alive`` (1|B, N_pad) and ``n_alive`` (1|B,) per row or shared."""
    alive_rank = torch.cumsum(alive.to(I32), 1, dtype=I32) - 1
    pos = (alive_rank + start[:, None]) % n_alive[:, None]
    return torch.where(alive, pos, BIG).to(I32)


def _gather_rows(state: AssignState, part) -> AssignState:
    """Every position's partition rows of ``state`` (node loads and flags
    are replicated already); ``state`` itself when unsharded."""
    if part.size == 1:
        return state
    return state._replace(**{f: part.gather(getattr(state, f), 1)
                             for f in ("acc_nodes", "acc_count", "deficit")})


def _block_rows(state: AssignState, part, p: int) -> AssignState:
    """This position's block of ``p`` rows of a gathered ``state``."""
    if part.size == 1:
        return state
    lo = part.index * p
    return state._replace(**{f: getattr(state, f)[:, lo:lo + p]
                             for f in ("acc_nodes", "acc_count", "deficit")})


def _wave_loop(body, state: AssignState, part=UNSHARDED) -> Tuple[AssignState, int]:
    """Run ``body`` until every topic is placed or stranded. A topic that is
    done is frozen (its state selected back), as its own ``while_loop``
    would stop. One host sync per wave and one to stop, on a value every
    position of a sharded part axis holds alike."""
    waves = 0
    while True:
        wanting = (state.deficit > 0).any(1)
        if part.size > 1:
            wanting = part.any(wanting)
        active = wanting & ~state.infeasible
        if not host_read(bool, active.any()):
            return state, waves
        state = _select(active, body(state), state)
        waves += 1


def place_batched(
    currents: torch.Tensor,   # (B, P_pad, L) broker index or -1
    rack_idx: torch.Tensor,   # (N_pad,)
    jhashes: torch.Tensor,    # (B,)
    p_reals: torch.Tensor,    # (B,)
    n: int,
    rf: int,                  # batch-max RF
    wave_mode: str = "auto",
    rfs: torch.Tensor | None = None,  # (B,) per-topic RF (mixed-RF batches)
    r_cap: int | None = None,
    width: int | None = None,  # compat slot width (see sticky_fill)
    alive: torch.Tensor | None = None,      # (M, N_pad) liveness masks
    alive_row: torch.Tensor | None = None,  # (B,) each row's mask in `alive`
    part=UNSHARDED,           # this position's part-axis group
    p_pad: int | None = None,  # the whole batch's P_pad (default: currents')
) -> PlaceResult:
    """Place every topic of the batch: the port of ``place_scan``.

    ``alive`` is the liveness: by default the first ``n`` nodes, one mask
    for every row; else ``(1, N_pad)`` shared, ``(B, N_pad)`` one mask per
    row, or M masks with ``alive_row`` naming each row's. Each row's live
    count, capacity and rotation start follow its mask, as the reference's
    ``_place_one_topic`` derives them (:1003-1005); segments are built once
    per mask and indexed per row.

    Returns per topic the accepted nodes and counts (``width`` slots wide
    when given, else ``rf``), the infeasible flag and the deficit vector
    (for the reference's error message); ``waves`` names every leg that
    ran. Inert padding topics (p_real 0) have nothing to place.

    Its reads of the device go through :func:`host_read`: a wave loop's
    flag a wave and one to stop, the quota leg's two branch flags a wave,
    the ``seq`` leg's row list, and the stranded rows after each leg.

    On a sharded part axis (``part`` a position of a mesh's part axis),
    ``currents`` is this position's block of rows, one of ``part.size``
    equal blocks, and the results are this block's; ``p_pad`` is the
    batch's own P_pad, which resolves the chain (the giant-shape gate) as
    the unsharded placement resolves it."""
    dev = currents.device
    currents = currents.to(I32)
    rack_idx = rack_idx.to(I32)
    jhashes = jhashes.to(I32)
    p_reals = p_reals.to(I32)
    b, p_rows, _ = currents.shape
    p_pad = p_rows if p_pad is None else p_pad
    n_pad = rack_idx.shape[0]
    legs, r_cap, giant = resolve_chain(wave_mode, p_pad, n_pad, r_cap)
    rfs = torch.full((b,), rf, dtype=I32, device=dev) if rfs is None else rfs.to(I32)
    masks = default_alive(rack_idx, n)[None] if alive is None else alive.to(torch.bool)
    row = None if alive_row is None else alive_row.long()

    def per_row(x):  # a per-mask tensor, (M, ...), to (1|B, ...)
        return x if row is None else x[row]

    def live(x, todo):  # a per-mask tensor for the rows `todo`
        return _rows(x, todo) if row is None else x[row[todo]]

    # Live nodes max(|alive[:n]|, 1), capacity ceil(P*RF/N_alive)
    # (KafkaAssignmentStrategy.java:65-71) and rotation start
    # abs(hash) % N_alive (:188-200), per row.
    n_alive_m = masks[:, : max(n, 1)].sum(1, dtype=I32).clamp(min=1)
    n_alive = per_row(n_alive_m)
    cap = (p_reals * rfs + n_alive - 1) // n_alive
    start = jhashes % n_alive

    sticky = sticky_fill(currents, rack_idx, rf, cap, n, p_reals, per_row(masks), rfs, width,
                         part)
    w = sticky.acc_nodes.shape[2]
    seg = None
    if any(leg in ("fast", "balance", "balance_quota") for leg in legs):
        seg = cluster_segments(rack_idx, n, masks, r_cap)

    result = sticky
    todo = torch.arange(b, device=dev)
    waves: Dict[str, int] = {}
    for leg in legs:
        sub = sticky.take(todo)
        cap_t, start_t = cap[todo], start[todo]
        alive_t, n_alive_t = live(masks, todo), live(n_alive_m, todo)
        if leg == "seq":
            # Sequential over rows: on a sharded part axis every position
            # runs it on the gathered rows and keeps its own block.
            out = _seq_fill(
                _gather_rows(sub, part), rack_idx,
                _positions(alive_t, start_t, n_alive_t), cap_t, n, alive_t,
            )
            out = _block_rows(out, part, p_rows)
            waves[leg] = 1
        elif leg == "dense":
            # Masks are (P x N) per topic: chunk the stranded topics.
            chunk = max(1, DENSE_CHUNK_ELEMS // (p_pad * n_pad))
            parts, trips = [], 0
            for c0 in range(0, len(todo), chunk):
                sl = slice(c0, c0 + chunk)
                alive_c = _rows(alive_t, sl)
                body = _wave_body_dense(
                    rack_idx, _positions(alive_c, start_t[sl], _rows(n_alive_t, sl)),
                    cap_t[sl], n, alive_c, r_cap, part,
                )
                placed_c, k = _wave_loop(body, sub.take(sl), part)
                parts.append(placed_c)
                trips += k
            out = AssignState(*(torch.cat(ts) for ts in zip(*parts)))
            waves[leg] = trips
        else:
            seg_t = Segments(*(live(f, todo) for f in seg))
            args = (rack_idx, cap_t, n, alive_t, w, r_cap, seg_t, start_t, n_alive_t)
            if leg == "balance_quota":
                body = _hybrid_quota_body(*args, part=part)
            else:
                body = _wave_body(
                    *args,
                    balance=leg in ("balance", "balance_slots"),
                    slot_pack=leg == "balance_slots" or (leg == "fast" and giant),
                    part=part,
                )
            out, waves[leg] = _wave_loop(body, sub, part)
        result = result.put(todo, out)
        todo = host_read(operator.getitem, todo, out.infeasible)
        if todo.numel() == 0:
            break
    return PlaceResult(
        result.acc_nodes, result.acc_count, result.infeasible, result.deficit,
        waves,
    )


class SweepResult(NamedTuple):
    """Per-scenario outcome of a what-if sweep."""

    moved: torch.Tensor       # (S,) placed replicas not in the row's current list
    infeasible: torch.Tensor  # (S,) bool: some topic of the scenario stranded
    load: torch.Tensor        # (S,) max node load, or (S, n) node loads (subset)
    waves: Dict[str, int]     # leg -> batched waves, summed over the chunks
    rows: int                 # (scenario, topic) rows placed
    chunks: int               # placement calls
    per_call: int             # scenarios the largest placement call held


@contextlib.contextmanager
def sharing_device(k: int) -> Iterator[None]:
    """Inside the block this thread's sweeps size each placement call for
    ``k`` sweeps running at once on their device (:func:`sweep_budget`):
    the in-process positions of a mesh whose blocks share one card."""
    outer = _SHARERS.k
    _SHARERS.k = max(1, k)
    try:
        yield
    finally:
        _SHARERS.k = outer


def sweep_budget(device: torch.device) -> Optional[int]:
    """Bytes one sweep call may hold on ``device``: a CUDA device's total
    memory over :data:`SWEEP_MEMORY_SHARE`, split among the sweeps that
    share it (:func:`sharing_device`); None off a CUDA device. The total,
    not the free memory: sweeps that start together would each see the
    same free memory."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return total // SWEEP_MEMORY_SHARE // _SHARERS.k


def sweep_row_bytes(p_pad: int, width: int, n_pad: int) -> int:
    """Device bytes one (scenario, topic) row of a sweep call holds at the
    call's peak, inside a wave of its first leg, from the shapes it builds.

    Per node (N_pad + 1 columns), 52 B: the int32 node loads of the sticky
    state, the leg's ``take`` of it and the wave loop's state (12 B); the
    wave's int32 headroom, units, gathered units, cumsum and its pad, or
    the accepted state's loads in place of the gathered units (20 B); the
    row's copies of the segment fields, ``order`` int64 and ``sorted_key``
    and ``sorted_rank`` int32 (16 B); the row's liveness and the wave's
    bool masks (4 B).

    Per partition row, 48 B a slot and 224 B: the slots, count and deficit
    of five states (the three above, the accepted one and the leg's
    ``put``) and the row's current list (24 B a slot, 40 B); the wave's
    rack ids and (K, width) blocking test, K <= 16 (20 B a slot); the
    int64 keys, order and ranks of ``_requests_rank``'s sort (56 B); the
    quota leg's (K,) int32 allowances and their cumsum (128 B); and 4 B a
    slot of bool masks and casts."""
    return 52 * (n_pad + 1) + p_pad * (48 * width + 224)


def sweep_scenarios_per_call(budget: Optional[int], t: int, p_pad: int, width: int,
                             n_pad: int) -> int:
    """Whole scenarios of ``t`` rows that one sweep call places: as many
    rows as ``budget`` bytes hold (:func:`sweep_row_bytes`), with no tensor
    of the call past :data:`SWEEP_MAX_ELEMS` elements (its (rows, N_pad + 1)
    node loads, its (rows, P_pad, K, width) blocking test with K at most
    max(width + 1, 16), and so its (rows x P_pad) sorts), and at least one.
    With no budget (off a CUDA device): ``SWEEP_CHUNK_ELEMS // (t * n_pad)``."""
    if budget is None:
        return max(1, SWEEP_CHUNK_ELEMS // (t * n_pad))
    widest = max(n_pad + 1, p_pad * width * max(width + 1, 16))
    rows = min(budget // sweep_row_bytes(p_pad, width, n_pad), SWEEP_MAX_ELEMS // widest)
    return max(1, rows // t)


def _sweep(currents, rack_idx, jhashes, p_reals, rfs, topics, alive_masks,
           n: int, rf: int, wave_mode: str, r_cap) -> SweepResult:
    """Place every (scenario, topic) row and reduce per scenario. Scenario
    s's rows are the topics ``topics[s]`` (``topics`` is (1|S, T); -1 is an
    inert padding row) under the mask ``alive_masks[s]``. Whole scenarios
    go to one ``place_batched`` call, as many as
    :func:`sweep_scenarios_per_call` gives for the device and the shapes,
    labelled ``ka/whatif/chunk`` under a profiler. ``load`` is the (S,
    N_pad) node loads here; each chunk's ``bincount`` reads its input's
    largest value from the device (:func:`host_read`)."""
    dev = currents.device
    s, t = alive_masks.shape[0], topics.shape[1]
    n_pad = rack_idx.shape[0]
    per = sweep_scenarios_per_call(sweep_budget(dev), t, currents.shape[1],
                                   max(rf, currents.shape[2]), n_pad)
    moved, infeasible, loads, waves = [], [], [], {}
    for s0 in range(0, s, per):
        k = min(per, s - s0)
        idx = _rows(topics, slice(s0, s0 + k)).expand(k, t).reshape(-1).long()
        real, safe = idx >= 0, idx.clamp(min=0)
        cur = torch.where(real[:, None, None], currents[safe], -1)
        scen = torch.arange(k, device=dev).repeat_interleave(t)
        with span("whatif/chunk", report=False):
            res = place_batched(
                cur, rack_idx, jhashes[safe], torch.where(real, p_reals[safe], 0), n,
                rf, wave_mode, rfs[safe], r_cap, alive=alive_masks[s0:s0 + k],
                alive_row=scen,
            )
        placed = res.acc_nodes
        # Moved: a placed replica the row's current list does not hold (the
        # reference's membership diff, :1441-1444).
        in_old = (placed[..., None] == cur[:, :, None, :]).any(-1)
        moved.append(((placed >= 0) & ~in_old).sum((1, 2)).view(k, t).sum(1))
        infeasible.append(res.infeasible.view(k, t).any(1))
        # Node loads: every placed replica of a row into its scenario's row.
        node = torch.where(placed >= 0, placed, n_pad).long()
        node = node + (scen * (n_pad + 1))[:, None, None]
        loads.append(host_read(torch.bincount, node.view(-1), minlength=k * (n_pad + 1))
                     .view(k, n_pad + 1)[:, :n_pad])
        for leg, w in res.waves.items():
            waves[leg] = waves.get(leg, 0) + w
    return SweepResult(torch.cat(moved), torch.cat(infeasible), torch.cat(loads),
                       waves, s * t, len(moved), min(per, s))


def whatif_sweep(
    currents: torch.Tensor,     # (B, P_pad, L) the cluster's topics
    rack_idx: torch.Tensor,     # (N_pad,)
    jhashes: torch.Tensor,      # (B,)
    p_reals: torch.Tensor,      # (B,)
    alive_masks: torch.Tensor,  # (S, N_pad) one liveness mask per scenario
    n: int,
    rf: int,                    # batch-max RF
    wave_mode: str = "fast",
    rfs: torch.Tensor | None = None,  # (B,) per-topic RF
    r_cap: int | None = None,
) -> SweepResult:
    """S broker-removal scenarios over the whole cluster (the reference's
    ``whatif_sweep``, :1393): every topic placed under every scenario's
    mask, placement only (the metrics are set-based; leadership only
    permutes a row). ``load`` is each scenario's max node load. The sweep
    runs ``fast`` (a raised flag may be a strand; the caller re-runs such
    scenarios with ``auto``) and the giant-shape chain where
    :func:`resolve_chain` says so."""
    b = currents.shape[0]
    currents = currents.to(I32)
    rfs = torch.full((b,), rf, dtype=I32, device=currents.device) if rfs is None else rfs
    topics = torch.arange(b, device=currents.device)[None]
    res = _sweep(currents, rack_idx, jhashes, p_reals, rfs, topics, alive_masks,
                 n, rf, wave_mode, r_cap)
    return res._replace(load=res.load.amax(1))


def whatif_subset_sweep(
    currents: torch.Tensor,     # (B, P_pad, L) the cluster's topics
    rack_idx: torch.Tensor,     # (N_pad,)
    jhashes: torch.Tensor,      # (B,)
    p_reals: torch.Tensor,      # (B,)
    topics: torch.Tensor,       # (S, T_pad) each scenario's affected topics; -1 pads
    alive_masks: torch.Tensor,  # (S, N_pad)
    n: int,
    rf: int,
    rfs: torch.Tensor | None = None,  # (B,)
    r_cap: int | None = None,
) -> SweepResult:
    """The sweep restricted to each scenario's own affected topics (the
    reference's ``whatif_subset_sweep``, :1458; the device half of the
    incremental sweep), on the ``fast`` leg. The (S, T_pad) index table
    stands in for the reference's per-scenario copies of the topic
    tensors; a -1 entry is an inert row, as the reference's zero padding
    is. ``load`` is the (S, n) node loads of the subset's placements."""
    b = currents.shape[0]
    currents = currents.to(I32)
    rfs = torch.full((b,), rf, dtype=I32, device=currents.device) if rfs is None else rfs
    res = _sweep(currents, rack_idx, jhashes, p_reals, rfs, topics, alive_masks,
                 n, rf, "fast", r_cap)
    return res._replace(load=res.load[:, :n])


# ---------------------------------------------------------------------------
# Consumer-group packing: the reference's K14 ``pack_group`` (:1552) and K15
# ``group_pack_sweep`` (:1638), batched over a leading candidate axis S.
#
# 1. sticky admission, ascending partition row per owner: row p stays on
#    its current owner c iff c is alive and the prefix weight of p and all
#    earlier rows currently on c fits cap[c]; one segmented prefix sum
#    (a stable sort on the owner key, an int32 cumsum, each segment's first
#    index by searchsorted), in plain PyTorch as in the reference;
# 2. orphan spread in ``proc_order``: the scan, ``ops/group_pack.py:
#    pack_scan`` (the KG1 kernel on the card, its plain version on the CPU).
#
# Weights and capacities arrive as int32 in a domain groups/encode.py keeps
# under 2^30, so every sum here stays int32.
# ---------------------------------------------------------------------------


def sticky_admission(
    weights: torch.Tensor,     # (S, P_pad) int32 scaled weights (0 on pad rows)
    capacities: torch.Tensor,  # (C_pad,) int32 scaled capacities
    current: torch.Tensor,     # (P_pad,) int32 current consumer index or -1
    alive: torch.Tensor,       # (S, C_pad) bool consumer liveness
    p_real: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1 of the packing for every candidate: ``(cur (P_pad,), assigned
    (S, P_pad), load (S, C_pad), need (S, P_pad))``, with ``cur`` the
    current owners masked to real rows, ``assigned`` the kept owners (-1
    elsewhere), ``load`` their weight per consumer, and ``need`` the real
    rows the orphan scan places. ``assigned`` and ``load`` are contiguous,
    ready for the scan to update in place."""
    s, p_pad = weights.shape
    c_pad = capacities.shape[0]
    dev = weights.device
    rows_real = torch.arange(p_pad, dtype=I32, device=dev) < p_real
    cur = torch.where(rows_real, current, -1)
    safe_cur = cur.clamp(0, c_pad - 1).long()
    sticky_cand = (cur >= 0)[None, :] & alive[:, safe_cur]

    # One segmented prefix sum: a stable sort on the owner key groups each
    # consumer's candidate rows in ascending row order; the inclusive
    # in-segment prefix is the cumsum minus the total through the previous
    # segment.
    key = torch.where(sticky_cand, cur[None, :], c_pad)
    sk, order = torch.sort(key, dim=1, stable=True)
    csum = torch.cumsum(torch.where(sticky_cand, weights, 0).gather(1, order), 1,
                        dtype=I32)
    first = torch.searchsorted(sk, sk, side="left")
    seg_base = torch.where(first > 0, csum.gather(1, (first - 1).clamp(min=0)), 0)
    cap_of = capacities[sk.clamp(0, c_pad - 1).long()]
    keep_sorted = sticky_cand.gather(1, order) & (csum - seg_base <= cap_of)
    kept = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)

    slot = torch.where(kept, safe_cur[None, :], c_pad)
    load = torch.zeros((s, c_pad + 1), dtype=I32, device=dev).scatter_add_(
        1, slot, torch.where(kept, weights, 0))[:, :c_pad].contiguous()
    assigned = torch.where(kept, cur[None, :], -1).contiguous()
    return cur, assigned, load, rows_real[None, :] & ~kept


def pack_group(
    weights: torch.Tensor,     # (S, P_pad) int32 scaled weights (0 on pad rows)
    capacities: torch.Tensor,  # (C_pad,) int32 scaled capacities
    current: torch.Tensor,     # (P_pad,) int32 current consumer index or -1
    proc_order: torch.Tensor,  # (P_pad,) int32 rows by (-base weight, row)
    alive: torch.Tensor,       # (S, C_pad) bool consumer liveness
    p_real: int,
    record: Dict[str, float] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each candidate's capacity-constrained partition-to-consumer packing:
    :func:`sticky_admission`, then the orphan scan.

    Returns ``(assigned (S, P_pad), load (S, C_pad), moved (S,), overflowed
    (S,), infeasible (S,))``, the reference's tuple per candidate. With
    ``record``, the sticky pass and the scan each end in a device sync and
    their ms go to ``record["sticky"]`` and ``["scan"]``, and the scan's
    steps (orphan rows per candidate) to ``["steps_max"]`` and
    ``["steps_sum"]``."""
    from .group_pack import pack_scan

    t0 = time.perf_counter()
    dev = weights.device
    cur, assigned, load, need = sticky_admission(weights, capacities, current, alive,
                                                 p_real)
    if record is not None:
        steps = need.sum(1)
        record.update(steps_max=int(steps.max()), steps_sum=int(steps.sum()),
                      sticky=_sync_ms(dev, t0))
        t0 = time.perf_counter()
    overflowed = pack_scan(weights, capacities, proc_order, alive, need, assigned, load)
    if record is not None:
        record["scan"] = _sync_ms(dev, t0)
    moved = ((cur >= 0) & (assigned != cur)).sum(1, dtype=I32)
    return assigned, load, moved, overflowed, overflowed > 0


def group_pack_sweep(
    weights: torch.Tensor,      # (P_pad,) int32 BASE weights
    capacities: torch.Tensor,   # (C_pad,) int32
    current: torch.Tensor,      # (P_pad,) int32
    proc_order: torch.Tensor,   # (P_pad,) int32 (scale-invariant, host-built)
    alive_masks: torch.Tensor,  # (S, C_pad) bool: "k consumers" = first k alive
    scale_pcts: torch.Tensor,   # (S,) int32 weight scale, percent
    p_real: int,
    record: Dict[str, float] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The autoscale sweep: every (consumer count x weight scale) candidate
    packed at once. Returns ``(moved (S,), overflowed (S,), infeasible
    (S,), load (S, C_pad))``. Scaled weights are ``(w * scale) // 100``,
    floored at 1 on real rows and 0 on pad rows; ``proc_order`` is shared,
    since positive scaling never reorders descending weights."""
    p_pad = weights.shape[0]
    rows_real = torch.arange(p_pad, dtype=I32, device=weights.device) < p_real
    w = (weights[None, :] * scale_pcts[:, None]) // 100
    w = torch.maximum(w, rows_real.to(I32)[None, :])
    _, load, moved, overflowed, infeasible = pack_group(
        w, capacities, current, proc_order, alive_masks, p_real, record)
    return moved, overflowed, infeasible, load


def _sync_ms(dev: torch.device, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3
