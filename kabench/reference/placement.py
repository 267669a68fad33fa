"""The plain reference of a reassignment plan, in NumPy and plain Python.

A plan, per topic, against the live broker set (kafka-assigner's rules,
SiftScience/kafka-assigner ``KafkaAssignmentStrategy.java``, with the orphan
spread of the system under test, kafka-assigner-tpu's wave auction):

1. capacity: at most ``ceil(P * RF / N)`` replicas of the topic a broker;
2. the node graph: brokers in ascending id order; a broker without a rack
   is its own rack; racks numbered as first seen in that order over the
   brokers the request names (the live ones for a plan, every broker of the
   cluster for a removal scenario);
3. sticky fill: round-robin over the partitions in ascending order, one
   replica-list entry a pass, a current replica kept iff its broker is live,
   under capacity, does not hold the partition yet and its rack holds no
   replica of the partition;
4. orphan spread, topic by topic from the state phase 3 leaves, through a
   chain of legs; a leg that strands the topic hands it, from phase 3's
   state again, to the next (:func:`spread`);
5. leadership: partitions in ascending order, slot by slot the holder seen
   least often at that slot so far (first strict minimum in the holders'
   ascending order rotated by ``abs(javaHash(topic)) % holders``), counters
   shared by every topic of the plan in the order the plan solves them.

A broker's rotated position in a topic is ``(i + abs(javaHash(topic)) % N)
% N`` for the i-th live broker; "first-fit" means the least position.

Phase 3 runs vectorized over every partition of the cluster at once: within
one pass a partition offers one replica, so partitions interact only through
the per-topic capacity of a broker, which a stable sort by (topic, broker)
and a rank within each group settle in partition order. Phases 4 and 5 are
plain loops, a topic or a row at a time.

What a plan is held to (:func:`check_plan`): every row equal to this
module's plan, brokers and order. A removal scenario (:func:`removal_answer`)
is held to the same plan's moved replicas, feasibility and largest broker
load, exactly.

This module imports nothing of the program. ``control`` breaks one guarantee
the configurations state, for the benchmark's control runs only:
``leaders_unbalanced`` lists every row in broker id order (phase 5 left
out), ``unsticky`` keeps only the first entry of each current replica list
(movement no longer minimal).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

CONTROLS = ("leaders_unbalanced", "unsticky")

#: The legs of the orphan spread, in order. ``fast`` and ``balance`` are
#: rack auctions, ``dense`` a first-fit auction over every broker, ``seq``
#: the tool's own one-row-at-a-time first fit.
LEGS = ("fast", "dense", "balance", "seq")

#: Past these sizes the system under test rewrites its leg chain (a topic's
#: padded partitions times the padded brokers over 2**27, or the padded
#: brokers squared over 2**30 - 1); this reference covers the chain above
#: only, and refuses such shapes.
GIANT_ELEMS = 1 << 27
PACKED_KEYS = (1 << 30) - 1

_LAST = np.iinfo(np.int64).max


def java_string_hash(s: str) -> int:
    """Java ``String.hashCode()`` over UTF-16 code units, wrapped to int32."""
    h = 0
    for (u,) in struct.iter_unpack(">H", s.encode("utf-16-be")):
        h = (31 * h + u) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def abs_hash(topic: str) -> int:
    """``Math.abs(topic.hashCode())``; the tool fails on ``Integer.MIN_VALUE``."""
    h = java_string_hash(topic)
    if h == -(1 << 31):
        raise ValueError(f"topic {topic!r} hashes to Integer.MIN_VALUE")
    return abs(h)


@dataclass
class Flat:
    """Every partition of a cluster as one row, topics in solve order and
    partitions ascending within a topic."""

    names: List[str]
    hashes: List[int]            # abs java hash per topic
    topic_of: np.ndarray         # (R,) topic index of each row
    part_ids: np.ndarray         # (R,) partition id of each row
    cur: np.ndarray              # (R, W) current broker ids, -1 padded
    rf: np.ndarray               # (T,) replication factor per topic
    p_count: np.ndarray          # (T,) partitions per topic
    starts: np.ndarray           # (T + 1,) first row of each topic


def flatten(topics: Sequence[Tuple[str, Mapping[int, Sequence[int]]]],
            desired_rf: int = -1) -> Flat:
    """Rows of ``topics`` (``[(name, {partition: replicas})]``). A negative
    ``desired_rf`` keeps each topic's own, which must be uniform."""
    names, rfs, counts, parts, lists = [], [], [], [], []
    width = 1
    for name, assignment in topics:
        rows = sorted(assignment.items())
        rf = desired_rf
        for p, reps in rows:
            if desired_rf < 0:
                if rf < 0:
                    rf = len(reps)
                elif len(reps) != rf:
                    raise ValueError(f"topic {name}: partition {p} has "
                                     f"replication factor {len(reps)}")
            width = max(width, len(reps))
        names.append(name)
        rfs.append(rf)
        counts.append(len(rows))
        parts.extend(p for p, _ in rows)
        lists.extend(reps for _, reps in rows)
    cur = np.full((len(lists), width), -1, dtype=np.int64)
    for r, reps in enumerate(lists):
        cur[r, :len(reps)] = reps
    p_count = np.array(counts, dtype=np.int64)
    return Flat(
        names=names,
        hashes=[abs_hash(n) for n in names],
        topic_of=np.repeat(np.arange(len(names)), p_count),
        part_ids=np.array(parts, dtype=np.int64),
        cur=cur,
        rf=np.array(rfs, dtype=np.int64),
        p_count=p_count,
        starts=np.concatenate([[0], np.cumsum(p_count)]),
    )


@dataclass
class Placement:
    """Accepted brokers (as indices into the sorted live ids) per row, and
    the per-topic broker counts behind the capacity gate."""

    ids: np.ndarray       # (N,) live broker ids, ascending
    index: np.ndarray     # broker id -> index into ids, -1 when not live
    rack_of: np.ndarray   # (N,) rack number of each live broker (phase 2)
    n_racks: int          # racks among the brokers the request names
    cap: np.ndarray       # (T,) per-topic capacity
    acc: np.ndarray       # (R, S) accepted broker indices, -1 padded
    n_acc: np.ndarray     # (R,)
    cnt: np.ndarray       # (T * N,) replicas of topic t on broker i
    feasible: bool = True

    def brokers(self) -> np.ndarray:
        """``acc`` as broker ids."""
        return np.where(self.acc >= 0, self.ids[np.maximum(self.acc, 0)], -1)


def _index(ids: np.ndarray, *arrays: np.ndarray) -> np.ndarray:
    top = max([int(ids.max(initial=0))] + [int(a.max(initial=0)) for a in arrays]) + 1
    index = np.full(top, -1, dtype=np.int64)
    index[ids] = np.arange(len(ids))
    return index


def rack_numbers(brokers: Iterable[int], racks: Mapping[int, str]) -> Dict[str, int]:
    """Rack name -> number, as first seen over ``brokers`` in ascending id
    order (phase 2); a broker without a rack is the rack named by its id."""
    numbers: Dict[str, int] = {}
    for b in sorted(brokers):
        numbers.setdefault(racks.get(int(b), str(int(b))), len(numbers))
    return numbers


def sticky(flat: Flat, live: Set[int], racks: Mapping[int, str],
           control: Optional[str] = None,
           named: Optional[Iterable[int]] = None) -> Placement:
    """Phases 1-3 for every topic of ``flat`` against ``live``; racks are
    numbered over ``named`` (default ``live``)."""
    ids = np.array(sorted(live), dtype=np.int64)
    n = len(ids)
    numbers = rack_numbers(live if named is None else named, racks)
    rack_of = np.array([numbers[racks.get(int(b), str(int(b)))] for b in ids],
                       dtype=np.int64)
    n_rows, width = flat.cur.shape
    index = _index(ids, flat.cur)
    cur_idx = np.where(flat.cur >= 0, index[np.maximum(flat.cur, 0)], -1)
    t_n = len(flat.names)
    cap = -(-(flat.p_count * flat.rf) // max(n, 1))
    slots = max(width, int(flat.rf.max(initial=0)))
    acc = np.full((n_rows, slots), -1, dtype=np.int64)
    acc_rack = np.full((n_rows, slots), -1, dtype=np.int64)
    n_acc = np.zeros(n_rows, dtype=np.int64)
    cnt = np.zeros(t_n * n, dtype=np.int64)
    passes = 1 if control == "unsticky" else width
    for j in range(passes):
        node = cur_idx[:, j]
        ok = node >= 0
        if j:
            rk = np.where(ok, rack_of[np.maximum(node, 0)], -2)
            ok &= ~(acc[:, :j] == node[:, None]).any(1)
            ok &= ~(acc_rack[:, :j] == rk[:, None]).any(1)
        rows = np.nonzero(ok)[0]
        key = flat.topic_of[rows] * n + node[rows]
        order = np.argsort(key, kind="stable")
        rows, key = rows[order], key[order]
        rank = np.arange(len(key)) - np.searchsorted(key, key, side="left")
        take = cnt[key] + rank < cap[flat.topic_of[rows]]
        rows, key = rows[take], key[take]
        acc[rows, n_acc[rows]] = node[rows]
        acc_rack[rows, n_acc[rows]] = rack_of[node[rows]]
        n_acc[rows] += 1
        np.add.at(cnt, key, 1)
    return Placement(ids, index, rack_of, len(numbers), cap, acc, n_acc, cnt)


class _Topic:
    """One topic's spread state: ``acc`` (P, S) broker indices, ``count``
    (P,), ``load`` (N,) the topic's replicas a broker, ``need`` (P,)."""

    def __init__(self, acc, count, load, need):
        self.acc, self.count, self.load, self.need = acc, count, load, need

    def copy(self) -> "_Topic":
        return _Topic(self.acc.copy(), self.count.copy(), self.load.copy(),
                      self.need.copy())

    def held(self, p: int) -> np.ndarray:
        return self.acc[p, :self.count[p]]

    def accept(self, p: int, node: int) -> None:
        self.acc[p, self.count[p]] = node
        self.count[p] += 1
        self.load[node] += 1
        self.need[p] -= 1


def _auction_wave(st: _Topic, cap: int, pos: np.ndarray, rack_of: np.ndarray,
                  by_rack: np.ndarray, n_racks: int, k: int, balance: bool) -> bool:
    """One rack auction wave (legs ``fast`` and ``balance``); False when a
    wanting partition has no rack to bid for (the topic is stranded; the
    wave's other accepts stand).

    Every broker under capacity offers one slot. The candidate racks are the
    ``k`` with the best first-fit broker (``fast``) or the most headroom
    (``balance``, ties to the lower rack number), among racks with a broker
    to offer. Each wanting partition, in ascending order, bids for the first
    candidate rack it holds no replica in; the j-th bidder for a rack gets
    its j-th broker in first-fit order, when the rack has that many."""
    avail = st.load < cap
    nodes = by_rack[avail[by_rack]]            # by rack, then position
    first = np.searchsorted(rack_of[nodes], np.arange(n_racks), side="left")
    offered = np.searchsorted(rack_of[nodes], np.arange(n_racks), side="right") - first
    if balance:
        room = np.bincount(rack_of, weights=np.where(avail, cap - st.load, 0),
                           minlength=n_racks)
        cands = np.argsort(-room, kind="stable")[:k]
        cands = cands[room[cands] > 0]
    else:
        best = np.where(offered > 0, pos[nodes[np.minimum(first, len(nodes) - 1)]]
                        if len(nodes) else _LAST, _LAST)
        cands = np.argsort(best, kind="stable")[:k]
        cands = cands[best[cands] < _LAST]
    bids = np.zeros(n_racks, dtype=np.int64)
    won = []
    stranded = False
    for p in np.nonzero(st.need > 0)[0]:
        held = set(rack_of[st.held(p)].tolist())
        rack = next((int(r) for r in cands if int(r) not in held), None)
        if rack is None:
            stranded = True
            continue
        j = bids[rack]
        bids[rack] += 1
        if j < offered[rack]:
            won.append((p, int(nodes[first[rack] + j])))
    for p, node in won:
        st.accept(p, node)
    return not stranded


def _dense_wave(st: _Topic, cap: int, pos: np.ndarray, rack_of: np.ndarray) -> bool:
    """One first-fit auction wave over every broker (leg ``dense``): each
    wanting partition bids for its first-fit broker among those under
    capacity, not holding it and in a rack it holds no replica in; a broker
    takes its bidders in ascending order while under capacity."""
    under = st.load < cap
    bids: Dict[int, int] = {}
    won = []
    stranded = False
    for p in np.nonzero(st.need > 0)[0]:
        held = st.held(p)
        ok = under & ~np.isin(rack_of, rack_of[held])
        ok[held] = False
        if not ok.any():
            stranded = True
            continue
        node = int(np.argmin(np.where(ok, pos, _LAST)))
        rank = bids.get(node, 0)
        bids[node] = rank + 1
        if st.load[node] + rank < cap:
            won.append((p, node))
    for p, node in won:
        st.accept(p, node)
    return not stranded


def _seq_leg(st: _Topic, cap: int, pos: np.ndarray, rack_of: np.ndarray) -> bool:
    """The tool's own orphan spread (leg ``seq``): partitions in ascending
    order, each filled completely, replica by replica, by first fit among
    the brokers under capacity, not holding it, in a rack it holds no
    replica in."""
    feasible = True
    for p in np.nonzero(st.need > 0)[0]:
        while st.need[p] > 0:
            held = st.held(p)
            ok = (st.load < cap) & ~np.isin(rack_of, rack_of[held])
            ok[held] = False
            if not ok.any():
                feasible = False
                break
            st.accept(p, int(np.argmin(np.where(ok, pos, _LAST))))
    return feasible


def _pad_bound(n: int) -> int:
    """A power of two at least ``n``: no padding of the system under test
    exceeds it."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _chain_k(flat: Flat, n: int, n_racks: int) -> int:
    """The auction's candidate racks: the slot width plus one, at most the
    rack bound (the next power of two past ``n_racks``, 16 at least).
    Refuses the shapes at which the chain is rewritten."""
    if _pad_bound(flat.p_count.max(initial=1)) * _pad_bound(n) > GIANT_ELEMS \
            or _pad_bound(n) ** 2 >= PACKED_KEYS:
        raise ValueError(f"{flat.p_count.max()} partitions on {n} brokers: "
                         "past the shapes this reference covers")
    r_cap = 16
    while r_cap < n_racks + 1:
        r_cap *= 2
    return min(int(flat.rf.max(initial=1)) + 1, r_cap)


def spread(flat: Flat, pl: Placement) -> Placement:
    """Phase 4 on the result of :func:`sticky`: every topic with a replica
    to place runs the legs of :data:`LEGS` in order until one places all of
    them; each leg starts from phase 3's state. A topic that every leg
    strands makes the plan infeasible, and the spread ends there."""
    n = len(pl.ids)
    need = flat.rf[flat.topic_of] - pl.n_acc
    k = _chain_k(flat, n, pl.n_racks)
    for t in np.unique(flat.topic_of[need > 0]).tolist():
        lo, hi = int(flat.starts[t]), int(flat.starts[t + 1])
        cap = int(pl.cap[t])
        pos = (np.arange(n) + flat.hashes[t] % n) % n
        by_rack = np.lexsort((pos, pl.rack_of))
        after_sticky = _Topic(pl.acc[lo:hi], pl.n_acc[lo:hi], pl.cnt[t * n:(t + 1) * n],
                              need[lo:hi])
        for leg in LEGS:
            st = after_sticky.copy()
            if leg == "seq":
                done = _seq_leg(st, cap, pos, pl.rack_of)
            else:
                done = True
                while done and st.need.any():
                    if leg == "dense":
                        done = _dense_wave(st, cap, pos, pl.rack_of)
                    else:
                        done = _auction_wave(st, cap, pos, pl.rack_of, by_rack,
                                             pl.n_racks, k, leg == "balance")
            if done:
                break
        pl.acc[lo:hi], pl.n_acc[lo:hi], pl.cnt[t * n:(t + 1) * n] = st.acc, st.count, st.load
        if not done:
            pl.feasible = False
            return pl
    return pl


def order_leaders(flat: Flat, rows: np.ndarray) -> np.ndarray:
    """Phase 5 over ``rows`` (``(R, S)`` broker ids of each row's replicas,
    any order, -1 padded): each row's preference list, -1 padded. One set
    of counters spans every topic, in row order."""
    n_rows, slots = rows.shape
    topic_of = flat.topic_of.tolist()
    ctx: Dict[int, List[int]] = {}
    out = []
    for row, reps in enumerate(rows.tolist()):
        h = flat.hashes[topic_of[row]]
        cands = sorted(b for b in reps if b >= 0)
        pref = []
        for slot in range(len(cands)):
            m = len(cands)
            first = (m - h % m) % m
            best, best_v = -1, None
            for q in range(m):
                b = cands[(first + q) % m]
                seen = ctx.get(b)
                v = seen[slot] if seen is not None else 0
                if best_v is None or v < best_v:
                    best, best_v = b, v
            pref.append(best)
            cands.remove(best)
        for slot, b in enumerate(pref):
            seen = ctx.get(b)
            if seen is None:
                seen = ctx[b] = [0] * slots
            seen[slot] += 1
        out.append(pref + [-1] * (slots - len(pref)))
    return np.array(out, dtype=np.int64).reshape(n_rows, slots)


def plan(flat: Flat, live: Set[int], racks: Mapping[int, str],
         control: Optional[str] = None) -> Optional[np.ndarray]:
    """The whole plan as ``(R, S)`` preference lists (broker ids, -1
    padded), or None when it is infeasible."""
    pl = spread(flat, sticky(flat, live, racks, control))
    if not pl.feasible:
        return None
    placed = pl.brokers()
    if control == "leaders_unbalanced":
        placed = np.sort(np.where(placed >= 0, placed, _LAST), 1)
        return np.where(placed == _LAST, -1, placed)
    return order_leaders(flat, placed)


def as_pairs(flat: Flat, rows: np.ndarray) -> List[Tuple[str, Dict[int, List[int]]]]:
    """``(R, S)`` preference lists as a plan ``[(topic, {partition: ...})]``."""
    out = []
    for t, name in enumerate(flat.names):
        lo, hi = int(flat.starts[t]), int(flat.starts[t + 1])
        out.append((name, {int(p): [int(b) for b in r if b >= 0]
                           for p, r in zip(flat.part_ids[lo:hi], rows[lo:hi])}))
    return out


def as_rows(flat: Flat, pairs: Sequence[Tuple[str, Mapping[int, Sequence[int]]]],
            width: int) -> Tuple[np.ndarray, int]:
    """A plan as returned by the program, as ``(R, width)`` broker ids in
    ``flat``'s row order (-1 padded; every entry -2 where the plan has no
    such row), and how many rows it has that ``flat`` does not (or that do
    not fit ``width``)."""
    out = np.full((len(flat.part_ids), width), -2, dtype=np.int64)
    where = {name: t for t, name in enumerate(flat.names)}
    extra = 0
    seen = set()
    for name, assignment in pairs:
        t = where.get(name)
        if t is None or t in seen:
            extra += len(assignment)
            continue
        seen.add(t)
        lo, hi = int(flat.starts[t]), int(flat.starts[t + 1])
        rows = dict(zip(flat.part_ids[lo:hi].tolist(), range(lo, hi)))
        for p, reps in assignment.items():
            r = rows.get(int(p))
            if r is None or len(reps) > width:
                extra += 1
                continue
            out[r, :len(reps)] = reps
            out[r, len(reps):] = -1
    return out, extra


def check_plan(flat: Flat, live: Set[int], racks: Mapping[int, str],
               pairs: Sequence[Tuple[str, Mapping[int, Sequence[int]]]]) -> int:
    """Rows of the plan ``pairs`` that differ from :func:`plan` for the
    cluster ``flat`` with ``live`` brokers: another broker, another order, a
    row missing or made up. Every row counts when the reference finds the
    plan infeasible."""
    want = plan(flat, live, racks)
    width = flat.cur.shape[1] if want is None else want.shape[1]
    got, extra = as_rows(flat, pairs, max(width, int(flat.rf.max(initial=1))))
    if want is None:
        return len(got) + extra
    return int((got != want).any(1).sum()) + extra


def removal_answer(flat: Flat, brokers: Set[int], racks: Mapping[int, str],
                   removed: Sequence[int], control: Optional[str] = None
                   ) -> Tuple[int, bool, int]:
    """``(moved replicas, feasible, largest broker load)`` of the whole plan
    with ``removed`` gone from ``brokers``: the replicas placed on a broker
    that did not hold them, and the most replicas on one broker."""
    live = set(brokers) - set(removed)
    pl = spread(flat, sticky(flat, live, racks, control, named=brokers))
    placed = pl.brokers()
    width = max(placed.shape[1], flat.cur.shape[1])
    cur = np.pad(flat.cur, ((0, 0), (0, width - flat.cur.shape[1])), constant_values=-1)
    in_old = (placed[:, :, None] == cur[:, None, :]).any(-1)
    moved = int(((placed >= 0) & ~in_old).sum())
    load = np.bincount(pl.acc[pl.acc >= 0], minlength=len(pl.ids))
    return moved, pl.feasible, int(load.max(initial=0))


def removal_agrees(want: Tuple[int, bool, int], got: Tuple[int, bool, int]) -> bool:
    """Whether a program's ``(moved, feasible, largest load)`` for one
    removal is :func:`removal_answer`'s: the feasibility, and where both are
    feasible every number."""
    if not (want[1] and got[1]):
        return bool(want[1]) == bool(got[1])
    return tuple(want) == tuple(got)
