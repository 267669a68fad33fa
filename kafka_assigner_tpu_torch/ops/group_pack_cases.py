"""Stress cases of the group-pack kernel (KG1), the check that holds it
against its plain version, and the timing helpers that ``chip_smoke.py``
uses: the kernel's own time a step, and the step probe's floor. The CPU tests run the same cases through ``pack_group`` against the
JAX package and the host oracle.

A case is a packing instance, ``(name, weights (S, P_pad), capacities
(C_pad,), current (P_pad,), proc_order (P_pad,), alive (S, C_pad), p_real,
force_global)``, all numpy; the scan's own inputs come from the sticky pass
(``ops/assignment.py:sticky_admission``).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from . import group_pack as gp
from .assignment import sticky_admission

Case = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, bool]

#: C_pad past the shared-memory opt-in limit (9 bytes a consumer over
#: 232,448 bytes on an H100): the global-memory variant.
GLOBAL_C_PAD = 32768
#: The largest C_pad of each of the register variant's K (consumers a
#: lane: 1, 2, 4, ..., 32) for a candidate whose last column is alive, and
#: a C_pad of the shared variant beyond them.
BUCKET_C_PADS = tuple(32 << i for i in range(gp.MAX_SLOTS.bit_length()))
SHARED_C_PAD = 2048
#: Real rows of a ring case: more orphans than the register variant's ring
#: holds (1,024 entries, ``csrc/group_pack.cu:kRing``), in each candidate.
RING_ROWS = 3000
#: The orphan share of the rows of the sparse step time (``step_ns``).
SPARSE_ORPHAN_SHARE = 0.2


def proc_order_of(weights: np.ndarray, p_real: int) -> np.ndarray:
    """Real rows by (-weight, row), then the pad rows, as
    ``groups/encode.py`` orders them."""
    order = sorted(range(p_real), key=lambda r: (-int(weights[r]), r))
    return np.array(order + list(range(p_real, len(weights))), np.int32)


def instance(rng, s: int, p_pad: int, p_real: int, c_pad: int, n_live: int,
             weights=(1, 2, 3, 5, 8, 40), caps=(0, 10, 60, 200), owned=0.7,
             dead=0.2) -> Tuple[np.ndarray, ...]:
    """A random instance: weights from a small set (many ties), capacities
    from ``caps`` on the first ``n_live`` columns (0 beyond, as pad
    columns), current owners over every column or -1, and per candidate
    the first ``n_live`` columns alive but a ``dead`` share of them."""
    w = np.zeros((s, p_pad), np.int32)
    base = rng.choice(weights, p_real).astype(np.int32)
    scale = rng.choice([100, 150, 300], s)
    w[:, :p_real] = np.maximum(base[None, :] * scale[:, None] // 100, 1)
    cap = np.zeros(c_pad, np.int32)
    cap[:n_live] = rng.choice(caps, n_live)
    cur = np.where(rng.random(p_pad) < owned, rng.integers(0, c_pad, p_pad), -1)
    alive = np.zeros((s, c_pad), bool)
    alive[:, :n_live] = rng.random((s, n_live)) >= dead
    order = proc_order_of(np.pad(base, (0, p_pad - p_real)), p_real)
    return w, cap, cur.astype(np.int32), order, alive


def boundary_case(rng, c_pad: int) -> Case:
    """A case at one C_pad of the variants' boundaries, three candidates
    on equal capacities (ties within a lane's slice and across lanes): all
    live consumers alive; a third of them dead, the last three real columns
    (inside the last lane's slice) among them; none alive. The last four
    columns are the encoding's pad columns (dead, capacity 0), and the
    register variant pads its slots past C_pad: neither may be picked while
    a consumer lives."""
    s, p_pad, p_real = 3, 160, 150
    n_live = c_pad - 4
    w, _, cur, order, alive = instance(rng, s, p_pad, p_real, c_pad, n_live,
                                       weights=(1, 2, 3, 5), owned=0.3, dead=0.0)
    cap = np.zeros(c_pad, np.int32)
    cap[:n_live] = 60
    cur = np.where(cur < n_live, cur, -1).astype(np.int32)
    alive[1] = alive[0] & (rng.random(c_pad) >= 1 / 3)
    alive[1, n_live - 3:n_live] = False
    alive[2] = False
    return (f"bucket-{c_pad}", w, cap, cur, order, alive, p_real, False)


def ring_case(rng, c_pad: int) -> Case:
    """A case at one C_pad whose two candidates each have over 1,024 orphan
    rows, so that the register variant's ring wraps and its producer waits
    for room: every row of the first is an orphan (the owners, all in the
    lower half of the columns, are dead), the second keeps about half its
    rows on their owners, so its orphans are sparse in ``proc_order``. The
    last column is alive in both, so both run at K = C_pad / 32 consumers a
    lane; capacities fall short of the first's weight, so rows overflow."""
    p_pad, p_real = RING_ROWS + 72, RING_ROWS
    half = max(c_pad // 2, 1)
    base = rng.choice((1, 2, 3, 5, 8), p_real).astype(np.int32)
    w = np.zeros((2, p_pad), np.int32)
    w[0, :p_real] = base
    w[1, :p_real] = np.maximum(base * 3 // 2, 1)
    cur = np.where(rng.random(p_pad) < 0.55, rng.integers(0, half, p_pad), -1)
    mean = int(w[1].sum()) // c_pad
    cap = rng.integers(mean // 2, mean + 2, c_pad).astype(np.int32)
    alive = np.ones((2, c_pad), bool)
    alive[0, :half] = False
    order = proc_order_of(np.pad(base, (0, p_pad - p_real)), p_real)
    return (f"ring-{c_pad}", w, cap, cur.astype(np.int32), order, alive, p_real, False)


def stress_cases(seed: int = 0) -> Iterator[Case]:
    """The cases of the kernel's rule, its lanes, its variants and their
    boundaries, and its skips."""
    rng = np.random.default_rng(seed)
    p = 64
    # Every headroom tied at every step: equal capacities, equal weights,
    # nothing owned; the picks walk the columns lowest index first.
    w = np.ones((4, p), np.int32)
    yield ("every-headroom-tied", w, np.full(16, 100, np.int32),
           np.full(p, -1, np.int32), np.arange(p, dtype=np.int32),
           np.ones((4, 16), bool), p, False)
    # No consumer alive: every pick is consumer 0 and every row overflows.
    w, cap, cur, order, _ = instance(rng, 2, p, 60, 16, 16)
    yield ("no-consumer-alive", w, cap, cur, order, np.zeros((2, 16), bool), 60, False)
    # Every weight above every capacity: every row overflows.
    w, cap, cur, order, alive = instance(rng, 3, p, p, 24, 24, weights=(50, 70, 90),
                                         caps=(1, 5, 10), dead=0.0)
    yield ("every-row-overflows", w, cap, np.full(p, -1, np.int32), order, alive, p, False)
    # Zero-capacity live consumers beside live ones with room.
    w, cap, cur, order, alive = instance(rng, 3, p, 57, 16, 16, caps=(0, 0, 0, 30))
    yield ("zero-capacity-live", w, cap, cur, order, alive, 57, False)
    # C_pad across the lane counts: under a warp, one warp, a warp and a
    # bit, many consumers per lane.
    for c_pad in (8, 24, 32, 40, 512, 4096):
        n_live = max(c_pad - 5, 1)
        w, cap, cur, order, alive = instance(rng, 3, 96, 90, c_pad, n_live)
        yield (f"cpad-{c_pad}", w, cap, cur, order, alive, 90, False)
    w, cap, cur, order, alive = instance(rng, 3, 96, 90, 512, 500)
    yield ("cpad-512-forced-global", w, cap, cur, order, alive, 90, True)
    w, cap, cur, order, alive = instance(rng, 2, 32, 30, GLOBAL_C_PAD, 40000 // 2)
    yield (f"cpad-{GLOBAL_C_PAD}-past-smem", w, cap, cur, order, alive, 30, False)
    # P_pad 8 with a single real row.
    w, cap, cur, order, alive = instance(rng, 2, 8, 1, 8, 3)
    yield ("p8-one-real-row", w, cap, cur, order, alive, 1, False)
    # One candidate, and a sweep's 256.
    w, cap, cur, order, alive = instance(rng, 1, p, 50, 16, 12)
    yield ("s1", w, cap, cur, order, alive, 50, False)
    w, cap, cur, order, alive = instance(rng, 256, p, 61, 8, 8)
    yield ("s256", w, cap, cur, order, alive, 61, False)
    # Nothing to place: every real row owned by a live consumer with room.
    cur = rng.integers(0, 8, p).astype(np.int32)
    w = rng.integers(1, 5, (2, p)).astype(np.int32)
    yield ("need-none", w, np.full(8, 10_000, np.int32), cur,
           proc_order_of(w[0], p), np.ones((2, 8), bool), p, False)
    # Each register bucket's largest C_pad and just past it (1,032 crosses
    # into the shared variant).
    rng = np.random.default_rng(seed + 1)
    for c_pad in BUCKET_C_PADS:
        yield boundary_case(rng, c_pad)
        yield boundary_case(rng, c_pad + 8)
    # Live consumers on a prefix of C_pad 1,024, of a length per candidate
    # (a sweep's counts): the register variant narrows each candidate's
    # slices to its span, from one consumer a lane to 32.
    spans = (1, 2, 33, 64, 100, 129, 256, 300, 512, 700, 1020)
    w, cap, cur, order, _ = instance(rng, len(spans), 160, 150, 1024, 1024,
                                     weights=(1, 2, 3, 5), caps=(60,), owned=0.3)
    alive = np.arange(1024)[None, :] < np.array(spans)[:, None]
    yield ("live-spans-1024", w, cap, cur, order, alive, 150, False)
    # More orphan rows than the register variant's ring holds, at each K.
    for c_pad in BUCKET_C_PADS:
        yield ring_case(rng, c_pad)


def scan_inputs(case: Case, device: str = "cpu"):
    """The scan's inputs for a case, after the sticky pass on ``device``:
    ``(weights, capacities, proc_order, alive, need, assigned, load)``."""
    _, w, cap, cur, order, alive, p_real, _ = case
    t = [torch.as_tensor(np.ascontiguousarray(x)).to(device)
         for x in (w, cap, cur, order, alive)]
    _, assigned, load, need = sticky_admission(t[0], t[1], t[2], t[4], p_real)
    return t[0], t[1], t[3], t[4], need, assigned, load


def check_case(case: Case, device: str = "cuda") -> int:
    """Max |kernel - plain| over ``assigned``, ``load`` and ``overflowed``
    for one case; the plain version runs on the CPU on the same inputs."""
    k_in = scan_inputs(case, device)
    p_in = tuple(x.cpu().clone() for x in k_in)
    over_k = gp.pack_scan(*k_in, force_global=case[7])
    torch.cuda.synchronize()
    over_p = gp.pack_scan_plain(*p_in)
    return max(int((a.cpu().long() - b.long()).abs().max())
               for a, b in ((k_in[5], p_in[5]), (k_in[6], p_in[6]), (over_k, over_p)))


def scan_bytes(s: int, p_pad: int, c_pad: int, orphans: int) -> int:
    """Bytes the scan must move for this data: the need flags, proc_order,
    capacities and liveness read once, the loads read and written, the
    weights read and assignments written for the orphan rows only, and the
    overflow counts."""
    return s * p_pad + 4 * p_pad + 4 * c_pad + s * c_pad + 8 * s * c_pad \
        + 8 * orphans + 4 * s


def step_ns(c_pad: int, steps: int = 1 << 18, reps: int = 5, sparse: bool = False) -> float:
    """ns per orphan row of one candidate's chain at ``c_pad``: the kernel
    on one candidate with ``steps`` orphan rows (all consumers alive with
    room), the median of ``reps`` launches by CUDA events over the orphan
    rows. Every row is an orphan; with ``sparse`` the orphans are a
    :data:`SPARSE_ORPHAN_SHARE` of the rows, drawn from a seed, so the time
    includes the row stream over the rows that need nothing. The inputs are
    re-made before each launch, since the scan updates them in place; the
    launches count as none."""
    rng = np.random.default_rng(0)
    density = SPARSE_ORPHAN_SHARE if sparse else 1.0
    rows = int(round(steps / density))
    w = torch.as_tensor(rng.integers(1, 100, (1, rows)).astype(np.int32), device="cuda")
    cap = torch.full((c_pad,), 1 << 29, dtype=torch.int32, device="cuda")
    order = torch.as_tensor(proc_order_of(w[0].cpu().numpy(), rows), device="cuda")
    alive = torch.ones((1, c_pad), dtype=torch.bool, device="cuda")
    flags = np.ones(rows, bool)
    if sparse:
        flags[:] = False
        flags[rng.choice(rows, steps, replace=False)] = True
    need = torch.as_tensor(flags[None, :], device="cuda")
    assigned = torch.empty((1, rows), dtype=torch.int32, device="cuda")
    load = torch.empty((1, c_pad), dtype=torch.int32, device="cuda")
    before = gp.launches["group_pack"]
    times: List[float] = []
    for i in range(reps + 1):  # 1 warm-up
        assigned.fill_(-1)
        load.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gp.pack_scan(w, cap, order, alive, need, assigned, load)
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    gp.launches["group_pack"] = before
    return float(np.median(times)) * 1e6 / steps


def probe_slot(seed: int = 0, weight: int = 37) -> np.ndarray:
    """The step probe's input: 32 headrooms, one a lane, drawn from a seed
    in [2^28, 2^29) (room for 2^21 steps of ``weight`` without an overflow,
    as a sweep's live consumers have), then the weight."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1 << 28, 1 << 29, gp.PROBE_WORDS - 1)
    return np.append(head, weight).astype(np.int32)


def probe_picks(slot: np.ndarray, steps: int) -> Tuple[int, int]:
    """``(last pick, overflow count)`` of the probe's chain after ``steps``
    steps, on the host: the first max of the headrooms, an overflow when it
    is below the weight, the weight off the picked headroom."""
    head = [int(h) for h in slot[:-1]]
    w = int(slot[-1])
    pick, over = -1, 0
    for _ in range(steps):
        v = max(head)
        pick = head.index(v)
        over += v < w
        head[pick] -= w
    return pick, over


def probe_ns(steps: int = 1 << 21, reps: int = 5, seed: int = 0,
             ballot: bool = False) -> Tuple[float, float]:
    """``(ns, cycles)`` per step of KG1's chain alone: the step probe over
    ``steps`` steps (with ``ballot``, the register variant's step), the
    median of ``reps`` calls timed with CUDA events, and its clock64 cycles
    over the same steps in the last call."""
    from .leadership_cases import event_ms

    slot = torch.as_tensor(probe_slot(seed), device="cuda")
    out = []
    times = event_ms(lambda: out.append(gp.step_probe(slot, steps, ballot)), reps)
    return float(np.median(times)) * 1e6 / steps, int(out[-1][2]) / steps
