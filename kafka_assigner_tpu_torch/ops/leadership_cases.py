"""Stress cases of the leadership kernel, the check that holds it against
its plain version, and the timing helpers that ``chip_smoke.py`` and
``scripts/torch_leadership_bench.py`` share.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from . import leadership as lead

Case = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]


def random_rows(rng, b: int, p: int, n: int, rf: int, counts=None):
    """(B, P, RF) rows of distinct brokers below ``n``, counts 0..RF (or
    the given (B, P) counts), -1 past each count."""
    acc = np.full((b, p, rf), -1, np.int32)
    cnt = (rng.integers(0, rf + 1, (b, p)) if counts is None else counts).astype(np.int32)
    for t in range(b):
        for i in range(p):
            c = min(int(cnt[t, i]), rf)
            if c > 0:
                acc[t, i, :c] = rng.choice(n, c, replace=False)
    return acc, cnt


def stress_cases(seed: int = 0) -> Iterator[Case]:
    """``(name, acc, count, counters, jhashes, force_global)`` cases that
    stress the kernel's pipeline, its tiles and its index semantics."""
    rng = np.random.default_rng(seed)

    def slab(n, rf, hi=5):
        return rng.integers(0, hi, (n, rf)).astype(np.int32)

    def jh(b):
        return rng.integers(0, 2**30, b).astype(np.int32)

    for rf in (1, 2, 3, 4, 5, 12, 32):
        acc, cnt = random_rows(rng, 3, 45, max(50, rf), rf)
        for force_global in (False, True):
            kind = "global" if force_global else "smem"
            yield (f"rf{rf}-{kind}", acc, cnt, slab(max(50, rf) + 6, rf),
                   jh(3), force_global)
    # Every row on the same RF brokers: every step of every column conflicts.
    for rf in (1, 3, 4):
        for n in (rf, rf + 1):
            acc = np.stack([rng.permutation(rf) for _ in range(2 * 300)])
            acc = acc.reshape(2, 300, rf).astype(np.int32)
            cnt = np.full((2, 300), rf, np.int32)
            yield (f"same-brokers-rf{rf}-npad{n}", acc, cnt, slab(n, rf, 3),
                   jh(2), False)
    # A mixed-RF batch: width 4, topics of RF 2, 3 and 4, counts below them.
    rfs = np.array([2, 4, 3, 2, 4, 3], np.int32)
    counts = np.minimum(rng.integers(0, 5, (6, 50)), rfs[:, None])
    acc, cnt = random_rows(rng, 6, 50, 40, 4, counts)
    yield ("mixed-rf-width4", acc, cnt, slab(40, 4), jh(6), False)
    # One partition per topic, and one long topic ending on a partial tile.
    acc, cnt = random_rows(rng, 5, 1, 30, 3)
    yield ("p1", acc, cnt, slab(30, 3), jh(5), False)
    acc, cnt = random_rows(rng, 1, 5000, 200, 3, np.full((1, 5000), 3))
    yield ("one-topic-p5000", acc, cnt, slab(200, 3), jh(1), False)
    # One long topic at the giant cells' N_pad, its counters carried in
    # from a slab already deep in use: 20,000 full rows of distinct brokers.
    n_pad, rows = 5104, 20000
    first = rng.integers(0, n_pad, rows)
    d1 = rng.integers(1, n_pad // 2, rows)
    d2 = rng.integers(1, n_pad // 2, rows)
    acc = np.stack([first, first + d1, first + d1 + d2], 1) % n_pad
    yield ("one-topic-p20000-warm-slab", acc.astype(np.int32)[None],
           np.full((1, rows), 3, np.int32), slab(n_pad, 3, 400), jh(1), False)
    # -1 and >= N_pad candidates, counts above RF, a negative hash.
    acc = rng.integers(-1, 14, (2, 40, 3)).astype(np.int32)
    cnt = rng.integers(-1, 5, (2, 40)).astype(np.int32)
    yield ("out-of-range", acc, cnt, slab(10, 3), np.array([7, -13], np.int32),
           False)
    # 320 KB slab: above the shared-memory opt-in limit.
    acc, cnt = random_rows(rng, 2, 16, 20000, 4)
    yield ("rf4-slab-over-optin-limit", acc, cnt, slab(20006, 4, 3), jh(2),
           False)


def check_case(case: Case, device: str = "cuda") -> int:
    """Max |kernel - plain| over outputs and counters for one case; the
    plain version runs on the CPU copies of the same inputs."""
    _, acc, cnt, counters, jhs, force_global = case
    args = [torch.as_tensor(x) for x in (acc, cnt, counters, jhs)]
    o_k, c_k = lead.leadership_order(
        *(a.to(device) for a in args), force_global_slab=force_global
    )
    torch.cuda.synchronize()
    o_p, c_p = lead.leadership_order_plain(*args)
    return max(int((o_k.cpu() - o_p).abs().max()), int((c_k.cpu() - c_p).abs().max()))


def event_ms(fn: Callable[[], object], reps: int) -> List[float]:
    """Each of ``reps`` calls timed on its own with CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def chain_steps(rows: int, rf: int) -> int:
    """Dependent steps of the chain: lane r runs two rows behind lane r-1."""
    return rows + 2 * (rf - 1)


def chain_step_ns(rf: int, steps: int = 1 << 21, reps: int = 5,
                  seed: int = 0) -> Tuple[float, float]:
    """``(ns, cycles)`` per step of the kernel's chain alone, at ``rf``:
    :func:`~kafka_assigner_tpu_torch.ops.leadership.chain_probe` over
    ``steps`` steps, the median of ``reps`` calls timed with CUDA events, and
    the probe's clock64 cycles over the same steps in the last call. The
    slot is slot 0 of a full row of distinct brokers on a zero slab, as the
    main path's first rows are; its choice alternates between the two
    lowest keys, as a bump makes it do."""
    rng = np.random.default_rng(seed)
    n_pad = 5000
    cand = rng.choice(n_pad, rf, replace=False)
    key = rng.permutation(rf)  # counter 0, m = rf: the key is the rotation
    words = np.concatenate([key, key + rf, cand, cand, np.zeros(rf), [1, n_pad]])
    slot = torch.as_tensor(words.astype(np.int32), device="cuda")
    out = []
    times = event_ms(lambda: out.append(lead.chain_probe(rf, slot, steps)), reps)
    cycles = int(out[-1][1])
    return float(np.median(times)) * 1e6 / steps, cycles / steps
