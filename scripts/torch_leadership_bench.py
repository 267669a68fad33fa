#!/usr/bin/env python3
"""The port's leadership kernel alone on the card, at config 4's shape.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_leadership_bench.py [--reps 10] [--baseline DIR] [--sass]

The inputs are config 4's leadership shape: B 2,000 topics, P_pad 104 (100
real partitions and 4 empty rows), RF 3, N_pad 5,000, random distinct
brokers per row and a zero slab. The script builds ``csrc/leadership.cu``,
checks that the shared- and global-memory slabs give the same result, and
times each launch on its own with CUDA events (median of ``--reps``):

- the kernel with the slab in shared memory, and forced into global memory;
- the same launches split at an event recorded between the prologue and the
  chain: the first part is the counter slab's copy and the prologue, the
  second the chain;
- the chain alone per step, from the probe kernel.

``--baseline DIR`` also times the kernel of another checkout of the repo
(say the parent commit's tree, unpacked with ``git archive`` into a
git-ignored directory) on the same inputs, in turns: baseline, this, this,
baseline. ``--sass`` counts the RF-3 chain loop's SASS instructions per step
with ``cuobjdump``. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kafka_assigner_tpu_torch.ops import build  # noqa: E402
from kafka_assigner_tpu_torch.ops import leadership as lead  # noqa: E402
from kafka_assigner_tpu_torch.ops import leadership_cases as cases  # noqa: E402

B, P_REAL, P_PAD, RF, N_PAD = 2000, 100, 104, 3, 5000


def config4_args(seed: int = 0):
    """Config 4's leadership inputs with random distinct brokers per row."""
    rng = np.random.default_rng(seed)
    rows = B * P_PAD
    acc = rng.integers(0, N_PAD, (rows, RF))
    while True:  # redraw rows that repeat a broker
        s = np.sort(acc, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            break
        acc[dup] = rng.integers(0, N_PAD, (int(dup.sum()), RF))
    acc = acc.reshape(B, P_PAD, RF).astype(np.int32)
    cnt = np.full((B, P_PAD), RF, np.int32)
    acc[:, P_REAL:] = -1
    cnt[:, P_REAL:] = 0
    counters = np.zeros((N_PAD, RF), np.int32)
    jhs = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    return tuple(torch.as_tensor(x, device="cuda") for x in (acc, cnt, counters, jhs))


def split_ms(args, reps: int):
    """``(first, second)`` lists of ms per launch, split at the event the
    kernel records between its prologue and its chain."""
    lead.leadership_order(*args)
    torch.cuda.synchronize()
    first, second = [], []
    for _ in range(reps):
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        lead.leadership_order(*args, mid_event=mid)
        end.record()
        end.synchronize()
        first.append(start.elapsed_time(mid))
        second.append(mid.elapsed_time(end))
    return first, second


def baseline_leadership(root: str):
    """The ``ops.leadership`` module of another checkout, loaded beside this
    one under its own name; it builds its kernel into that checkout's own
    ``build/``."""
    init = Path(root).resolve() / "kafka_assigner_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "baseline_port", init, submodule_search_locations=[str(init.parent)]
    )
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("baseline_port.ops.leadership")


def sass_per_step(rf: int):
    """``(instructions, steps)`` of the innermost loop of the shared-slab
    chain kernel for ``rf``: the smallest backward branch whose body holds
    the steps' shuffles (one per step)."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.lib_path("leadership"))],
        capture_output=True, text=True, check=True,
    ).stdout
    width = rf if rf <= 4 else 32  # the kernel's RF bucket
    func = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in func if re.match(rf"\S*chain_kernelILi{width}ELb1E", f))
    instrs = [(int(a, 16), t) for a, t in
              re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for addr, text in instrs:
        m = re.search(r"\bBRA 0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        loop = [t for a, t in instrs if int(m.group(1), 16) <= a <= addr]
        shuffles = sum("SHFL.UP" in t for t in loop)
        if shuffles and (best is None or len(loop) < best[0]):
            best = (len(loop), shuffles)
    if best is None:
        raise RuntimeError("no loop with shuffles found in the chain kernel")
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", action="store_true",
                    help="count the RF-3 chain loop's SASS instructions per step")
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout: time its kernel on the same inputs, "
                         "in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_leadership_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    built = build.build_all()
    print(f"[build] {built['seconds']:.2f} s", flush=True)
    k_args = config4_args()
    o_k, c_k = lead.leadership_order(*k_args)
    o_g, c_g = lead.leadership_order(*k_args, force_global_slab=True)
    torch.cuda.synchronize()
    if not (torch.equal(o_k, o_g) and torch.equal(c_k, c_g)):
        print("torch_leadership_bench: shared and global slabs disagree", file=sys.stderr)
        return 1
    smem = cases.event_ms(lambda: lead.leadership_order(*k_args), args.reps)
    glob = cases.event_ms(
        lambda: lead.leadership_order(*k_args, force_global_slab=True), args.reps)
    first, second = split_ms(k_args, args.reps)
    ns, cycles = cases.chain_step_ns(RF)
    steps = cases.chain_steps(B * P_PAD, RF)
    out = {
        "device": torch.cuda.get_device_name(0),
        "shape": [B, P_PAD, RF, N_PAD],
        "chain_steps": steps,
        "smem_ms_median": statistics.median(smem), "smem_ms": smem,
        "global_ms_median": statistics.median(glob), "global_ms": glob,
        "copy_and_prologue_ms_median": statistics.median(first),
        "chain_ms_median": statistics.median(second),
        "probe_ns_per_step": ns, "probe_cycles_per_step": cycles,
        "chain_bound_ms": steps * ns * 1e-6,
    }
    if args.baseline:
        base = baseline_leadership(args.baseline)
        o_b, c_b = base.leadership_order(*k_args)
        torch.cuda.synchronize()
        if not (torch.equal(o_k, o_b) and torch.equal(c_k, c_b)):
            print("torch_leadership_bench: the baseline's kernel disagrees",
                  file=sys.stderr)
            return 1
        runs = {"baseline": [], "this": []}
        for who in ("baseline", "this", "this", "baseline"):
            fn = (base if who == "baseline" else lead).leadership_order
            runs[who] += cases.event_ms(lambda: fn(*k_args), args.reps)
        out["baseline_ms_median"] = statistics.median(runs["baseline"])
        out["this_ms_median"] = statistics.median(runs["this"])
    if args.sass:
        n, per = sass_per_step(RF)
        out["sass_loop_instructions"], out["sass_loop_steps"] = n, per
        out["sass_instructions_per_step"] = n / per
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
