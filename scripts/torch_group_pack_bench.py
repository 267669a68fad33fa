#!/usr/bin/env python3
"""The port's group-pack kernel (KG1) alone on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/torch_group_pack_bench.py [--reps 5] [--baseline DIR]

The script builds ``csrc/group_pack.cu`` and prints each kernel's registers,
stack frame and spills (``-Xptxas -v``). It holds the kernel bit-equal to
the plain version on every stress case of ``ops/group_pack_cases.py``,
printing the variant each case launched. Then it times, by CUDA events:

- the step probe (two warp reductions and the bump, one warp): the chain's
  yardstick, ns and cycles a step; and the ballot probe (one reduction, a
  ballot and the bump), the register variant's step alone;
- the kernel's own ns per orphan row (``group_pack_cases.step_ns``) at the
  largest C_pad of each K of the register variant (32, 64, ..., 1,024) and
  at 2,048 (the shared variant): one candidate whose every row is an
  orphan, and one whose orphans are ``SPARSE_ORPHAN_SHARE`` of its rows
  (the row stream over rows that need nothing included).

``--baseline DIR`` also times the dense step of another checkout's kernel
(say the parent commit's tree, unpacked with ``git archive`` into a
git-ignored directory) at the same C_pads, in turns: baseline, this, this,
baseline. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kafka_assigner_tpu_torch.ops import build  # noqa: E402
from kafka_assigner_tpu_torch.ops import group_pack as gp  # noqa: E402
from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases  # noqa: E402

C_PADS = gcases.BUCKET_C_PADS + (gcases.SHARED_C_PAD,)


def baseline_cases(root: str):
    """The ``ops.group_pack_cases`` module of another checkout, loaded beside
    this one under its own name; it builds its kernel into that checkout's
    own ``build/``."""
    init = Path(root).resolve() / "kafka_assigner_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "baseline_port", init, submodule_search_locations=[str(init.parent)]
    )
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("baseline_port.ops.group_pack_cases")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout: time its kernel's dense step in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_group_pack_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    built = build.build_all()
    resources = build.kernel_resources(built["ptxas"].get("group_pack", ""))
    print(f"[build] {built['seconds']:.2f} s", flush=True)
    for name, stats in resources.items():
        print(f"[build] group_pack {name}: {stats}", flush=True)

    variants = {}
    for case in gcases.stress_cases():
        err = gcases.check_case(case)
        variants[case[0]] = gp.last_variant
        if err:
            print(f"torch_group_pack_bench: kernel disagrees with plain on {case[0]}",
                  file=sys.stderr)
            return 1
        print(f"[cases] {case[0]} C_pad {case[2].shape[0]} {gp.last_variant}: bit-equal",
              flush=True)

    probe_ns, probe_cycles = gcases.probe_ns()
    print(f"[probe] {probe_ns:.2f} ns, {probe_cycles:.2f} cycles a step", flush=True)
    ballot_ns, ballot_cycles = gcases.probe_ns(ballot=True)
    print(f"[probe] ballot {ballot_ns:.2f} ns, {ballot_cycles:.2f} cycles a step",
          flush=True)
    share = gcases.SPARSE_ORPHAN_SHARE
    dense, sparse = {}, {}
    for c in C_PADS:
        dense[c] = gcases.step_ns(c, reps=args.reps)
        sparse[c] = gcases.step_ns(c, reps=args.reps, sparse=True)
        print(f"[step] C_pad {c} {gp.last_variant}: {dense[c]:.1f} ns an orphan row "
              f"(every row an orphan), {sparse[c]:.1f} ns (orphan share {share}); "
              f"{dense[c] / probe_ns:.2f}x the probe, {dense[c] / ballot_ns:.2f}x the "
              "ballot probe", flush=True)
    out = {
        "device": torch.cuda.get_device_name(0),
        "resources": resources,
        "variants": variants,
        "probe_ns": probe_ns, "probe_cycles": probe_cycles,
        "ballot_probe_ns": ballot_ns, "ballot_probe_cycles": ballot_cycles,
        "step_ns": {str(c): dense[c] for c in C_PADS},
        "step_ns_sparse": {str(c): sparse[c] for c in C_PADS},
        "sparse_orphan_share": share,
    }
    if args.baseline:
        base = baseline_cases(args.baseline)
        runs = {c: {"baseline": [], "this": []} for c in C_PADS}
        for who in ("baseline", "this", "this", "baseline"):
            fn = (base if who == "baseline" else gcases).step_ns
            for c in C_PADS:
                runs[c][who].append(fn(c, reps=args.reps))
        out["baseline_step_ns"] = {str(c): statistics.median(r["baseline"])
                                   for c, r in runs.items()}
        out["this_step_ns_in_turns"] = {str(c): statistics.median(r["this"])
                                        for c, r in runs.items()}
        for c in C_PADS:
            print(f"[turns] C_pad {c}: baseline {out['baseline_step_ns'][str(c)]:.1f} ns, "
                  f"this {out['this_step_ns_in_turns'][str(c)]:.1f} ns", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
