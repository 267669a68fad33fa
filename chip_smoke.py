#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``kafka_assigner_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build — every ``kafka_assigner_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, started together), with the
   registers and shared memory ``-Xptxas -v`` reports per kernel;
3. kernels — the leadership kernel against its plain PyTorch version,
   bit for bit, on the stress cases of
   ``kafka_assigner_tpu_torch/ops/leadership_cases.py``: RF 1-5, 12 and
   32 with shared- and global-memory slabs, partial and empty rows, P not
   a multiple of 8, multi-topic counter carry; every row on the same
   brokers with N_pad = RF and RF + 1 (every step conflicts); a mixed-RF
   batch; P = 1; one topic of 5,000 partitions (many record tiles, a
   partial last one); -1 and >= N_pad candidates; a slab over the
   shared-memory opt-in limit;
4. main path — BASELINE config 4 (5,000 brokers in 10 racks, 2,000 topics
   x 100 partitions at RF 3, brokers 0-99 replaced by 5000-5099, built as
   ``bench.py:build_headline`` does) written to a snapshot and solved by the
   port's mode-3 CLI on ``cuda``; checks rack-distinct RF-sized replica
   sets, no replica on a removed broker, at most ``cap`` replicas per node
   per topic, moved replicas == the replicas that sat on brokers 0-99, and
   that the main path launched the leadership kernel; then the kernel at the
   main path's shape against the plain version on the same inputs;
5. cuda == cpu — a 64-topic prefix of config 4, plan text byte-identical;
6. timing — warm median of 5 solves split into encode, placement,
   leadership and decode (host clocks ending in ``torch.cuda.synchronize``),
   the kernel alone at the config-4 shape (median of 10 launches, each
   timed with CUDA events), its byte bound, its dependent-chain floor
   (the chain's steps at this shape times the time per step of the chain
   alone, measured here by the kernel's probe), and the plain version on
   the card at a reduced shape (stated in the output).

In the ``kernels`` line, ``bound_ms`` is the throughput bound (bytes over
the memory rate); ``chain_bound_ms`` is the design's latency floor, which
the throughput bound does not see.

The last lines are the ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. There is no fallback to
the CPU and none to the plain version.
"""
from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_BROKERS, N_RACKS, N_TOPICS, P_PER_TOPIC, RF, REPLACED = 5000, 10, 2000, 100, 3, 100
PREFIX_TOPICS = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
LEADERSHIP_TPU_KERNEL = "kafka_assigner_tpu/ops/pallas_leadership.py:63"
KERNEL_REPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def kernel_cases(cases):
    """Phase 3: kernel vs plain on the stress cases. Returns max |kernel -
    plain| over every case."""
    worst = 0
    for case in cases.stress_cases():
        name, acc, _, counters = case[:4]
        err = cases.check_case(case)
        worst = max(worst, err)
        if err:
            fail(f"leadership kernel disagrees with plain on case {name}")
        b, p, rf = acc.shape
        phase("kernels", f"leadership {name} (B={b} P={p} RF={rf} "
              f"N_pad={counters.shape[0]}): bit-equal")
    return worst


def build_config4():
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    topic_map, _, racks = rack_striped_cluster(
        N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS,
        name_fmt="topic-{:04d}", extra_brokers=REPLACED,
    )
    live = set(range(REPLACED, N_BROKERS)) | set(
        range(N_BROKERS, N_BROKERS + REPLACED)
    )
    return topic_map, live, {b: racks[b] for b in live}


def write_snapshot(path, topic_map, live, rack_map):
    data = {
        "brokers": [
            {"id": b, "host": f"b{b}", "port": 9092, "rack": rack_map[b]}
            for b in sorted(live)
        ],
        "topics": {
            t: {str(p): r for p, r in parts.items()} for t, parts in topic_map.items()
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)


def run_cli(argv):
    from kafka_assigner_tpu_torch.cli import run_tool

    buf = io.StringIO()
    rc = run_tool(argv, out=buf)
    if rc != 0:
        fail(f"port CLI exited {rc} for {argv}")
    return buf.getvalue()


def new_assignment(text):
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    marker = "NEW ASSIGNMENT:\n"
    if marker not in text:
        fail("no NEW ASSIGNMENT section in the plan")
    return parse_reassignment_json(text.split(marker, 1)[1].strip())


def check_plan(plan, topic_map, live, rack_map):
    removed = set(range(REPLACED))
    cap = math.ceil(P_PER_TOPIC * RF / len(live))
    moved = expected = 0
    for t, old in topic_map.items():
        new = plan.get(t)
        if new is None or set(new) != set(old):
            fail(f"topic {t}: partitions missing from the plan")
        per_node = {}
        for p, reps in new.items():
            if len(reps) != RF or len(set(reps)) != RF:
                fail(f"{t}/{p}: replica list {reps} is not {RF} distinct brokers")
            if len({rack_map[b] for b in reps if b in rack_map}) != RF:
                fail(f"{t}/{p}: replicas {reps} not on {RF} distinct racks")
            if any(b not in live for b in reps):
                fail(f"{t}/{p}: replica on a removed or unknown broker: {reps}")
            for b in reps:
                per_node[b] = per_node.get(b, 0) + 1
            moved += len(set(reps) - set(old[p]))
            expected += sum(1 for b in old[p] if b in removed)
        if max(per_node.values()) > cap:
            fail(f"topic {t}: a node holds more than cap={cap} replicas")
    if moved != expected:
        fail(f"moved {moved} replicas, but {expected} sat on brokers 0-{REPLACED - 1}")
    return moved, cap


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import kafka_assigner_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable next to this script ({e})")

    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models.problem import context_to_array, encode_topic_group
    from kafka_assigner_tpu_torch.ops import build
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.ops import leadership_cases as cases
    from kafka_assigner_tpu_torch.ops.assignment import place_batched
    from kafka_assigner_tpu_torch.solvers.base import Context

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    built = build.build_all()
    phase("build", f"nvcc sm_90a: {built['seconds']:.2f} s for {sorted(built['ptxas'])}")
    for src, log in built["ptxas"].items():
        for line in log.splitlines():
            if "Compiling entry function" in line or "Used" in line:
                phase("build", f"{src}: {line.strip()}")

    max_err = kernel_cases(cases)

    # --- 4: main path at config 4 -------------------------------------
    topic_map, live, rack_map = build_config4()
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    snap = os.path.join(work, "config4.json")
    write_snapshot(snap, topic_map, live, rack_map)
    argv = ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT"]
    lead.launches["leadership"] = 0
    t0 = time.perf_counter()
    text = run_cli(argv + ["--device", "cuda"])
    wall_s = time.perf_counter() - t0
    launched = lead.launches["leadership"]
    if launched < 1:
        fail("the main path never launched the leadership kernel")
    moved, cap = check_plan(new_assignment(text), topic_map, live, rack_map)
    phase("main", f"config 4 mode 3 on cuda: {wall_s:.2f} s wall, moved {moved} "
          f"replicas (== replicas on brokers 0-{REPLACED - 1}), cap {cap}, "
          f"leadership kernel launches {launched}")

    # The kernel at the main path's shape, on the main path's inputs,
    # against the plain version on the same inputs (copied to the CPU).
    topics = list(topic_map.items())
    encs, currents, jhashes, p_reals = encode_topic_group(topics, rack_map, live, RF)
    t32 = lambda a: to_tensor(a, "cuda")  # noqa: E731
    placed = place_batched(
        t32(currents), t32(encs[0].rack_idx), t32(jhashes), t32(p_reals),
        encs[0].n, RF, "auto", None, r_cap=encs[0].r_cap,
    )
    b = len(encs)
    k_args = (
        placed.acc_nodes[:b].contiguous(), placed.acc_count[:b].contiguous(),
        t32(context_to_array(Context(), encs[0])), t32(jhashes[:b]),
    )
    o_k, c_k = lead.leadership_order(*k_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o_p, c_p = lead.leadership_order_plain(*(a.cpu() for a in k_args))
    plain_cpu_s = time.perf_counter() - t0
    err = max(int((o_k.cpu() - o_p).abs().max()), int((c_k.cpu() - c_p).abs().max()))
    max_err = max(max_err, err)
    if err:
        fail("leadership kernel disagrees with plain at the config-4 shape")
    shape = tuple(k_args[0].shape)
    phase("kernels", f"leadership at the main-path shape {shape} N_pad="
          f"{k_args[2].shape[0]}: bit-equal to plain (plain on CPU {plain_cpu_s:.1f} s)")

    # --- 5: cuda == cpu on a prefix -------------------------------------
    prefix = ",".join(t for t, _ in topics[:PREFIX_TOPICS])
    a = run_cli(argv + ["--topics", prefix, "--device", "cuda"])
    c = run_cli(argv + ["--topics", prefix, "--device", "cpu"])
    if a != c:
        fail(f"{PREFIX_TOPICS}-topic prefix: cuda and cpu plans differ")
    phase("cuda==cpu", f"{PREFIX_TOPICS}-topic prefix of config 4: plan text "
          f"byte-identical ({len(a)} bytes)")

    # --- 6: timing ---------------------------------------------------------
    assigner = TopicAssigner(device="cuda")
    runs = []
    for i in range(6):  # 1 warm-up + 5 timed
        assigner.context = Context()
        t0 = time.perf_counter()
        assigner.generate_assignments(topics, live, rack_map)
        total = (time.perf_counter() - t0) * 1e3
        if i:
            runs.append(dict(assigner.solver.last_timers, total=total))
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    phase("timing", "solve median of 5 (ms): " + ", ".join(
        f"{k} {med[k]:.1f}" for k in ("total", "encode", "place", "leadership", "decode")
    ) + f"; waves {assigner.solver.last_waves}")

    times = cases.event_ms(lambda: lead.leadership_order(*k_args), KERNEL_REPS)
    ms = statistics.median(times)
    small = tuple(t[:2].contiguous() for t in (k_args[0], k_args[1])) + (
        k_args[2], k_args[3][:2].contiguous())
    ms_small = statistics.median(
        cases.event_ms(lambda: lead.leadership_order(*small), 5))
    plain_ms = cases.event_ms(lambda: lead.leadership_order_plain(*small), 1)[0]
    b_, p_, rf_ = shape
    n_pad = k_args[2].shape[0]
    nbytes = 4 * (2 * b_ * p_ * rf_ + b_ * p_ + b_ + 2 * n_pad * rf_)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    steps = cases.chain_steps(b_ * p_, rf_)
    step_ns, step_cycles = cases.chain_step_ns(rf_)
    chain_bound_ms = steps * step_ns * 1e-6
    small_shape = f"B=2 P={p_} RF={rf_} N_pad={n_pad}"
    phase("timing", f"leadership kernel median {ms:.3f} ms of {KERNEL_REPS} launches "
          f"(min {min(times):.3f}, max {max(times):.3f}) at {shape}; byte bound "
          f"{bound_ms:.4f} ms ({nbytes} bytes); chain floor {chain_bound_ms:.3f} ms "
          f"({steps} steps x {step_ns:.3f} ns, {step_cycles:.2f} cycles, per step of "
          f"the chain alone, measured by the probe); "
          f"at {small_shape}: kernel {ms_small:.3f} ms, plain on the card {plain_ms:.1f} ms")
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "leadership",
        "route": "cuda",
        "source": "kafka_assigner_tpu_torch/csrc/leadership.cu",
        "replaces": LEADERSHIP_TPU_KERNEL,
        "launches": launched,
        "max_abs_err": max_err,
        "tolerance": "exact (integer outputs)",
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_shape": small_shape,
        "ms_at_plain_shape": ms_small,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "chain_steps": steps,
        "chain_bound_ms": chain_bound_ms,
    }]}
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
