#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``kafka_assigner_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build — every ``kafka_assigner_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, started together), with the
   registers and shared memory ``-Xptxas -v`` reports per kernel; then the
   native host libraries (``native/greedy.cpp`` with ``g++``,
   ``native/hostcodec.c`` with ``gcc``), each loaded, with their paths and
   build times;
3. kernels — the leadership kernel against its plain PyTorch version,
   bit for bit, on the stress cases of
   ``kafka_assigner_tpu_torch/ops/leadership_cases.py``: RF 1-5, 12 and
   32 with shared- and global-memory slabs, partial and empty rows, P not
   a multiple of 8, multi-topic counter carry; every row on the same
   brokers with N_pad = RF and RF + 1 (every step conflicts); a mixed-RF
   batch; P = 1; one topic of 5,000 partitions (many record tiles, a
   partial last one); one topic of 20,000 rows on a warm slab; -1 and
   >= N_pad candidates; a slab over the shared-memory opt-in limit;
4. main path — BASELINE config 4 (5,000 brokers in 10 racks, 2,000 topics
   x 100 partitions at RF 3, brokers 0-99 replaced by 5000-5099, built as
   ``bench.py:build_headline`` does) written to a snapshot and solved by the
   port's mode-3 CLI on ``cuda``; checks rack-distinct RF-sized replica
   sets, no replica on a removed broker, at most ``cap`` replicas per node
   per topic, moved replicas == the replicas that sat on brokers 0-99, that
   the main path launched the leadership kernel and that its encode and
   decode took the C codec; then the kernel at the main path's shape
   against the plain version on the same inputs;
5. cuda == cpu — a 64-topic prefix of config 4, plan text byte-identical;
6. timing — warm median of 5 solves split into encode, placement,
   leadership and decode (host clocks ending in ``torch.cuda.synchronize``),
   in turns with 5 under ``KA_HOSTCODEC=0`` (the codec A/B: plans
   byte-identical, the C codec asserted to have run),
   the kernel alone at the config-4 shape (median of 10 launches, each
   timed with CUDA events), its byte bound, its dependent-chain floor
   (the chain's steps at this shape times the time per step of the chain
   alone, measured here by the kernel's probe), and the plain version on
   the card at a reduced shape (stated in the output);
7. giant cells — one 200,000-partition RF-3 topic on 5,000 brokers in 10
   racks plus 100 added brokers (``bench.py:472-538``), each through the
   port's CLI on ``cuda``, with the kernel counts reset before and read
   after each: (a) expansion, brokers 0-5,099 live: mode 3, cap 118,
   exactly 10,000 replicas moved (each original broker sheds 2); (b)
   saturated, brokers 100-5,099 live: mode 3, cap 120, exactly 12,000
   moved; (c) fresh: ``PRINT_FRESH_ASSIGNMENT`` of a 200,000-partition
   RF-3 topic on (a)'s brokers, cap 118. Each plan is checked for
   rack-distinct RF-sized lists on live brokers under the cap; each
   placement for the giant-shape chain with no dense or seq leg run; and
   each leadership launch, at (1, 200000, 3) on the inputs the solver gave
   it, against the plain version on all rows, bit-equal;
8. cuda == cpu past a lowered ``KA_DENSE_MASK_BUDGET`` (the giant-shape
   chain at a reduced size; knobs restored afterwards), plan text
   byte-identical: a saturated replace-10 of 100 brokers in 5 racks with
   one 2,000-partition topic, a fresh 2,000-partition plan, and an RF
   decrease with orphans under ``KA_RF_DECREASE_COMPAT=1`` (auction and
   seq chains). Each ``cuda`` run must launch the kernel, place through
   the giant-shape chain (read from the solver's own placement call) and
   agree with the plain version on every launch;
9. giant timing — warm median of 3 solves of (a), (b) and (c) split by
   phase, in turns with 3 under ``KA_HOSTCODEC=0`` (the codec A/B), the
   waves of every leg that ran (no dense or seq leg may run),
   and the kernel at (1, 200000, 3) on (a)'s inputs: median of 10 by CUDA
   events, its byte bound and its chain floor, its result held against
   the one checked in phase 7;
10. what-if at BASELINE config 5 (``rack_striped_cluster(1000, 100, 50, 3,
    10)``, 256 singleton removals of brokers 0-255): the incremental and
    the dense sweep on ``cuda``, equal to each other and to the port's
    ``cpu`` run, every scenario feasible with moved == the replicas the
    removed broker held; warm median of 3 per path split into host prep,
    device sweep, rescue and compose, waves per leg, rows, chunks and peak
    device memory;
11. RANK_DECOMMISSION through the port's CLI on config 4's steady-state
    cluster (5,000 brokers, 2,000 topics x 100 partitions at RF 3), every
    live broker ranked: 5,000 feasible rows sorted least-disruptive-first
    with moved == held; then 16 ``--integer_broker_ids`` candidates and a
    ``--scenario_file`` (a same-rack pair, a cross-rack pair, a hostname,
    the empty scenario), stdout byte-identical on ``cuda`` and ``cpu``;
12. the rescue: 100 brokers in 5 racks, one 2,000-partition RF-3 topic,
    scenarios removing 4 brokers of every rack (cap 75, no slack): the fast
    sweep strands, the ``auto`` chain re-runs those scenarios; the rescued
    count and every result equal on ``cuda`` and ``cpu``; then the
    stranded scenarios' sweeps timed on ``cuda`` on the fast leg, the
    ``auto`` chain and the ``seq`` leg alone;
13. the host modes ``PRINT_CURRENT_ASSIGNMENT`` and ``PRINT_CURRENT_BROKERS``
    on phase 11's snapshot: JSON with all 5,000 brokers and 200,000
    partitions, byte-identical under ``--device cuda`` and ``cpu``;
14. ``ka-groups`` plan on config 4's cluster: a lake-ingest group ``ingest``
    subscribed to every topic, 256 live members of capacity null (fair share
    x 1.25), row i of the 200,000 sorted (topic, partition) rows owned by
    ``c-{i % 320:03d}`` (owners 256-319 have left), heavy-tailed lag from a
    seed. Through ``python -m kafka_assigner_tpu_torch.groups``'s
    ``run_groups`` on ``cuda`` and (in a worker) ``cpu``: stdout
    byte-identical, every row on a live member, ``moves`` == the rows whose
    owner changed, the group-pack kernel launched;
15. ``ka-groups`` sweep on the same group: counts 32, 64, ..., 512 x scales
    100, 150, 200, 300 (64 candidates, C_pad 512), stdout identical on
    ``cuda`` and ``cpu``; then a warm median of 3 of the sweep split into
    host encode, sticky, scan and decode, with the scan's steps and peak
    device memory;
16. ``ka-groups --synthetic --weight throughput --mode sweep`` on phase 11's
    snapshot (no groups section): 8 synthetic members, 48 candidates, stdout
    identical on ``cuda`` and ``cpu``; without ``--synthetic`` the refusal
    (exit 1);
17. the leadership lanes — ``KA_LEADERSHIP=native`` (the host C++ pass,
    ``native/leadership.py``) against ``device`` (the kernel) on config 4
    and the giant expansion: CLI stdout byte-identical, the kernel launched
    on the device lane only; then a warm median of each lane in turns, split
    by phase (the native lane's leadership phase includes copying the
    placement to the host);
18. the solver lanes — ``--solver native`` (the C++ greedy) on config 4
    through the CLI: the same checks as phase 4, moved == ``--solver
    device``'s; ``--solver greedy`` and ``native`` on phase 5's prefix,
    byte-identical, moved == the device's; neither launches the kernel
    (the greedy lanes place orphans first-fit, the device solver by waves, so
    their lists differ where orphans land, as the JAX package's lanes do);
    then ``scripts/torch_bench.py`` in a subprocess, its JSON line printed;
19. observability and the failure policy (``obs/``, ``faults/``), on
    ``cuda``: (a) config 4 through the CLI with ``--report-json``: the
    report valid with status ok, the spans ``metadata/assignment``,
    ``feasibility``, ``plan/solve/{encode,solve,decode}`` and
    ``plan/emit``, ``plan.moves`` == phase 4's moved replicas, 200,000
    partitions, the ``zk.*`` counters, the leadership kernel launched once,
    stdout byte-identical to phase 4's; the span tree's times and the CLI
    wall (host clock around the run) less the mode span printed; (b) one
    warm config-4 solve through ``TopicAssigner.generate_assignments``
    under ``KA_OBS_PROFILE_DIR``: the Chrome trace's dispatch window, the
    device busy time (the union of kernel, memcpy and memset intervals in
    it), the device idle share, the top 8 device ops, the leadership
    kernel's traced time (its chain kernel exactly once) beside phase 6's
    CUDA-events time and phase 6's unprofiled warm median; (c) the 64-topic
    prefix with ``KA_FAULTS_SPEC=solve:0=crash``: ``--failure-policy
    best-effort`` exits 6 with stdout byte-identical to phase 18's
    ``--solver greedy``, the report degraded with ``solve.fallbacks`` 1 and
    ``faults.injected`` 1, the kernel launched 0 times; the default policy
    exits 4 with the report's error a ``SolveError``; with no spec,
    best-effort is byte-identical to strict; (d) phase 14's plan with the
    report (``groups.plans`` 1, ``groups.moves`` == the envelope's, the
    group-pack kernel launched once, stdout == phase 14's), then phase 16's
    synthetic sweep with the crash and best-effort: exit 6, ``"solver":
    "greedy-fallback"``, the group-pack kernel launched 0 times, the
    envelope == the ``--solver greedy`` run's but that marker (the oracle
    run on ``cpu`` in a worker, beside the later phases); (e) phase 11's
    16 candidates with the report: the
    ``whatif/rank`` span, ``whatif.scenarios`` 16, ``whatif.fanout``,
    stdout == phase 11's. Phases 1-18 run strict and unprofiled: the smoke
    fails at start when ``KA_FAILURE_POLICY``, ``KA_FAULTS_SPEC``,
    ``KA_OBS_PROFILE_DIR``, ``KA_PROFILE``, ``KA_OBS_REPORT`` or
    ``KA_OBS_ENABLE`` is set, and phase 19 sets them per run;
20. live ZooKeeper (``io/zkwire.py``, ``io/zk.py``, the streamed ingest of
    ``generator.py``), on ``cuda``: ``tests/jute_server.py`` serves config
    4's tree from a spawned process (5,100 znodes ``/brokers/ids/<id>``,
    brokers 0-99 still registered, and the 2,000 topic znodes); (a) the
    port's mode-3 CLI with ``--zk_string 127.0.0.1:<port>``,
    ``KA_ZK_CLIENT=wire`` and ``--broker_hosts_to_remove b0,...,b99``:
    stdout byte-identical to phase 4's snapshot plan, the same replicas
    moved, the accumulator's encode on the C codec, the solve on its
    preencode (no encode of its own), the leadership kernel launched once
    and that launch held against the plain version on the same inputs (in a
    worker); (b) the same under ``KA_ZK_OVERLAP=0`` (the solve encodes) and
    under ``KA_ZK_INGEST_CHUNK=7``, the same bytes; (c) the 64-topic prefix
    over ZooKeeper on ``cuda`` and ``cpu``, byte-identical and equal to
    phase 5's; (d) with a 1 ms reply delay (``reply_delay_s=0.001``, as
    ``scripts/bench_zk_ingest.py``), one turn: the overlap on, ``KA_ZK_
    OVERLAP=0`` and serial reads (``KA_ZK_PIPELINE=1``), each with
    ``--report-json``: the CLI wall, ``zk/brokers``, ``metadata/assignment``,
    ``ingest.encode_ms`` and ``ingest.overlap_ms``, ``zk.pipeline.*`` and
    ``plan/solve``, each line with the card's name and power limit;
21. warm start in fresh processes (``utils/programstore.py``,
    ``solvers/warmup.py``, ``ka-warm``), each child run through
    ``scripts/torch_bench_warmstart.py``'s child mode, which counts the
    leadership kernel's launches inside the child: (a) ``ka-warm`` on
    phase 4's snapshot against an empty temporary store (exit 0,
    ``warmed``, ``compile.store.misses`` and ``compiles_ms``, the warm-up's
    steps), and beside it under ``KA_PROGRAM_STORE=0`` (exit 1, "NOTHING
    persisted"); neither launches the kernel; (b)
    ``scripts/torch_bench_warmstart.py`` on phase 4's snapshot, its JSON
    line printed, each child's plan byte-identical to phase 4's; (c) phase
    20(d)'s 1 ms server, every library loaded from (a)'s store
    (``compile.store.hits`` and ``loads_ms``, no build), the warm-up on
    against ``KA_WARMUP=0`` in one turn: the CLI wall, the ingest's and
    the warm-up's windows in the child (did the warm-up end inside the
    ingest?) and its steps, the ``warmup`` span beside
    ``metadata/assignment``, ``plan/solve``, ``warmup.*`` and
    ``compile.store.*``; stdout == phase 4's and the kernel launched once
    in each run. Phase 21's launches run
    in child processes and are not held against the plain version one by
    one: each is held through its plan, byte-identical to phase 4's, whose
    launch at the same shape the plain version checked;
22. plan execution (``exec/``, the snapshot backend's simulated
    convergence, the wire client's writes), each ``ka-execute`` run in a
    fresh process through ``python -m kafka_assigner_tpu_torch.exec``: (a)
    config 4's plan through mode 3 on ``cuda`` (stdout == phase 4's, the
    leadership kernel launched and held against the plain version in a
    worker), written to a plan file; (b) ``ka-execute`` of it on a copy of
    phase 4's snapshot with ``--report-json`` at the printed wave size and
    poll interval: exit 0, "verify-after-move OK", the final snapshot
    byte-identical to the plan's NEW ASSIGNMENT written through the port's
    ``write_snapshot``, the journal complete; the wall, waves, the
    ``exec/*`` span totals, one persist's time and the execution entry's
    import in a fresh process (no torch); (c) ``--rollback`` on the same
    copy, back to the original's bytes through ``write_snapshot``; (d) on
    the 64-topic prefix, a process under ``KA_FAULTS_SPEC=wave:1=crash``
    dies at the wave boundary with one wave committed and ``--resume``
    ends byte-identical to an uninterrupted run; (e) the prefix over
    ``tests/jute_server.py`` with its simulated controller (a spawned
    process), the tree read back equal to (d)'s final assignment.

Phase 3b holds the group-pack kernel (KG1, ``csrc/group_pack.cu``) bit-equal
to its plain version on the stress cases of ``ops/group_pack_cases.py``,
with the variant each launched (``registers``, ``shared``, ``global``) and,
in the register variant, the consumers a lane (K) its candidates took;
each of phases 14-16 holds its kernel launch bit-equal to the plain version
on the inputs the main path gave it (in a worker) and times it alone
(median of 10 by CUDA events) beside its C_pad and variant, its byte bound,
its chain floor (the largest orphan count of a candidate times the time of
one step of two warp reductions and a bump alone, measured by the step
probe) and the ratio of the two, the same over the register variant's
floor (the probe's chain with one reduction and a ballot a step), and the
chain at the kernel's own time a step (on one all-orphan candidate at the
K of the longest chain); the kernel's own time a step is also printed at
each K's largest C_pad (32 to 1,024) and at 2,048 (the shared variant).

The what-if and group phases do not order leaders: the leadership kernel is
not on their path, and the smoke checks that they launch it no time.

The plain leadership checks of phases 4 and 7 (config 4's 208,000 rows and
each giant cell's 200,000, a Python loop over rows on the host CPU), and
the plain group-pack checks and ``cpu`` runs of phases 14-16, run in
spawned worker processes, one thread each, while the later phases go on;
their results are collected after phase 16, so phases 17-18 time a quiet
host.

Phases 7 and 8 read what the solver hands ``place_batched`` and
``leadership_order`` through :func:`solver_probe`, which wraps the two names
in ``solvers/torch_solver.py`` for the block; the kernel's wrapper and its
launch count are untouched.

In the ``kernels`` line, ``bound_ms`` is the throughput bound (bytes over
the memory rate); ``chain_bound_ms`` is the design's latency floor, which
the throughput bound does not see; ``launches`` sums the counts of every
path driven (config 4, the three giant cells, the reduced ``cuda`` runs,
phase 17's CLI runs on each lane, phase 19's, 20's, 21's and 22's runs,
21's counted inside each child process), and ``launches_by_path`` gives
each; the group-pack entry's counts are those of
phases 14-16.

The last lines are the ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. There is no fallback to
the CPU and none to the plain version.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_BROKERS, N_RACKS, N_TOPICS, P_PER_TOPIC, RF, REPLACED = 5000, 10, 2000, 100, 3, 100
PREFIX_TOPICS = 64
GIANT_P = 200_000
# Reduced giant-chain instance for cuda == cpu: 100 brokers in 5 racks, one
# 2,000-partition topic, brokers 0-9 replaced; the budget sits under its
# P_pad x N_pad (2,000 x 104), and under the compat instance's.
REDUCED = dict(brokers=100, racks=5, partitions=2000, replaced=10, budget=1_000)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
LEADERSHIP_TPU_KERNEL = "kafka_assigner_tpu/ops/pallas_leadership.py:63"
KERNEL_REPS = 10
SOLVE_REPS = 5
GIANT_SOLVE_REPS = 3
WHATIF_REPS = 3
PLAIN_WORKERS = 4
CONFIG5_SCENARIOS = 256
# Phase 11's candidates: 16 brokers over every rack of config 4's cluster.
RANK_CANDIDATES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 1234, 2500, 3001, 4444, 4998, 4999)
# Phases 14-16: the consumer group on config 4's cluster.
GROUP_TPU_LOOP = "kafka_assigner_tpu/ops/assignment.py:1599"
GROUP_MEMBERS, GROUP_OWNERS = 256, 320
GROUP_COUNTS = tuple(range(32, 513, 32))
GROUP_SCALES = (100, 150, 200, 300)
GROUP_SWEEP_REPS = 3
# The plain group-pack version timed on the card at this reduced shape.
GROUP_PLAIN_SHAPE = dict(s=4, p=1024, c=512)


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


@contextlib.contextmanager
def knobs(**values):
    """Set ``KA_*`` knobs for a block and restore them afterwards."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def solver_probe():
    """Record, for a block, what the port's solver hands its placement and
    the leadership kernel: per placement, ``(legs, giant, waves)`` (the
    chain resolved for the placement's own mode and shape, whether it is
    the giant-shape chain, and the waves of every leg that ran); per
    ordering call, ``(inputs, outputs)``. Wraps the two names in
    ``solvers/torch_solver.py`` and restores them afterwards."""
    import inspect

    from kafka_assigner_tpu_torch.ops.assignment import resolve_chain
    from kafka_assigner_tpu_torch.solvers import torch_solver as ts

    seen = {"chains": [], "orders": []}
    place, order = ts.place_batched, ts.leadership_order
    signature = inspect.signature(place)

    def place_recorded(*args, **kw):
        a = signature.bind(*args, **kw).arguments
        placed = place(*args, **kw)
        legs, _, giant = resolve_chain(a["wave_mode"], a["currents"].shape[1],
                                       a["rack_idx"].shape[0], a.get("r_cap"))
        seen["chains"].append((legs, giant, dict(placed.waves)))
        return placed

    def order_recorded(*args, **kw):
        inputs = tuple(t.clone() for t in args[:4])
        outputs = order(*args, **kw)
        seen["orders"].append((inputs, outputs))
        return outputs

    ts.place_batched, ts.leadership_order = place_recorded, order_recorded
    try:
        yield seen
    finally:
        ts.place_batched, ts.leadership_order = place, order


def check_orders(lead, orders, what):
    """Each recorded kernel call against the plain version on the same
    inputs (copied to the CPU); returns max |kernel - plain|."""
    import torch

    worst = 0
    for inputs, (o_k, c_k) in orders:
        torch.cuda.synchronize()
        o_p, c_p = lead.leadership_order_plain(*(a.cpu() for a in inputs))
        err = max(int((o_k.cpu() - o_p).abs().max()), int((c_k.cpu() - c_p).abs().max()))
        if err:
            fail(f"{what}: leadership kernel disagrees with plain at "
                 f"{tuple(inputs[0].shape)}")
        worst = max(worst, err)
    return worst


def plain_check(inputs, outputs):
    """Worker process: the plain leadership version on ``inputs`` (numpy
    arrays), against the kernel's ``outputs``; returns (max |kernel -
    plain|, seconds)."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from kafka_assigner_tpu_torch.ops.leadership import leadership_order_plain

    t0 = time.perf_counter()
    plain = leadership_order_plain(*(torch.from_numpy(a) for a in inputs))
    err = max(int(np.abs(k - p.numpy()).max()) for k, p in zip(outputs, plain))
    return err, time.perf_counter() - t0


class PlainChecks:
    """Host CPU work in spawned worker processes, so it runs beside the
    later phases: kernel launches held against the plain version, and the
    ``cpu`` runs that ``cuda`` output is compared with. Each job's result
    goes to its ``done`` callback at :meth:`collect`."""

    def __init__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.pending = []

    def job(self, kernel, done, fn, *args):
        """Run ``fn(*args)`` in a worker; ``done(result)`` returns max
        |kernel - plain| of ``kernel`` (0 for a job that compares no
        kernel) and fails on any disagreement."""
        self.pending.append((kernel, done, self.pool.submit(fn, *args)))

    def submit(self, what, inputs, outputs):
        inputs = tuple(a.cpu().numpy() for a in inputs)
        outputs = tuple(a.cpu().numpy() for a in outputs)
        shape = f"{inputs[0].shape} N_pad={inputs[2].shape[0]}"

        def done(result):
            err, secs = result
            if err:
                fail(f"{what}: leadership kernel disagrees with plain at {shape}")
            phase("kernels", f"leadership at {what} {shape}: bit-equal to plain on "
                  f"all rows (plain on CPU {secs:.1f} s in a worker)")
            return err

        self.job("leadership", done, plain_check, inputs, outputs)

    def collect(self):
        """Every job's result; fails on any disagreement. Returns max
        |kernel - plain| per kernel."""
        worst = {}
        for kernel, done, future in self.pending:
            worst[kernel] = max(worst.get(kernel, 0), done(future.result()))
        self.pending = []
        return worst

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def check_chains(chains, what, rescue_allowed=True):
    """Every placement of the block ran the giant-shape chain, and only its
    legs; without ``rescue_allowed``, neither dense nor seq ran."""
    if not chains:
        fail(f"{what}: the solver placed nothing")
    for legs, giant, waves in chains:
        if not giant:
            fail(f"{what}: the placement did not take the giant-shape chain ({legs})")
        if not set(waves) <= set(legs):
            fail(f"{what}: legs {sorted(waves)} ran outside the chain {legs}")
        if not rescue_allowed and ("dense" in waves or "seq" in waves):
            fail(f"{what}: a rescue leg ran ({waves})")
    return [waves for _, _, waves in chains]


def native_builds():
    """Phase 2 (host): the greedy library with g++ and the boundary codec
    with gcc, each loaded; a failed build fails the phase."""
    from kafka_assigner_tpu_torch.native import build as nbuild

    for what, make, path, load in (
        ("greedy.cpp (g++)", nbuild.build_native_library, nbuild.greedy_lib_path,
         nbuild.load_native_library),
        ("hostcodec.c (gcc)", nbuild.build_hostcodec, nbuild.codec_lib_path,
         nbuild.load_hostcodec),
    ):
        t0 = time.perf_counter()
        try:
            make()
            load()
        except nbuild.NativeBuildError as e:
            fail(f"native build of {what}: {e}")
        phase("build", f"{what}: {os.path.relpath(path(), ROOT)} built and loaded in "
              f"{time.perf_counter() - t0:.2f} s")


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
    from kafka_assigner_tpu_torch.models.synthetic import build_config4

    return build_config4(N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, REPLACED)


def giant_cells(n_brokers=N_BROKERS, n_racks=N_RACKS, partitions=GIANT_P,
                added=REPLACED, name="giant-{:04d}"):
    """The giant topic and its three cells: ``{cell: (topic_map, live,
    rack_map, cap, moved)}``, ``moved`` the replicas the plan must move."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    topic_map, _, racks = rack_striped_cluster(
        n_brokers, 1, partitions, RF, n_racks, name_fmt=name, extra_brokers=added,
    )
    load = partitions * RF // n_brokers  # replicas per original broker
    cells = {}
    for cell, live in (("expansion", set(range(n_brokers + added))),
                       ("saturated", set(range(added, n_brokers + added)))):
        cap = math.ceil(partitions * RF / len(live))
        removed = n_brokers + added - len(live)
        # Expansion: each original broker sheds load - cap; saturated:
        # the removed brokers' replicas, and nothing else, move.
        moved = removed * load if removed else n_brokers * (load - cap)
        cells[cell] = (topic_map, live, {b: racks[b] for b in live}, cap, moved)
    _, live, rack_map, cap, _ = cells["expansion"]
    fresh = {"giant-fresh": {p: [] for p in range(partitions)}}
    cells["fresh"] = (fresh, live, rack_map, cap, partitions * RF)
    return cells


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


def plan_section(text, marker="NEW ASSIGNMENT:\n"):
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    if marker not in text:
        fail(f"no {marker.strip()} section in the plan")
    return parse_reassignment_json(text.split(marker, 1)[1].strip())


def check_plan(plan, topic_map, live, rack_map, cap, expected_moved, rf=RF):
    """Every partition placed on ``rf`` live brokers of distinct racks, at
    most ``cap`` replicas per node per topic, and exactly
    ``expected_moved`` replicas on brokers that did not hold them."""
    moved = 0
    for t, old in topic_map.items():
        new = plan.get(t)
        if new is None or set(new) != set(old):
            fail(f"topic {t}: partitions missing from the plan")
        per_node = {}
        for p, reps in new.items():
            if len(reps) != rf or len(set(reps)) != rf:
                fail(f"{t}/{p}: replica list {reps} is not {rf} distinct brokers")
            if len({rack_map[b] for b in reps if b in rack_map}) != rf:
                fail(f"{t}/{p}: replicas {reps} not on {rf} distinct racks")
            if any(b not in live for b in reps):
                fail(f"{t}/{p}: replica on a removed or unknown broker: {reps}")
            for b in reps:
                per_node[b] = per_node.get(b, 0) + 1
            moved += len(set(reps) - set(old[p]))
        if max(per_node.values()) > cap:
            fail(f"topic {t}: a node holds more than cap={cap} replicas")
    if moved != expected_moved:
        fail(f"moved {moved} replicas, expected exactly {expected_moved}")
    return moved


def giant_main_paths(cells, work, lead, checks):
    """Phase 7: the three giant cells through the CLI on the card, the
    kernel counts reset just before each and read just after; each
    placement's chain checked, and each kernel launch handed to ``checks``.
    Returns the launches per cell and (a)'s kernel inputs and outputs."""
    snaps = {}
    for cell in ("expansion", "saturated"):
        topic_map, live, rack_map, _, _ = cells[cell]
        snaps[cell] = os.path.join(work, f"giant_{cell}.json")
        write_snapshot(snaps[cell], topic_map, live, rack_map)
    p = len(cells["fresh"][0]["giant-fresh"])
    argvs = {
        "expansion": ["--zk_string", f"file://{snaps['expansion']}",
                      "--mode", "PRINT_REASSIGNMENT"],
        "saturated": ["--zk_string", f"file://{snaps['saturated']}",
                      "--mode", "PRINT_REASSIGNMENT"],
        "fresh": ["--zk_string", f"file://{snaps['expansion']}",
                  "--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "giant-fresh",
                  "--partition_count", str(p), "--desired_replication_factor", str(RF)],
    }
    launches, k_expansion = {}, None
    for cell, argv in argvs.items():
        topic_map, live, rack_map, cap, expected = cells[cell]
        with solver_probe() as seen:
            lead.launches["leadership"] = 0
            t0 = time.perf_counter()
            text = run_cli(argv + ["--device", "cuda"])
            wall_s = time.perf_counter() - t0
            launches[cell] = lead.launches["leadership"]
        if launches[cell] < 1:
            fail(f"giant {cell} never launched the leadership kernel")
        marker = "FRESH ASSIGNMENT:\n" if cell == "fresh" else "NEW ASSIGNMENT:\n"
        moved = check_plan(plan_section(text, marker), topic_map, live, rack_map,
                           cap, expected)
        waves = check_chains(seen["chains"], f"giant {cell}", rescue_allowed=False)
        phase("giant", f"({cell}) {argv[3]} on cuda: {wall_s:.2f} s wall, "
              f"P={p} N={len(live)}, moved {moved} replicas (expected exactly "
              f"{expected}), cap {cap}, giant-shape chain {seen['chains'][0][0]}, "
              f"waves {waves}, leadership kernel launches {launches[cell]}")
        for inputs, outputs in seen["orders"]:
            checks.submit(f"the giant {cell} cell's launch, on the inputs the solver "
                          "gave it,", inputs, outputs)
        if cell == "expansion":
            k_expansion = seen["orders"][0]
    return launches, k_expansion


def reduced_parity(work, lead):
    """Phase 8: cuda == cpu, plan text byte-identical, past a lowered
    KA_DENSE_MASK_BUDGET; each cuda run launches the kernel, places through
    the giant-shape chain and agrees with plain. Returns the launches per
    run and max |kernel - plain|."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    r = REDUCED
    cells = giant_cells(r["brokers"], r["racks"], r["partitions"], r["replaced"],
                        name="reduced-{:02d}")
    topic_map, live, rack_map, cap, moved = cells["saturated"]
    snap = os.path.join(work, "reduced_saturated.json")
    write_snapshot(snap, topic_map, live, rack_map)
    base = ["--zk_string", f"file://{snap}"]
    # An RF decrease 4 -> 2 on 25 brokers in 5 racks with brokers 0-4
    # replaced: compat keeps every retained replica and re-places the
    # orphans.
    c_map, _, c_racks = rack_striped_cluster(25, 1, 50, 4, 5, name_fmt="compat-{:02d}",
                                             extra_brokers=5)
    c_live = set(range(5, 30))
    c_snap = os.path.join(work, "compat.json")
    write_snapshot(c_snap, c_map, c_live, {b: c_racks[b] for b in c_live})
    c_argv = ["--zk_string", f"file://{c_snap}", "--mode", "PRINT_REASSIGNMENT",
              "--desired_replication_factor", "2"]
    # (path, what, argv, knobs)
    runs = [
        ("reduced_saturated", "saturated mode 3",
         base + ["--mode", "PRINT_REASSIGNMENT"], {}),
        ("reduced_fresh", "fresh",
         base + ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "reduced-fresh",
                 "--partition_count", str(r["partitions"]),
                 "--desired_replication_factor", str(RF)], {}),
        ("compat_auction", "compat RF 4->2, auction chain", c_argv,
         {"KA_RF_DECREASE_COMPAT": 1, "KA_WAVE_MODE": "auto"}),
        ("compat_seq", "compat RF 4->2, seq chain", c_argv,
         {"KA_RF_DECREASE_COMPAT": 1}),
    ]
    launches, worst = {}, 0
    for path, what, argv, extra in runs:
        with knobs(KA_DENSE_MASK_BUDGET=r["budget"], **extra):
            with solver_probe() as seen:
                lead.launches["leadership"] = 0
                a = run_cli(argv + ["--device", "cuda"])
                launches[path] = lead.launches["leadership"]
            c = run_cli(argv + ["--device", "cpu"])
        if launches[path] < 1:
            fail(f"reduced {what}: the cuda run never launched the leadership kernel")
        if a != c:
            fail(f"reduced {what}: cuda and cpu plans differ")
        waves = check_chains(seen["chains"], f"reduced {what}")
        worst = max(worst, check_orders(lead, seen["orders"], f"reduced {what}"))
        if what == "saturated mode 3":
            check_plan(plan_section(a), topic_map, live, rack_map, cap, moved)
        if what.startswith("compat"):
            old = c_map["compat-00"]
            new = plan_section(a)["compat-00"]
            if not any(set(v) - set(old[p]) for p, v in new.items()):
                fail(f"reduced {what}: the decrease left no orphan to place")
        k_shape = tuple(seen["orders"][0][0][0].shape)
        phase("cuda==cpu", f"reduced {what} (budget {r['budget']}, chain "
              f"{seen['chains'][0][0]}, waves {waves}): plan text byte-identical "
              f"({len(a)} bytes); leadership kernel launches {launches[path]} at "
              f"{k_shape}, bit-equal to plain")
    return launches, worst


def giant_timing(cells):
    """Phase 9 (solves): the codec A/B of each cell, a warm median of
    GIANT_SOLVE_REPS each in turns, split by phase, with the waves of every
    leg that ran."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.solvers.base import Context

    out = {}
    for cell in ("expansion", "saturated", "fresh"):
        topic_map, live, rack_map, _, _ = cells[cell]
        assigner = TopicAssigner(device="cuda")
        if cell == "fresh":
            p = len(topic_map["giant-fresh"])

            def plan():
                return [("giant-fresh", assigner.solver.fresh_assignment(
                    "giant-fresh", p, live, rack_map, RF, Context()))]
        else:
            topics = list(topic_map.items())

            def plan():
                assigner.context = Context()
                return assigner.generate_assignments(topics, live, rack_map)

        def solve():
            return plan(), assigner.solver

        med = codec_ab(f"giant {cell}", solve, GIANT_SOLVE_REPS)
        waves = dict(assigner.solver.last_waves)
        if "dense" in waves or "seq" in waves:
            fail(f"giant {cell}: a rescue leg ran ({waves})")
        phase("timing", f"giant {cell} solve median of {GIANT_SOLVE_REPS} (ms): "
              f"{phase_ms(med['c'])}; waves {waves}")
        out[cell] = dict(med, waves=waves)
    return out


def timed_turns(solve, variants, reps):
    """``solve()`` under each variant's knobs in turns, ``reps + 1`` rounds,
    the first a warm-up. ``solve()`` returns ``(plan pairs, solver)``.
    Returns ``{variant: (medians of the total and of each phase (ms), the
    plan's text of the last run, the solver's last_codec and last_leadership
    of the last run, leadership kernel launches over every run)}``."""
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs
    from kafka_assigner_tpu_torch.ops import leadership as lead

    runs = {name: [] for name in variants}
    last, launched = {}, dict.fromkeys(variants, 0)
    for i in range(reps + 1):
        for name, values in variants.items():
            with knobs(**values):
                before = lead.launches["leadership"]
                t0 = time.perf_counter()
                pairs, solver = solve()
                total = (time.perf_counter() - t0) * 1e3
                launched[name] += lead.launches["leadership"] - before
            if i:
                runs[name].append(dict(solver.last_timers, total=total))
            last[name] = (pairs, dict(solver.last_codec), solver.last_leadership)
    last = {name: (format_reassignment_pairs(pairs), *rest)
            for name, (pairs, *rest) in last.items()}
    return {name: ({k: statistics.median(r[k] for r in rs) for k in rs[0]}, *last[name],
                   launched[name])
            for name, rs in runs.items()}


PHASES = ("total", "encode", "place", "leadership", "decode")


def phase_ms(med):
    return ", ".join(f"{k} {med[k]:.1f}" for k in PHASES)


def codec_ab(what, solve, reps):
    """The boundary codec A/B within one call: the C codec and
    ``KA_HOSTCODEC=0`` in turns; fails unless the C codec ran where it is
    on and the plans are byte-identical. Returns the medians of each."""
    got = timed_turns(solve, {"c": {"KA_HOSTCODEC": 1}, "numpy": {"KA_HOSTCODEC": 0}}, reps)
    (med_c, text_c, codec_c, _, _), (med_n, text_n, codec_n, _, _) = got["c"], got["numpy"]
    if codec_c["decode"] != "c" or codec_n != {"encode": "numpy", "decode": "numpy"}:
        fail(f"{what}: codec routes {codec_c} with KA_HOSTCODEC=1, {codec_n} with 0")
    if text_c != text_n:
        fail(f"{what}: the plans differ between the C codec and numpy")
    phase("timing", f"codec A/B {what}, median of {reps} in turns (ms): C codec "
          f"({codec_c['encode']} encode, c decode): {phase_ms(med_c)}; KA_HOSTCODEC=0: "
          f"{phase_ms(med_n)}; plans byte-identical ({len(text_c)} bytes)")
    return {"c": med_c, "numpy": med_n, "routes": codec_c}


def replicas_held(topic_map):
    held = {}
    for cur in topic_map.values():
        for reps in cur.values():
            for b in reps:
                held[b] = held.get(b, 0) + 1
    return held


def as_tuples(results):
    return [dataclasses.astuple(r) for r in results]


def whatif_config5():
    """Phase 10: BASELINE config 5 on both sweep paths on the card, against
    each other and the port's cpu run; warm medians by phase, waves, rows,
    chunks and peak device memory per path."""
    import torch

    from kafka_assigner_tpu_torch.models.synthetic import build_config5
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = build_config5()
    scenarios = [[b] for b in range(CONFIG5_SCENARIOS)]
    held = replicas_held(topic_map)
    results, out = {}, {}
    for path, flag in (("incremental", 1), ("dense", 0)):
        with knobs(KA_WHATIF_INCREMENTAL=flag):
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for i in range(WHATIF_REPS + 1):  # 1 cold
                t0 = time.perf_counter()
                res = whatif.evaluate_removal_scenarios(topic_map, live, racks,
                                                        scenarios, 3, device="cuda")
                total = (time.perf_counter() - t0) * 1e3
                if i:
                    runs.append(dict(whatif.last_sweep, total=total))
            peak = torch.cuda.max_memory_allocated()
        rec = runs[-1]
        if rec["path"] != path:
            fail(f"config 5: the {path} sweep did not run ({rec['path']} did)")
        med = {k: statistics.median(r[k] for r in runs)
               for k in ("total", "prep", "sweep", "rescue", "compose")}
        host = med["prep"] + med["compose"]
        phase("whatif", f"config 5 {path} on cuda, 256 scenarios, warm median of "
              f"{WHATIF_REPS} (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
              + f"; host share {host / med['total']:.2f}; rows {rec['rows']}, "
              f"t_pad {rec['t_pad']}, chunks {rec['chunks']}, waves {rec['waves']}, "
              f"rescued {rec['rescued']}, peak device memory {peak / 2**20:.1f} MiB")
        results[path] = as_tuples(res)
        out[path] = dict(med, rows=rec["rows"], chunks=rec["chunks"],
                         waves=rec["waves"], peak_bytes=peak)
    t0 = time.perf_counter()
    cpu = as_tuples(whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios,
                                                      3, device="cpu"))
    if not results["incremental"] == results["dense"] == cpu:
        fail("config 5: incremental, dense and cpu sweeps differ")
    for removed, moved, feasible, _ in cpu:
        if not feasible or moved != held[removed[0]]:
            fail(f"config 5: scenario {removed} feasible={feasible} moved {moved}, "
                 f"expected {held[removed[0]]}")
    span = sorted({held[b] for b in range(CONFIG5_SCENARIOS)})
    phase("whatif", f"config 5: incremental == dense == cpu ({time.perf_counter() - t0:.1f} s "
          f"on the CPU) on all {CONFIG5_SCENARIOS} scenarios, all feasible, moved == "
          f"replicas held ({span[0]}-{span[-1]})")
    return out


def rank_config4(work):
    """Phase 11: RANK_DECOMMISSION of every live broker of config 4's
    steady-state cluster through the CLI on cuda, then 16 candidates and a
    scenario file on cuda and cpu. Returns the snapshot and the record."""
    import torch

    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = rack_striped_cluster(
        N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, name_fmt="topic-{:04d}")
    snap = os.path.join(work, "config4_steady.json")
    write_snapshot(snap, topic_map, live, racks)
    held = replicas_held(topic_map)
    argv = ["--zk_string", f"file://{snap}", "--mode", "RANK_DECOMMISSION"]
    marker = "DECOMMISSION RANKING:\n"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text = run_cli(argv + ["--device", "cuda"])
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = dict(whatif.last_sweep)
    rows = json.loads(text.split(marker, 1)[1])
    if len(rows) != len(live) or not all(r["feasible"] for r in rows):
        fail(f"rank: {len(rows)} rows for {len(live)} brokers, or an infeasible one")
    keys = [(not r["feasible"], r["moved_replicas"], r["broker"]) for r in rows]
    if keys != sorted(keys):
        fail("rank: rows are not sorted least-disruptive-first")
    for r in rows:
        if r["moved_replicas"] != held[r["broker"]]:
            fail(f"rank: broker {r['broker']} moved {r['moved_replicas']}, "
                 f"held {held[r['broker']]}")
    span = sorted(set(held.values()))
    host = rec["prep"] + rec["compose"]
    phase("whatif", f"RANK_DECOMMISSION of config 4's {len(live)} brokers on cuda: "
          f"{wall_s:.2f} s wall; sweep (ms) prep {rec['prep']:.1f}, sweep "
          f"{rec['sweep']:.1f}, rescue {rec['rescue']:.1f}, compose {rec['compose']:.1f}; "
          f"host share {host / (host + rec['sweep'] + rec['rescue']):.2f}; path {rec['path']}, "
          f"t_pad {rec['t_pad']}, rows {rec['rows']}, chunks {rec['chunks']}, waves "
          f"{rec['waves']}, peak device memory {peak / 2**30:.2f} GiB; {len(rows)} rows "
          f"feasible, sorted, moved == held ({span[0]}-{span[-1]})")

    scen = os.path.join(work, "scenarios.json")
    with open(scen, "w", encoding="utf-8") as f:
        json.dump([[0, 10], [1, 2], ["b7"], []], f)  # same rack, cross rack
    texts = {}
    for what, extra in (
        ("16 candidates", ["--integer_broker_ids", ",".join(map(str, RANK_CANDIDATES))]),
        ("scenario file", ["--scenario_file", scen]),
    ):
        a = run_cli(argv + extra + ["--device", "cuda"])
        c = run_cli(argv + extra + ["--device", "cpu"])
        if a != c:
            fail(f"rank {what}: cuda and cpu stdout differ")
        texts[what] = a
        phase("cuda==cpu", f"RANK_DECOMMISSION {what} on config 4's cluster: stdout "
              f"byte-identical ({len(a)} bytes, path {whatif.last_sweep['path']})")
    return snap, dict(rec, wall_s=wall_s, peak_bytes=peak,
                      candidates_text=texts["16 candidates"])


def rescue_parity():
    """Phase 12: scenarios the fast sweep strands, re-run by the rescue on
    the auto chain, on cuda and cpu (the instance of
    ``tests/test_torch_whatif.py:rescue_cluster``)."""
    import numpy as np

    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = rack_striped_cluster(100, 1, 2000, RF, 5, name_fmt="rescue-{:02d}")
    rng = np.random.default_rng(0)
    by_rack = {}
    for b in sorted(live):
        by_rack.setdefault(racks[b], []).append(b)
    # Four brokers of every rack: cap ceil(6,000 / 80) = 75, no slack.
    scenarios = [sorted(int(x) for r in sorted(by_rack)
                        for x in rng.choice(by_rack[r], 4, replace=False))
                 for _ in range(4)] + [[0], []]
    out = {}
    for dev in ("cuda", "cpu"):
        res = whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios, RF,
                                                device=dev)
        out[dev] = (as_tuples(res), dict(whatif.last_sweep))
    (a, rec), (c, rec_c) = out["cuda"], out["cpu"]
    if rec["rescued"] < 1 or rec["rescued"] != rec_c["rescued"] or a != c:
        fail(f"rescue: cuda rescued {rec['rescued']}, cpu {rec_c['rescued']}, "
             f"results equal: {a == c}")
    phase("cuda==cpu", f"what-if rescue: {rec['rescued']} of {len(scenarios)} scenarios "
          f"stranded the fast sweep and re-ran on the auto chain ({rec['rescue']:.1f} ms "
          f"on cuda, waves {rec['rescue_waves']}); results equal on cuda and cpu: "
          + ", ".join(f"{m}{'' if f else ' infeasible'}" for _, m, f, _ in a))

    # The four stranded scenarios' sweeps timed on the card: the fast leg,
    # the auto chain the rescue runs, and the seq leg alone.
    import torch

    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models.problem import encode_topic_group
    from kafka_assigner_tpu_torch.ops.assignment import whatif_sweep

    encs, cur, jh, pr = encode_topic_group(list(topic_map.items()), racks, live, RF)
    alive = np.zeros((4, encs[0].n_pad), bool)
    alive[:, : encs[0].n] = True
    for s, removed in enumerate(scenarios[:4]):
        alive[s, np.searchsorted(encs[0].broker_ids, removed)] = False
    args = [to_tensor(x, "cuda") for x in (cur, encs[0].rack_idx, jh, pr)]
    args.append(torch.as_tensor(alive).cuda())
    legs = []
    for mode in ("fast", "auto", "seq"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = whatif_sweep(*args, encs[0].n, RF, mode, r_cap=encs[0].r_cap)
        torch.cuda.synchronize()
        legs.append(f"{mode} {(time.perf_counter() - t0) * 1e3:.1f} ms {res.waves}")
    phase("whatif", "rescue instance, the 4 stranded scenarios on cuda: " + "; ".join(legs))


def host_modes(snap, n_brokers, n_partitions):
    """Phase 13: the two current-state modes on phase 11's snapshot."""
    for mode, marker, count in (
        ("PRINT_CURRENT_ASSIGNMENT", "CURRENT ASSIGNMENT:\n",
         lambda d: len(d["partitions"])),
        ("PRINT_CURRENT_BROKERS", "CURRENT BROKERS:\n", len),
    ):
        argv = ["--zk_string", f"file://{snap}", "--mode", mode]
        a = run_cli(argv + ["--device", "cuda"])
        c = run_cli(argv + ["--device", "cpu"])
        got = count(json.loads(a.split(marker, 1)[1]))
        want = n_partitions if mode == "PRINT_CURRENT_ASSIGNMENT" else n_brokers
        if a != c or got != want:
            fail(f"{mode}: {got} entries (expected {want}), or cuda and cpu differ")
        phase("host", f"{mode}: {got} entries, {len(a)} bytes, identical on cuda and cpu")


def group_kernel_cases():
    """Phase 3b: the group-pack kernel against its plain version on the
    stress cases. Returns max |kernel - plain| over every case."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases

    worst = 0
    for case in gcases.stress_cases():
        name, w, cap = case[:3]
        err = gcases.check_case(case)
        worst = max(worst, err)
        if err:
            fail(f"group-pack kernel disagrees with plain on case {name}")
        phase("kernels", f"group_pack {name} (S={w.shape[0]} P_pad={w.shape[1]} "
              f"C_pad={cap.shape[0]}{', forced global' if case[7] else ''}; "
              f"variant {variant_name(gp.last_variant, case[5])}): bit-equal")
    return worst


def variant_name(variant, alive):
    """``registers/K`` (the consumers a lane of the candidates, ``alive``
    their liveness), ``shared`` or ``global``."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp

    if variant != "registers":
        return variant
    return "registers/" + ",".join(map(str, sorted({gp.span_slots(row) for row in alive})))


def write_group_snapshot(path, topic_map, live, racks):
    """Config 4's steady cluster with phase 14's ``groups`` section; returns
    the old owner of every (topic, partition)."""
    import numpy as np

    rows = sorted((t, p) for t, parts in topic_map.items() for p in parts)
    rng = np.random.default_rng(0)
    lags = np.minimum((rng.pareto(1.2, len(rows)) * 100).astype(np.int64), 10**7)
    owner, assignment, lag = {}, {}, {}
    for i, (t, p) in enumerate(rows):
        owner[t, p] = f"c-{i % GROUP_OWNERS:03d}"
        assignment.setdefault(t, {})[str(p)] = owner[t, p]
        lag.setdefault(t, {})[str(p)] = int(lags[i])
    write_snapshot(path, topic_map, live, racks)
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    data["groups"] = {"ingest": {
        "members": {f"c-{m:03d}": None for m in range(GROUP_MEMBERS)},
        "assignment": assignment, "lag": lag,
    }}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return owner


def groups_cli(argv):
    """``run_groups(argv)`` with stdout captured: ``(rc, stdout, stderr)``."""
    from kafka_assigner_tpu_torch.cli import run_groups

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_groups(argv)
    return rc, out.getvalue(), err.getvalue()


def groups_cpu_run(argv):
    """Worker process: the ``ka-groups`` run on ``cpu``; returns ``(rc,
    stdout, seconds)``."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rc, out, _ = groups_cli(argv + ["--device", "cpu"])
    return rc, out, time.perf_counter() - t0


def group_plain_check(inputs, outputs):
    """Worker process: the plain group-pack scan on ``inputs`` (numpy
    arrays: weights, capacities, proc_order, alive, need, assigned, load),
    against the kernel's ``outputs`` (assigned, load, overflowed); returns
    (max |kernel - plain|, seconds)."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from kafka_assigner_tpu_torch.ops.group_pack import pack_scan_plain

    t0 = time.perf_counter()
    t = [torch.from_numpy(a) for a in inputs]
    over = pack_scan_plain(*t)
    plain = (t[5].numpy(), t[6].numpy(), over.numpy())
    err = max(int(np.abs(k.astype(np.int64) - p).max()) for k, p in zip(outputs, plain))
    return err, time.perf_counter() - t0


@contextlib.contextmanager
def scan_probe():
    """Record, for a block, every group-pack scan call: ``(inputs,
    outputs)``, inputs copied before the call (it updates ``assigned`` and
    ``load`` in place). Wraps ``ops/group_pack.py:pack_scan`` and restores
    it afterwards; the wrapper and its launch count are untouched."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp

    seen = []
    real = gp.pack_scan

    def recorded(*args, **kw):
        inputs = tuple(t.clone() for t in args[:7])
        over = real(*args, **kw)
        seen.append((inputs, (args[5].clone(), args[6].clone(), over.clone())))
        return over

    gp.pack_scan = recorded
    try:
        yield seen
    finally:
        gp.pack_scan = real


def scan_timing(what, inputs, outputs):
    """The kernel alone on a main path's inputs: median of KERNEL_REPS
    launches by CUDA events (``assigned`` and ``load`` re-copied before
    each, outside the events), its result held against the launch checked
    against plain. Returns (ms, min, max)."""
    import torch

    from kafka_assigner_tpu_torch.ops import group_pack as gp

    times = []
    for i in range(KERNEL_REPS + 1):  # 1 warm-up
        assigned, load = inputs[5].clone(), inputs[6].clone()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        over = gp.pack_scan(*inputs[:5], assigned, load)
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    if any(not torch.equal(x, y) for x, y in zip((assigned, load, over), outputs)):
        fail(f"{what}: the timed group-pack launch differs from the checked one")
    return statistics.median(times), min(times), max(times)


def group_phases(work, steady_snap, checks):
    """Phases 14-16: ``ka-groups`` plan, sweep and the synthetic sweep on
    config 4's cluster, each ``cuda`` run with the kernel counts reset just
    before and read just after; ``cpu`` runs and plain checks go to the
    workers. Returns the group-pack kernel's entry of the ``kernels`` line,
    and each path's argv and ``cuda`` stdout."""
    import numpy as np
    import torch

    from kafka_assigner_tpu_torch.groups import solve as gsolve
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = rack_striped_cluster(
        N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, name_fmt="topic-{:04d}")
    snap = os.path.join(work, "config4_groups.json")
    owner = write_group_snapshot(snap, topic_map, live, racks)
    base = ["--zk_string", f"file://{snap}"]
    counts = ",".join(map(str, GROUP_COUNTS))
    scales = ",".join(map(str, GROUP_SCALES))
    paths = {
        "group_plan": base + ["--mode", "plan"],
        "group_sweep": base + ["--mode", "sweep", "--counts", counts, "--scales", scales],
        "group_synthetic": ["--zk_string", f"file://{steady_snap}", "--mode", "sweep",
                            "--synthetic", "--weight", "throughput"],
    }
    by_path, records, texts, timed = {}, {}, {}, {}
    for path, argv in paths.items():
        with scan_probe() as seen:
            gp.launches["group_pack"] = 0
            t0 = time.perf_counter()
            rc, text, err = groups_cli(argv + ["--device", "cuda"])
            wall = time.perf_counter() - t0
            by_path[path] = gp.launches["group_pack"]
        if rc != 0:
            fail(f"{path}: ka-groups exited {rc} on cuda: {err.strip()}")
        if by_path[path] < 1 or len(seen) != by_path[path]:
            fail(f"{path}: the group-pack kernel launched {by_path[path]} times")
        records[path] = dict(whatif.last_groups, wall_s=wall)
        texts[path] = text

        def done(result, path=path, text=text):
            rc_c, text_c, secs = result
            if rc_c != 0 or text_c != text:
                fail(f"{path}: ka-groups stdout differs on cuda and cpu (cpu rc {rc_c})")
            phase("cuda==cpu", f"{path}: ka-groups stdout byte-identical on cuda and "
                  f"cpu ({len(text)} bytes; the cpu run {secs:.1f} s in a worker)")
            return 0

        checks.job("group_pack", done, groups_cpu_run, argv)
        inputs, outputs = seen[0]
        shape = f"S={inputs[0].shape[0]} P_pad={inputs[0].shape[1]} C_pad={inputs[1].shape[0]}"

        def checked(result, path=path, shape=shape):
            err, secs = result
            if err:
                fail(f"{path}: group-pack kernel disagrees with plain at {shape}")
            phase("kernels", f"group_pack at {path} {shape}: bit-equal to plain on "
                  f"assigned, load and overflowed (plain on CPU {secs:.1f} s in a worker)")
            return err

        checks.job("group_pack", checked, group_plain_check,
                   tuple(a.cpu().numpy() for a in inputs),
                   tuple(a.cpu().numpy() for a in outputs))
        timed[path] = (inputs, outputs, shape)
        rec = records[path]
        phase("groups", f"{path} on cuda: {wall:.2f} s wall; {shape}; steps (orphan "
              f"rows) max {rec['steps_max']}, sum {rec['steps_sum']}; (ms) encode "
              f"{rec['encode']:.1f}, upload {rec['upload']:.1f}, sticky {rec['sticky']:.1f}, "
              f"scan {rec['scan']:.1f}, download {rec['download']:.1f}, decode "
              f"{rec['decode']:.1f}; group-pack kernel launches {by_path[path]}")

    # Phase 14: every row on a live member, moves == rows whose owner changed.
    plan = json.loads(texts["group_plan"])
    members = {f"c-{m:03d}" for m in range(GROUP_MEMBERS)}
    placed = {(t, int(p)): m for t, per in plan["plan"].items() for p, m in per.items()}
    if set(placed) != set(owner) or not set(placed.values()) <= members:
        fail("group plan: a row is missing or sits on a member that left")
    # A departed member's rows are unowned in the encoding: they are placed,
    # not moved, so moves counts the rows taken off a live owner.
    changed = sum(placed[k] != o for k, o in owner.items() if o in members)
    departed = sum(o not in members for o in owner.values())
    if plan["moves"] != changed:
        fail(f"group plan: moves {plan['moves']} != {changed} rows taken off a live owner")
    phase("groups", f"plan: {len(placed)} rows on {len(set(placed.values()))} live members; "
          f"moves {plan['moves']} == rows taken off a live owner; {departed} rows of "
          f"departed members placed; orphan rows "
          f"{records['group_plan']['steps_sum']}; overflowed {plan['overflowed']}; "
          f"feasible {plan['feasible']}")
    # Phase 15: the cost curve.
    sweep = json.loads(texts["group_sweep"])
    if "recommended_consumers" not in sweep or len(sweep["candidates"]) != \
            len(GROUP_COUNTS) * len(GROUP_SCALES):
        fail("group sweep: no recommendation or a wrong candidate count")
    feas = {s: min([c["consumers"] for c in sweep["candidates"]
                    if c["scale_pct"] == s and c["feasible"]], default=None)
            for s in GROUP_SCALES}
    phase("groups", f"sweep: recommended_consumers {sweep['recommended_consumers']}; "
          f"smallest feasible count per scale {feas}")
    synth = json.loads(texts["group_synthetic"])
    rc, out, err = groups_cli(["--zk_string", f"file://{steady_snap}", "--mode", "sweep",
                               "--weight", "throughput", "--device", "cuda"])
    if rc != 1 or out or "--synthetic" not in err:
        fail(f"the refusal without --synthetic: exit {rc}, stdout {len(out)} bytes")
    phase("groups", f"synthetic: {len(synth['candidates'])} candidates, "
          f"recommended_consumers {synth['recommended_consumers']}; without "
          "--synthetic: refused, exit 1")

    # Phase 15's timing: the sweep through the library, warm median of 3.
    backend = SnapshotBackend(snap)
    part_map = {t: sorted(per) for t, per in
                backend.partition_assignment(backend.all_topics()).items()}
    states, real = gsolve.load_group_states(backend, part_map)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(GROUP_SWEEP_REPS + 1):  # 1 warm-up
        t0 = time.perf_counter()
        gsolve.build_group_bodies(states, real, part_map, "sweep", "lag", None,
                                  list(GROUP_SCALES), 1.25, 256,
                                  counts=list(GROUP_COUNTS), device="cuda")
        if i:
            runs.append(dict(whatif.last_groups, total=(time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    keys = ("total", "encode", "upload", "sticky", "scan", "download", "decode")
    med = {k: statistics.median(r[k] for r in runs) for k in keys}
    phase("timing", f"group sweep median of {GROUP_SWEEP_REPS} (ms): "
          + ", ".join(f"{k} {med[k]:.1f}" for k in keys)
          + f"; steps max {runs[-1]['steps_max']}, sum {runs[-1]['steps_sum']}; "
          f"peak device memory {peak / 2**20:.1f} MiB")

    # The kernel alone at each path's shape, its bound, its chain floor (the
    # longest chain times the step probe's time a step) and the register
    # variant's (times the ballot probe's), the ratios to them, and the
    # chain at the kernel's own time a step (one all-orphan candidate, every
    # consumer alive, at the longest chain's K in the register variant).
    probe_ns, probe_cycles = gcases.probe_ns()
    phase("timing", f"group_pack step probe: {probe_ns:.2f} ns, {probe_cycles:.2f} cycles "
          "a step of the chain alone (two warp reductions and the bump, one warp)")
    ballot_ns, ballot_cycles = gcases.probe_ns(ballot=True)
    phase("timing", f"group_pack ballot probe: {ballot_ns:.2f} ns, {ballot_cycles:.2f} "
          "cycles a step of the chain alone (one warp reduction, a ballot and the bump, "
          "one warp): the register variant's floor")
    step_by_c = {}
    for c_pad in gcases.BUCKET_C_PADS + (gcases.SHARED_C_PAD,):
        step_by_c[c_pad] = gcases.step_ns(c_pad)
        label = variant_name(gp.last_variant, [[True] * c_pad])
        phase("timing", f"group_pack kernel's own step at C_pad {c_pad} (variant "
              f"{label}, one all-orphan candidate): {step_by_c[c_pad]:.1f} ns, "
              f"{step_by_c[c_pad] / probe_ns:.2f}x the probe, "
              f"{step_by_c[c_pad] / ballot_ns:.2f}x the ballot probe")
    out = {}
    for path, (inputs, outputs, shape) in timed.items():
        ms, lo, hi = scan_timing(path, inputs, outputs)
        variant = gp.last_variant
        s_, p_ = inputs[0].shape
        c_ = inputs[1].shape[0]
        rec = records[path]
        nbytes = gcases.scan_bytes(s_, p_, c_, rec["steps_sum"])
        orphans = inputs[4].sum(1).tolist()
        longest = max(range(s_), key=orphans.__getitem__)
        slots = gp.span_slots(inputs[3][longest].tolist()) if variant == "registers" else 0
        step_c = 32 * slots if slots else c_
        step = step_by_c.get(step_c) or gcases.step_ns(step_c)
        # Each candidate's chain at its own K's step: the slowest of them.
        slowest_ms = max(n * (step_by_c[32 * gp.span_slots(row)] if slots else step)
                         for n, row in zip(orphans, inputs[3].tolist())) * 1e-6
        chain_bound_ms = rec["steps_max"] * probe_ns * 1e-6
        register_floor_ms = rec["steps_max"] * ballot_ns * 1e-6
        out[path] = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                         c_pad=c_, variant=variant, longest_chain_slots=slots,
                         chain_steps=rec["steps_max"], step_probe_ns=probe_ns,
                         chain_bound_ms=chain_bound_ms,
                         ratio_to_chain_floor=ms / chain_bound_ms,
                         register_floor_ms=register_floor_ms,
                         ratio_to_register_floor=ms / register_floor_ms,
                         kernel_step_ns=step, kernel_step_c_pad=step_c,
                         chain_kernel_ms=rec["steps_max"] * step * 1e-6,
                         slowest_chain_kernel_ms=slowest_ms)
        phase("timing", f"group_pack kernel at {path} ({shape}, variant "
              f"{variant_name(variant, inputs[3].tolist())}; the longest chain's "
              f"candidate at {slots} consumers a lane): median {ms:.3f} ms of "
              f"{KERNEL_REPS} (min {lo:.3f}, max {hi:.3f}); byte bound "
              f"{out[path]['bound_ms']:.4f} ms ({nbytes} bytes); chain floor "
              f"{chain_bound_ms:.3f} ms ({rec['steps_max']} steps x {probe_ns:.2f} ns of "
              f"the probe); ms / chain floor {out[path]['ratio_to_chain_floor']:.3f}; "
              f"register floor {register_floor_ms:.3f} ms (x {ballot_ns:.2f} ns of the "
              f"ballot probe), ms / it {out[path]['ratio_to_register_floor']:.3f}; the "
              f"chain at the kernel's own {step:.1f} ns a step (one all-orphan "
              f"candidate at C_pad {step_c}) {out[path]['chain_kernel_ms']:.3f} ms; the "
              f"slowest candidate's chain at its own K's step {slowest_ms:.3f} ms")
    r = GROUP_PLAIN_SHAPE
    rng = np.random.default_rng(1)
    w, cap, cur, order, alive = gcases.instance(rng, r["s"], r["p"], r["p"], r["c"], r["c"])
    case = ("plain-shape", w, cap, cur, order, alive, r["p"], False)
    small = gcases.scan_inputs(case, "cuda")
    plain_in = tuple(x.clone() for x in small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    over_p = gp.pack_scan_plain(*plain_in)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # The timed launches are held against the plain version's result here.
    small_ms, _, _ = scan_timing("the plain shape", small, (*plain_in[5:], over_p))
    plain_shape = f"S={r['s']} P_pad={r['p']} C_pad={r['c']}"
    phase("timing", f"group_pack at {plain_shape}: kernel {small_ms:.3f} ms, plain on "
          f"the card {plain_ms:.1f} ms")
    main = out["group_sweep"]
    return {
        "name": "group_pack",
        "route": "cuda",
        "source": "kafka_assigner_tpu_torch/csrc/group_pack.cu",
        "replaces": GROUP_TPU_LOOP,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": 0,
        "tolerance": "exact (integer outputs)",
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "plain_shape": plain_shape,
        "ms_at_plain_shape": small_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "chain_steps": main["chain_steps"],
        "chain_bound_ms": main["chain_bound_ms"],
        "step_probe_ns": probe_ns,
        "step_probe_cycles": probe_cycles,
        "ballot_probe_ns": ballot_ns,
        "ballot_probe_cycles": ballot_cycles,
        "chain_kernel_ms": main["chain_kernel_ms"],
        "variant": main["variant"],
        "longest_chain_slots": main["longest_chain_slots"],
        "ratio_to_chain_floor": main["ratio_to_chain_floor"],
        "register_floor_ms": main["register_floor_ms"],
        "ratio_to_register_floor": main["ratio_to_register_floor"],
        "step_ns_by_c_pad": {str(c): v for c, v in step_by_c.items()},
        "by_path": out,
    }, {path: (argv, texts[path]) for path, argv in paths.items()}


def leadership_lanes(argv4, config4, cells, work):
    """Phase 17: ``KA_LEADERSHIP=native`` against ``device`` on config 4 and
    the giant expansion. Through the CLI on cuda: stdout byte-identical, the
    leadership kernel launched on the device lane only. Then a warm median
    of each lane in turns, split by phase; the native lane's leadership
    phase includes copying the placement to the host."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.solvers.base import Context

    g_map, g_live, g_racks, _, _ = cells["expansion"]
    g_argv = ["--zk_string", f"file://{os.path.join(work, 'giant_expansion.json')}",
              "--mode", "PRINT_REASSIGNMENT"]
    lanes = {"native": {"KA_LEADERSHIP": "native"}, "device": {"KA_LEADERSHIP": "device"}}
    out = {}
    for what, argv, (topics, live, rack_map), reps in (
        ("config 4", argv4, config4, SOLVE_REPS),
        ("giant expansion", g_argv, (list(g_map.items()), g_live, g_racks), GIANT_SOLVE_REPS),
    ):
        texts, launched = {}, {}
        for lane, values in lanes.items():
            with knobs(**values):
                lead.launches["leadership"] = 0
                texts[lane] = run_cli(argv + ["--device", "cuda"])
                launched[lane] = lead.launches["leadership"]
        if texts["native"] != texts["device"]:
            fail(f"{what}: the plans differ on the native and device leadership lanes")
        if launched["native"] or launched["device"] < 1:
            fail(f"{what}: leadership kernel launches {launched} (native must be 0)")
        assigner = TopicAssigner(device="cuda")

        def solve(topics=topics, live=live, rack_map=rack_map):
            assigner.context = Context()
            return assigner.generate_assignments(topics, live, rack_map), assigner.solver

        got = timed_turns(solve, lanes, reps)
        (med_n, text_n, _, lane_n, k_n), (med_d, text_d, _, lane_d, k_d) = \
            got["native"], got["device"]
        if (lane_n, lane_d) != ("native", "cuda") or k_n or k_d != reps + 1 \
                or text_n != text_d:
            fail(f"{what}: lanes ran {lane_n}/{lane_d}, kernel launches {k_n}/{k_d}, "
                 f"plans equal {text_n == text_d}")
        phase("lanes", f"{what}: CLI stdout byte-identical on KA_LEADERSHIP=native and "
              f"device ({len(texts['native'])} bytes); leadership kernel launches "
              f"{launched['native']} / {launched['device']}; median of {reps} in turns "
              f"(ms): native {phase_ms(med_n)}; device {phase_ms(med_d)}")
        out[what] = {"native": med_n, "device": med_d, "cli_launches": launched}
    return out


def moved_count(plan, topic_map):
    return sum(len(set(reps) - set(topic_map[t][p]))
               for t, per in plan.items() for p, reps in per.items())


def solver_lanes(argv4, device_text, prefix, prefix_text, topic_map, live, rack_map,
                 cap, on_removed):
    """Phase 18: ``--solver native`` on config 4 through the CLI, then
    ``--solver greedy`` and ``native`` on phase 5's prefix; neither launches
    the leadership kernel. The C++ greedy places orphans first-fit where the
    device solver runs its waves, so the two NEW ASSIGNMENT sections agree
    in what moves, not in every list (as in the JAX package's lanes, which
    the CPU tests hold these to). Returns the ``--solver greedy`` prefix
    text."""
    from kafka_assigner_tpu_torch.ops import leadership as lead

    lead.launches["leadership"] = 0
    t0 = time.perf_counter()
    native = run_cli(argv4 + ["--solver", "native", "--device", "cuda"])
    wall = time.perf_counter() - t0
    marker = "NEW ASSIGNMENT:\n"
    if native.split(marker)[0] != device_text.split(marker)[0]:
        fail("--solver native: the CURRENT ASSIGNMENT section differs from --solver device's")
    plan_n, plan_d = plan_section(native), plan_section(device_text)
    moved = check_plan(plan_n, topic_map, live, rack_map, cap, on_removed)
    differ = sum(plan_n[t][p] != plan_d[t][p] for t in plan_n for p in plan_n[t])
    phase("solvers", f"--solver native on config 4 through the CLI: {wall:.2f} s wall, "
          f"moved {moved} == --solver device's; {differ} of "
          f"{sum(map(len, plan_n.values()))} lists differ from the device plan")
    sub = {t: topic_map[t] for t in prefix.split(",")}
    texts = {}
    for solver in ("greedy", "native"):
        t0 = time.perf_counter()
        texts[solver] = run_cli(argv4 + ["--topics", prefix, "--solver", solver,
                                         "--device", "cuda"])
        texts[solver + "_s"] = time.perf_counter() - t0
    if texts["greedy"] != texts["native"]:
        fail(f"{PREFIX_TOPICS}-topic prefix: --solver greedy and native differ")
    want = moved_count(plan_section(prefix_text), sub)
    moved_p = check_plan(plan_section(texts["greedy"]), sub, live, rack_map, cap, want)
    if lead.launches["leadership"]:
        fail(f"the greedy lanes launched the leadership kernel {lead.launches['leadership']}"
             " times")
    phase("solvers", f"{PREFIX_TOPICS}-topic prefix: --solver greedy "
          f"({texts['greedy_s']:.2f} s) and native ({texts['native_s']:.2f} s) "
          f"byte-identical, moved {moved_p} == --solver device's; leadership kernel "
          "launches 0 on the greedy lanes")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "torch_bench.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"scripts/torch_bench.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    extra = bench["extra"]
    if extra["moved_replicas"] != on_removed or extra["codec"] != \
            {"encode": "c", "decode": "c"} or extra["leadership"] != "cuda":
        fail(f"scripts/torch_bench.py: unexpected run {extra}")
    phase("solvers", f"scripts/torch_bench.py in a subprocess ({time.perf_counter() - t0:.1f} s), "
          "its line:")
    print(line, flush=True)
    return texts["greedy"]


#: The knobs phases 1-18 run without; phase 19 sets them per run.
POLICY_KNOBS = ("KA_FAILURE_POLICY", "KA_FAULTS_SPEC", "KA_OBS_PROFILE_DIR", "KA_PROFILE",
                "KA_OBS_REPORT", "KA_OBS_ENABLE")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def cli_run(fn, argv):
    """``fn(argv)`` (the port's ``run`` or ``run_groups``) with stdout and
    stderr captured: ``(rc, stdout, stderr, seconds)``; the fault injector
    starts from a fresh schedule."""
    from kafka_assigner_tpu_torch import faults

    faults.reset()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def read_report(path, status):
    from kafka_assigner_tpu_torch.obs.report import validate_report

    with open(path, encoding="utf-8") as f:
        report = json.load(f)
    problems = validate_report(report)
    if problems or report["status"] != status:
        fail(f"{path}: status {report['status']} (want {status}), problems {problems}")
    return report


def busy_us(intervals, lo, hi):
    """Length of the union of ``intervals`` (start, end) clipped to [lo, hi]."""
    total, cur = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def trace_window(path):
    """The dispatch window of one ``dispatch_trace`` Chrome trace: ``(window
    ms, device busy ms, device ops inside the window as (name, ms))``; the
    busy time is the union of kernel, memcpy and memset intervals."""
    from kafka_assigner_tpu_torch.obs.profile import DISPATCH_LABEL

    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    wins = [e for e in events if e.get("name") == DISPATCH_LABEL and e.get("ph") == "X"
            and e.get("cat") != "gpu_user_annotation"]
    if len(wins) != 1:
        fail(f"{path}: {len(wins)} dispatch windows, not 1")
    lo = float(wins[0]["ts"])
    hi = lo + float(wins[0]["dur"])
    dev = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    inside = [(n, (min(b, hi) - max(a, lo)) / 1e3) for n, a, b in dev if b > lo and a < hi]
    return (hi - lo) / 1e3, busy_us([(a, b) for _, a, b in dev], lo, hi) / 1e3, inside


def obs_phases(work, checks, argv4, text4, moved4, config4, k1_ms, warm_med, prefix,
               prefix_text, greedy_prefix, group_runs, steady_snap, rank_text):
    """Phase 19: the run report, the device trace and the failure policy on
    cuda. (a) config 4 through the CLI with ``--report-json``; (b) one warm
    config-4 solve traced under ``KA_OBS_PROFILE_DIR``; (c) the failure
    policy on the 64-topic prefix with ``KA_FAULTS_SPEC=solve:0=crash``;
    (d) ``ka-groups`` with the report, and the synthetic sweep's
    best-effort fallback; (e) RANK_DECOMMISSION of the 16 candidates with the report.
    Returns the leadership kernel's launches per run."""
    from kafka_assigner_tpu_torch import cli
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    rdir = os.path.join(work, "reports")
    os.makedirs(rdir, exist_ok=True)
    launches = {}

    # (a) the mode-3 report at config 4.
    path = os.path.join(rdir, "config4.json")
    lead.launches["leadership"] = 0
    rc, out, err, wall = cli_run(cli.run, argv4 + ["--device", "cuda", "--report-json", path])
    launches["obs_report_config4"] = lead.launches["leadership"]
    if rc != 0 or out != text4:
        fail(f"19a: exit {rc}; stdout equal to phase 4's: {out == text4}; {err[-500:]}")
    report = read_report(path, "ok")
    spans = {s["path"]: s for s in report["spans"]}
    mode = "mode/PRINT_REASSIGNMENT"
    want = [f"{mode}/{leaf}" for leaf in (
        "metadata/assignment", "feasibility", "plan/solve", "plan/solve/encode",
        "plan/solve/solve", "plan/solve/decode", "plan/emit")]
    counters = report["metrics"]["counters"]
    if [p for p in want if p not in spans] or report["plan"]["moves"] != moved4 \
            or report["plan"]["partitions"] != N_TOPICS * P_PER_TOPIC \
            or counters.get("zk.reads", 0) < 1 or counters.get("zk.bytes", 0) <= 0 \
            or launches["obs_report_config4"] != 1:
        fail(f"19a: spans {sorted(spans)}, plan {report['plan']}, counters {counters}, "
             f"leadership launches {launches['obs_report_config4']}")
    top = spans[mode]
    kids = [s for s in report["spans"] if s["depth"] == 1]
    solve_kids = [s for s in report["spans"] if s["path"].startswith(f"{mode}/plan/solve/")]
    phase("obs", f"(a) config 4 mode 3 with --report-json on cuda: report valid, status ok; "
          f"stdout byte-identical to phase 4's; plan moves {report['plan']['moves']}, "
          f"partitions {report['plan']['partitions']}, leader churn "
          f"{report['plan']['leader_churn']}; zk.reads {counters['zk.reads']}, zk.bytes "
          f"{counters['zk.bytes']}; leadership kernel launches 1")
    phase("obs", f"(a) span tree (ms): {top['path']} {top['ms']}: "
          + ", ".join(f"{s['name']} {s['ms']}" for s in kids)
          + f", not in a child span {top['ms'] - sum(s['ms'] for s in kids):.1f}; plan/solve: "
          + ", ".join(f"{s['name']} {s['ms']}" for s in solve_kids)
          + f"; CLI wall {wall * 1e3:.1f}, of it outside the mode span "
          f"{wall * 1e3 - top['ms']:.1f}")

    # (b) one warm config-4 solve under the profiler.
    topics, live, rack_map = config4
    assigner = TopicAssigner(device="cuda")
    assigner.generate_assignments(topics, live, rack_map)  # warm
    tdir = os.path.join(work, "traces")
    if os.path.isdir(tdir):
        for name in os.listdir(tdir):
            os.unlink(os.path.join(tdir, name))
    lead.launches["leadership"] = 0
    with knobs(KA_OBS_PROFILE_DIR=tdir):
        t0 = time.perf_counter()
        assigner.generate_assignments(topics, live, rack_map)
        traced_wall = (time.perf_counter() - t0) * 1e3
    launches["obs_trace_warm"] = lead.launches["leadership"]
    traces = os.listdir(tdir)
    if len(traces) != 1 or launches["obs_trace_warm"] != 1:
        fail(f"19b: {len(traces)} traces, {launches['obs_trace_warm']} kernel launches")
    window, busy, inside = trace_window(os.path.join(tdir, traces[0]))
    by_name = {}
    for name, dur in inside:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + dur, n + 1)
    chain = [d for n, d in inside if "chain_kernel" in n]
    prologue = [d for n, d in inside if "prologue_kernel" in n]
    timers = assigner.solver.last_timers
    phase("obs", f"(b) warm config-4 solve under KA_OBS_PROFILE_DIR: dispatch window "
          f"{window:.1f} ms (the call's host clock with the profiler's start and the trace's "
          f"export {traced_wall:.1f} ms; the unprofiled warm median of "
          f"phase 6 {warm_med['total']:.1f} ms); phases under the profiler (ms) "
          + ", ".join(f"{k} {timers[k]:.1f}" for k in ("encode", "place", "leadership",
                                                      "decode"))
          + f"; {len(inside)} device events, trace {os.path.getsize(os.path.join(tdir, traces[0]))}"
          " bytes")
    if len(chain) != 1 or len(prologue) != 1:
        fail(f"19b: the leadership kernel appears {len(chain)} (chain) / "
             f"{len(prologue)} (prologue) times in the trace, not once "
             f"({len(inside)} device events)")
    topn = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    phase("obs", f"(b) device busy {busy:.2f} ms of the {window:.1f} ms window: "
          f"idle share {1 - busy / window:.4f}; leadership kernel traced "
          f"{chain[0] + prologue[0]:.3f} ms (chain {chain[0]:.3f}, prologue "
          f"{prologue[0]:.3f}) against {k1_ms:.3f} ms by CUDA events in phase 6")
    phase("obs", "(b) top device ops (total ms, launches): " + "; ".join(
        f"{name[:70]} {tot:.3f} ({n})" for name, (tot, n) in topn))

    # (c) the failure policy on the prefix.
    base = argv4 + ["--topics", prefix, "--device", "cuda"]
    path = os.path.join(rdir, "fallback.json")
    lead.launches["leadership"] = 0
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc, out, err, secs = cli_run(cli.run, base + ["--failure-policy", "best-effort",
                                                      "--report-json", path])
    launched = lead.launches["leadership"]
    report = read_report(path, "degraded")
    counters = report["metrics"]["counters"]
    if rc != cli.EXIT_DEGRADED or "falling back to the greedy solver" not in err \
            or out != greedy_prefix or counters.get("solve.fallbacks") != 1 \
            or counters.get("faults.injected") != 1 or launched:
        fail(f"19c best-effort: exit {rc}, stdout == phase 18's greedy prefix "
             f"{out == greedy_prefix}, counters {counters}, kernel launches {launched}")
    path = os.path.join(rdir, "strict.json")
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc_s, out_s, err_s, _ = cli_run(cli.run, base + ["--report-json", path])
    strict = read_report(path, "error")
    if rc_s != cli.EXIT_SOLVE or strict.get("error", {}).get("type") != "SolveError":
        fail(f"19c strict: exit {rc_s}, error {strict.get('error')}")
    lead.launches["leadership"] = 0
    rc_c, out_c, _, _ = cli_run(cli.run, base + ["--failure-policy", "best-effort"])
    launches["obs_policy_clean"] = lead.launches["leadership"]
    if rc_c != 0 or out_c != prefix_text or launches["obs_policy_clean"] != 1:
        fail(f"19c clean best-effort: exit {rc_c}, stdout == strict {out_c == prefix_text}")
    phase("obs", f"(c) {PREFIX_TOPICS}-topic prefix on cuda, KA_FAULTS_SPEC=solve:0=crash: "
          f"best-effort exit 6 in {secs:.2f} s, stdout byte-identical to phase 18's "
          "--solver greedy, report degraded, solve.fallbacks 1, faults.injected 1, "
          "leadership kernel launches 0; strict exit 4, report error SolveError; no spec "
          "+ best-effort: exit 0, stdout byte-identical to strict, kernel launches 1")

    # (d) ka-groups with the report; the synthetic sweep's fallback.
    argv, text = group_runs["group_plan"]
    path = os.path.join(rdir, "groups_plan.json")
    gp.launches["group_pack"] = 0
    rc, out, err, secs = cli_run(cli.run_groups, argv + ["--device", "cuda",
                                                        "--report-json", path])
    kg1 = gp.launches["group_pack"]
    report = read_report(path, "ok")
    counters = report["metrics"]["counters"]
    moves = json.loads(text)["moves"]
    if rc != 0 or out != text or kg1 != 1 or counters.get("groups.plans") != 1 \
            or counters.get("groups.moves") != moves:
        fail(f"19d plan: exit {rc}, stdout == phase 14's {out == text}, KG1 launches "
             f"{kg1}, counters {counters}")
    phase("obs", f"(d) ka-groups plan with --report-json on cuda ({secs:.2f} s): stdout "
          f"byte-identical to phase 14's, groups.plans 1, groups.moves {moves} == the "
          f"envelope's, group-pack kernel launches 1")
    # The oracle (--solver greedy: the host sweep, no device) runs on cpu in
    # a worker beside the later phases; the fallback runs here on cuda.
    argv, _ = group_runs["group_synthetic"]
    fallback = {}

    def oracle_done(result):
        rc_g, out_g, secs_g = result
        body = json.loads(fallback["out"] or "{}")
        if rc_g != 0 or dict(body, solver="greedy") != json.loads(out_g or "{}"):
            fail(f"19d synthetic fallback: the --solver greedy run exited {rc_g}; "
                 f"envelopes equal but the marker {dict(body, solver='greedy')}")
        phase("obs", f"(d) the synthetic sweep's greedy-fallback envelope == --solver "
              f"greedy's but the marker (the oracle on cpu {secs_g:.1f} s in a worker)")
        return 0

    checks.job("group_pack", oracle_done, groups_cpu_run, argv + ["--solver", "greedy"])
    gp.launches["group_pack"] = 0
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc_f, fallback["out"], _, secs_f = cli_run(
            cli.run_groups, argv + ["--failure-policy", "best-effort", "--device", "cuda"])
    body = json.loads(fallback["out"] or "{}")
    if rc_f != cli.EXIT_DEGRADED or body.get("solver") != "greedy-fallback" \
            or gp.launches["group_pack"]:
        fail(f"19d synthetic fallback: exit {rc_f}, solver {body.get('solver')}, "
             f"group-pack kernel launches {gp.launches['group_pack']}")
    phase("obs", f"(d) the synthetic sweep with solve:0=crash --failure-policy "
          f"best-effort on cuda: exit 6 ({secs_f:.2f} s), solver greedy-fallback, "
          f"{len(body.get('candidates', []))} candidates, group-pack kernel launches 0")

    # (e) RANK_DECOMMISSION of the 16 candidates with the report.
    path = os.path.join(rdir, "rank.json")
    argv = ["--zk_string", f"file://{steady_snap}", "--mode", "RANK_DECOMMISSION",
            "--integer_broker_ids", ",".join(map(str, RANK_CANDIDATES))]
    lead.launches["leadership"] = 0
    rc, out, err, secs = cli_run(cli.run, argv + ["--device", "cuda", "--report-json", path])
    report = read_report(path, "ok")
    paths = {s["path"] for s in report["spans"]}
    counters, gauges = report["metrics"]["counters"], report["metrics"]["gauges"]
    if rc != 0 or out != rank_text or "mode/RANK_DECOMMISSION/whatif/rank" not in paths \
            or counters.get("whatif.scenarios") != len(RANK_CANDIDATES) \
            or "whatif.fanout" not in gauges or lead.launches["leadership"]:
        fail(f"19e: exit {rc}, stdout == phase 11's {out == rank_text}, spans {sorted(paths)}, "
             f"counters {counters}, gauges {gauges}")
    phase("obs", f"(e) RANK_DECOMMISSION of {len(RANK_CANDIDATES)} candidates with "
          f"--report-json on cuda ({secs:.2f} s): stdout byte-identical to phase 11's; "
          f"whatif/rank span, whatif.scenarios {counters['whatif.scenarios']}, whatif.fanout "
          f"{gauges['whatif.fanout']}, spans {sorted(p.split('/', 2)[-1] for p in paths)}")
    phase("timing", f"phase 19 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 20: the reply delay of the timed runs (1 ms, as
#: scripts/bench_zk_ingest.py:82 models a round trip) and their turns (one:
#: a second turn took 29 s that phase 21's fresh processes need).
ZK_REPLY_DELAY_S = 0.001
ZK_TIMING_TURNS = 1


def zk_tree(n_brokers, n_topics, p_per_topic, rf, n_racks, replaced):
    """Config 4's znode tree: every broker (the replaced ones too, still
    registered) as ``/brokers/ids/<id>`` with host ``b<id>`` and its rack,
    and every topic as ``/brokers/topics/<t>``."""
    from kafka_assigner_tpu_torch.models.synthetic import (
        build_config4,
        rack_striped_cluster,
    )

    topic_map, _, _ = build_config4(n_brokers, n_topics, p_per_topic, rf, n_racks,
                                    replaced)
    _, _, racks = rack_striped_cluster(n_brokers, 0, 0, rf, n_racks,
                                       extra_brokers=replaced)
    tree = {f"/brokers/ids/{b}": json.dumps(
        {"host": f"b{b}", "port": 9092, "rack": racks[b]}).encode() for b in sorted(racks)}
    for t, parts in topic_map.items():
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in parts.items()}}).encode()
    return tree


def serve_tree(conn, tree, **kw):
    """In a worker process: serve ``tree`` with ``tests/jute_server.py``
    (``kw`` its options) until the parent writes to or closes ``conn``;
    sends ``(port, znodes, bytes)`` once listening."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jute_server", os.path.join(ROOT, "tests", "jute_server.py"))
    jute = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jute)
    server = jute.JuteZkServer(tree, **kw)
    server.start()
    conn.send((server.port, len(tree), sum(len(v) for v in tree.values())))
    try:
        conn.recv()
    except EOFError:
        pass
    server.shutdown()


def zk_server_main(conn, shape, reply_delay_s):
    """Worker process: config 4's tree (:func:`zk_tree` of ``shape``)."""
    sys.path.insert(0, ROOT)
    serve_tree(conn, zk_tree(*shape), reply_delay_s=reply_delay_s)


@contextlib.contextmanager
def server_process(target, *args):
    """``target(conn, *args)`` in a spawned process (its own interpreter,
    so the server's threads do not share the CLI's); yields what it first
    sends and stops the process afterwards."""
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=target, args=(child, *args), daemon=True)
    proc.start()
    child.close()
    try:
        if not parent.poll(300):
            fail("the jute server process did not report a port within 300 s")
        yield parent.recv()
    finally:
        with contextlib.suppress(OSError):
            parent.send("stop")
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


def zk_quorum(reply_delay_s=0.0):
    """Config 4's ZooKeeper tree served from a spawned process; yields
    ``(port, znodes, bytes)``."""
    shape = (N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, REPLACED)
    return server_process(zk_server_main, shape, reply_delay_s)


def zk_phases(work, checks, argv4, text4, prefix, prefix_text, topic_map, live,
              rack_map, cap, on_removed):
    """Phase 20: config 4 over ZooKeeper through the wire client and the
    streamed ingest, on cuda. Returns the leadership kernel's launches per
    run."""
    from kafka_assigner_tpu_torch import cli, generator
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    rdir = os.path.join(work, "reports")
    os.makedirs(rdir, exist_ok=True)
    launches = {}
    removed = ",".join(f"b{b}" for b in range(REPLACED))

    def zk_argv(port):
        return ["--zk_string", f"127.0.0.1:{port}", "--mode", "PRINT_REASSIGNMENT",
                "--broker_hosts_to_remove", removed]

    def run(key, argv, what, want=text4):
        lead.launches["leadership"] = 0
        rc, out, err, wall = cli_run(cli.run, argv)
        launches[key] = lead.launches["leadership"]
        ingest = dict(generator.last_ingest)
        if rc != 0 or out != want:
            fail(f"20 {what}: exit {rc}, stdout equal to the snapshot run's "
                 f"{out == want}; {err[-800:]}")
        return wall, ingest

    with knobs(KA_ZK_CLIENT="wire"), zk_quorum() as (port, znodes, nbytes):
        # (a) config 4 over the socket: the snapshot plan's bytes, the
        # preencode, the C codec, one kernel launch held against plain.
        with solver_probe() as seen:
            wall, ingest = run("zk_config4", zk_argv(port) + ["--device", "cuda"],
                               "(a) config 4")
        orders = seen["orders"]
        if launches["zk_config4"] != 1 or len(orders) != 1:
            fail(f"20 (a): the leadership kernel launched {launches['zk_config4']} times "
                 f"({len(orders)} ordering calls), not once")
        if ingest.get("solve_encode") != "preencoded" or ingest.get("codecs") != ["c"]:
            fail(f"20 (a): the solve did not take a C-codec preencode ({ingest})")
        moved = check_plan(plan_section(text4), topic_map, live, rack_map, cap, on_removed)
        (inputs, outputs), = orders
        checks.submit("phase 20's streamed config-4 solve", inputs, outputs)
        phase("zk", f"(a) config 4 over ZooKeeper ({znodes} znodes, {nbytes} bytes, port "
              f"{port}) on cuda: {wall:.2f} s CLI wall; stdout byte-identical to phase "
              f"4's snapshot plan; moved {moved}; {ingest['topics']} topics streamed in "
              f"{ingest['chunks']} chunks, encode {ingest['encode_ms']:.1f} ms on the "
              f"{'/'.join(ingest['codecs'])} codec ({ingest['overlap_ms']:.1f} ms of it "
              f"while replies were in flight); the solve took the preencode; leadership "
              f"kernel launches 1 at {tuple(inputs[0].shape)}")

        # (b) the overlap off, and a 7-topic chunk: the same bytes.
        with knobs(KA_ZK_OVERLAP=0):
            wall_off, ingest = run("zk_overlap_off", zk_argv(port) + ["--device", "cuda"],
                                   "(b) KA_ZK_OVERLAP=0")
        if ingest.get("preencoded") or ingest.get("solve_encode") != "c":
            fail(f"20 (b): KA_ZK_OVERLAP=0 still streamed an encode ({ingest})")
        with knobs(KA_ZK_INGEST_CHUNK=7):
            wall_7, ingest = run("zk_chunk7", zk_argv(port) + ["--device", "cuda"],
                                 "(b) KA_ZK_INGEST_CHUNK=7")
        if ingest.get("chunks") != -(-N_TOPICS // 7) or ingest.get("solve_encode") != "preencoded":
            fail(f"20 (b): KA_ZK_INGEST_CHUNK=7 gave {ingest}")
        phase("zk", f"(b) KA_ZK_OVERLAP=0 ({wall_off:.2f} s, the solve encoded on the C "
              f"codec) and KA_ZK_INGEST_CHUNK=7 ({wall_7:.2f} s, {ingest['chunks']} "
              "chunks): stdout byte-identical to (a); kernel launches 1 each")

        # (c) the prefix over ZooKeeper, cuda == cpu == phase 5's.
        argv = zk_argv(port) + ["--topics", prefix]
        run("zk_prefix", argv + ["--device", "cuda"], "(c) prefix on cuda", prefix_text)
        run("zk_prefix_cpu", argv + ["--device", "cpu"], "(c) prefix on cpu", prefix_text)
        launches.pop("zk_prefix_cpu")
        phase("zk", f"(c) {PREFIX_TOPICS}-topic prefix over ZooKeeper: cuda and cpu "
              "byte-identical, equal to phase 5's snapshot plan")

    # (d) a 1 ms reply delay: the overlap on, off, and serial reads.
    variants = (("overlap on", {}), ("overlap off", {"KA_ZK_OVERLAP": "0"}),
                ("serial", {"KA_ZK_PIPELINE": "1"}))
    mode = "mode/PRINT_REASSIGNMENT"
    rows = {name: [] for name, _ in variants}
    with knobs(KA_ZK_CLIENT="wire"), zk_quorum(ZK_REPLY_DELAY_S) as (port, _, _):
        for turn in range(ZK_TIMING_TURNS):
            for name, env in variants:
                path = os.path.join(rdir, f"zk_{name.replace(' ', '_')}_{turn}.json")
                with knobs(**env):
                    wall, _ = run(f"zk_delay_{name.replace(' ', '_')}_{turn}",
                                  zk_argv(port) + ["--device", "cuda", "--report-json", path],
                                  f"(d) {name}")
                report = read_report(path, "ok")
                spans = {sp["path"]: sp["ms"] for sp in report["spans"]}
                c, g = report["metrics"]["counters"], report["metrics"]["gauges"]
                h = report["metrics"]["histograms"].get("zk.pipeline.batch_ms", {})
                row = {
                    "wall_ms": wall * 1e3,
                    "metadata_ms": spans[f"{mode}/metadata/assignment"],
                    "brokers_ms": spans.get(f"{mode}/zk/brokers"),
                    "solve_ms": spans[f"{mode}/plan/solve"],
                    "encode_ms": g.get("ingest.encode_ms"),
                    "overlap_ms": g.get("ingest.overlap_ms"),
                    "batches": c.get("zk.pipeline.batches"),
                    "rtts_saved": c.get("zk.pipeline.rtts_saved"),
                    "in_flight": g.get("zk.pipeline.in_flight"),
                    "batch_ms": h.get("sum"),
                    "solve_encode_ms": spans.get(f"{mode}/plan/solve/encode"),
                }
                rows[name].append(row)
                phase("zk", f"(d) 1 ms reply delay, {name}, turn {turn + 1}: CLI wall "
                      f"{row['wall_ms']:.1f} ms; zk/brokers {row['brokers_ms']} ms; "
                      f"metadata/assignment {row['metadata_ms']} ms; "
                      f"ingest.encode_ms {row['encode_ms']}, ingest.overlap_ms "
                      f"{row['overlap_ms']}; zk.pipeline batches {row['batches']}, "
                      f"rtts_saved {row['rtts_saved']}, in_flight {row['in_flight']}, "
                      f"batch_ms sum {row['batch_ms']}; plan/solve {row['solve_ms']} ms "
                      f"(its encode {row['solve_encode_ms']} ms) | {smi}")
    for name, _ in variants:
        med = {k: statistics.median(r[k] for r in rows[name])
               for k in ("wall_ms", "brokers_ms", "metadata_ms", "solve_ms")}
        phase("zk", f"(d) {name}, median of {ZK_TIMING_TURNS}: CLI wall "
              f"{med['wall_ms']:.1f} ms, zk/brokers {med['brokers_ms']:.1f} ms, "
              f"metadata/assignment {med['metadata_ms']:.1f} ms, "
              f"plan/solve {med['solve_ms']:.1f} ms | {smi}")
    phase("timing", f"phase 20 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 21: fresh processes through the warm-start bench's child mode
#: (scripts/torch_bench_warmstart.py), which runs the CLI or ka-warm in the
#: child and reports the leadership kernel's launches from inside it.
WARMSTART = os.path.join(ROOT, "scripts", "torch_bench_warmstart.py")
#: Phase 21(c)'s turns: one (a second took ~26 s that phase 22 needs).
WARM_TURNS = 1


def warm_child(kind, argv, env=None):
    """One fresh process of the port's CLI (``kind`` ``cli``) or ``ka-warm``
    (``warm``): the bench's ``run_child`` result."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_bench_warmstart", WARMSTART)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.run_child(kind, argv, env)


def warm_steps(r):
    """The warm-up's steps and the kernel fingerprint in one child, as
    ``name ms`` (each window's length, summed over its calls)."""
    out = []
    for name, wins in sorted(r["windows"].items()):
        if name.startswith(("warmup:", "fingerprint:cuda")):
            out.append(f"{name.split(':', 1)[1] if name.startswith('warmup:') else name} "
                       f"{sum(b - a for a, b in wins):.1f}")
    return ", ".join(out) or "none"


def warm_phases(work, snap, text4):
    """Phase 21: warm start in fresh processes, on cuda. (a) ``ka-warm`` on
    phase 4's snapshot against an empty store, and beside it with the store
    off; (b) ``scripts/torch_bench_warmstart.py``; (c) config 4 over
    ZooKeeper at a 1 ms reply delay, loading every library from (a)'s
    store, the warm-up on against ``KA_WARMUP=0`` (WARM_TURNS turns). Returns the
    leadership kernel's launches per child run, as each child counted
    them."""
    import hashlib
    import tempfile

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    launches = {}
    store = tempfile.mkdtemp(prefix="store21-", dir=work)
    warm_argv = ["--zk_string", f"file://{snap}"]
    ms = lambda r, k: r["hist_sums"].get(k, {}).get("sum")  # noqa: E731

    # (a) ka-warm seeds an empty store; beside it, ka-warm with the store
    # off refuses to call its run seeded. (c)'s runs load from this store.
    seeded = "ka-warm: solve_batched: warmed"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        off = pool.submit(warm_child, "warm", warm_argv,
                          {"KA_PROGRAM_STORE_DIR": store, "KA_PROGRAM_STORE": "0"})
        r = warm_child("warm", warm_argv, {"KA_PROGRAM_STORE_DIR": store})
        r_off = off.result()
    launches["warm_seed"] = r["launches"]
    c = r["counters"]
    if r["exit"] != 0 or seeded not in r["stderr_tail"] or not c.get("compile.store.misses"):
        fail(f"21 (a) ka-warm seed: exit {r['exit']}, counters {c}; "
             f"{r['stderr_tail'][-800:]}")
    if r["launches"] or r_off["launches"]:
        fail(f"21 (a) ka-warm launched the leadership kernel {r['launches']}; "
             f"{r_off['launches']} times")
    wins = r["windows"].get("warmup", [[0, 0]])
    phase("warm", f"(a) ka-warm on phase 4's snapshot, an empty store: exit 0, "
          f"{seeded!r}; {c}; compiles_ms {ms(r, 'compile.store.compiles_ms')}; process "
          f"wall {r['wall_ms']:.1f} ms (torch import {r['torch_import_ms']:.1f}, "
          f"host-library prebuild {r['prebuild_ms']:.1f}, warm-up "
          f"{wins[0][1] - wins[0][0]:.1f} ms: {warm_steps(r)}); leadership launches 0; "
          f"beside the store-off run below | {smi}")
    if r_off["exit"] != 1 or "NOTHING persisted" not in r_off["stderr_tail"]:
        fail(f"21 (a) ka-warm with the store off: exit {r_off['exit']}; "
             f"{r_off['stderr_tail'][-800:]}")
    phase("warm", f"(a) ka-warm under KA_PROGRAM_STORE=0: exit 1, 'NOTHING persisted' "
          f"({r_off['wall_ms']:.1f} ms, beside the seeding run); leadership launches 0")

    # (b) the bench: cold, warm, warm + overlap, off; each plan == phase 4's.
    proc = subprocess.run([sys.executable, WARMSTART, "--snapshot", snap], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"21 (b) torch_bench_warmstart.py exited {proc.returncode}: "
             f"{proc.stderr[-1500:]}")
    line = proc.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    want = hashlib.sha256(text4.encode()).hexdigest()
    for name, child in bench["children"].items():
        if child["plan_sha256"] != want:
            fail(f"21 (b) the bench's {name} plan differs from phase 4's")
        launches[f"warmstart_{name}"] = child["launches"]
    print(line)
    phase("warm", f"(b) torch_bench_warmstart.py: each of {sorted(bench['children'])} "
          f"byte-identical to phase 4's plan, one leadership launch each | {smi}")

    # (c) over ZooKeeper at a 1 ms reply delay, fresh processes in turns.
    removed = ",".join(f"b{b}" for b in range(REPLACED))
    mode = "mode/PRINT_REASSIGNMENT"
    rdir = os.path.join(work, "reports21")
    os.makedirs(rdir, exist_ok=True)
    variants = (("warm-up on", {}), ("KA_WARMUP=0", {"KA_WARMUP": "0"}))
    seeded_env = {"KA_PROGRAM_STORE_DIR": store}
    with knobs(KA_ZK_CLIENT="wire"), zk_quorum(ZK_REPLY_DELAY_S) as (port, _, _):
        for turn in range(WARM_TURNS):
            for name, env in variants:
                key = f"zk_{'on' if env == {} else 'off'}_{turn}"
                path = os.path.join(rdir, f"{key}.json")
                r = warm_child("cli", ["--zk_string", f"127.0.0.1:{port}", "--mode",
                                       "PRINT_REASSIGNMENT", "--broker_hosts_to_remove",
                                       removed, "--device", "cuda", "--report-json", path],
                               {**seeded_env, **env})
                launches[f"warm_{key}"] = r["launches"]
                if r["exit"] != 0 or r["stdout"] != text4 or r["launches"] != 1:
                    fail(f"21 (c) {name}: exit {r['exit']}, stdout equal to phase 4's "
                         f"{r['stdout'] == text4}, launches {r['launches']}; "
                         f"{r['stderr_tail'][-800:]}")
                report = read_report(path, "ok")
                spans = {sp["path"]: sp["ms"] for sp in report["spans"]}
                counters = report["metrics"]["counters"]
                warm = {k: v for k, v in counters.items() if k.startswith("warmup.")}
                store_c = {k: v for k, v in counters.items()
                           if k.startswith("compile.store.")}
                if (warm == {}) != bool(env):
                    fail(f"21 (c) {name}: warmup counters {warm}")
                # Every library from the store ka-warm seeded in (a): the
                # host libraries at startup, the kernel's in the report.
                loads = report["metrics"]["histograms"].get(
                    "compile.store.loads_ms", {}).get("sum")
                if not store_c.get("compile.store.hits") or loads is None \
                        or "compile.store.misses" in store_c \
                        or "compile.store.misses" in r["counters"]:
                    fail(f"21 (c) {name}: not loaded from ka-warm's store: {store_c}, "
                         f"startup {r['counters']}")
                ingest = r["windows"]["ingest"][0]
                wwin = r["windows"].get("warmup", [None])[0]
                inside = (f"{wwin[0]:.1f}-{wwin[1]:.1f} ms, ended "
                          f"{'inside' if wwin[1] <= ingest[1] else 'after'} the ingest"
                          if wwin else "none")
                phase("warm", f"(c) 1 ms reply delay, {name}, turn {turn + 1}: CLI wall "
                      f"{r['wall_ms']:.1f} ms (torch import {r['torch_import_ms']:.1f}, "
                      f"prebuild {r['prebuild_ms']:.1f}); ingest {ingest[0]:.1f}-"
                      f"{ingest[1]:.1f} ms; warm-up {inside} ({warm_steps(r)}); "
                      f"warmup span "
                      f"{spans.get('warmup')} ms beside metadata/assignment "
                      f"{spans.get(f'{mode}/metadata/assignment')} ms; plan/solve "
                      f"{spans.get(f'{mode}/plan/solve')} ms; {warm}; {store_c}, "
                      f"loads_ms {loads:.1f} from ka-warm's store; "
                      f"leadership launches 1; stdout == phase 4's | {smi}")
    phase("timing", f"phase 21 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 22: ka-execute of config 4's plan. The wave size and the first
#: poll interval are passed explicitly: config 4's plan changes the replica
#: list (order included) of 171,046 of its 208,000 partitions, so at the
#: default of 8 moves a wave it would take ~21,000 waves, each rewriting
#: the whole snapshot and the journal. At 32,768 it takes 6. The 64-topic
#: prefix runs (d) and (e) take waves of 512 (11 waves), so the kill lands
#: with waves still to go.
EXEC_WAVE_SIZE = 32768
EXEC_POLL_INTERVAL = 0.01
EXEC_PREFIX_WAVE = 512
EXEC_PERSIST_REPS = 3


def exec_run(argv, env=None):
    """``python -m kafka_assigner_tpu_torch.exec ARGV`` in a fresh process,
    as a user runs ``ka-execute``: ``(exit code, stderr, seconds)``."""
    full = dict(os.environ, PYTHONPATH=ROOT,
                KA_EXEC_POLL_INTERVAL=str(EXEC_POLL_INTERVAL), **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kafka_assigner_tpu_torch.exec", *argv],
                          cwd=ROOT, env=full, capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stderr, time.perf_counter() - t0


def canonical_snapshot(src, out, plan=None):
    """``src``'s brokers and topics (with ``plan``'s partitions applied)
    written through the port's ``write_snapshot`` to ``out``; its text."""
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend, write_snapshot

    backend = SnapshotBackend(src)
    topics = {t: dict(parts) for t, parts in backend._topics.items()}
    for t, parts in (plan or {}).items():
        topics[t].update(parts)
    write_snapshot(out, backend.brokers(), topics)
    with open(out, encoding="utf-8") as f:
        return f.read()


def assignment_bytes(backend, topics):
    """The backend's assignment of ``topics`` as canonical plan bytes."""
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_json

    return format_reassignment_json(backend.partition_assignment(topics),
                                    topic_order=sorted(topics))


def exec_server_main(conn, tree_path):
    """Worker process: the znode tree in ``tree_path`` (JSON, path to text)
    with the jute server's simulated controller."""
    with open(tree_path, encoding="utf-8") as f:
        tree = {k: v.encode() for k, v in json.load(f).items()}
    serve_tree(conn, tree, controller_delay_ops=1)


def exec_phases(work, checks, argv4, text4, snap, prefix, prefix_text):
    """Phase 22: plan execution. (a) config 4's plan through mode 3 on cuda
    (the leadership kernel launched and held against plain); (b)
    ``ka-execute`` of it on a copy of phase 4's snapshot; (c) its
    ``--rollback``; (d) on the 64-topic prefix, a kill at a wave boundary
    and ``--resume``; (e) the prefix over ZooKeeper. Returns the kernel's
    launches."""
    from kafka_assigner_tpu_torch.exec.engine import load_plan_file
    from kafka_assigner_tpu_torch.exec.journal import ExecutionJournal
    from kafka_assigner_tpu_torch.io.base import open_backend
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend, write_snapshot
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    xdir = os.path.join(work, "exec")
    os.makedirs(xdir, exist_ok=True)

    def read(path):
        with open(path, encoding="utf-8") as f:
            return f.read()

    def journal_state(path):
        j = json.loads(read(path))
        return j["status"], j["waves_committed"], len(j["moves"])

    # (a) the plan through the normal entry, on cuda.
    lead.launches["leadership"] = 0
    with solver_probe() as seen:
        text = run_cli(argv4 + ["--device", "cuda"])
    launched = lead.launches["leadership"]
    if text != text4 or launched < 1 or len(seen["orders"]) != 1:
        fail(f"22 (a): plan equal to phase 4's {text == text4}, leadership launches "
             f"{launched}, ordering calls {len(seen['orders'])}")
    (inputs, outputs), = seen["orders"]
    checks.submit("phase 22's config-4 plan", inputs, outputs)
    plan_path = os.path.join(xdir, "config4.plan")
    with open(plan_path, "w", encoding="utf-8") as f:
        f.write(text)
    plan, order = load_plan_file(plan_path)
    phase("exec", f"(a) config 4 mode 3 on cuda: stdout byte-identical to phase 4's "
          f"({len(text)} bytes, {sum(len(v) for v in plan.values())} partitions in the "
          f"NEW ASSIGNMENT), leadership kernel launches {launched}, held against plain")

    # The per-wave persist: the whole snapshot through write_snapshot.
    persist = []
    backend = SnapshotBackend(snap)
    for _ in range(EXEC_PERSIST_REPS):
        t0 = time.perf_counter()
        write_snapshot(os.path.join(xdir, "persist.json"), backend.brokers(),
                       backend._topics)
        persist.append((time.perf_counter() - t0) * 1e3)
    persist_bytes = os.path.getsize(os.path.join(xdir, "persist.json"))
    t0 = time.perf_counter()
    SnapshotBackend(os.path.join(xdir, "persist.json"))
    load_ms = (time.perf_counter() - t0) * 1e3

    # The import in a fresh process: ka-execute needs no torch.
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, time\n"
         "t0 = time.perf_counter()\n"
         "import kafka_assigner_tpu_torch.cli, kafka_assigner_tpu_torch.exec\n"
         "print(json.dumps({'ms': (time.perf_counter() - t0) * 1e3,"
         " 'torch': 'torch' in sys.modules}))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    imp = json.loads(probe.stdout.strip().splitlines()[-1])
    if probe.returncode != 0 or imp["torch"]:
        fail(f"22: importing the execution entry imported torch or failed: {probe.stderr}")

    # (b) forward: the plan on a copy of phase 4's snapshot.
    cluster = os.path.join(xdir, "config4.json")
    shutil.copy(snap, cluster)
    canonical = canonical_snapshot(snap, os.path.join(xdir, "canonical.json"))
    expected = canonical_snapshot(snap, os.path.join(xdir, "expected.json"), plan)
    report = os.path.join(xdir, "forward.json")
    journal = os.path.join(xdir, "forward.journal")
    rc, err, secs = exec_run(["--zk_string", cluster, "--plan", plan_path,
                              "--journal", journal, "--wave-size", str(EXEC_WAVE_SIZE),
                              "--report-json", report])
    if rc != 0 or "verify-after-move OK" not in err:
        fail(f"22 (b) ka-execute: exit {rc}; {err[-1500:]}")
    if read(cluster) != expected:
        fail("22 (b): the executed snapshot differs from the plan's NEW ASSIGNMENT "
             "written through write_snapshot")
    if journal_state(journal)[0] != "complete":
        fail(f"22 (b): journal {journal_state(journal)}")
    # One journal commit at this move count, as every converged wave makes.
    done = ExecutionJournal.load(journal)
    done.path = os.path.join(xdir, "commit.journal")
    commits = []
    for _ in range(EXEC_PERSIST_REPS):
        t0 = time.perf_counter()
        done.save()
        commits.append((time.perf_counter() - t0) * 1e3)
    rep = read_report(report, "ok")
    c = rep["metrics"]["counters"]
    span_ms = {n: sum(sp["ms"] for sp in rep["spans"] if sp["name"] == n)
               for n in ("exec/wave", "exec/submit", "exec/poll", "exec/verify")}
    mode_ms = next(sp["ms"] for sp in rep["spans"] if sp["depth"] == 0)
    wave_h = rep["metrics"]["histograms"]["exec.wave_ms"]
    phase("exec", f"(b) ka-execute of config 4's plan on a copy of phase 4's snapshot, "
          f"--wave-size {EXEC_WAVE_SIZE}, KA_EXEC_POLL_INTERVAL={EXEC_POLL_INTERVAL}: exit 0, "
          f"verify-after-move OK, final snapshot byte-identical to the NEW ASSIGNMENT "
          f"through write_snapshot, journal complete; process wall {secs * 1e3:.1f} ms, "
          f"mode span {mode_ms:.1f} ms; waves {c['exec.waves']}, moves "
          f"{c['exec.moves']}, noops {rep['plan']['noops']}, polls "
          f"{c['exec.waves'] + c.get('exec.retries', 0)}; span totals (ms): exec/wave "
          f"{span_ms['exec/wave']:.1f}, exec/submit {span_ms['exec/submit']:.1f}, "
          f"exec/poll {span_ms['exec/poll']:.1f}, exec/verify "
          f"{span_ms['exec/verify']:.1f}; exec.wave_ms min {wave_h['min']:.1f} max "
          f"{wave_h['max']:.1f} | {smi}")
    phase("exec", f"(b) one snapshot persist (write_snapshot, {persist_bytes} bytes, "
          f"indent 1 and fsync, as every converged wave writes it): "
          f"{', '.join(f'{v:.1f}' for v in persist)} ms; its load {load_ms:.1f} ms; "
          f"one journal commit ({len(done.moves)} moves, "
          f"{os.path.getsize(done.path)} bytes): "
          f"{', '.join(f'{v:.1f}' for v in commits)} ms; "
          f"importing the execution entry in a fresh process {imp['ms']:.1f} ms, "
          f"torch not imported | {smi}")

    # (c) rollback: back to the original snapshot's canonical bytes.
    journal_rb = os.path.join(xdir, "rollback.journal")
    rc, err, secs = exec_run(["--zk_string", cluster, "--plan", plan_path, "--rollback",
                              "--journal", journal_rb, "--wave-size", str(EXEC_WAVE_SIZE),
                              "--report-json", os.path.join(xdir, "rollback.json")])
    if rc != 0 or "verify-after-move OK" not in err:
        fail(f"22 (c) --rollback: exit {rc}; {err[-1500:]}")
    if read(cluster) != canonical:
        fail("22 (c): the rolled-back snapshot differs from the original's canonical bytes")
    rep = read_report(os.path.join(xdir, "rollback.json"), "ok")
    if rep["mode"] != "ROLLBACK_REASSIGNMENT" or journal_state(journal_rb)[0] != "complete":
        fail(f"22 (c): mode {rep['mode']}, journal {journal_state(journal_rb)}")
    phase("exec", f"(c) --rollback on the same copy: exit 0, verify OK, bytes equal to "
          f"the original snapshot through write_snapshot; process wall "
          f"{secs * 1e3:.1f} ms, waves {rep['metrics']['counters']['exec.waves']} | {smi}")

    # (d) the prefix: killed at a wave boundary, then resumed.
    topics = prefix.split(",")
    pplan = os.path.join(xdir, "prefix.plan")
    with open(pplan, "w", encoding="utf-8") as f:
        f.write(prefix_text)
    psnap = os.path.join(xdir, "prefix.json")
    write_snapshot(psnap, backend.brokers(), {t: backend._topics[t] for t in topics})
    runs = {}
    for name, env in (("uninterrupted", {}), ("killed", {"KA_FAULTS_SPEC": "wave:1=crash"})):
        path = os.path.join(xdir, f"prefix_{name}.json")
        shutil.copy(psnap, path)
        runs[name] = exec_run(["--zk_string", path, "--plan", pplan, "--journal",
                               path + ".journal", "--wave-size", str(EXEC_PREFIX_WAVE)], env)
    rc, err, _ = runs["uninterrupted"]
    if rc != 0:
        fail(f"22 (d) uninterrupted: exit {rc}; {err[-1500:]}")
    killed = os.path.join(xdir, "prefix_killed.json")
    rc, err, _ = runs["killed"]
    status, committed, n_moves = journal_state(killed + ".journal")
    if rc == 0 or "InjectedExecCrash" not in err or (status, committed) != ("in-progress", 1):
        fail(f"22 (d) kill: exit {rc}, journal {status}/{committed}; {err[-800:]}")
    rc, err, _ = exec_run(["--zk_string", killed, "--plan", pplan, "--journal",
                           killed + ".journal", "--wave-size", str(EXEC_PREFIX_WAVE),
                           "--resume"])
    final = read(os.path.join(xdir, "prefix_uninterrupted.json"))
    if rc != 0 or "resuming from journal" not in err or read(killed) != final:
        fail(f"22 (d) --resume: exit {rc}, bytes equal to the uninterrupted run's "
             f"{read(killed) == final}; {err[-800:]}")
    waves = -(-n_moves // EXEC_PREFIX_WAVE)
    phase("exec", f"(d) {PREFIX_TOPICS}-topic prefix, {n_moves} moves in {waves} waves of "
          f"{EXEC_PREFIX_WAVE}: KA_FAULTS_SPEC=wave:1=crash killed the process with 1 wave "
          f"committed; --resume finished it byte-identical to the uninterrupted run")

    # (e) the prefix over ZooKeeper, the jute server's controller applying.
    tree = {f"/brokers/ids/{b.id}": json.dumps({"host": b.host, "port": b.port,
                                                "rack": b.rack})
            for b in backend.brokers()}
    for t in topics:
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in backend._topics[t].items()}})
    tree_path = os.path.join(xdir, "prefix_tree.json")
    with open(tree_path, "w", encoding="utf-8") as f:
        json.dump(tree, f)
    with server_process(exec_server_main, tree_path) as (port, _, _):
        spec = f"127.0.0.1:{port}"
        rc, err, secs = exec_run(["--zk_string", spec, "--plan", pplan, "--journal",
                                  os.path.join(xdir, "zk.journal"), "--wave-size",
                                  str(EXEC_PREFIX_WAVE)], {"KA_ZK_CLIENT": "wire"})
        if rc != 0 or "verify-after-move OK" not in err:
            fail(f"22 (e) ka-execute over ZooKeeper: exit {rc}; {err[-1500:]}")
        with knobs(KA_ZK_CLIENT="wire"):
            zk = open_backend(spec)
            try:
                got = assignment_bytes(zk, topics)
                in_flight = zk._zk.exists("/admin/reassign_partitions") is not None
            finally:
                zk.close()
    want = assignment_bytes(SnapshotBackend(os.path.join(xdir, "prefix_uninterrupted.json")),
                            topics)
    if got != want or in_flight:
        fail(f"22 (e): the tree read back equals (d)'s final assignment {got == want}, "
             f"a reassignment still in flight {in_flight}")
    phase("exec", f"(e) the prefix over ZooKeeper (jute server, simulated controller, wire "
          f"client): exit 0, verify OK in {secs * 1e3:.1f} ms; the tree read back equals "
          f"(d)'s final assignment ({len(got)} bytes), no reassignment in flight")
    phase("timing", f"phase 22 {time.perf_counter() - t_phase:.1f} s")
    return {"exec_plan": launched}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import kafka_assigner_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable next to this script ({e})")
    checks = PlainChecks()
    try:
        return smoke(checks)
    finally:
        checks.close()


def smoke(checks) -> int:
    import torch

    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models import problem
    from kafka_assigner_tpu_torch.models.problem import context_to_array, encode_topic_group
    from kafka_assigner_tpu_torch.ops import build
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.ops import leadership_cases as cases
    from kafka_assigner_tpu_torch.ops.assignment import place_batched
    from kafka_assigner_tpu_torch.solvers.base import Context

    t_start = time.perf_counter()
    set_knobs = [k for k in POLICY_KNOBS if os.environ.get(k)]
    if set_knobs:
        fail(f"phases 1-18 run strict and unprofiled; unset {set_knobs}")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    built = build.build_all()
    phase("build", f"nvcc sm_90a: {built['seconds']:.2f} s for {sorted(built['ptxas'])}")
    for src, log in built["ptxas"].items():
        for kernel, stats in build.kernel_resources(log).items():
            phase("build", f"{src}: {kernel}: {stats.get('registers')} registers, "
                  f"{stats.get('stack')} bytes stack frame, {stats.get('spill_stores')} "
                  f"bytes spill stores, {stats.get('spill_loads')} bytes spill loads")
    native_builds()

    max_err = kernel_cases(cases)
    group_case_err = group_kernel_cases()

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
    if problem.last_codec != {"encode": "c", "decode": "c"}:
        fail(f"the main path's encode and decode did not take the C codec "
             f"({problem.last_codec})")
    removed = set(range(REPLACED))
    on_removed = sum(b in removed for old in topic_map.values()
                     for reps in old.values() for b in reps)
    cap = math.ceil(P_PER_TOPIC * RF / len(live))
    moved = check_plan(plan_section(text), topic_map, live, rack_map, cap, on_removed)
    phase("main", f"config 4 mode 3 on cuda: {wall_s:.2f} s wall, moved {moved} "
          f"replicas (== replicas on brokers 0-{REPLACED - 1}), cap {cap}, "
          f"leadership kernel launches {launched}, encode and decode through the C codec")

    # The kernel at the main path's shape, on the main path's inputs,
    # against the plain version on the same inputs (in a worker).
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
    checks.submit("the main-path shape", k_args, lead.leadership_order(*k_args))
    shape = tuple(k_args[0].shape)

    # --- 5: cuda == cpu on a prefix -------------------------------------
    prefix = ",".join(t for t, _ in topics[:PREFIX_TOPICS])
    a = run_cli(argv + ["--topics", prefix, "--device", "cuda"])
    c = run_cli(argv + ["--topics", prefix, "--device", "cpu"])
    if a != c:
        fail(f"{PREFIX_TOPICS}-topic prefix: cuda and cpu plans differ")
    phase("cuda==cpu", f"{PREFIX_TOPICS}-topic prefix of config 4: plan text "
          f"byte-identical ({len(a)} bytes)")

    # --- 6: timing, with the codec A/B ---------------------------------------
    assigner = TopicAssigner(device="cuda")

    def solve_config4():
        assigner.context = Context()
        return assigner.generate_assignments(topics, live, rack_map), assigner.solver

    ab = codec_ab("config 4", solve_config4, SOLVE_REPS)
    if ab["routes"] != {"encode": "c", "decode": "c"}:
        fail(f"config 4: the C codec did not run under KA_HOSTCODEC=1 ({ab['routes']})")
    phase("timing", f"solve median of {SOLVE_REPS} (ms): {phase_ms(ab['c'])}; waves "
          f"{assigner.solver.last_waves}")

    times = cases.event_ms(lambda: lead.leadership_order(*k_args), KERNEL_REPS)
    ms = statistics.median(times)
    small = tuple(t[:2].contiguous() for t in (k_args[0], k_args[1])) + (
        k_args[2], k_args[3][:2].contiguous())
    ms_small = statistics.median(
        cases.event_ms(lambda: lead.leadership_order(*small), 5))
    plain_ms = cases.event_ms(lambda: lead.leadership_order_plain(*small), 1)[0]
    b_, p_, rf_ = shape
    n_pad = k_args[2].shape[0]
    nbytes = kernel_bytes(b_, p_, rf_, n_pad)
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

    # --- 7-9: the giant cells --------------------------------------------
    cells = giant_cells()
    launches, (k_giant, checked) = giant_main_paths(cells, work, lead, checks)
    reduced, err = reduced_parity(work, lead)
    max_err = max(max_err, err)
    giant_timing(cells)
    g_times = cases.event_ms(lambda: lead.leadership_order(*k_giant), KERNEL_REPS)
    g_ms = statistics.median(g_times)
    if any(not torch.equal(x, y) for x, y in zip(lead.leadership_order(*k_giant), checked)):
        fail("the timed giant-shape launch differs from the one checked against plain")
    g_shape = tuple(k_giant[0].shape)
    g_bytes = kernel_bytes(*g_shape, k_giant[2].shape[0])
    g_bound_ms = g_bytes / HBM_BYTES_PER_S * 1e3
    g_steps = cases.chain_steps(g_shape[0] * g_shape[1], g_shape[2])
    g_chain_ms = g_steps * step_ns * 1e-6
    phase("timing", f"leadership kernel median {g_ms:.3f} ms of {KERNEL_REPS} launches "
          f"(min {min(g_times):.3f}, max {max(g_times):.3f}) at the giant shape "
          f"{g_shape} N_pad={k_giant[2].shape[0]}; byte bound {g_bound_ms:.4f} ms "
          f"({g_bytes} bytes); chain floor {g_chain_ms:.3f} ms ({g_steps} steps x "
          f"{step_ns:.3f} ns); result equal to the launch checked in phase 7")
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    # --- 10-13: what-if sweeps, RANK_DECOMMISSION, host modes -----------
    # Placement only: the leadership kernel is not on these paths.
    lead.launches["leadership"] = 0
    whatif_config5()
    steady_snap, rank_rec = rank_config4(work)
    rescue_parity()
    host_modes(steady_snap, N_BROKERS, N_TOPICS * P_PER_TOPIC)
    if lead.launches["leadership"]:
        fail(f"the what-if phases launched the leadership kernel "
             f"{lead.launches['leadership']} times")
    phase("whatif", "phases 10-13 launched the leadership kernel 0 times")

    # --- 14-16: consumer-group packing ------------------------------------
    # The group phases do not order leaders either.
    lead.launches["leadership"] = 0
    gk, group_runs = group_phases(work, steady_snap, checks)
    if lead.launches["leadership"]:
        fail(f"the group phases launched the leadership kernel "
             f"{lead.launches['leadership']} times")
    phase("groups", "phases 14-16 launched the leadership kernel 0 times")
    # The workers' checks end here, so phases 17-18 time a quiet host.
    worst = checks.collect()
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    # --- 17-18: the leadership lanes and the solver lanes -------------------
    lanes = leadership_lanes(argv, (topics, live, rack_map), cells, work)
    greedy_prefix = solver_lanes(argv, text, prefix, a, topic_map, live, rack_map, cap,
                                 on_removed)

    # --- 19: the run report, the device trace and the failure policy --------
    obs_launches = obs_phases(
        work, checks, argv, text, moved, (topics, live, rack_map), ms, ab["c"], prefix,
        a, greedy_prefix, group_runs, steady_snap, rank_rec["candidates_text"])

    # --- 20: live ZooKeeper and the streamed ingest --------------------------
    zk_launches = zk_phases(work, checks, argv, text, prefix, a, topic_map, live,
                            rack_map, cap, on_removed)

    # --- 21: warm start in fresh processes -----------------------------------
    warm_launches = warm_phases(work, snap, text)

    # --- 22: plan execution ---------------------------------------------------
    exec_launches = exec_phases(work, checks, argv, text, snap, prefix, a)
    late = checks.collect()

    max_err = max(max_err, worst.get("leadership", 0), late.get("leadership", 0))
    gk["max_abs_err"] = max(group_case_err, worst.get("group_pack", 0))
    phase("timing", f"whole smoke {time.perf_counter() - t_start:.1f} s")

    by_path = {"config4": launched, **{f"giant_{k}": v for k, v in launches.items()},
               **reduced,
               **{f"lane_{k.replace(' ', '_')}_{lane}": v["cli_launches"][lane]
                  for k, v in lanes.items() for lane in ("native", "device")},
               **obs_launches, **zk_launches, **warm_launches, **exec_launches}
    kernels = {"kernels": [{
        "name": "leadership",
        "route": "cuda",
        "source": "kafka_assigner_tpu_torch/csrc/leadership.cu",
        "replaces": LEADERSHIP_TPU_KERNEL,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
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
        "giant_shape": list(g_shape),
        "giant_ms": g_ms,
        "giant_bound_ms": g_bound_ms,
        "giant_chain_steps": g_steps,
        "giant_chain_bound_ms": g_chain_ms,
    }, gk]}
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


def kernel_bytes(b: int, p: int, rf: int, n_pad: int) -> int:
    """Bytes the leadership function must move: candidates in and order out
    (B x P x RF int32 each), counts, hashes, and the counter slab in and
    out."""
    return 4 * (2 * b * p * rf + b * p + b + 2 * n_pad * rf)


if __name__ == "__main__":
    sys.exit(main())
